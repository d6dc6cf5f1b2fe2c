// Device code shared by the classification block kernels (rw_cls_block.cu,
// mala_cls_block.cu, hmc_cls_block.cu) for Hopper (sm_90a): the forward of
// the two-layer sigmoid FNN with O outputs, the multinomial log-likelihood
// over the softmax of the sigmoid outputs, the first-argmax prediction with
// its rmse and accuracy, and the backprop of the log-likelihood (the port of
// ptnn/ops/pallas_step.py `_fwd_cls` and `_fwd_grad_cls`).
//
// Flat codec [W1 (I x H), W2 (H x O, h-major), B1 (H), B2 (O)]; the forward
// subtracts the biases. A row's class index is the float last column of the
// data row.
//
// The kernels lay a chain's vectors of w_size entries out over a warp's
// lanes: lane l owns entries l, l + 32, ..., l + 32 (PER - 1) of a vector of
// VEC = 32 * PER floats, so elementwise work is lane-local and a dot
// product is a warp reduction; entries past w_size hold zeros
// (cls_chain.cuh spreads a chain's rows over several warps in that layout).
//
// The gradient (99 entries for iris) does not fit the regression kernels'
// register layout, where every lane accumulates every entry. Here the rows
// are taken in tiles of 32, one row per lane: each lane runs its row's
// forward and the backward deltas and writes the row's RECORD [s (H), dh
// (H), d2 (O), x (I), 1] to its warp's tile in shared memory (odd stride,
// conflict-free); then each lane sums, over the tile's rows, the products
// record[ia] * record[ib] of the PER entries it owns (`cls_entry`: dW1_ih =
// dh_h x_i, dW2_ho = d2_o s_h, dB = -delta * 1). So a lane holds PER
// accumulators, not w_size, and the gradient lands in the lane layout with
// no reduction.
//
// No fast-math: expf, logf, sqrtf and division are the IEEE-rounded
// versions, so a kernel stays within float rounding of its plain version;
// the rmse and accuracy are exact functions of the argmax.

#pragma once

#include <cuda_runtime.h>

#define CLS_MASK 0xffffffffu

struct ClsPrecondParams {
  // inputs: data, temperatures, state
  const float* rows;  // (n_tr + n_te, NI + 1): x..., class index; train first
  const float* at;    // (C,) adaptive temperature
  const float* w;     // (C, W)
  const float* w_last;
  const float* g_like;
  const float* pc_mean;
  const float* pc_m2;
  const float* ll;  // (C,) untempered
  const float* prior;
  const float* rmse_tr;
  const float* rmse_te;
  const float* acc_tr;
  const float* acc_te;
  const int* n_accept;
  const float* log_step_w;
  const float* log_traj;  // (C,) ChEES only
  const float* chees_m1;
  const float* chees_v2;
  // inputs: noise
  const float* noise_w;  // (K, C, W)
  const float* u;        // (K, C) MH uniforms
  const float* u_jit;    // (K, C) HMC step jitter
  const float* u_traj;   // (K,) ChEES trajectory jitter
  // outputs: new state
  float* o_w;
  float* o_w_last;
  float* o_g_like;
  float* o_pc_mean;
  float* o_pc_m2;
  float* o_ll;
  float* o_prior;
  float* o_rmse_tr;
  float* o_rmse_te;
  float* o_acc_tr;
  float* o_acc_te;
  int* o_n_accept;
  float* o_log_step_w;
  float* o_log_traj;
  float* o_chees_m1;
  float* o_chees_v2;
  // outputs: trace rows (K, C), and (K, C, W) weights or null
  float* t_ll;
  float* t_rmse_tr;
  float* t_rmse_te;
  float* t_acc_tr;
  float* t_acc_te;
  int* t_accept;
  float* t_traj_len;
  float* t_w;
  int n_tr, n_te, chains, k_max, start, length, pc_start, warm_end, burn_end,
      leapfrog, chees, rungs, panel;
  float sigma_sq, adapt_rate, target, warmstart_step, precond_power, eps_jitter,
      chees_rate, n_ladders_f, prior_const, inv_n_tr, inv_n_te, acc_n_tr, acc_n_te,
      w_size_f, log_lo_w, log_hi, log_traj_lo, log09, log0999;
};

template <int NI, int NH, int NO>
struct ClsNet {
  static constexpr int S1 = NI * NH;       // W2 starts (h-major: S1 + h * NO + o)
  static constexpr int S2 = S1 + NH * NO;  // B1
  static constexpr int B2 = S2 + NH;       // B2
  static constexpr int W = B2 + NO;        // w_size
  static constexpr int PER = (W + 31) / 32;  // entries a lane owns
  static constexpr int VEC = 32 * PER;       // floats per chain vector slot
  static constexpr int REC = 2 * NH + NO + NI + 1;  // record [s, dh, d2, x, 1]
  static constexpr int STRIDE = REC | 1;            // odd: conflict-free
  static_assert(NO >= 2, "classification has two or more classes");
};

__device__ __forceinline__ float cls_sigmoid(float z) { return 1.0f / (1.0f + expf(-z)); }

__device__ __forceinline__ float cls_clip(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);  // the upper bound wins, as jnp.clip
}

__device__ __forceinline__ float cls_warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(CLS_MASK, v, off);
  return v;
}

// The forward of one row x at the weights wb (read as broadcasts): hidden
// sigmoids s and sigmoid outputs out, in ptnn's summation order.
template <int NI, int NH, int NO>
__device__ __forceinline__ void cls_forward(const float (&x)[NI], const float* wb,
                                            float (&s)[NH], float (&out)[NO]) {
  using N = ClsNet<NI, NH, NO>;
#pragma unroll
  for (int o = 0; o < NO; ++o) out[o] = -wb[N::B2 + o];
#pragma unroll
  for (int h = 0; h < NH; ++h) {
    float z = -wb[N::S2 + h];
#pragma unroll
    for (int i = 0; i < NI; ++i) z += x[i] * wb[i * NH + h];
    s[h] = cls_sigmoid(z);
#pragma unroll
    for (int o = 0; o < NO; ++o) out[o] += s[h] * wb[N::S1 + h * NO + o];
  }
#pragma unroll
  for (int o = 0; o < NO; ++o) out[o] = cls_sigmoid(out[o]);
}

// First argmax: a later class wins only if strictly larger.
template <int NO>
__device__ __forceinline__ int cls_argmax(const float (&out)[NO]) {
  float best = out[0];
  int pred = 0;
#pragma unroll
  for (int o = 1; o < NO; ++o) {
    if (out[o] > best) {
      best = out[o];
      pred = o;
    }
  }
  return pred;
}

// log sum_o exp(out_o), as mx + log(sum exp(out - mx)).
template <int NO>
__device__ __forceinline__ float cls_lse(const float (&out)[NO]) {
  float mx = out[0];
#pragma unroll
  for (int o = 1; o < NO; ++o) mx = fmaxf(mx, out[o]);
  float se = 0.f;
#pragma unroll
  for (int o = 0; o < NO; ++o) se += expf(out[o] - mx);
  return mx + logf(se);
}

// out[y] without dynamic indexing of a register array.
template <int NO>
__device__ __forceinline__ float cls_pick(const float (&out)[NO], int y) {
  float v = 0.f;
#pragma unroll
  for (int o = 0; o < NO; ++o) v = (o == y) ? out[o] : v;
  return v;
}

template <int NI>
__device__ __forceinline__ int cls_load_row(const float* xr, float (&x)[NI]) {
#pragma unroll
  for (int i = 0; i < NI; ++i) x[i] = xr[i];
  return (int)xr[NI];
}

// Per-row sums of the metrics: log-likelihood, squared class-index error,
// matches. The last two are small integers, so float sums are exact.
struct ClsSums {
  float ll, err2, cnt;
};

// The record fields (ia, ib) and sign whose product, summed over rows, is
// the gradient of entry e (sign 0 past w_size).
template <int NI, int NH, int NO>
__device__ __forceinline__ void cls_entry(int e, int& ia, int& ib, float& sg) {
  using N = ClsNet<NI, NH, NO>;
  constexpr int ONE = N::REC - 1;
  if (e < N::S1) {  // W1[i, h]: dh_h x_i
    ia = NH + e % NH;
    ib = 2 * NH + NO + e / NH;
    sg = 1.f;
  } else if (e < N::S2) {  // W2[h, o]: d2_o s_h
    ia = 2 * NH + (e - N::S1) % NO;
    ib = (e - N::S1) / NO;
    sg = 1.f;
  } else if (e < N::B2) {  // B1[h]: -dh_h
    ia = NH + (e - N::S2);
    ib = ONE;
    sg = -1.f;
  } else if (e < N::W) {  // B2[o]: -d2_o
    ia = 2 * NH + (e - N::B2);
    ib = ONE;
    sg = -1.f;
  } else {
    ia = ONE;
    ib = ONE;
    sg = 0.f;
  }
}

// Floats of the data rows in shared memory, padded to 16 bytes.
__device__ __forceinline__ int cls_rows_floats(int n_rows, int ni) {
  return (n_rows * (ni + 1) + 3) & ~3;  // 16-byte aligned slots follow
}

// Lane-owned entries of a global (W,) vector into registers; zero past W.
template <int W, int PER>
__device__ __forceinline__ void cls_ld(const float* src, int lane, float (&v)[PER]) {
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int e = lane + 32 * j;
    v[j] = e < W ? src[e] : 0.f;
  }
}

template <int PER>
__device__ __forceinline__ void cls_put(float* slot, int lane, const float (&v)[PER]) {
#pragma unroll
  for (int j = 0; j < PER; ++j) slot[lane + 32 * j] = v[j];
}

template <int PER>
__device__ __forceinline__ float cls_dot(const float (&a)[PER], const float (&b)[PER]) {
  float t = 0.f;
#pragma unroll
  for (int j = 0; j < PER; ++j) t += a[j] * b[j];
  return cls_warp_sum(t);
}

// The scalar carries of one chain; every lane of its warp holds the same
// values (they come from warp-wide sums that all lanes share).
struct ClsCarry {
  float ll, pr, rtr, rte, atr, ate, lsw, at;
  int na;
};

__device__ __forceinline__ ClsCarry cls_load_carry(const ClsPrecondParams& p, int c) {
  ClsCarry r;
  r.ll = p.ll[c];
  r.pr = p.prior[c];
  r.rtr = p.rmse_tr[c];
  r.rte = p.rmse_te[c];
  r.atr = p.acc_tr[c];
  r.ate = p.acc_te[c];
  r.lsw = p.log_step_w[c];
  r.at = p.at[c];
  r.na = p.n_accept[c];
  return r;
}

__device__ __forceinline__ void cls_store_carry(const ClsPrecondParams& p, const ClsCarry& r,
                                                int c) {
  p.o_ll[c] = r.ll;
  p.o_prior[c] = r.pr;
  p.o_rmse_tr[c] = r.rtr;
  p.o_rmse_te[c] = r.rte;
  p.o_acc_tr[c] = r.atr;
  p.o_acc_te[c] = r.ate;
  p.o_n_accept[c] = r.na;
  p.o_log_step_w[c] = r.lsw;
}

// Accepting: the proposal's metrics become the carries.
__device__ __forceinline__ void cls_take_metrics(ClsCarry& r, const ClsSums& tr,
                                                 const ClsSums& te, const ClsPrecondParams& p) {
  r.rtr = sqrtf(tr.err2 * p.inv_n_tr);
  r.rte = sqrtf(te.err2 * p.inv_n_te);
  r.atr = tr.cnt * p.acc_n_tr;
  r.ate = te.cnt * p.acc_n_te;
}

// The host-side queries each library exports; the loader checks them
// against precond_cls_step.py. Each .cu includes this header once.
extern "C" {

int ptnn_cls_params_size() { return (int)sizeof(ClsPrecondParams); }

int ptnn_cls_w_size() { return ClsNet<4, 12, 3>::W; }

const char* ptnn_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
