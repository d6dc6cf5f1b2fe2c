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
// MALA layout: one warp per chain, CLS_WARPS chains per thread block (the HMC
// kernel spreads a chain over several warps: hmc_cls_block.cu). A
// chain's vectors of w_size entries sit in shared-memory slots of VEC = 32
// * PER floats; lane l owns entries l, l + 32, ..., l + 32 (PER - 1), so the
// slot index is the entry index, every lane-wide access is conflict-free and
// elementwise work is lane-local. Slot entries past w_size hold zeros.
//
// The gradient (99 entries for iris) does not fit the regression kernels'
// register layout, where every lane accumulates every entry. Here the rows
// are taken in tiles of 32, one row per lane: each lane runs its row's
// forward and the backward deltas and writes the row's RECORD [s (H), dh
// (H), d2 (O), x (I), 1] to its warp's tile in shared memory (odd stride,
// conflict-free); then each lane sums, over the tile's rows, the products
// record[ia] * record[ib] of the PER entries it owns (dW1_ih = dh_h x_i,
// dW2_ho = d2_o s_h, dB = -delta * 1). So a lane holds PER accumulators,
// not w_size, and the gradient lands in the lane layout with no reduction.
//
// No fast-math: expf, logf, sqrtf and division are the IEEE-rounded
// versions, so a kernel stays within float rounding of its plain version;
// the rmse and accuracy are exact functions of the argmax.

#pragma once

#include <cuda_runtime.h>

#define CLS_WARPS 16  // chains per thread block (MALA)
#define CLS_THREADS (CLS_WARPS * 32)
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

// Forward over the n train rows at the weights in wb, the multinomial ll,
// the metrics and d ll / dw in the lane layout (the port of `_fwd_grad_cls`).
// `rec` is the warp's tile of 32 records.
template <int NI, int NH, int NO>
__device__ __forceinline__ ClsSums cls_fwd_grad(const float* __restrict__ rows, int n,
                                                const float* wb, float* rec, int lane,
                                                float (&g)[ClsNet<NI, NH, NO>::PER]) {
  using N = ClsNet<NI, NH, NO>;
  constexpr int PER = N::PER;
  int ia[PER], ib[PER];
  float sg[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    cls_entry<NI, NH, NO>(lane + 32 * j, ia[j], ib[j], sg[j]);
    g[j] = 0.f;
  }
  float ll = 0.f, err2 = 0.f, cnt = 0.f;
  float* my = rec + lane * N::STRIDE;
  for (int base = 0; base < n; base += 32) {
    const int r = base + lane;
    if (r < n) {
      float x[NI], s[NH], out[NO];
      const int y = cls_load_row<NI>(rows + r * (NI + 1), x);
      cls_forward<NI, NH, NO>(x, wb, s, out);
      const float lse = cls_lse<NO>(out);
      ll += cls_pick<NO>(out, y) - lse;
      const int pred = cls_argmax<NO>(out);
      const float err = (float)(pred - y);
      err2 += err * err;
      cnt += (pred == y) ? 1.f : 0.f;
      float d2[NO];
#pragma unroll
      for (int o = 0; o < NO; ++o) {
        const float pr = expf(out[o] - lse);
        d2[o] = ((o == y ? 1.f : 0.f) - pr) * out[o] * (1.f - out[o]);
        my[2 * NH + o] = d2[o];
      }
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        float dh = 0.f;
#pragma unroll
        for (int o = 0; o < NO; ++o) dh += d2[o] * wb[N::S1 + h * NO + o];
        my[h] = s[h];
        my[NH + h] = dh * s[h] * (1.f - s[h]);
      }
#pragma unroll
      for (int i = 0; i < NI; ++i) my[2 * NH + NO + i] = x[i];
      my[N::REC - 1] = 1.f;
    } else {  // a row past the end contributes nothing
#pragma unroll
      for (int f = 0; f < N::REC; ++f) my[f] = 0.f;
    }
    __syncwarp();
    const int nr = min(32, n - base);
    for (int t = 0; t < nr; ++t) {
      const float* rt = rec + t * N::STRIDE;
#pragma unroll
      for (int j = 0; j < PER; ++j) g[j] += rt[ia[j]] * rt[ib[j]];
    }
    __syncwarp();  // the tile is read before the next one is written
  }
#pragma unroll
  for (int j = 0; j < PER; ++j) g[j] *= sg[j];
  ClsSums out;
  out.ll = cls_warp_sum(ll);
  out.err2 = cls_warp_sum(err2);
  out.cnt = cls_warp_sum(cnt);
  return out;
}

// Forward over n rows and the metrics only (the test rows); ll is 0.
template <int NI, int NH, int NO>
__device__ __forceinline__ ClsSums cls_fwd_metrics(const float* __restrict__ rows, int n,
                                                   const float* wb, int lane) {
  float err2 = 0.f, cnt = 0.f;
  for (int r = lane; r < n; r += 32) {
    float x[NI], s[NH], out[NO];
    const int y = cls_load_row<NI>(rows + r * (NI + 1), x);
    cls_forward<NI, NH, NO>(x, wb, s, out);
    const int pred = cls_argmax<NO>(out);
    const float err = (float)(pred - y);
    err2 += err * err;
    cnt += (pred == y) ? 1.f : 0.f;
  }
  ClsSums out;
  out.ll = 0.f;
  out.err2 = cls_warp_sum(err2);
  out.cnt = cls_warp_sum(cnt);
  return out;
}

// ---------------------------------------------------------------------------
// One warp per chain (MALA).

// The warp's shared-memory slots: w, w_last, g_like, Welford mean and M2, the
// broadcast slot wb the forward reads, and the record tile.
struct ClsSlots {
  float* w;
  float* wl;
  float* gl;
  float* pm;
  float* p2;
  float* wb;
  float* rec;
};

__device__ __forceinline__ int cls_rows_floats(int n_rows, int ni) {
  return (n_rows * (ni + 1) + 3) & ~3;  // 16-byte aligned slots follow
}

template <int NI, int NH, int NO>
__device__ __forceinline__ int cls_warp_floats() {
  using N = ClsNet<NI, NH, NO>;
  return 6 * N::VEC + 32 * N::STRIDE;
}

template <int NI, int NH, int NO>
__device__ __forceinline__ ClsSlots cls_slots(float* smem, int row_floats, int warp) {
  using N = ClsNet<NI, NH, NO>;
  float* base = smem + row_floats + warp * cls_warp_floats<NI, NH, NO>();
  ClsSlots s;
  s.w = base;
  s.wl = base + N::VEC;
  s.gl = base + 2 * N::VEC;
  s.pm = base + 3 * N::VEC;
  s.p2 = base + 4 * N::VEC;
  s.wb = base + 5 * N::VEC;
  s.rec = base + 6 * N::VEC;
  return s;
}

__device__ __forceinline__ void cls_load_rows(const ClsPrecondParams& p, float* s_rows,
                                              int ni) {
  const int n = (p.n_tr + p.n_te) * (ni + 1);
  for (int t = threadIdx.x; t < n; t += CLS_THREADS) s_rows[t] = p.rows[t];
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

template <int W, int PER>
__device__ __forceinline__ void cls_st(float* dst, int lane, const float* slot) {
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int e = lane + 32 * j;
    if (e < W) dst[e] = slot[e];
  }
}

template <int PER>
__device__ __forceinline__ void cls_get(const float* slot, int lane, float (&v)[PER]) {
#pragma unroll
  for (int j = 0; j < PER; ++j) v[j] = slot[lane + 32 * j];
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

// Evaluate at v: publish it to the warp's broadcast slot first.
template <int PER>
__device__ __forceinline__ void cls_publish(float* wb, int lane, const float (&v)[PER]) {
  __syncwarp();  // every lane is done reading the previous weights
  cls_put<PER>(wb, lane, v);
  __syncwarp();
}

template <int W, int PER>
__device__ __forceinline__ void cls_load_chain(const ClsPrecondParams& p, const ClsSlots& s,
                                               int c, int lane) {
  const size_t cw = (size_t)c * W;
  float v[PER];
  cls_ld<W, PER>(p.w + cw, lane, v);
  cls_put<PER>(s.w, lane, v);
  cls_ld<W, PER>(p.w_last + cw, lane, v);
  cls_put<PER>(s.wl, lane, v);
  cls_ld<W, PER>(p.g_like + cw, lane, v);
  cls_put<PER>(s.gl, lane, v);
  cls_ld<W, PER>(p.pc_mean + cw, lane, v);
  cls_put<PER>(s.pm, lane, v);
  cls_ld<W, PER>(p.pc_m2 + cw, lane, v);
  cls_put<PER>(s.p2, lane, v);
}

template <int W, int PER>
__device__ __forceinline__ void cls_store_chain(const ClsPrecondParams& p, const ClsSlots& s,
                                                int c, int lane) {
  const size_t cw = (size_t)c * W;
  cls_st<W, PER>(p.o_w + cw, lane, s.w);
  cls_st<W, PER>(p.o_w_last + cw, lane, s.wl);
  cls_st<W, PER>(p.o_g_like + cw, lane, s.gl);
  cls_st<W, PER>(p.o_pc_mean + cw, lane, s.pm);
  cls_st<W, PER>(p.o_pc_m2 + cw, lane, s.p2);
}

// The diagonal preconditioner m at step i from the Welford M2 slot.
template <int PER>
__device__ __forceinline__ void cls_precond_diag(const float* p2, int i, const ClsPrecondParams& p,
                                                 int lane, float (&m)[PER]) {
  if (i < p.pc_start) {
#pragma unroll
    for (int j = 0; j < PER; ++j) m[j] = 1.f;
    return;
  }
  const float cnt = (float)max(min(i, p.burn_end) - p.warm_end, 1);
  float var[PER], t = 0.f;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    var[j] = p2[lane + 32 * j] / cnt;
    t += var[j];
  }
  const float den = fmaxf(cls_warp_sum(t) / p.w_size_f, 1e-30f);
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    m[j] = cls_clip(var[j] / den, 1e-4f, 1e4f);
    if (p.precond_power != 1.f) m[j] = powf(m[j], p.precond_power);
  }
}

// Welford accumulation of the post-decision w (slot) into (pm, p2).
template <int PER>
__device__ __forceinline__ void cls_welford(const ClsSlots& s, int lane, int i,
                                            const ClsPrecondParams& p) {
  const float cnt_new = (float)max(min(i + 1, p.burn_end) - p.warm_end, 1);
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int e = lane + 32 * j;
    const float w = s.w[e];
    const float d = w - s.pm[e];
    const float pm = s.pm[e] + d / cnt_new;
    s.pm[e] = pm;
    s.p2[e] = s.p2[e] + d * (w - pm);
  }
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

// Trace rows of step k, after its decision: the UNTEMPERED ll, the carries,
// the accept count BEFORE the decision and the w row that follows w_last.
template <int W, int PER>
__device__ __forceinline__ void cls_write_trace(const ClsPrecondParams& p, const ClsSlots& s,
                                                size_t kc, int lane, float ll_row,
                                                const ClsCarry& r, int na_before) {
  if (lane == 0) {
    p.t_ll[kc] = ll_row;
    p.t_rmse_tr[kc] = r.rtr;
    p.t_rmse_te[kc] = r.rte;
    p.t_acc_tr[kc] = r.atr;
    p.t_acc_te[kc] = r.ate;
    p.t_accept[kc] = na_before;
  }
  if (p.t_w != nullptr) cls_st<W, PER>(p.t_w + kc * W, lane, s.wl);
}

// The host-side queries each library exports; the loader checks them
// against precond_cls_step.py. Each .cu includes this header once.
extern "C" {

int ptnn_cls_params_size() { return (int)sizeof(ClsPrecondParams); }

int ptnn_cls_warps() { return CLS_WARPS; }

int ptnn_cls_w_size() { return ClsNet<4, 12, 3>::W; }

const char* ptnn_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
