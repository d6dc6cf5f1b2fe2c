// Device code shared by the preconditioned MALA and HMC block kernels
// (mala_block.cu, hmc_block.cu), regression task, for Hopper (sm_90a).
//
// A chain's vectors of w_size <= 63 entries sit in 64-float slots; lane l
// of a warp owns entries 2l and 2l+1 (a float2), so elementwise work on w,
// momenta and gradients is lane-local and a dot product is one warp
// reduction. The data rows [x..., y] (train, then test) sit in shared
// memory once per block. The HMC kernel runs one warp per chain and keeps
// the chain's vectors in its warp's shared-memory slots (`ChainSlots`);
// the MALA kernel spreads a chain's rows over several warps and keeps them
// in registers (reg_chain.cuh).
//
// The FNN backprop (reg_chain.cuh, the port of ptnn/ops/pallas_step.py
// `_fwd_grad_reg`) keeps its w_size gradient partial sums in registers and
// reduces them with a recursive-halving reduce-scatter across the warp
// (`reduce_scatter64`): 62 shuffles leave lane l holding entries 2l and
// 2l+1, the lane-owned layout, where one warp sum per entry would take 5 x
// 61. The SSEs ride in the free slots past w_size of the same reduction.
//
// No fast-math: expf, sqrtf and division are the IEEE-rounded versions, so
// a kernel stays within float rounding of its plain PyTorch version.

#pragma once

#include <cuda_runtime.h>

#define VEC 64  // floats per chain vector slot
#define FULL_MASK 0xffffffffu

struct PrecondParams {
  // inputs: data, temperatures, state
  const float* rows;  // (n_tr + n_te, NI + 1): x..., y; train first
  const float* at;    // (C,) adaptive temperature
  const float* w;     // (C, W)
  const float* w_last;
  const float* g_like;
  const float* pc_mean;
  const float* pc_m2;
  const float* eta;  // (C,)
  const float* ll;   // (C,) untempered
  const float* prior;
  const float* rmse_tr;
  const float* rmse_te;
  const int* n_accept;
  const float* log_step_w;
  const float* log_step_eta;
  const float* log_traj;  // (C,) ChEES only
  const float* chees_m1;
  const float* chees_v2;
  // inputs: noise
  const float* noise_w;    // (K, C, W)
  const float* noise_eta;  // (K, C)
  const float* u;          // (K, C) w-block uniforms
  const float* u_eta;      // (K, C) eta-block uniforms
  const float* u_jit;      // (K, C) HMC step jitter
  const float* u_traj;     // (K,) ChEES trajectory jitter
  // outputs: new state
  float* o_w;
  float* o_w_last;
  float* o_g_like;
  float* o_pc_mean;
  float* o_pc_m2;
  float* o_eta;
  float* o_ll;
  float* o_prior;
  float* o_rmse_tr;
  float* o_rmse_te;
  int* o_n_accept;
  float* o_log_step_w;
  float* o_log_step_eta;
  float* o_log_traj;
  float* o_chees_m1;
  float* o_chees_v2;
  // outputs: trace rows (K, C), and (K, C, W) weights or null
  float* t_ll;
  float* t_rmse_tr;
  float* t_rmse_te;
  int* t_accept;
  float* t_traj_len;
  float* t_w;
  // HMC under ChEES on the cooperative route: the exchange slots in device
  // memory, (C, 2, 2 * VEC + 4) floats; null otherwise
  float* exch;
  int n_tr, n_te, chains, k_max, start, length, pc_start, warm_end, burn_end,
      leapfrog, chees, rungs, panel;
  float sigma_sq, one_plus_nu1, nu2, adapt_rate, target, eta_target,
      warmstart_step, precond_power, eps_jitter, chees_rate, n_ladders_f,
      prior_const, ll_const, log_2pi, n_tr_f, n_te_f, w_size_f, log_lo_w,
      log_lo_eta, log_hi, log_traj_lo, log09, log0999;
};

template <int NI, int NH>
struct Net {
  static constexpr int S1 = NI * NH;  // W2 entries start
  static constexpr int S2 = S1 + NH;  // B1
  static constexpr int B2 = S2 + NH;  // B2
  static constexpr int W = B2 + 1;    // w_size
  static_assert(W < VEC, "the lane layout holds w_size <= 63");
};

__device__ __forceinline__ float sigmoid_f(float z) {
  return 1.0f / (1.0f + expf(-z));
}

__device__ __forceinline__ float clipf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);  // the upper bound wins, as jnp.clip
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL_MASK, v, off);
  return v;
}

__device__ __forceinline__ float2 f2(float x, float y) { return make_float2(x, y); }

// Entries 2l, 2l+1 of a global (W,) vector; zero past W.
__device__ __forceinline__ float2 ld2(const float* p, int lane, int w) {
  const int j = 2 * lane;
  return f2(j < w ? p[j] : 0.f, j + 1 < w ? p[j + 1] : 0.f);
}

__device__ __forceinline__ void st2(float* p, int lane, int w, float2 v) {
  const int j = 2 * lane;
  if (j < w) p[j] = v.x;
  if (j + 1 < w) p[j + 1] = v.y;
}

__device__ __forceinline__ float dot2(float2 a, float2 b) {
  return warp_sum(a.x * b.x + a.y * b.y);
}

// One stage of the reduce-scatter: lanes whose bit HALF / 2 is set keep the
// upper HALF entries and send the lower ones to their partner, the others
// the reverse. HALF is a template argument so that the loop unrolls fully:
// with a trip count that depends on an outer loop's counter, the inner loop
// was unrolled by 4 before the outer one, which indexed the array with a
// runtime pointer and put it in local memory (a 256-byte stack frame read
// and written on every reduce-scatter).
template <int HALF>
__device__ __forceinline__ void reduce_scatter_stage(float (&v)[VEC], int lane) {
  const bool upper = (lane & (HALF / 2)) != 0;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float send = upper ? v[i] : v[i + HALF];
    const float keep = upper ? v[i + HALF] : v[i];
    v[i] = keep + __shfl_xor_sync(FULL_MASK, send, HALF / 2);
  }
}

// Recursive-halving reduce-scatter of 64 values per lane: afterwards
// v[0], v[1] of lane l hold the warp sums of entries 2l and 2l+1.
__device__ __forceinline__ void reduce_scatter64(float (&v)[VEC], int lane) {
  reduce_scatter_stage<32>(v, lane);
  reduce_scatter_stage<16>(v, lane);
  reduce_scatter_stage<8>(v, lane);
  reduce_scatter_stage<4>(v, lane);
  reduce_scatter_stage<2>(v, lane);
}

// The diagonal preconditioner m at step i from the Welford M2 (lane layout).
__device__ __forceinline__ float2 precond_diag(float2 p2, int i, const PrecondParams& p) {
  if (i < p.pc_start) return f2(1.f, 1.f);
  const float cnt = (float)max(min(i, p.burn_end) - p.warm_end, 1);
  const float2 var = f2(p2.x / cnt, p2.y / cnt);
  const float mean_var = warp_sum(var.x + var.y) / p.w_size_f;
  const float den = fmaxf(mean_var, 1e-30f);
  float2 m = f2(clipf(var.x / den, 1e-4f, 1e4f), clipf(var.y / den, 1e-4f, 1e4f));
  if (p.precond_power != 1.f) m = f2(powf(m.x, p.precond_power), powf(m.y, p.precond_power));
  return m;
}

// The dataset-free eta block: a random walk on eta whose likelihood is
// recovered from the carried ll, with its Robbins-Monro scale.
__device__ __forceinline__ void eta_block(float& eta, float& ll, float& pr, float& lse,
                                          float ne, float ue, float at, int i,
                                          const PrecondParams& p) {
  const float eta_p = eta + expf(lse) * ne;
  const float val_cur = (ll + (-p.ll_const) * (p.log_2pi + eta)) * expf(eta);
  const float ll_eta = p.ll_const * (p.log_2pi + eta_p) + val_cur * expf(-eta_p);
  const float dprior = -p.one_plus_nu1 * (eta_p - eta) - p.nu2 * (expf(-eta_p) - expf(-eta));
  const float mh_e = expf(fminf((ll_eta - ll) / at + dprior, 0.f));
  if (ue < mh_e) {
    eta = eta_p;
    ll = ll_eta;
    pr = pr + dprior;
  }
  if (i < p.burn_end) lse = lse + p.adapt_rate * (mh_e - p.eta_target);
  lse = clipf(lse, p.log_lo_eta, p.log_hi);
}

// Welford accumulation of the post-decision w into (pm, p2).
__device__ __forceinline__ void welford(float2 w, float2& pm, float2& p2, int i,
                                        const PrecondParams& p) {
  const float cnt_new = (float)max(min(i + 1, p.burn_end) - p.warm_end, 1);
  const float2 d = f2(w.x - pm.x, w.y - pm.y);
  pm = f2(pm.x + d.x / cnt_new, pm.y + d.y / cnt_new);
  p2 = f2(p2.x + d.x * (w.x - pm.x), p2.y + d.y * (w.y - pm.y));
}

// Per-warp shared-memory slots of the HMC kernel: w, w_last, g_like,
// pc_mean, pc_m2 and the broadcast slot wb that an evaluation publishes.
struct ChainSlots {
  float2* w;
  float2* wl;
  float2* gl;
  float2* pm;
  float2* p2;
  float* wb;
};

__device__ __forceinline__ int rows_floats(int n_rows, int ni) {
  return (n_rows * (ni + 1) + 3) & ~3;  // 16-byte aligned slots follow
}

__device__ __forceinline__ ChainSlots chain_slots(float* smem, int row_floats, int warp) {
  float* base = smem + row_floats + warp * 6 * VEC;
  ChainSlots s;
  s.w = reinterpret_cast<float2*>(base);
  s.wl = reinterpret_cast<float2*>(base + VEC);
  s.gl = reinterpret_cast<float2*>(base + 2 * VEC);
  s.pm = reinterpret_cast<float2*>(base + 3 * VEC);
  s.p2 = reinterpret_cast<float2*>(base + 4 * VEC);
  s.wb = base + 5 * VEC;
  return s;
}

// Evaluate at `v`: publish it to the warp's broadcast slot first.
__device__ __forceinline__ void publish(float* wb, int lane, float2 v) {
  __syncwarp();  // every lane is done reading the previous weights
  reinterpret_cast<float2*>(wb)[lane] = v;
  __syncwarp();
}

__device__ __forceinline__ void load_chain(const PrecondParams& p, const ChainSlots& s,
                                           int c, int lane, int w) {
  const size_t cw = (size_t)c * w;
  s.w[lane] = ld2(p.w + cw, lane, w);
  s.wl[lane] = ld2(p.w_last + cw, lane, w);
  s.gl[lane] = ld2(p.g_like + cw, lane, w);
  s.pm[lane] = ld2(p.pc_mean + cw, lane, w);
  s.p2[lane] = ld2(p.pc_m2 + cw, lane, w);
}

__device__ __forceinline__ void store_chain(const PrecondParams& p, const ChainSlots& s,
                                            int c, int lane, int w) {
  const size_t cw = (size_t)c * w;
  st2(p.o_w + cw, lane, w, s.w[lane]);
  st2(p.o_w_last + cw, lane, w, s.wl[lane]);
  st2(p.o_g_like + cw, lane, w, s.gl[lane]);
  st2(p.o_pc_mean + cw, lane, w, s.pm[lane]);
  st2(p.o_pc_m2 + cw, lane, w, s.p2[lane]);
}

// The scalar carries of one chain; every lane of its warps holds the same
// values (they are computed from warp-wide sums that all lanes share).
struct Carry {
  float eta, ll, pr, rtr, rte, lsw, lse, at;
  int na;
};

__device__ __forceinline__ Carry load_carry(const PrecondParams& p, int c) {
  Carry r;
  r.eta = p.eta[c];
  r.ll = p.ll[c];
  r.pr = p.prior[c];
  r.rtr = p.rmse_tr[c];
  r.rte = p.rmse_te[c];
  r.lsw = p.log_step_w[c];
  r.lse = p.log_step_eta[c];
  r.at = p.at[c];
  r.na = p.n_accept[c];
  return r;
}

__device__ __forceinline__ void store_carry(const PrecondParams& p, const Carry& r, int c) {
  p.o_eta[c] = r.eta;
  p.o_ll[c] = r.ll;
  p.o_prior[c] = r.pr;
  p.o_rmse_tr[c] = r.rtr;
  p.o_rmse_te[c] = r.rte;
  p.o_n_accept[c] = r.na;
  p.o_log_step_w[c] = r.lsw;
  p.o_log_step_eta[c] = r.lse;
}

// Trace rows of step k, after its decision: the rmse carries, the accept
// count BEFORE the decision and the w row that follows w_last (lane 0
// writes the scalars, every lane its w entries).
__device__ __forceinline__ void write_trace(const PrecondParams& p, float2 wl, size_t kc,
                                            int lane, int w, float ll_row, const Carry& r,
                                            int na_before) {
  if (lane == 0) {
    p.t_ll[kc] = ll_row;
    p.t_rmse_tr[kc] = r.rtr;
    p.t_rmse_te[kc] = r.rte;
    p.t_accept[kc] = na_before;
  }
  if (p.t_w != nullptr) st2(p.t_w + kc * w, lane, w, wl);
}

__device__ __forceinline__ void load_rows(const PrecondParams& p, float* s_rows, int ni) {
  const int n = (p.n_tr + p.n_te) * (ni + 1);
  for (int t = threadIdx.x; t < n; t += blockDim.x) s_rows[t] = p.rows[t];
}

// The host-side queries each kernel's library exports; the loader checks
// them against precond_step.py. Each .cu includes this header once.
extern "C" {

int ptnn_precond_params_size() { return (int)sizeof(PrecondParams); }

int ptnn_precond_w_size() { return Net<4, 10>::W; }

const char* ptnn_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
