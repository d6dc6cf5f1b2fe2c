// Device code of the regression kernels that evaluate the FNN with a
// chain's weights in registers (hmc_block.cu, mala_block.cu), for Hopper
// (sm_90a).
//
// An evaluation publishes the chain's weights to its warp's broadcast slot
// once and loads all 61 (and 3 pad entries) into registers with 16 float4
// loads, so the row loop reads no weight from shared memory. Each lane
// walks rows r0 + lane, r0 + lane + 32, ... below r1 and keeps its w_size
// gradient partial sums in registers; a recursive-halving reduce-scatter
// (precond_common.cuh) leaves lane l holding entries 2l and 2l+1, the
// lane-owned layout, with the SSEs riding in the free slots past w_size.
//
// The MALA kernel spreads one chain's rows over WPC warps (the layout of
// cls_chain.cuh, for regression): each warp evaluates its contiguous share
// of the train and test rows (`chain_eval`), the chain's warps publish their
// partials (gradient and the two SSEs, one VEC-float slot in the lane
// layout) to parity-alternating slots in shared memory, meet at a named
// barrier of their own (bar.sync 1 + chain, 32 WPC threads; barrier 0 is
// __syncthreads') and each warp sums the WPC partials in warp order. No
// atomics: every run gives the same bits, and every warp of a chain the
// same. At WPC 1 no barrier is needed.

#pragma once

#include "precond_common.cuh"

// The chain's 61 weights (and 3 pad entries) from its broadcast slot into
// registers: 16 float4 loads.
__device__ __forceinline__ void load_weights(const float* wb, float (&wr)[VEC]) {
  const float4* q = reinterpret_cast<const float4*>(wb);
#pragma unroll
  for (int e = 0; e < VEC / 4; ++e) {
    const float4 v = q[e];
    wr[4 * e] = v.x;
    wr[4 * e + 1] = v.y;
    wr[4 * e + 2] = v.z;
    wr[4 * e + 3] = v.w;
  }
}

// The forward and backward of rows [r0, r1) (the port of ptnn's
// `_fwd_grad_reg`): this lane's rows' d(-SSE/2)/dw added to acc, and
// their SSE.
template <int NI, int NH>
__device__ __forceinline__ float grad_rows(const float* __restrict__ rows, int r0, int r1,
                                           const float (&wr)[VEC], int lane,
                                           float (&acc)[VEC]) {
  using N = Net<NI, NH>;
  float sse = 0.f;
  for (int r = r0 + lane; r < r1; r += 32) {
    const float* xr = rows + r * (NI + 1);
    float x[NI];
#pragma unroll
    for (int i = 0; i < NI; ++i) x[i] = xr[i];
    const float y = xr[NI];
    float s[NH];
    float out = 0.f;
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      float z = -wr[N::S2 + h];
#pragma unroll
      for (int i = 0; i < NI; ++i) z += x[i] * wr[i * NH + h];
      s[h] = sigmoid_f(z);
      out += s[h] * wr[N::S1 + h];
    }
    const float fx = sigmoid_f(out - wr[N::B2]);
    const float resid = y - fx;
    sse += resid * resid;
    const float delta = resid * fx * (1.f - fx);
    acc[N::B2] -= delta;
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      acc[N::S1 + h] += delta * s[h];
      const float dh = delta * wr[N::S1 + h] * s[h] * (1.f - s[h]);
      acc[N::S2 + h] -= dh;
#pragma unroll
      for (int i = 0; i < NI; ++i) acc[i * NH + h] += dh * x[i];
    }
  }
  return sse;
}

// The forward and the SSE of this lane's rows of [r0, r1).
template <int NI, int NH>
__device__ __forceinline__ float sse_rows(const float* __restrict__ rows, int r0, int r1,
                                          const float (&wr)[VEC], int lane) {
  using N = Net<NI, NH>;
  float sse = 0.f;
  for (int r = r0 + lane; r < r1; r += 32) {
    const float* xr = rows + r * (NI + 1);
    float out = 0.f;
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      float z = -wr[N::S2 + h];
#pragma unroll
      for (int i = 0; i < NI; ++i) z += xr[i] * wr[i * NH + h];
      out += sigmoid_f(z) * wr[N::S1 + h];
    }
    const float resid = xr[NI] - sigmoid_f(out - wr[N::B2]);
    sse += resid * resid;
  }
  return sse;
}

// Forward over the n_tr train rows at the weights in registers, the SSE,
// and d(-SSE/2)/dw in the lane layout, from one warp.
template <int NI, int NH>
__device__ __forceinline__ float2 fwd_grad_reg(const float* __restrict__ rows, int n_tr,
                                               const float (&wr)[VEC], int lane,
                                               float& sse_out) {
  using N = Net<NI, NH>;
  float acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
  acc[N::W] = grad_rows<NI, NH>(rows, 0, n_tr, wr, lane, acc);
  reduce_scatter64(acc, lane);
  sse_out = __shfl_sync(FULL_MASK, acc[N::W & 1], N::W >> 1);
  float2 g = f2(acc[0], acc[1]);
  if (2 * lane == N::W) g.x = 0.f;  // the slot that carried the SSE
  if (2 * lane + 1 == N::W) g.y = 0.f;
  return g;
}

// Forward and SSE over n rows (the test rmse), from one warp.
template <int NI, int NH>
__device__ __forceinline__ float fwd_sse_reg(const float* __restrict__ rows, int n,
                                             const float (&wr)[VEC], int lane) {
  return warp_sum(sse_rows<NI, NH>(rows, 0, n, wr, lane));
}

__device__ __forceinline__ void chain_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// Entry e of a vector in the lane layout, read by every lane.
__device__ __forceinline__ float lane_entry(float2 v, int e) {
  return __shfl_sync(FULL_MASK, (e & 1) ? v.y : v.x, e >> 1);
}

// One evaluation of a chain at v by one of its WPC warps: this warp's train
// rows [r0, r1) (SSE and gradient) and test rows [t0, t1) (SSE), then the
// chain's sums over its warps, in warp order: the gradient of -SSE/2 in the
// lane layout (returned) and the two SSEs. `wb` is the warp's broadcast
// slot, `part` the chain's partial slots (2 parities x WPC x VEC floats),
// `epar` their parity, flipped here.
template <int NI, int NH, int WPC>
__device__ __forceinline__ float2 chain_eval(const float* __restrict__ rows, int r0, int r1,
                                             const float* __restrict__ te_rows, int t0, int t1,
                                             float2 v, float* wb, float* part, int& epar,
                                             int sub, int bar_id, int lane, float& sse_tr,
                                             float& sse_te) {
  using N = Net<NI, NH>;
  static_assert(N::W + 1 < VEC, "the two SSEs ride past w_size");
  publish(wb, lane, v);
  float wr[VEC];
  load_weights(wb, wr);
  float acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
  acc[N::W] = grad_rows<NI, NH>(rows, r0, r1, wr, lane, acc);
  acc[N::W + 1] = sse_rows<NI, NH>(te_rows, t0, t1, wr, lane);
  reduce_scatter64(acc, lane);
  float2 g = f2(acc[0], acc[1]);
  if constexpr (WPC > 1) {
    float2* q = reinterpret_cast<float2*>(part + epar * WPC * VEC);
    q[sub * (VEC / 2) + lane] = g;
    chain_barrier(bar_id, 32 * WPC);
    g = q[lane];
#pragma unroll
    for (int w = 1; w < WPC; ++w) {
      const float2 o = q[w * (VEC / 2) + lane];
      g = f2(g.x + o.x, g.y + o.y);
    }
    epar ^= 1;  // the next evaluation writes the other parity
  }
  sse_tr = lane_entry(g, N::W);
  sse_te = lane_entry(g, N::W + 1);
  if (2 * lane >= N::W) g.x = 0.f;  // the slots that carried the SSEs
  if (2 * lane + 1 >= N::W) g.y = 0.f;
  return g;
}

// write_trace for the generic route (gen_chain.cuh): the w row from the
// chain's slot `wl` of a runtime w_size.
__device__ __forceinline__ void gen_reg_trace(const PrecondParams& p, int w, const float* wl,
                                              size_t kc, int lane, float ll_row, const Carry& r,
                                              int na_before) {
  if (lane == 0) {
    p.t_ll[kc] = ll_row;
    p.t_rmse_tr[kc] = r.rtr;
    p.t_rmse_te[kc] = r.rte;
    p.t_accept[kc] = na_before;
  }
  if (p.t_w != nullptr)
    for (int e = lane; e < w; e += 32) p.t_w[kc * w + e] = wl[e];
}
