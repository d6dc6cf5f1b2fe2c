// Device code of the classification kernels that spread one chain's rows
// over several warps (mala_cls_block.cu, hmc_cls_block.cu), for Hopper
// (sm_90a).
//
// Layout: a block of 8 warps holds 8 / WPC chains of WPC warps each (4, 2 or
// 1). Every warp of a chain keeps its own copy of the chain's elementwise
// state in registers (lane l owns entries l, l + 32, ..., as in
// cls_common.cuh) and does the same arithmetic in the same order, so the
// copies stay bit-identical. An evaluation of the chain at a weight vector
// (`chain_eval`) splits the train rows and the test rows into WPC contiguous
// shares, one a warp. A warp runs its share's forward, backward and record
// code with the weights in registers and gets a partial gradient in the
// lane layout and partial sums (ll, err^2, matches on the train rows; err^2,
// matches on the test rows). The chain's warps publish their partials to
// parity-alternating slots in shared memory, meet at a named barrier of the
// chain's warps alone (bar.sync 1 + chain, 32 WPC threads; barrier 0 is
// __syncthreads') and each warp sums the WPC partials in warp order. No
// atomics: every run gives the same bits. At WPC 1 no barrier is needed.
//
// Shared memory of a block: the data rows (padded to 16 bytes), then per
// warp a broadcast slot (VEC floats) and a 32-row record tile (32 x
// STRIDE), then per warp two parities of its partial slot (PART floats).

#pragma once

#include "cls_common.cuh"

#define CLS_PART 8  // floats after the gradient in a partial slot

template <int NI, int NH, int NO>
struct ChainCls {
  using N = ClsNet<NI, NH, NO>;
  static constexpr int WR = (N::W + 3) / 4 * 4;  // weights held in registers
  static constexpr int WARP = N::VEC + 32 * N::STRIDE;  // wb slot, record tile
  static constexpr int PART = N::VEC + CLS_PART;       // one warp's partial
};

__device__ __forceinline__ void chain_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// The forward of cls_common.cuh's cls_forward with the weights in registers
// (the same summation order).
template <int NI, int NH, int NO, int WR>
__device__ __forceinline__ void fwd_reg(const float (&x)[NI], const float (&wr)[WR],
                                        float (&s)[NH], float (&out)[NO]) {
  using N = ClsNet<NI, NH, NO>;
#pragma unroll
  for (int o = 0; o < NO; ++o) out[o] = -wr[N::B2 + o];
#pragma unroll
  for (int h = 0; h < NH; ++h) {
    float z = -wr[N::S2 + h];
#pragma unroll
    for (int i = 0; i < NI; ++i) z += x[i] * wr[i * NH + h];
    s[h] = cls_sigmoid(z);
#pragma unroll
    for (int o = 0; o < NO; ++o) out[o] += s[h] * wr[N::S1 + h * NO + o];
  }
#pragma unroll
  for (int o = 0; o < NO; ++o) out[o] = cls_sigmoid(out[o]);
}

// One evaluation of a chain at v by one of its WPC warps: this warp's train
// rows [r0, r1) (ll, metrics and gradient) and test rows
// [t0, t1) (metrics), then the chain's sums over its warps, in warp order,
// into g (lane layout), tr and te. `part` is the chain's partial slots,
// `epar` their parity, flipped here.
template <int NI, int NH, int NO, int WPC>
__device__ __forceinline__ void chain_eval(const float* __restrict__ rows, int r0, int r1,
                                           const float* __restrict__ te_rows, int t0, int t1,
                                           const float (&v)[ClsNet<NI, NH, NO>::PER], float* wb,
                                           float* rec, float* part, int& epar, int sub,
                                           int bar_id, int lane,
                                           float (&g)[ClsNet<NI, NH, NO>::PER], ClsSums& tr,
                                           ClsSums& te) {
  using N = ClsNet<NI, NH, NO>;
  using H = ChainCls<NI, NH, NO>;
  constexpr int PER = N::PER, WR = H::WR;
  // the weights: through the warp's slot into registers
  __syncwarp();  // every lane is done reading the record tile
  cls_put<PER>(wb, lane, v);
  __syncwarp();
  float wr[WR];
  const float4* q = reinterpret_cast<const float4*>(wb);
#pragma unroll
  for (int e = 0; e < WR / 4; ++e) {
    const float4 t = q[e];
    wr[4 * e] = t.x;
    wr[4 * e + 1] = t.y;
    wr[4 * e + 2] = t.z;
    wr[4 * e + 3] = t.w;
  }
  // the train share: records of 32 rows at a time, summed per owned entry
  int ia[PER], ib[PER];
  float sg[PER], gp[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    cls_entry<NI, NH, NO>(lane + 32 * j, ia[j], ib[j], sg[j]);
    gp[j] = 0.f;
  }
  float ll = 0.f, err2 = 0.f, cnt = 0.f;
  float* my = rec + lane * N::STRIDE;
  for (int base = r0; base < r1; base += 32) {
    const int r = base + lane;
    if (r < r1) {
      float x[NI], s[NH], out[NO];
      const int y = cls_load_row<NI>(rows + r * (NI + 1), x);
      fwd_reg<NI, NH, NO, WR>(x, wr, s, out);
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
        for (int o = 0; o < NO; ++o) dh += d2[o] * wr[N::S1 + h * NO + o];
        my[h] = s[h];
        my[NH + h] = dh * s[h] * (1.f - s[h]);
      }
#pragma unroll
      for (int i = 0; i < NI; ++i) my[2 * NH + NO + i] = x[i];
      my[N::REC - 1] = 1.f;
    }
    __syncwarp();
    const int nr = min(32, r1 - base);
    for (int t = 0; t < nr; ++t) {
      const float* rt = rec + t * N::STRIDE;
#pragma unroll
      for (int j = 0; j < PER; ++j) gp[j] += rt[ia[j]] * rt[ib[j]];
    }
    __syncwarp();  // the tile is read before the next one is written
  }
#pragma unroll
  for (int j = 0; j < PER; ++j) gp[j] *= sg[j];
  // the test share: metrics only
  float te_err2 = 0.f, te_cnt = 0.f;
  for (int r = t0 + lane; r < t1; r += 32) {
    float x[NI], s[NH], out[NO];
    const int y = cls_load_row<NI>(te_rows + r * (NI + 1), x);
    fwd_reg<NI, NH, NO, WR>(x, wr, s, out);
    const int pred = cls_argmax<NO>(out);
    const float err = (float)(pred - y);
    te_err2 += err * err;
    te_cnt += (pred == y) ? 1.f : 0.f;
  }
  ll = cls_warp_sum(ll);
  err2 = cls_warp_sum(err2);
  cnt = cls_warp_sum(cnt);
  te_err2 = cls_warp_sum(te_err2);
  te_cnt = cls_warp_sum(te_cnt);
  if constexpr (WPC == 1) {
#pragma unroll
    for (int j = 0; j < PER; ++j) g[j] = gp[j];
    tr = ClsSums{ll, err2, cnt};
    te = ClsSums{0.f, te_err2, te_cnt};
    return;
  }
  // the chain's sum over its warps, in warp order
  float* mine = part + (epar * WPC + sub) * H::PART;
  cls_put<PER>(mine, lane, gp);
  if (lane == 0) {
    mine[N::VEC] = ll;
    mine[N::VEC + 1] = err2;
    mine[N::VEC + 2] = cnt;
    mine[N::VEC + 3] = te_err2;
    mine[N::VEC + 4] = te_cnt;
  }
  chain_barrier(bar_id, 32 * WPC);
  const float* q0 = part + epar * WPC * H::PART;
#pragma unroll
  for (int j = 0; j < PER; ++j) g[j] = q0[lane + 32 * j];
  float s0 = q0[N::VEC], s1 = q0[N::VEC + 1], s2 = q0[N::VEC + 2], s3 = q0[N::VEC + 3],
        s4 = q0[N::VEC + 4];
#pragma unroll
  for (int w = 1; w < WPC; ++w) {
    const float* qw = q0 + w * H::PART;
#pragma unroll
    for (int j = 0; j < PER; ++j) g[j] += qw[lane + 32 * j];
    s0 += qw[N::VEC];
    s1 += qw[N::VEC + 1];
    s2 += qw[N::VEC + 2];
    s3 += qw[N::VEC + 3];
    s4 += qw[N::VEC + 4];
  }
  tr = ClsSums{s0, s1, s2};
  te = ClsSums{0.f, s3, s4};
  epar ^= 1;  // the next evaluation writes the other parity
}

// The diagonal preconditioner m at step i from the Welford M2 in registers:
// the variances over their mean, clipped to [1e-4, 1e4], to precond_power.
template <int PER>
__device__ __forceinline__ void precond_diag_reg(const float (&p2)[PER], int i,
                                                 const ClsPrecondParams& p, float (&m)[PER]) {
  if (i < p.pc_start) {
#pragma unroll
    for (int j = 0; j < PER; ++j) m[j] = 1.f;
    return;
  }
  const float cnt = (float)max(min(i, p.burn_end) - p.warm_end, 1);
  float var[PER], t = 0.f;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    var[j] = p2[j] / cnt;
    t += var[j];
  }
  const float den = fmaxf(cls_warp_sum(t) / p.w_size_f, 1e-30f);
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    m[j] = cls_clip(var[j] / den, 1e-4f, 1e4f);
    if (p.precond_power != 1.f) m[j] = powf(m[j], p.precond_power);
  }
}

// Trace rows of step k from the chain's first warp: the scalars from lane 0,
// the w row (w_last) from every lane.
template <int W, int PER>
__device__ __forceinline__ void write_trace(const ClsPrecondParams& p, size_t kc, int lane,
                                            float ll_row, const ClsCarry& r, int na_before,
                                            const float (&wl)[PER]) {
  if (lane == 0) {
    p.t_ll[kc] = ll_row;
    p.t_rmse_tr[kc] = r.rtr;
    p.t_rmse_te[kc] = r.rte;
    p.t_acc_tr[kc] = r.atr;
    p.t_acc_te[kc] = r.ate;
    p.t_accept[kc] = na_before;
  }
  if (p.t_w != nullptr) {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int e = lane + 32 * j;
      if (e < W) p.t_w[kc * W + e] = wl[j];
    }
  }
}

// write_trace for the generic route (gen_chain.cuh): the w row from the
// chain's slot `wl` of a runtime w_size.
__device__ __forceinline__ void gen_cls_trace(const ClsPrecondParams& p, int w, size_t kc,
                                              int lane, float ll_row, const ClsCarry& r,
                                              int na_before, const float* wl) {
  if (lane == 0) {
    p.t_ll[kc] = ll_row;
    p.t_rmse_tr[kc] = r.rtr;
    p.t_rmse_te[kc] = r.rte;
    p.t_acc_tr[kc] = r.atr;
    p.t_acc_te[kc] = r.ate;
    p.t_accept[kc] = na_before;
  }
  if (p.t_w != nullptr)
    for (int e = lane; e < w; e += 32) p.t_w[kc * w + e] = wl[e];
}

template <int W, int PER>
__device__ __forceinline__ void st_vec(float* dst, int lane, const float (&v)[PER]) {
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int e = lane + 32 * j;
    if (e < W) dst[e] = v[j];
  }
}

// The host-side query the loader checks against precond_cls_step.py.
extern "C" {

int ptnn_cls_part() { return CLS_PART; }

}  // extern "C"
