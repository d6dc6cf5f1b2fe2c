// A fused block of K preconditioned-MALA steps for every chain of the
// parallel-tempering ladder, classification task, for Hopper (sm_90a).
//
// Replaces the TPU kernel ptnn/ops/pallas_step.py `_mala_cls_block_kernel`
// (wrapper `fused_mala_cls_block_impl`). The plain PyTorch version of the
// same function is `mala_cls_block_reference` in
// ptnn_torch/ops/precond_cls_step.py, whose docstring states the semantics.
//
// What bounds it. A chain-step is one forward and backward pass of the
// (4, 12, 3) FNN over the 105 iris train rows (about 400 flops a row), a
// forward over the 45 test rows, a handful of warp reductions and one MH
// decision. The steps of a chain are serial, so a block costs K times the
// latency of one step: 105 rows on 32 lanes are 4 tiles, each a row's
// forward and deltas per lane, then 32 x 4 record products per lane.
// Device memory sees only the noise read and the trace rows written once a
// step.
//
// Design. One warp per chain, 16 chains per 512-thread block
// (cls_common.cuh): the rows live in shared memory once per block, the
// chain's w, w_last, g_like and Welford buffers in its warp's slots with
// lane l owning entries l, l + 32, l + 64, l + 96, so the proposal, the
// q-ratio and the Welford update are lane-local and every sum is a warp
// shuffle reduction. Chains are independent, so no barrier crosses warps
// after the rows are loaded.

#include "cls_common.cuh"

template <int NI, int NH, int NO>
__global__ void __launch_bounds__(CLS_THREADS, 1) mala_cls_block_kernel(const ClsPrecondParams p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  using N = ClsNet<NI, NH, NO>;
  constexpr int W = N::W, PER = N::PER;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x * CLS_WARPS + warp;
  const int n_rows = p.n_tr + p.n_te;
  float* s_rows = smem;
  const ClsSlots s = cls_slots<NI, NH, NO>(smem, cls_rows_floats(n_rows, NI), warp);
  cls_load_rows(p, s_rows, NI);
  __syncthreads();
  if (c >= p.chains) return;  // no barrier follows

  cls_load_chain<W, PER>(p, s, c, lane);
  ClsCarry r = cls_load_carry(p, c);
  const float sq = p.sigma_sq;
  const float* te_rows = s_rows + p.n_tr * (NI + 1);

  for (int k = 0; k < p.k_max; ++k) {
    const int i = p.start + k;
    const size_t kc = (size_t)k * p.chains + c;
    if (k >= p.length) {  // dead step: carries into the trace rows
      cls_write_trace<W, PER>(p, s, kc, lane, r.ll, r, r.na);
      r.lsw = cls_clip(r.lsw, p.log_lo_w, p.log_hi);
      continue;
    }
    const bool warm = i < p.warm_end;
    const float sig = expf(r.lsw);
    float m[PER], w[PER], gl[PER], g_cur[PER], sig2m[PER], mean_fwd[PER], w_prop[PER];
    cls_precond_diag<PER>(s.p2, i, p, lane, m);
    cls_get<PER>(s.w, lane, w);
    cls_get<PER>(s.gl, lane, gl);
    float nw[PER];
    cls_ld<W, PER>(p.noise_w + kc * W, lane, nw);
    // --- MALA under m (classification: g = g_like / T - w / sigma^2) -------
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      g_cur[j] = gl[j] / r.at - w[j] / sq;
      sig2m[j] = sig * sig * m[j];
      mean_fwd[j] = w[j] + 0.5f * sig2m[j] * g_cur[j];
      w_prop[j] = mean_fwd[j] + sig * sqrtf(m[j]) * nw[j];
    }
    if (warm) {
      const float g_rms = sqrtf(cls_dot<PER>(g_cur, g_cur) / p.w_size_f);
      const float d = fmaxf(g_rms, 1e-12f);
#pragma unroll
      for (int j = 0; j < PER; ++j) w_prop[j] = w[j] + p.warmstart_step * g_cur[j] / d;
    }
    const float ssq = cls_dot<PER>(w_prop, w_prop);
    const float pr_p = p.prior_const - ssq / (2.f * sq);
    cls_publish<PER>(s.wb, lane, w_prop);
    float g_rows[PER];
    const ClsSums tr = cls_fwd_grad<NI, NH, NO>(s_rows, p.n_tr, s.wb, s.rec, lane, g_rows);
    const ClsSums te = cls_fwd_metrics<NI, NH, NO>(te_rows, p.n_te, s.wb, lane);
    const float ll_p = tr.ll;
    float qf = 0.f, qr = 0.f;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const float g_prop = g_rows[j] / r.at - w_prop[j] / sq;
      const float mean_rev = w_prop[j] + 0.5f * sig2m[j] * g_prop;
      const float d_fwd = w_prop[j] - mean_fwd[j];
      const float d_rev = w[j] - mean_rev;
      qf += d_fwd * d_fwd / m[j];
      qr += d_rev * d_rev / m[j];
    }
    const float diff = (cls_warp_sum(qf) - cls_warp_sum(qr)) / (2.f * sig * sig);
    const float log_mh = (ll_p - r.ll) / r.at + (pr_p - r.pr) + diff;
    const float a = expf(fminf(log_mh, 0.f));
    const bool accept = p.u[kc] < a || warm;
    const int na_before = r.na;
    if (accept) {
      cls_take_metrics(r, tr, te, p);
      cls_put<PER>(s.w, lane, w_prop);
      cls_put<PER>(s.wl, lane, w_prop);
      cls_put<PER>(s.gl, lane, g_rows);
      r.ll = ll_p;
      r.pr = pr_p;
      r.na += 1;
    }
    cls_write_trace<W, PER>(p, s, kc, lane, ll_p, r, na_before);
    // --- Welford and the Robbins-Monro w scale ------------------------------
    if (i >= p.warm_end && i < p.burn_end) {
      cls_welford<PER>(s, lane, i, p);
      r.lsw = r.lsw + p.adapt_rate * (a - p.target);
    }
    r.lsw = cls_clip(r.lsw, p.log_lo_w, p.log_hi);
  }

  cls_store_chain<W, PER>(p, s, c, lane);
  if (lane == 0) cls_store_carry(p, r, c);
}

extern "C" {

// Launches ceil(C / CLS_WARPS) blocks on `stream`; returns the cudaError_t
// of the attribute call or of the launch (0 = success). Does not
// synchronise.
int ptnn_mala_cls_block(const ClsPrecondParams* p, int smem_bytes, void* stream) {
  auto kern = mala_cls_block_kernel<4, 12, 3>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       smem_bytes);
  if (e != cudaSuccess) return (int)e;
  const int grid = (p->chains + CLS_WARPS - 1) / CLS_WARPS;
  kern<<<grid, CLS_THREADS, smem_bytes, (cudaStream_t)stream>>>(*p);
  return (int)cudaGetLastError();
}

}  // extern "C"
