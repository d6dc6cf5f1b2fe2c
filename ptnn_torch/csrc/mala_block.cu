// A fused block of K preconditioned-MALA steps for every chain of the
// parallel-tempering ladder, regression task, for Hopper (sm_90a).
//
// Replaces the TPU kernel ptnn/ops/pallas_step.py `_mala_block_kernel`
// (wrapper `fused_mala_block_impl`). The plain PyTorch version of the same
// function is `mala_block_reference` in ptnn_torch/ops/precond_step.py,
// whose docstring states the semantics.
//
// What bounds it. A chain-step is one forward and backward pass of the
// (4, 10, 1) FNN over the 298 train rows (about 300 flops a row), a forward
// over the 198 test rows, nine warp reductions and two MH decisions. The
// steps of a chain are serial, so a block costs K times the latency of one
// step; device memory sees only the noise read and the trace rows written
// once a step. The work is the per-row arithmetic (sigmoids, the 61
// gradient accumulators), spread over the 32 lanes of one warp.
//
// Design. One warp per chain, 16 chains per 512-thread block
// (precond_common.cuh): the rows live in shared memory once per block, the
// chain's w, w_last, g_like and Welford buffers in its warp's 64-float
// slots with lane l owning entries 2l and 2l+1, so the proposal, the
// q-ratio and the Welford update are lane-local and every sum is a warp
// shuffle reduction; the gradient comes out of a reduce-scatter already in
// the lane layout. Chains are independent, so no barrier crosses warps
// after the rows are loaded. Every lane of a warp computes the chain's
// scalars from the same reduced values, so they agree without a broadcast.
// Registers: the 61 gradient partial sums dominate; `__launch_bounds__(512,
// 1)` caps a thread at 128.

#include "precond_common.cuh"

template <int NI, int NH>
__global__ void __launch_bounds__(THREADS, 1) mala_block_kernel(const PrecondParams p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  using N = Net<NI, NH>;
  constexpr int W = N::W;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x * WARPS + warp;
  const int n_rows = p.n_tr + p.n_te;
  float* s_rows = smem;
  const ChainSlots s = chain_slots(smem, rows_floats(n_rows, NI), warp);
  load_rows(p, s_rows, NI);
  __syncthreads();
  if (c >= p.chains) return;  // no barrier follows

  load_chain(p, s, c, lane, W);
  Carry r = load_carry(p, c);
  const float sq = p.sigma_sq;
  const float* te_rows = s_rows + p.n_tr * (NI + 1);

  for (int k = 0; k < p.k_max; ++k) {
    const int i = p.start + k;
    const size_t kc = (size_t)k * p.chains + c;
    if (k >= p.length) {  // dead step: carries into the trace rows
      write_trace(p, s, kc, lane, W, r.ll / r.at, r, r.na);
      r.lse = clipf(r.lse, p.log_lo_eta, p.log_hi);
      r.lsw = clipf(r.lsw, p.log_lo_w, p.log_hi);
      continue;
    }
    const bool warm = i < p.warm_end;
    const float sig = expf(r.lsw);
    const float2 m = precond_diag(s.p2[lane], i, p);
    const float tau = expf(r.eta);
    const float tat = tau * r.at;
    const float2 w = s.w[lane];
    const float2 gl = s.gl[lane];
    // --- the w block: MALA under m, or the warm start ----------------------
    const float2 g_cur = f2(gl.x / tat - w.x / sq, gl.y / tat - w.y / sq);
    const float2 sig2m = f2(sig * sig * m.x, sig * sig * m.y);
    const float2 mean_fwd =
        f2(w.x + 0.5f * sig2m.x * g_cur.x, w.y + 0.5f * sig2m.y * g_cur.y);
    const float2 nw = ld2(p.noise_w + kc * W, lane, W);
    float2 w_prop = f2(mean_fwd.x + sig * sqrtf(m.x) * nw.x,
                       mean_fwd.y + sig * sqrtf(m.y) * nw.y);
    if (warm) {
      const float g_rms = sqrtf(dot2(g_cur, g_cur) / p.w_size_f);
      const float d = fmaxf(g_rms, 1e-12f);
      w_prop = f2(w.x + p.warmstart_step * g_cur.x / d,
                  w.y + p.warmstart_step * g_cur.y / d);
    }
    const float ssq = dot2(w_prop, w_prop);
    const float pr_p = p.prior_const - ssq / (2.f * sq) - p.one_plus_nu1 * r.eta - p.nu2 / tau;
    publish(s.wb, lane, w_prop);
    float sse_tr;
    const float2 g_rows = fwd_grad<NI, NH>(s_rows, p.n_tr, s.wb, lane, sse_tr);
    const float sse_te = fwd_sse<NI, NH>(te_rows, p.n_te, s.wb, lane);
    const float ll_p = p.ll_const * (p.log_2pi + r.eta) - 0.5f * sse_tr / tau;
    const float2 g_prop = f2(g_rows.x / tat - w_prop.x / sq, g_rows.y / tat - w_prop.y / sq);
    const float2 mean_rev = f2(w_prop.x + 0.5f * sig2m.x * g_prop.x,
                               w_prop.y + 0.5f * sig2m.y * g_prop.y);
    const float2 d_fwd = f2(w_prop.x - mean_fwd.x, w_prop.y - mean_fwd.y);
    const float2 d_rev = f2(w.x - mean_rev.x, w.y - mean_rev.y);
    const float q_fwd = warp_sum(d_fwd.x * d_fwd.x / m.x + d_fwd.y * d_fwd.y / m.y);
    const float q_rev = warp_sum(d_rev.x * d_rev.x / m.x + d_rev.y * d_rev.y / m.y);
    const float diff = (q_fwd - q_rev) / (2.f * sig * sig);
    const float log_mh = (ll_p - r.ll) / r.at + (pr_p - r.pr) + diff;
    const float a = expf(fminf(log_mh, 0.f));
    const bool accept = p.u[kc] < a || warm;
    const int na_before = r.na;
    if (accept) {
      r.rtr = sqrtf(sse_tr / p.n_tr_f);
      r.rte = sqrtf(sse_te / p.n_te_f);
      s.w[lane] = w_prop;
      s.wl[lane] = w_prop;
      s.gl[lane] = g_rows;
      r.ll = ll_p;
      r.pr = pr_p;
      r.na += 1;
    }
    write_trace(p, s, kc, lane, W, ll_p / r.at, r, na_before);
    // --- the eta block ------------------------------------------------------
    eta_block(r.eta, r.ll, r.pr, r.lse, p.noise_eta[kc], p.u_eta[kc], r.at, i, p);
    // --- Welford and the Robbins-Monro w scale ------------------------------
    if (i >= p.warm_end && i < p.burn_end) {
      float2 pm = s.pm[lane], p2 = s.p2[lane];
      welford(s.w[lane], pm, p2, i, p);
      s.pm[lane] = pm;
      s.p2[lane] = p2;
      r.lsw = r.lsw + p.adapt_rate * (a - p.target);
    }
    r.lsw = clipf(r.lsw, p.log_lo_w, p.log_hi);
  }

  store_chain(p, s, c, lane, W);
  if (lane == 0) store_carry(p, r, c);
}

extern "C" {

// Launches ceil(C / WARPS) blocks on `stream`; returns the cudaError_t of
// the attribute call or of the launch (0 = success). Does not synchronise.
int ptnn_mala_block(const PrecondParams* p, int smem_bytes, void* stream) {
  auto kern = mala_block_kernel<4, 10>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       smem_bytes);
  if (e != cudaSuccess) return (int)e;
  const int grid = (p->chains + WARPS - 1) / WARPS;
  kern<<<grid, THREADS, smem_bytes, (cudaStream_t)stream>>>(*p);
  return (int)cudaGetLastError();
}

}  // extern "C"
