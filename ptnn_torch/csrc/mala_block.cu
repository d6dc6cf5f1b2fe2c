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
// over the 198 test rows, a handful of warp reductions and two MH
// decisions. The steps of a chain are serial, so a block costs K times the
// latency of one step, and the Sunspot path has only 64 chains, too few to
// fill the card with one warp each. Device memory sees only the noise read
// and the trace rows written once a step; a step's noise is loaded during
// the step before it.
//
// Design: the iris MALA kernel's layout (cls_chain.cuh), for regression
// (reg_chain.cuh).
//   * A block is MALA_THREADS = 256 threads, 8 warps: 8 / WPC chains of WPC
//     warps each (8, 4, 2 or 1; ops/precond_step.py `mala_launch_plan`
//     takes the largest WPC whose blocks fit one wave of the card's SMs:
//     on the H100 one chain a block up to 132 chains, the path's 64
//     included). One block an SM, so a thread may use 255 registers: the
//     61 weights of an evaluation, the 64 gradient partial sums and the
//     chain's state stay in registers, unspilled.
//   * Each step evaluates the proposal once (`chain_eval`): each warp of the
//     chain takes a contiguous share of the 298 train and 198 test rows (at
//     WPC 8, 38 and 25), runs them with the weights in registers, and one
//     reduce-scatter puts its partial gradient in the lane layout with the
//     two SSEs in the free slots; the chain's warps sum their partials in
//     warp order after a named barrier of their own.
//   * Every warp keeps a bit-identical copy of the chain's elementwise state
//     (w, w_last, g_like, the Welford buffers; lane l owns entries 2l and
//     2l+1) and of its carries; the chain's first warp writes the trace rows
//     and the outputs.
//
// The generic route (`mala_gen_kernel`) runs any other (I, H, 1) given at
// run time (gen_chain.cuh): the same step, with the chain's vectors in
// shared or device memory and each evaluation's rows taken through the
// record tile, so nothing scales a lane's registers with w_size (Sunspot at
// any hidden width the fused gate admits, 385 weights at 64 units).
//
// No fast-math: expf, sqrtf and division are the IEEE-rounded versions. The
// sums over rows run in another order than in the plain version (per lane,
// per warp, then across warps), so ll and the gradient round differently.

#include "gen_chain.cuh"
#include "reg_chain.cuh"

#define MALA_THREADS 256  // threads a block: 8 warps, WPC of them a chain

// A step's noise and uniforms of one chain, in the lane layout.
struct StepNoise {
  float2 w;
  float u, eta, u_eta;
};

__device__ __forceinline__ StepNoise load_noise(const PrecondParams& p, size_t kc, int lane,
                                                int w) {
  return StepNoise{ld2(p.noise_w + kc * w, lane, w), p.u[kc], p.noise_eta[kc], p.u_eta[kc]};
}

template <int NI, int NH, int WPC>
__global__ void __launch_bounds__(MALA_THREADS, 1) mala_block_kernel(const PrecondParams p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  using N = Net<NI, NH>;
  constexpr int W = N::W;
  constexpr int WARPS = MALA_THREADS / 32;
  constexpr int CPB = WARPS / WPC;  // chains a block
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cl = warp / WPC, sub = warp % WPC;
  const int c = blockIdx.x * CPB + cl;
  const bool lead = sub == 0;  // the warp that writes the chain's outputs
  const int n_rows = p.n_tr + p.n_te;
  float* s_rows = smem;
  const int row_floats = rows_floats(n_rows, NI);
  float* wb = smem + row_floats + warp * VEC;
  float* part = smem + row_floats + WARPS * VEC + cl * 2 * WPC * VEC;
  load_rows(p, s_rows, NI);
  __syncthreads();
  if (c >= p.chains) return;  // a chain's warps go together; no block barrier follows

  const float sq = p.sigma_sq;
  const float* te_rows = s_rows + p.n_tr * (NI + 1);
  // this warp's share of the rows
  const int tr_share = (p.n_tr + WPC - 1) / WPC, te_share = (p.n_te + WPC - 1) / WPC;
  const int r0 = min(p.n_tr, sub * tr_share), r1 = min(p.n_tr, r0 + tr_share);
  const int t0 = min(p.n_te, sub * te_share), t1 = min(p.n_te, t0 + te_share);
  const int bar_id = 1 + cl;  // barrier 0 is __syncthreads'
  const size_t cw = (size_t)c * W;
  float2 w = ld2(p.w + cw, lane, W), wl = ld2(p.w_last + cw, lane, W),
         gl = ld2(p.g_like + cw, lane, W), pm = ld2(p.pc_mean + cw, lane, W),
         p2 = ld2(p.pc_m2 + cw, lane, W);
  Carry r = load_carry(p, c);
  int epar = 0;  // parity of the partial slots
  // the noise of the next live step: loaded a step ahead, so that no step
  // starts with a dependent device-memory load
  StepNoise next{};
  if (p.length > 0) next = load_noise(p, c, lane, W);

  for (int k = 0; k < p.k_max; ++k) {
    const int i = p.start + k;
    const size_t kc = (size_t)k * p.chains + c;
    if (k >= p.length) {  // dead step: carries into the trace rows
      if (lead) write_trace(p, wl, kc, lane, W, r.ll / r.at, r, r.na);
      r.lse = clipf(r.lse, p.log_lo_eta, p.log_hi);
      r.lsw = clipf(r.lsw, p.log_lo_w, p.log_hi);
      continue;
    }
    const StepNoise nz = next;
    if (k + 1 < p.length) next = load_noise(p, kc + p.chains, lane, W);
    const bool warm = i < p.warm_end;
    const float sig = expf(r.lsw);
    const float2 m = precond_diag(p2, i, p);
    const float tau = expf(r.eta);
    const float tat = tau * r.at;
    // --- the w block: MALA under m, or the warm start ----------------------
    const float2 g_cur = f2(gl.x / tat - w.x / sq, gl.y / tat - w.y / sq);
    const float2 sig2m = f2(sig * sig * m.x, sig * sig * m.y);
    const float2 mean_fwd =
        f2(w.x + 0.5f * sig2m.x * g_cur.x, w.y + 0.5f * sig2m.y * g_cur.y);
    float2 w_prop = f2(mean_fwd.x + sig * sqrtf(m.x) * nz.w.x,
                       mean_fwd.y + sig * sqrtf(m.y) * nz.w.y);
    if (warm) {
      const float g_rms = sqrtf(dot2(g_cur, g_cur) / p.w_size_f);
      const float d = fmaxf(g_rms, 1e-12f);
      w_prop = f2(w.x + p.warmstart_step * g_cur.x / d,
                  w.y + p.warmstart_step * g_cur.y / d);
    }
    const float ssq = dot2(w_prop, w_prop);
    const float pr_p = p.prior_const - ssq / (2.f * sq) - p.one_plus_nu1 * r.eta - p.nu2 / tau;
    float sse_tr, sse_te;
    const float2 g_rows = chain_eval<NI, NH, WPC>(s_rows, r0, r1, te_rows, t0, t1, w_prop, wb,
                                                  part, epar, sub, bar_id, lane, sse_tr,
                                                  sse_te);
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
    const bool accept = nz.u < a || warm;
    const int na_before = r.na;
    if (accept) {
      r.rtr = sqrtf(sse_tr / p.n_tr_f);
      r.rte = sqrtf(sse_te / p.n_te_f);
      w = w_prop;
      wl = w_prop;
      gl = g_rows;
      r.ll = ll_p;
      r.pr = pr_p;
      r.na += 1;
    }
    if (lead) write_trace(p, wl, kc, lane, W, ll_p / r.at, r, na_before);
    // --- the eta block ------------------------------------------------------
    eta_block(r.eta, r.ll, r.pr, r.lse, nz.eta, nz.u_eta, r.at, i, p);
    // --- Welford and the Robbins-Monro w scale ------------------------------
    if (i >= p.warm_end && i < p.burn_end) {
      welford(w, pm, p2, i, p);
      r.lsw = r.lsw + p.adapt_rate * (a - p.target);
    }
    r.lsw = clipf(r.lsw, p.log_lo_w, p.log_hi);
  }

  if (lead) {
    st2(p.o_w + cw, lane, W, w);
    st2(p.o_w_last + cw, lane, W, wl);
    st2(p.o_g_like + cw, lane, W, gl);
    st2(p.o_pc_mean + cw, lane, W, pm);
    st2(p.o_pc_m2 + cw, lane, W, p2);
    if (lane == 0) store_carry(p, r, c);
  }
}

// The generic route: the step of mala_block_kernel at a runtime (I, H, 1)
// (gen_chain.cuh's layout: blockDim.x = 32 g.warps).
__global__ void __launch_bounds__(GEN_THREADS, 1)
    mala_gen_kernel(const PrecondParams p, const GenShape g, float* vdev) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cl = warp / g.wpc, sub = warp % g.wpc;
  const int c = blockIdx.x * (g.warps / g.wpc) + cl;
  const bool lead = sub == 0;  // the warp that writes the chain's outputs
  const int NI = g.ni, W = g.w, V = g.vec;
  const int n_rows = p.n_tr + p.n_te;
  float* s_rows = smem;
  const int row_floats = gen_rows_floats(n_rows, NI);
  const GenWarp L = gen_warp(smem, row_floats, g, warp, vdev);
  load_rows(p, s_rows, NI);
  __syncthreads();
  if (c >= p.chains) return;  // a chain's warps go together; no block barrier follows

  const float sq = p.sigma_sq;
  const float* te_rows = s_rows + p.n_tr * (NI + 1);
  int r0, r1, t0, t1;
  gen_share(p.n_tr, g.wpc, sub, r0, r1);
  gen_share(p.n_te, g.wpc, sub, t0, t1);
  const int bar_id = 1 + cl;  // barrier 0 is __syncthreads'
  float* w = L.v;
  float* wl = w + V;
  float* gl = wl + V;
  float* pm = gl + V;
  float* p2 = pm + V;
  float* m = p2 + V;
  float* gr = m + V;  // the last evaluation's gradient of -SSE/2
  float* wp = L.wb;   // the proposal, in the evaluation slot
  const size_t cw = (size_t)c * W;
  gen_load(w, p.w + cw, lane, g);
  gen_load(wl, p.w_last + cw, lane, g);
  gen_load(gl, p.g_like + cw, lane, g);
  gen_load(pm, p.pc_mean + cw, lane, g);
  gen_load(p2, p.pc_m2 + cw, lane, g);
  Carry r = load_carry(p, c);
  int epar = 0;  // parity of the partial slots

  for (int k = 0; k < p.k_max; ++k) {
    const int i = p.start + k;
    const size_t kc = (size_t)k * p.chains + c;
    if (k >= p.length) {  // dead step: carries into the trace rows
      if (lead) gen_reg_trace(p, W, wl, kc, lane, r.ll / r.at, r, r.na);
      r.lse = clipf(r.lse, p.log_lo_eta, p.log_hi);
      r.lsw = clipf(r.lsw, p.log_lo_w, p.log_hi);
      continue;
    }
    const bool warm = i < p.warm_end;
    const float sig = expf(r.lsw);
    gen_precond(p, p2, m, i, lane, V);
    const float tau = expf(r.eta);
    const float tat = tau * r.at;
    const float* nw = p.noise_w + kc * W;
    // --- the w block: MALA under m, or the warm start ----------------------
    for (int e = lane; e < V; e += 32) {
      const float g_cur = gl[e] / tat - w[e] / sq;
      const float sig2m = sig * sig * m[e];
      const float mean_fwd = w[e] + 0.5f * sig2m * g_cur;
      wp[e] = mean_fwd + sig * sqrtf(m[e]) * (e < W ? nw[e] : 0.f);
    }
    if (warm) {
      float t = 0.f;
      for (int e = lane; e < V; e += 32) {
        const float g_cur = gl[e] / tat - w[e] / sq;
        t += g_cur * g_cur;
      }
      const float g_rms = sqrtf(gen_warp_sum(t) / p.w_size_f);
      const float d = fmaxf(g_rms, 1e-12f);
      for (int e = lane; e < V; e += 32)
        wp[e] = w[e] + p.warmstart_step * (gl[e] / tat - w[e] / sq) / d;
    }
    const float ssq = gen_dot(wp, wp, lane, V);
    const float pr_p = p.prior_const - ssq / (2.f * sq) - p.one_plus_nu1 * r.eta - p.nu2 / tau;
    GenSums s;
    gen_eval<true>(g, s_rows, r0, r1, te_rows, t0, t1, wp, L.rec, L.part, epar, sub, bar_id,
                   lane, gr, s);
    const float sse_tr = s.tr, sse_te = s.te_err2;
    const float ll_p = p.ll_const * (p.log_2pi + r.eta) - 0.5f * sse_tr / tau;
    float qf = 0.f, qr = 0.f;
    for (int e = lane; e < V; e += 32) {
      const float g_cur = gl[e] / tat - w[e] / sq;
      const float sig2m = sig * sig * m[e];
      const float mean_fwd = w[e] + 0.5f * sig2m * g_cur;
      const float g_prop = gr[e] / tat - wp[e] / sq;
      const float mean_rev = wp[e] + 0.5f * sig2m * g_prop;
      const float d_fwd = wp[e] - mean_fwd;
      const float d_rev = w[e] - mean_rev;
      qf += d_fwd * d_fwd / m[e];
      qr += d_rev * d_rev / m[e];
    }
    const float diff = (gen_warp_sum(qf) - gen_warp_sum(qr)) / (2.f * sig * sig);
    const float log_mh = (ll_p - r.ll) / r.at + (pr_p - r.pr) + diff;
    const float a = expf(fminf(log_mh, 0.f));
    const bool accept = p.u[kc] < a || warm;
    const int na_before = r.na;
    if (accept) {
      r.rtr = sqrtf(sse_tr / p.n_tr_f);
      r.rte = sqrtf(sse_te / p.n_te_f);
      for (int e = lane; e < V; e += 32) {
        w[e] = wp[e];
        wl[e] = wp[e];
        gl[e] = gr[e];
      }
      r.ll = ll_p;
      r.pr = pr_p;
      r.na += 1;
    }
    if (lead) gen_reg_trace(p, W, wl, kc, lane, ll_p / r.at, r, na_before);
    // --- the eta block ------------------------------------------------------
    eta_block(r.eta, r.ll, r.pr, r.lse, p.noise_eta[kc], p.u_eta[kc], r.at, i, p);
    // --- Welford and the Robbins-Monro w scale ------------------------------
    if (i >= p.warm_end && i < p.burn_end) {
      gen_welford(p, w, pm, p2, i, lane, V);
      r.lsw = r.lsw + p.adapt_rate * (a - p.target);
    }
    r.lsw = clipf(r.lsw, p.log_lo_w, p.log_hi);
  }

  if (lead) {
    gen_store(p.o_w + cw, w, lane, g);
    gen_store(p.o_w_last + cw, wl, lane, g);
    gen_store(p.o_g_like + cw, gl, lane, g);
    gen_store(p.o_pc_mean + cw, pm, lane, g);
    gen_store(p.o_pc_m2 + cw, p2, lane, g);
    if (lane == 0) store_carry(p, r, c);
  }
}

template <int WPC>
static int launch(const PrecondParams* p, int smem_bytes, cudaStream_t stream) {
  constexpr int CPB = MALA_THREADS / 32 / WPC;
  auto kern = mala_block_kernel<4, 10, WPC>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       smem_bytes);
  if (e != cudaSuccess) return (int)e;
  const int grid = (p->chains + CPB - 1) / CPB;
  kern<<<grid, MALA_THREADS, smem_bytes, stream>>>(*p);
  return (int)cudaGetLastError();
}

extern "C" {

int ptnn_mala_threads() { return MALA_THREADS; }

// Launches ceil(C / (8 / wpc)) blocks of `wpc` warps a chain on `stream`;
// returns the cudaError_t of the attribute call or of the launch (0 =
// success). Does not synchronise.
int ptnn_mala_block(const PrecondParams* p, int smem_bytes, int wpc, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (wpc == 8) return launch<8>(p, smem_bytes, st);
  if (wpc == 4) return launch<4>(p, smem_bytes, st);
  if (wpc == 2) return launch<2>(p, smem_bytes, st);
  if (wpc == 1) return launch<1>(p, smem_bytes, st);
  return (int)cudaErrorInvalidValue;
}

// Launches the generic route at the network and layout `g`: ceil(C /
// (g.warps / g.wpc)) blocks of 32 g.warps threads on `stream`; `vdev` holds
// the warps' vectors where g.vec_dev. Returns the cudaError_t of the
// attribute call or of the launch (0 = success). Does not synchronise.
int ptnn_mala_gen(const PrecondParams* p, const GenShape* g, float* vdev, int smem_bytes,
                  void* stream) {
  if (!gen_shape_ok(g, vdev) || g->no != 1) return (int)cudaErrorInvalidValue;
  cudaError_t e = gen_set_attributes(mala_gen_kernel, smem_bytes, false);
  if (e != cudaSuccess) return (int)e;
  const int cpb = g->warps / g->wpc;
  const int grid = (p->chains + cpb - 1) / cpb;
  mala_gen_kernel<<<grid, 32 * g->warps, smem_bytes, (cudaStream_t)stream>>>(*p, *g, vdev);
  return (int)cudaGetLastError();
}

}  // extern "C"
