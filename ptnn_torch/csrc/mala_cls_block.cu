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
// latency of one step, and the iris path has only 64 chains, too few to
// fill the card with one warp each. Device memory sees only the noise read
// and the trace rows written once a step.
//
// Design: the iris HMC kernel's layout (cls_chain.cuh), without its ChEES
// exchange: MALA couples no chains, so there is no cluster, no cooperative
// launch and no exchange slot.
//   * A block is MALA_CLS_THREADS = 256 threads, 8 warps: 8 / WPC chains of
//     WPC warps each (4, 2 or 1; ops/precond_cls_step.py `mala_launch_plan`
//     takes the largest WPC whose blocks fit one wave of the card's SMs).
//     One block an SM, so a thread may use 255 registers: the 99 weights of
//     an evaluation and the chain's state stay in registers, unspilled.
//   * Each step evaluates the proposal once (`chain_eval`): each warp of the
//     chain takes a contiguous share of the 105 train and 45 test rows (at
//     WPC 4, one tile of <= 27 and <= 12 rows), and the chain's warps sum
//     their partial gradients and sums in warp order after a named barrier
//     of their own.
//   * Every warp keeps a bit-identical copy of the chain's elementwise state
//     (w, w_last, g_like, the Welford buffers) and of its carries; the
//     chain's first warp writes the trace rows and the outputs.
//
// The generic route (`mala_cls_gen_kernel`) runs any other (I, H, O) given
// at run time (gen_chain.cuh): the same step, with the chain's vectors in
// shared or device memory and each evaluation's rows taken through the
// record tile, so nothing scales a lane's registers with w_size (Cancer's
// 146 weights, any user network the fused gate admits).
//
// No fast-math: expf, logf, sqrtf and division are the IEEE-rounded
// versions. The sums over rows run in another order than in the plain
// version (per warp, then across warps), so ll and the gradient round
// differently.

#include "cls_chain.cuh"
#include "gen_chain.cuh"

#define MALA_CLS_THREADS 256  // threads a block: 8 warps, WPC of them a chain

template <int NI, int NH, int NO, int WPC>
__global__ void __launch_bounds__(MALA_CLS_THREADS, 1)
    mala_cls_block_kernel(const ClsPrecondParams p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  using N = ClsNet<NI, NH, NO>;
  using L = ChainCls<NI, NH, NO>;
  constexpr int W = N::W, PER = N::PER, VEC = N::VEC;
  constexpr int WARPS = MALA_CLS_THREADS / 32;
  constexpr int CPB = WARPS / WPC;  // chains a block
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cl = warp / WPC, sub = warp % WPC;
  const int c = blockIdx.x * CPB + cl;
  const bool lead = sub == 0;  // the warp that writes the chain's outputs
  const int n_rows = p.n_tr + p.n_te;
  float* s_rows = smem;
  const int row_floats = cls_rows_floats(n_rows, NI);
  float* wb = smem + row_floats + warp * L::WARP;
  float* rec = wb + VEC;
  float* part = smem + row_floats + WARPS * L::WARP + cl * 2 * WPC * L::PART;
  for (int t = threadIdx.x; t < n_rows * (NI + 1); t += MALA_CLS_THREADS) s_rows[t] = p.rows[t];
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
  float w[PER], wl[PER], gl[PER], pm[PER], p2[PER];
  cls_ld<W, PER>(p.w + cw, lane, w);
  cls_ld<W, PER>(p.w_last + cw, lane, wl);
  cls_ld<W, PER>(p.g_like + cw, lane, gl);
  cls_ld<W, PER>(p.pc_mean + cw, lane, pm);
  cls_ld<W, PER>(p.pc_m2 + cw, lane, p2);
  ClsCarry r = cls_load_carry(p, c);
  int epar = 0;  // parity of the partial slots

  for (int k = 0; k < p.k_max; ++k) {
    const int i = p.start + k;
    const size_t kc = (size_t)k * p.chains + c;
    if (k >= p.length) {  // dead step: carries into the trace rows
      if (lead) write_trace<W, PER>(p, kc, lane, r.ll, r, r.na, wl);
      r.lsw = cls_clip(r.lsw, p.log_lo_w, p.log_hi);
      continue;
    }
    const bool warm = i < p.warm_end;
    const float sig = expf(r.lsw);
    float m[PER], g_cur[PER], sig2m[PER], mean_fwd[PER], w_prop[PER], nw[PER];
    precond_diag_reg<PER>(p2, i, p, m);
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
    float g_rows[PER];
    ClsSums tr, te;
    chain_eval<NI, NH, NO, WPC>(s_rows, r0, r1, te_rows, t0, t1, w_prop, wb, rec, part, epar,
                                sub, bar_id, lane, g_rows, tr, te);
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
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        w[j] = w_prop[j];
        wl[j] = w_prop[j];
        gl[j] = g_rows[j];
      }
      r.ll = ll_p;
      r.pr = pr_p;
      r.na += 1;
    }
    if (lead) write_trace<W, PER>(p, kc, lane, ll_p, r, na_before, wl);
    // --- Welford and the Robbins-Monro w scale ------------------------------
    if (i >= p.warm_end && i < p.burn_end) {
      const float cnt_new = (float)max(min(i + 1, p.burn_end) - p.warm_end, 1);
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const float d = w[j] - pm[j];
        pm[j] = pm[j] + d / cnt_new;
        p2[j] = p2[j] + d * (w[j] - pm[j]);
      }
      r.lsw = r.lsw + p.adapt_rate * (a - p.target);
    }
    r.lsw = cls_clip(r.lsw, p.log_lo_w, p.log_hi);
  }

  if (lead) {
    st_vec<W, PER>(p.o_w + cw, lane, w);
    st_vec<W, PER>(p.o_w_last + cw, lane, wl);
    st_vec<W, PER>(p.o_g_like + cw, lane, gl);
    st_vec<W, PER>(p.o_pc_mean + cw, lane, pm);
    st_vec<W, PER>(p.o_pc_m2 + cw, lane, p2);
    if (lane == 0) cls_store_carry(p, r, c);
  }
}

// The generic route: the step of mala_cls_block_kernel at a runtime (I, H,
// O) (gen_chain.cuh's layout: blockDim.x = 32 g.warps).
__global__ void __launch_bounds__(GEN_THREADS, 1)
    mala_cls_gen_kernel(const ClsPrecondParams p, const GenShape g, float* vdev) {
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
  for (int t = threadIdx.x; t < n_rows * (NI + 1); t += blockDim.x) s_rows[t] = p.rows[t];
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
  float* gr = m + V;  // the last evaluation's gradient
  float* wp = L.wb;   // the proposal, in the evaluation slot
  const size_t cw = (size_t)c * W;
  gen_load(w, p.w + cw, lane, g);
  gen_load(wl, p.w_last + cw, lane, g);
  gen_load(gl, p.g_like + cw, lane, g);
  gen_load(pm, p.pc_mean + cw, lane, g);
  gen_load(p2, p.pc_m2 + cw, lane, g);
  ClsCarry r = cls_load_carry(p, c);
  int epar = 0;  // parity of the partial slots

  for (int k = 0; k < p.k_max; ++k) {
    const int i = p.start + k;
    const size_t kc = (size_t)k * p.chains + c;
    if (k >= p.length) {  // dead step: carries into the trace rows
      if (lead) gen_cls_trace(p, W, kc, lane, r.ll, r, r.na, wl);
      r.lsw = cls_clip(r.lsw, p.log_lo_w, p.log_hi);
      continue;
    }
    const bool warm = i < p.warm_end;
    const float sig = expf(r.lsw);
    gen_precond(p, p2, m, i, lane, V);
    const float* nw = p.noise_w + kc * W;
    // --- MALA under m (classification: g = g_like / T - w / sigma^2) -------
    for (int e = lane; e < V; e += 32) {
      const float g_cur = gl[e] / r.at - w[e] / sq;
      const float sig2m = sig * sig * m[e];
      const float mean_fwd = w[e] + 0.5f * sig2m * g_cur;
      wp[e] = mean_fwd + sig * sqrtf(m[e]) * (e < W ? nw[e] : 0.f);
    }
    if (warm) {
      float t = 0.f;
      for (int e = lane; e < V; e += 32) {
        const float g_cur = gl[e] / r.at - w[e] / sq;
        t += g_cur * g_cur;
      }
      const float g_rms = sqrtf(gen_warp_sum(t) / p.w_size_f);
      const float d = fmaxf(g_rms, 1e-12f);
      for (int e = lane; e < V; e += 32)
        wp[e] = w[e] + p.warmstart_step * (gl[e] / r.at - w[e] / sq) / d;
    }
    const float ssq = gen_dot(wp, wp, lane, V);
    const float pr_p = p.prior_const - ssq / (2.f * sq);
    GenSums s;
    gen_eval<false>(g, s_rows, r0, r1, te_rows, t0, t1, wp, L.rec, L.part, epar, sub, bar_id,
                    lane, gr, s);
    const float ll_p = s.tr;
    float qf = 0.f, qr = 0.f;
    for (int e = lane; e < V; e += 32) {
      const float g_cur = gl[e] / r.at - w[e] / sq;
      const float sig2m = sig * sig * m[e];
      const float mean_fwd = w[e] + 0.5f * sig2m * g_cur;
      const float g_prop = gr[e] / r.at - wp[e] / sq;
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
      cls_take_metrics(r, ClsSums{s.tr, s.err2, s.cnt}, ClsSums{0.f, s.te_err2, s.te_cnt}, p);
      for (int e = lane; e < V; e += 32) {
        w[e] = wp[e];
        wl[e] = wp[e];
        gl[e] = gr[e];
      }
      r.ll = ll_p;
      r.pr = pr_p;
      r.na += 1;
    }
    if (lead) gen_cls_trace(p, W, kc, lane, ll_p, r, na_before, wl);
    // --- Welford and the Robbins-Monro w scale ------------------------------
    if (i >= p.warm_end && i < p.burn_end) {
      gen_welford(p, w, pm, p2, i, lane, V);
      r.lsw = r.lsw + p.adapt_rate * (a - p.target);
    }
    r.lsw = cls_clip(r.lsw, p.log_lo_w, p.log_hi);
  }

  if (lead) {
    gen_store(p.o_w + cw, w, lane, g);
    gen_store(p.o_w_last + cw, wl, lane, g);
    gen_store(p.o_g_like + cw, gl, lane, g);
    gen_store(p.o_pc_mean + cw, pm, lane, g);
    gen_store(p.o_pc_m2 + cw, p2, lane, g);
    if (lane == 0) cls_store_carry(p, r, c);
  }
}

template <int NH, int WPC>
static int launch(const ClsPrecondParams* p, int smem_bytes, cudaStream_t stream) {
  constexpr int CPB = MALA_CLS_THREADS / 32 / WPC;
  auto kern = mala_cls_block_kernel<4, NH, 3, WPC>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       smem_bytes);
  if (e != cudaSuccess) return (int)e;
  const int grid = (p->chains + CPB - 1) / CPB;
  kern<<<grid, MALA_CLS_THREADS, smem_bytes, stream>>>(*p);
  return (int)cudaGetLastError();
}

extern "C" {

int ptnn_mala_cls_threads() { return MALA_CLS_THREADS; }

// Launches ceil(C / (8 / wpc)) blocks of `wpc` warps a chain of the (4,
// `hidden`, 3) network (CLS_PRECOND_HIDDEN) on `stream`; returns the
// cudaError_t of the attribute call or of the launch (0 = success). Does
// not synchronise.
int ptnn_mala_cls_block(const ClsPrecondParams* p, int smem_bytes, int wpc, int hidden,
                        void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
#define CLS_CASE(NH, WPC) \
  if (hidden == NH && wpc == WPC) return launch<NH, WPC>(p, smem_bytes, st);
  CLS_PRECOND_CASES
#undef CLS_CASE
  return (int)cudaErrorInvalidValue;
}

// Launches the generic route at the network and layout `g`: ceil(C /
// (g.warps / g.wpc)) blocks of 32 g.warps threads on `stream`; `vdev` holds
// the warps' vectors where g.vec_dev. Returns the cudaError_t of the
// attribute call or of the launch (0 = success). Does not synchronise.
int ptnn_mala_cls_gen(const ClsPrecondParams* p, const GenShape* g, float* vdev,
                      int smem_bytes, void* stream) {
  if (!gen_shape_ok(g, vdev) || g->no < 2) return (int)cudaErrorInvalidValue;
  cudaError_t e = gen_set_attributes(mala_cls_gen_kernel, smem_bytes, false);
  if (e != cudaSuccess) return (int)e;
  const int cpb = g->warps / g->wpc;
  const int grid = (p->chains + cpb - 1) / cpb;
  mala_cls_gen_kernel<<<grid, 32 * g->warps, smem_bytes, (cudaStream_t)stream>>>(*p, *g, vdev);
  return (int)cudaGetLastError();
}

}  // extern "C"
