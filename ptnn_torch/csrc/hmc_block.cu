// A fused block of K preconditioned-HMC steps for every chain of the
// parallel-tempering ladder, with in-kernel ChEES trajectory adaptation,
// regression task, for Hopper (sm_90a).
//
// Replaces the TPU kernel ptnn/ops/pallas_step.py `_hmc_block_kernel`
// (wrapper `fused_hmc_block_impl`, with `rung_sum_matrix`). The plain
// PyTorch version of the same function is `hmc_block_reference` in
// ptnn_torch/ops/precond_step.py, whose docstring states the semantics.
//
// What bounds it. A chain-step runs up to `leapfrog` (16 in the flagship)
// gradient evaluations, each a forward and backward pass of the (4, 10, 1)
// FNN over the 298 train rows, one after the other: a block costs K times
// one trajectory. A trajectory is per-row arithmetic (about 400 instructions
// a row, ten rows a lane) and a 62-shuffle reduce-scatter, so with a warp
// per chain the SM's instruction issue, not memory, sets the pace. Device
// memory sees only the noise and the trace rows.
//
// Design. The precond layout of precond_common.cuh (one warp per chain,
// rows in shared memory, the chain's vectors in its warp's slots, lane l
// owning entries 2l and 2l+1), with HMC_WARPS = 8 chains per 256-thread
// block: the flagship's 1024 chains are 128 blocks on 128 of the 132 SMs,
// two warps per scheduler, and one block an SM leaves a thread up to 255
// registers. Each gradient evaluation publishes its weights to the warp's
// broadcast slot once and loads all 61 into registers (16 float4 loads), so
// the row loop reads no weight from shared memory (reg_chain.cuh, shared
// with the MALA kernel). Each warp runs its own
// chain's leapfrog count and skips the trajectory on warm-start and dead
// steps; ptnn masks lanes past their count inside the block's longest
// trajectory, which is the same arithmetic. The proposal's SSE and gradient
// are the last leapfrog step's; only a live warm-start step evaluates its
// proposal afresh.
//
// ChEES couples the chains of a panel at every adapting step: after the
// decision, each chain needs the means over its rung's replicas in the
// panel (128 chains, or all C <= 128) of w' and of the pre-decision w, and
// then the rung sums of the acceptance a and of the estimator. So all
// chains of a panel run at the same time, in lockstep at those points. Each
// warp publishes (w', w_old, a) to its exchange slot, all synchronise, each
// warp sums its rung's replicas (in replica order, so every replica of a
// rung gets the same bits), publishes its estimator, all synchronise again
// and each warp sums the estimators. The slots alternate between two
// parities, so the next exchange need not wait for the last reads. Two
// routes, picked by the wrapper from the card's occupancy
// (ops/precond_step.py `hmc_route`):
//   * cluster: a panel is one thread-block cluster of up to 16 blocks (16 is
//     a non-portable size), launched with cudaLaunchKernelEx; the slots sit
//     in shared memory and are read through distributed shared memory; the
//     barrier is the cluster's. Blocks hold their shared memory until a last
//     cluster barrier. Taken when every panel's cluster fits on the card at
//     once.
//   * grid: a cooperative launch (every block resident, one an SM); the
//     slots sit in device memory (PrecondParams::exch, read past L1 with
//     __ldcg) and the barrier is a grid barrier. Taken when the clusters do
//     not all fit at once but the whole grid does.
// Without ChEES the kernel runs no exchange and no barrier after the rows
// are loaded.
//
// The generic route (`hmc_gen_kernel`) runs any other (I, H, 1) given at
// run time (gen_chain.cuh): the step and both exchanges of the
// classification HMC kernels' layout, a chain's rows over WPC warps of a
// block of 1-8 warps, its vectors in shared or device memory, each
// evaluation's rows through the record tile (the last one takes the test
// rows), the exchange slots sized from the runtime w_size.

#include <cooperative_groups.h>

#include "gen_chain.cuh"
#include "reg_chain.cuh"

namespace cg = cooperative_groups;

#define HMC_WARPS 8  // chains per thread block
#define HMC_THREADS (HMC_WARPS * 32)
#define HMC_MAX_CLUSTER 16  // blocks of a panel's cluster (non-portable)
#define EX_FLOATS (2 * VEC + 4)  // one parity of a chain's exchange slot
#define ROUTE_PLAIN 0  // no ChEES: no exchange
#define ROUTE_CLUSTER 1
#define ROUTE_GRID 2

// Reads of an exchange slot: distributed shared memory, or device memory
// past the SM's L1 (another SM wrote it since this one last read it).
template <int ROUTE>
__device__ __forceinline__ float2 ex_ld2(const float* q, int lane) {
  if constexpr (ROUTE == ROUTE_GRID) return __ldcg(reinterpret_cast<const float2*>(q) + lane);
  return reinterpret_cast<const float2*>(q)[lane];
}

template <int ROUTE>
__device__ __forceinline__ float ex_ld(const float* q) {
  if constexpr (ROUTE == ROUTE_GRID) return __ldcg(q);
  return *q;
}

template <int ROUTE>
__device__ __forceinline__ void ex_sync() {
  if constexpr (ROUTE == ROUTE_CLUSTER) {
    cg::this_cluster().sync();
  } else {
    __threadfence();
    cg::this_grid().sync();
  }
}

template <int NI, int NH, int ROUTE>
__global__ void __launch_bounds__(HMC_THREADS, 1) hmc_block_kernel(const PrecondParams p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  using N = Net<NI, NH>;
  constexpr int W = N::W;
  constexpr bool CHEES = ROUTE != ROUTE_PLAIN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x * HMC_WARPS + warp;
  const bool active = c < p.chains;
  const int n_rows = p.n_tr + p.n_te;
  float* s_rows = smem;
  const int row_floats = rows_floats(n_rows, NI);
  const ChainSlots s = chain_slots(smem, row_floats, warp);
  float* ex_base = smem + row_floats + HMC_WARPS * 6 * VEC;  // cluster route
  load_rows(p, s_rows, NI);
  __syncthreads();
  if (!CHEES && !active) return;  // without ChEES no barrier follows

  const float sq = p.sigma_sq;
  const float leap_f = (float)p.leapfrog;
  const float* te_rows = s_rows + p.n_tr * (NI + 1);
  Carry r{};
  float lt = 0.f, m1 = 0.f, v2 = 0.f;
  if (active) {
    load_chain(p, s, c, lane, W);
    r = load_carry(p, c);
    if (CHEES) {
      lt = p.log_traj[c];
      m1 = p.chees_m1[c];
      v2 = p.chees_v2[c];
    }
  }
  // the chain's rung and the first replica of it in the panel
  const int pbase = (c / max(p.panel, 1)) * p.panel;
  const int rung0 = pbase + (c - pbase) % max(p.rungs, 1);
  const int n_lad = p.panel / max(p.rungs, 1);
  int parity = 0;
  float wr[VEC];  // the weights of the last evaluation

  for (int k = 0; k < p.k_max; ++k) {
    const int i = p.start + k;
    const size_t kc = (size_t)k * p.chains + c;
    float eps = 1.f;
    if (active) {
      eps = expf(r.lsw);
      if (p.eps_jitter > 0.f) eps = eps * (1.f + p.eps_jitter * (2.f * p.u_jit[kc] - 1.f));
    }
    if (k >= p.length) {  // dead step: carries into the trace rows
      if (active) {
        write_trace(p, s.wl[lane], kc, lane, W, r.ll / r.at, r, r.na);
        if (lane == 0) p.t_traj_len[kc] = 0.f;
        r.lse = clipf(r.lse, p.log_lo_eta, p.log_hi);
        if (CHEES) lt = clipf(lt, p.log_traj_lo, logf(eps * leap_f));
        r.lsw = clipf(r.lsw, p.log_lo_w, p.log_hi);
      }
      continue;
    }
    const bool warm = i < p.warm_end;
    const bool adapting = i >= p.warm_end && i < p.burn_end;
    float2 m = f2(1.f, 1.f), w_prop = f2(0.f, 0.f), w_old = f2(0.f, 0.f),
           p_end = f2(0.f, 0.f);
    float a = 0.f, u_t = 0.f, tau_traj = 0.f;
    if (active) {
      m = precond_diag(s.p2[lane], i, p);
      const float tau = expf(r.eta);
      const float tat = tau * r.at;
      const float2 w = s.w[lane];
      const float2 gl = s.gl[lane];
      const float2 g_cur = f2(gl.x / tat - w.x / sq, gl.y / tat - w.y / sq);
      // --- the trajectory schedule ------------------------------------------
      float l_steps = leap_f;
      if (CHEES) {
        u_t = p.u_traj[k];
        tau_traj = expf(lt) * u_t;
        l_steps = clipf(ceilf(tau_traj / eps), 1.f, leap_f);
      }
      // --- leapfrog under the mass matrix diag(1/m) -------------------------
      const float2 nw = ld2(p.noise_w + kc * W, lane, W);
      const float2 p0 = f2(nw.x / sqrtf(m.x), nw.y / sqrtf(m.y));
      const float k_init = 0.5f * warp_sum(m.x * p0.x * p0.x + m.y * p0.y * p0.y);
      float2 w_c = w, p_c = p0, g_c = g_cur, glr_c = gl;
      float sse_c = 0.f;
      const int n_leap = warm ? 0 : (int)l_steps;
      for (int n = 0; n < n_leap; ++n) {
        const float2 p_half = f2(p_c.x + 0.5f * eps * g_c.x, p_c.y + 0.5f * eps * g_c.y);
        const float2 w_n = f2(w_c.x + eps * m.x * p_half.x, w_c.y + eps * m.y * p_half.y);
        publish(s.wb, lane, w_n);
        load_weights(s.wb, wr);
        float sse_n;
        const float2 gl_n = fwd_grad_reg<NI, NH>(s_rows, p.n_tr, wr, lane, sse_n);
        const float2 g_n = f2(gl_n.x / tat - w_n.x / sq, gl_n.y / tat - w_n.y / sq);
        p_c = f2(p_half.x + 0.5f * eps * g_n.x, p_half.y + 0.5f * eps * g_n.y);
        w_c = w_n;
        g_c = g_n;
        sse_c = sse_n;
        glr_c = gl_n;
      }
      p_end = p_c;
      const float k_end = 0.5f * warp_sum(m.x * p_c.x * p_c.x + m.y * p_c.y * p_c.y);
      // --- the proposal: the trajectory's end, or the warm start ------------
      w_prop = w_c;
      float sse_tr = sse_c;
      float2 g_rows = glr_c;
      if (warm) {
        const float g_rms = sqrtf(dot2(g_cur, g_cur) / p.w_size_f);
        const float d = fmaxf(g_rms, 1e-12f);
        w_prop = f2(w.x + p.warmstart_step * g_cur.x / d, w.y + p.warmstart_step * g_cur.y / d);
        publish(s.wb, lane, w_prop);
        load_weights(s.wb, wr);
        g_rows = fwd_grad_reg<NI, NH>(s_rows, p.n_tr, wr, lane, sse_tr);
      }
      // wr holds w_prop: the last leapfrog step or the warm start loaded it
      const float sse_te = fwd_sse_reg<NI, NH>(te_rows, p.n_te, wr, lane);
      const float ssq = dot2(w_prop, w_prop);
      const float pr_p =
          p.prior_const - ssq / (2.f * sq) - p.one_plus_nu1 * r.eta - p.nu2 / tau;
      const float ll_p = p.ll_const * (p.log_2pi + r.eta) - 0.5f * sse_tr / tau;
      const float log_mh = (ll_p - r.ll) / r.at + (pr_p - r.pr) + (k_init - k_end);
      a = expf(fminf(log_mh, 0.f));
      const bool accept = p.u[kc] < a || warm;
      const int na_before = r.na;
      w_old = w;
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
      write_trace(p, s.wl[lane], kc, lane, W, ll_p / r.at, r, na_before);
      if (lane == 0) p.t_traj_len[kc] = l_steps;
      // --- the eta block ------------------------------------------------------
      eta_block(r.eta, r.ll, r.pr, r.lse, p.noise_eta[kc], p.u_eta[kc], r.at, i, p);
    }
    // --- ChEES: Adam on log_traj from the panel's rung means ----------------
    if constexpr (CHEES) {
      if (adapting) {  // uniform over the grid
        auto slot = [&](int chain) -> float* {
          if constexpr (ROUTE == ROUTE_CLUSTER) {
            cg::cluster_group cluster = cg::this_cluster();
            const int cbase = (int)(blockIdx.x - cluster.block_rank());
            float* local = ex_base + (chain % HMC_WARPS) * 2 * EX_FLOATS + parity * EX_FLOATS;
            return cluster.map_shared_rank(local, (unsigned)(chain / HMC_WARPS - cbase));
          } else {
            return p.exch + ((size_t)chain * 2 + parity) * EX_FLOATS;
          }
        };
        float* mine = ROUTE == ROUTE_CLUSTER
                          ? ex_base + warp * 2 * EX_FLOATS + parity * EX_FLOATS
                          : p.exch + ((size_t)c * 2 + parity) * EX_FLOATS;
        if (active) {
          reinterpret_cast<float2*>(mine)[lane] = w_prop;
          reinterpret_cast<float2*>(mine + VEC)[lane] = w_old;
          if (lane == 0) mine[2 * VEC] = a;
        }
        ex_sync<ROUTE>();
        float2 sp = f2(0.f, 0.f), so = f2(0.f, 0.f);
        float sa = 0.f, g_ch = 0.f;
        if (active) {
          for (int t = 0; t < n_lad; ++t) {
            const float* x = slot(rung0 + t * p.rungs);
            const float2 xp = ex_ld2<ROUTE>(x, lane);
            const float2 xo = ex_ld2<ROUTE>(x + VEC, lane);
            sp = f2(sp.x + xp.x, sp.y + xp.y);
            so = f2(so.x + xo.x, so.y + xo.y);
            sa += ex_ld<ROUTE>(x + 2 * VEC);
          }
          const float2 dxp = f2(w_prop.x - sp.x / p.n_ladders_f, w_prop.y - sp.y / p.n_ladders_f);
          const float2 dx = f2(w_old.x - so.x / p.n_ladders_f, w_old.y - so.y / p.n_ladders_f);
          const float dsq = warp_sum(m.x * dxp.x * dxp.x + m.y * dxp.y * dxp.y) -
                            warp_sum(m.x * dx.x * dx.x + m.y * dx.y * dx.y);
          const float inner = dot2(dxp, p_end);
          g_ch = a * dsq * inner * u_t;
          if (lane == 0) mine[2 * VEC + 1] = g_ch;
        }
        ex_sync<ROUTE>();
        if (active) {
          float sg = 0.f;
          for (int t = 0; t < n_lad; ++t) sg += ex_ld<ROUTE>(slot(rung0 + t * p.rungs) + 2 * VEC + 1);
          const float wsum = fmaxf(sa, 1e-6f);
          const float g_log = sg / wsum * tau_traj;
          const float t_ad = fmaxf((float)(min(i, p.burn_end) - p.warm_end) + 1.f, 1.f);
          m1 = 0.9f * m1 + 0.1f * g_log;
          v2 = 0.999f * v2 + 0.001f * g_log * g_log;
          const float bc1 = 1.f - expf(t_ad * p.log09);
          const float bc2 = 1.f - expf(t_ad * p.log0999);
          lt = lt + p.chees_rate * (m1 / bc1) / (sqrtf(v2 / bc2) + 1e-8f);
        }
        parity ^= 1;
      }
      if (active) lt = clipf(lt, p.log_traj_lo, logf(eps * leap_f));
    }
    // --- Welford and the Robbins-Monro w scale ------------------------------
    if (active) {
      if (adapting) {
        float2 pm = s.pm[lane], p2 = s.p2[lane];
        welford(s.w[lane], pm, p2, i, p);
        s.pm[lane] = pm;
        s.p2[lane] = p2;
        r.lsw = r.lsw + p.adapt_rate * (a - p.target);
      }
      r.lsw = clipf(r.lsw, p.log_lo_w, p.log_hi);
    }
  }

  if (active) {
    store_chain(p, s, c, lane, W);
    if (lane == 0) {
      store_carry(p, r, c);
      if (CHEES) {
        p.o_log_traj[c] = lt;
        p.o_chees_m1[c] = m1;
        p.o_chees_v2[c] = v2;
      }
    }
  }
  if constexpr (ROUTE == ROUTE_CLUSTER) cg::this_cluster().sync();  // keep the slots alive
}

// The generic route: the step of hmc_block_kernel at a runtime (I, H, 1)
// (gen_chain.cuh's layout: blockDim.x = 32 g.warps); the grid route's
// slots in p.exch, (C, 2, 2 VEC + 4) floats. ROUTE as above.
template <int ROUTE>
__global__ void __launch_bounds__(GEN_THREADS, 1)
    hmc_gen_kernel(const PrecondParams p, const GenShape g, float* vdev) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr bool CHEES = ROUTE != ROUTE_PLAIN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cl = warp / g.wpc, sub = warp % g.wpc;
  const int c = blockIdx.x * (g.warps / g.wpc) + cl;
  const bool active = c < p.chains;
  const bool lead = sub == 0;  // the warp that writes the chain's outputs
  const int NI = g.ni, W = g.w, V = g.vec;
  const int n_rows = p.n_tr + p.n_te;
  float* s_rows = smem;
  const int row_floats = gen_rows_floats(n_rows, NI);
  const GenWarp L = gen_warp(smem, row_floats, g, warp, vdev);
  load_rows(p, s_rows, NI);
  __syncthreads();
  if (!CHEES && !active) return;  // without ChEES no barrier follows

  const float sq = p.sigma_sq;
  const float leap_f = (float)p.leapfrog;
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
  float* gr = m + V;   // the last evaluation's gradient of -SSE/2
  float* pc = gr + V;  // the momentum
  float* wo = pc + V;  // the pre-decision w (ChEES)
  float* wn = L.wb;    // the leapfrog position, then the proposal
  Carry r{};
  float lt = 0.f, m1 = 0.f, v2 = 0.f;
  if (active) {
    const size_t cw = (size_t)c * W;
    gen_load(w, p.w + cw, lane, g);
    gen_load(wl, p.w_last + cw, lane, g);
    gen_load(gl, p.g_like + cw, lane, g);
    gen_load(pm, p.pc_mean + cw, lane, g);
    gen_load(p2, p.pc_m2 + cw, lane, g);
    r = load_carry(p, c);
    if (CHEES) {
      lt = p.log_traj[c];
      m1 = p.chees_m1[c];
      v2 = p.chees_v2[c];
    }
  }
  // the chain's rung and the first replica of it in the panel
  const int pbase = (c / max(p.panel, 1)) * p.panel;
  const int rung0 = pbase + (c - pbase) % max(p.rungs, 1);
  const int n_lad = p.panel / max(p.rungs, 1);
  int epar = 0, xpar = 0;  // parities of the partial and the exchange slots

  for (int k = 0; k < p.k_max; ++k) {
    const int i = p.start + k;
    const size_t kc = (size_t)k * p.chains + c;
    float eps = 1.f;
    if (active) {
      eps = expf(r.lsw);
      if (p.eps_jitter > 0.f) eps = eps * (1.f + p.eps_jitter * (2.f * p.u_jit[kc] - 1.f));
    }
    if (k >= p.length) {  // dead step: carries into the trace rows
      if (active) {
        if (lead) {
          gen_reg_trace(p, W, wl, kc, lane, r.ll / r.at, r, r.na);
          if (lane == 0) p.t_traj_len[kc] = 0.f;
        }
        r.lse = clipf(r.lse, p.log_lo_eta, p.log_hi);
        if (CHEES) lt = clipf(lt, p.log_traj_lo, logf(eps * leap_f));
        r.lsw = clipf(r.lsw, p.log_lo_w, p.log_hi);
      }
      continue;
    }
    const bool warm = i < p.warm_end;
    const bool adapting = i >= p.warm_end && i < p.burn_end;
    float a = 0.f, u_t = 0.f, tau_traj = 0.f;
    if (active) {
      gen_precond(p, p2, m, i, lane, V);
      const float tau = expf(r.eta);
      const float tat = tau * r.at;
      // --- the trajectory schedule ------------------------------------------
      float l_steps = leap_f;
      if (CHEES) {
        u_t = p.u_traj[k];
        tau_traj = expf(lt) * u_t;
        l_steps = clipf(ceilf(tau_traj / eps), 1.f, leap_f);
      }
      // --- leapfrog under the mass matrix diag(1/m) -------------------------
      const float* nw = p.noise_w + kc * W;
      float ki = 0.f;
      for (int e = lane; e < V; e += 32) {
        const float p0 = (e < W ? nw[e] : 0.f) / sqrtf(m[e]);
        pc[e] = p0;
        ki += m[e] * p0 * p0;
        wn[e] = w[e];
        gr[e] = gl[e];
      }
      const float k_init = 0.5f * warp_sum(ki);
      // --- the evaluations: the leapfrog steps', or the warm start's ---------
      if (warm) {
        float t = 0.f;
        for (int e = lane; e < V; e += 32) {
          const float g_cur = gl[e] / tat - w[e] / sq;
          t += g_cur * g_cur;
        }
        const float g_rms = sqrtf(warp_sum(t) / p.w_size_f);
        const float d = fmaxf(g_rms, 1e-12f);
        for (int e = lane; e < V; e += 32)
          wn[e] = w[e] + p.warmstart_step * (gl[e] / tat - w[e] / sq) / d;
      }
      GenSums s{0.f, 0.f, 0.f, 0.f, 0.f};
      const int n_eval = warm ? 1 : (int)l_steps;  // leapfrog >= 1
      for (int n = 0; n < n_eval; ++n) {
        if (!warm) {
          for (int e = lane; e < V; e += 32) {
            const float g_c = gr[e] / tat - wn[e] / sq;
            const float p_half = pc[e] + 0.5f * eps * g_c;
            pc[e] = p_half;
            wn[e] = wn[e] + eps * m[e] * p_half;
          }
        }
        // the last evaluation is the proposal's: it takes the test rows too
        const bool last = n == n_eval - 1;
        gen_eval<true>(g, s_rows, r0, r1, te_rows, last ? t0 : 0, last ? t1 : 0, wn, L.rec,
                       L.part, epar, sub, bar_id, lane, gr, s);
        if (!warm) {
          for (int e = lane; e < V; e += 32) {
            const float g_n = gr[e] / tat - wn[e] / sq;
            pc[e] = pc[e] + 0.5f * eps * g_n;
          }
        }
      }
      float ke = 0.f;
      for (int e = lane; e < V; e += 32) ke += m[e] * pc[e] * pc[e];
      const float k_end = 0.5f * warp_sum(ke);
      const float sse_tr = s.tr, sse_te = s.te_err2;
      const float ssq = gen_dot(wn, wn, lane, V);
      const float pr_p =
          p.prior_const - ssq / (2.f * sq) - p.one_plus_nu1 * r.eta - p.nu2 / tau;
      const float ll_p = p.ll_const * (p.log_2pi + r.eta) - 0.5f * sse_tr / tau;
      const float log_mh = (ll_p - r.ll) / r.at + (pr_p - r.pr) + (k_init - k_end);
      a = expf(fminf(log_mh, 0.f));
      const bool accept = p.u[kc] < a || warm;
      const int na_before = r.na;
      if (CHEES && adapting)
        for (int e = lane; e < V; e += 32) wo[e] = w[e];
      if (accept) {
        r.rtr = sqrtf(sse_tr / p.n_tr_f);
        r.rte = sqrtf(sse_te / p.n_te_f);
        for (int e = lane; e < V; e += 32) {
          w[e] = wn[e];
          wl[e] = wn[e];
          gl[e] = gr[e];
        }
        r.ll = ll_p;
        r.pr = pr_p;
        r.na += 1;
      }
      if (lead) {
        gen_reg_trace(p, W, wl, kc, lane, ll_p / r.at, r, na_before);
        if (lane == 0) p.t_traj_len[kc] = l_steps;
      }
      // --- the eta block ------------------------------------------------------
      eta_block(r.eta, r.ll, r.pr, r.lse, p.noise_eta[kc], p.u_eta[kc], r.at, i, p);
    }
    // --- ChEES: Adam on log_traj from the panel's rung means ----------------
    if constexpr (CHEES) {
      if (adapting)  // uniform over the grid
        gen_chees<ROUTE>(p, g, L, p.exch, c, active, lead, lane, rung0, n_lad, wn, wo, m, pc, a,
                         u_t, tau_traj, i, xpar, lt, m1, v2);
      if (active) lt = clipf(lt, p.log_traj_lo, logf(eps * leap_f));
    }
    // --- Welford and the Robbins-Monro w scale ------------------------------
    if (active) {
      if (adapting) {
        gen_welford(p, w, pm, p2, i, lane, V);
        r.lsw = r.lsw + p.adapt_rate * (a - p.target);
      }
      r.lsw = clipf(r.lsw, p.log_lo_w, p.log_hi);
    }
  }

  if (active && lead) {
    const size_t cw = (size_t)c * W;
    gen_store(p.o_w + cw, w, lane, g);
    gen_store(p.o_w_last + cw, wl, lane, g);
    gen_store(p.o_g_like + cw, gl, lane, g);
    gen_store(p.o_pc_mean + cw, pm, lane, g);
    gen_store(p.o_pc_m2 + cw, p2, lane, g);
    if (lane == 0) {
      store_carry(p, r, c);
      if (CHEES) {
        p.o_log_traj[c] = lt;
        p.o_chees_m1[c] = m1;
        p.o_chees_v2[c] = v2;
      }
    }
  }
  if constexpr (ROUTE == ROUTE_CLUSTER) cg::this_cluster().sync();  // keep the slots alive
}

// The attributes every launch of `kern` needs: its dynamic shared memory
// and, for a cluster kernel, clusters above the portable 8 blocks.
template <typename K>
static cudaError_t set_attributes(K kern, int smem_bytes, bool cluster) {
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       smem_bytes);
  if (e == cudaSuccess && cluster)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return e;
}

static cudaLaunchConfig_t cluster_config(int grid, int smem_bytes, int cluster,
                                         cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid, 1, 1);
  cfg.blockDim = dim3(HMC_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

extern "C" {

int ptnn_hmc_warps() { return HMC_WARPS; }

int ptnn_hmc_max_cluster() { return HMC_MAX_CLUSTER; }

// How many clusters of `cluster` blocks of the cluster-route kernel the card
// holds at once, into *out; returns the cudaError_t (0 = success).
int ptnn_hmc_max_active_clusters(int smem_bytes, int cluster, int* out) {
  auto kern = hmc_block_kernel<4, 10, ROUTE_CLUSTER>;
  cudaError_t e = set_attributes(kern, smem_bytes, true);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(cluster, smem_bytes, cluster, 0, attr);
  return (int)cudaOccupancyMaxActiveClusters(out, kern, &cfg);
}

// How many blocks of the grid-route kernel the card holds at once (blocks
// an SM times SMs), into *out; returns the cudaError_t (0 = success).
int ptnn_hmc_coop_blocks(int smem_bytes, int* out) {
  auto kern = hmc_block_kernel<4, 10, ROUTE_GRID>;
  cudaError_t e = set_attributes(kern, smem_bytes, false);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0, dev = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, HMC_THREADS, smem_bytes);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *out = per_sm * sms;
  return (int)e;
}

// Launches ceil(C / HMC_WARPS) blocks on `stream` by `route`: ROUTE_PLAIN
// (no ChEES), ROUTE_CLUSTER (clusters of `cluster` blocks, one a panel) or
// ROUTE_GRID (cooperative; p->exch holds the slots). Returns the
// cudaError_t of the attribute call or of the launch (0 = success). Does
// not synchronise.
int ptnn_hmc_block(const PrecondParams* p, int smem_bytes, int cluster, int route,
                   void* stream) {
  const int grid = (p->chains + HMC_WARPS - 1) / HMC_WARPS;
  const cudaStream_t st = (cudaStream_t)stream;
  if (route == ROUTE_PLAIN && !p->chees) {
    auto kern = hmc_block_kernel<4, 10, ROUTE_PLAIN>;
    cudaError_t e = set_attributes(kern, smem_bytes, false);
    if (e != cudaSuccess) return (int)e;
    kern<<<grid, HMC_THREADS, smem_bytes, st>>>(*p);
    return (int)cudaGetLastError();
  }
  if (route == ROUTE_CLUSTER && p->chees) {
    if (cluster < 1 || cluster > HMC_MAX_CLUSTER || grid % cluster != 0)
      return (int)cudaErrorInvalidValue;
    auto kern = hmc_block_kernel<4, 10, ROUTE_CLUSTER>;
    cudaError_t e = set_attributes(kern, smem_bytes, true);
    if (e != cudaSuccess) return (int)e;
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = cluster_config(grid, smem_bytes, cluster, st, attr);
    e = cudaLaunchKernelEx(&cfg, kern, *p);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
  }
  if (route == ROUTE_GRID && p->chees && p->exch != nullptr) {
    auto kern = hmc_block_kernel<4, 10, ROUTE_GRID>;
    cudaError_t e = set_attributes(kern, smem_bytes, false);
    if (e != cudaSuccess) return (int)e;
    void* args[] = {(void*)p};
    e = cudaLaunchCooperativeKernel((const void*)kern, dim3(grid), dim3(HMC_THREADS), args,
                                    (size_t)smem_bytes, st);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}

// The generic route's occupancy: clusters of `cluster` blocks of `threads`
// threads at once, and blocks of the grid route at once, into *out;
// returns the cudaError_t.
int ptnn_hmc_gen_max_active_clusters(int threads, int smem_bytes, int cluster, int* out) {
  return gen_max_active_clusters(hmc_gen_kernel<ROUTE_CLUSTER>, threads, smem_bytes, cluster,
                                 out);
}

int ptnn_hmc_gen_coop_blocks(int threads, int smem_bytes, int* out) {
  return gen_coop_blocks(hmc_gen_kernel<ROUTE_GRID>, threads, smem_bytes, out);
}

// Launches the generic route at the network and layout `g`: ceil(C /
// (g.warps / g.wpc)) blocks of 32 g.warps threads on `stream` by `route`,
// as ptnn_hmc_block; `vdev` holds the warps' vectors where g.vec_dev.
int ptnn_hmc_gen(const PrecondParams* p, const GenShape* g, float* vdev, int smem_bytes,
                 int cluster, int route, void* stream) {
  if (!gen_shape_ok(g, vdev) || g->no != 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int cpb = g->warps / g->wpc, threads = 32 * g->warps;
  const int grid = (p->chains + cpb - 1) / cpb;
  if (route == ROUTE_PLAIN && !p->chees) {
    auto kern = hmc_gen_kernel<ROUTE_PLAIN>;
    cudaError_t e = gen_set_attributes(kern, smem_bytes, false);
    if (e != cudaSuccess) return (int)e;
    kern<<<grid, threads, smem_bytes, st>>>(*p, *g, vdev);
    return (int)cudaGetLastError();
  }
  if (route == ROUTE_CLUSTER && p->chees) {
    if (cluster < 1 || cluster > HMC_MAX_CLUSTER || grid % cluster != 0)
      return (int)cudaErrorInvalidValue;
    auto kern = hmc_gen_kernel<ROUTE_CLUSTER>;
    cudaError_t e = gen_set_attributes(kern, smem_bytes, true);
    if (e != cudaSuccess) return (int)e;
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = gen_cluster_config(grid, threads, smem_bytes, cluster, st, attr);
    e = cudaLaunchKernelEx(&cfg, kern, *p, *g, vdev);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
  }
  if (route == ROUTE_GRID && p->chees && p->exch != nullptr) {
    auto kern = hmc_gen_kernel<ROUTE_GRID>;
    cudaError_t e = gen_set_attributes(kern, smem_bytes, false);
    if (e != cudaSuccess) return (int)e;
    PrecondParams params = *p;
    GenShape shape = *g;
    void* args[] = {(void*)&params, (void*)&shape, (void*)&vdev};
    e = cudaLaunchCooperativeKernel((const void*)kern, dim3(grid), dim3(threads), args,
                                    (size_t)smem_bytes, st);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
