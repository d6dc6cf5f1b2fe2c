// A fused block of K preconditioned-HMC steps for every chain of the
// parallel-tempering ladder, with in-kernel ChEES trajectory adaptation,
// classification task, for Hopper (sm_90a).
//
// Replaces the TPU kernel ptnn/ops/pallas_step.py `_hmc_cls_block_kernel`
// (wrapper `fused_hmc_cls_block_impl`, with `rung_sum_matrix`). The plain
// PyTorch version of the same function is `hmc_cls_block_reference` in
// ptnn_torch/ops/precond_cls_step.py, whose docstring states the semantics.
//
// What bounds it. A chain-step runs up to `leapfrog` (16 in the iris
// flagship) gradient evaluations, each a forward and backward pass of the
// (4, 12, 3) FNN over the 105 train rows, one after the other: a block costs
// K times the latency of one trajectory, and the iris flagship has only 64
// chains, too few to fill the card with one warp each. Device memory sees
// only the noise and the trace rows.
//
// Design: one chain's rows spread over WPC warps (4, 2 or 1), so that an
// otherwise empty card shortens each evaluation.
//   * A block is HMC_CLS_THREADS = 256 threads, 8 warps: 8 / WPC chains of
//     WPC warps each, one block an SM, so a thread may use 255 registers.
//   * Each warp of a chain takes a contiguous share of the train rows (at
//     iris, 4 warps x one tile of <= 27 rows) and of the test rows. It runs
//     the per-row forward, backward and record code of cls_chain.cuh on
//     its share, with the weights in registers, and gets a partial
//     gradient in the lane layout (lane l owns entries l + 32 j) and
//     partial sums (ll, err^2, matches, and on the test rows err^2 and
//     matches).
//   * The chain's warps publish their partials to parity-alternating slots
//     in shared memory and meet at a named barrier of the chain's warps
//     alone (bar.sync 1 + chain, 32 WPC threads); each warp then sums the
//     WPC partials in warp order. No atomics: every run gives the same bits.
//   * Every warp of a chain keeps its own copy of the chain's elementwise
//     state (w, w_last, g_like, the Welford buffers, momenta, the carries
//     and the ChEES scalars) in registers and does the same arithmetic in
//     the same order, so the copies stay bit-identical and the sums need no
//     broadcast. The chain's first warp writes its outputs.
//   * The proposal's ll, train metrics and gradient are the last leapfrog
//     step's; that evaluation also takes the test rows, so a step costs
//     one barrier an evaluation. Only a live warm-start step evaluates its
//     proposal afresh. Each warp runs its chain's leapfrog count and skips
//     the trajectory on warm-start and dead steps; ptnn masks lanes past
//     their count inside the block's longest trajectory, which is the same
//     arithmetic.
//
// ChEES couples the chains of a panel (all C <= 128 chains, else each run of
// 128) at every adapting step: the rung means of w' and of the pre-decision
// w, then the rung sums of the acceptance and of the estimator, summed in
// replica order. Two routes, as in hmc_block.cu, picked by the wrapper from
// the card's occupancy (ops/precond_cls_step.py `launch_plan`):
//   * cluster: a panel is one thread-block cluster of up to 16 blocks; the
//     slots sit in shared memory, read through distributed shared memory,
//     between cluster barriers;
//   * grid: a cooperative launch (every block resident); the slots sit in
//     device memory (`exch`, read past L1 with __ldcg) between grid
//     barriers.
// The slots alternate between two parities. Without ChEES the kernel runs
// no exchange and no barrier after the rows are loaded.
//
// The generic route (`hmc_cls_gen_kernel`) runs any other (I, H, O) given
// at run time (gen_chain.cuh): the same step and both ChEES exchanges, with
// the chain's vectors in shared or device memory, each evaluation's rows
// taken through the record tile and the exchange slots sized from the
// runtime w_size.
//
// No fast-math: expf, logf, sqrtf and division are the IEEE-rounded
// versions. The sums over rows run in another order than in the plain
// version (per warp, then across warps), so ll and the gradient round
// differently.

#include <cooperative_groups.h>

#include "cls_chain.cuh"
#include "gen_chain.cuh"

namespace cg = cooperative_groups;

#define HMC_CLS_THREADS 256  // threads a block: 8 warps, WPC of them a chain
#define HMC_CLS_MAX_CLUSTER 16  // blocks of a panel's cluster (non-portable)
#define ROUTE_PLAIN 0   // no ChEES: no exchange
#define ROUTE_CLUSTER 1
#define ROUTE_GRID 2

constexpr int BLOCK_WARPS = HMC_CLS_THREADS / 32;

// The classification HMC layout of cls_chain.cuh, and one parity of a
// chain's ChEES exchange slot (w', w_old and two scalars).
template <int NI, int NH, int NO>
struct HmcCls : ChainCls<NI, NH, NO> {
  static constexpr int EX = 2 * ClsNet<NI, NH, NO>::VEC + 4;
};


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

template <int NI, int NH, int NO, int WPC, int ROUTE>
__global__ void __launch_bounds__(HMC_CLS_THREADS, 1)
    hmc_cls_block_kernel(const ClsPrecondParams p, float* exch) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  using N = ClsNet<NI, NH, NO>;
  using H = HmcCls<NI, NH, NO>;
  constexpr int W = N::W, PER = N::PER, VEC = N::VEC, EX = H::EX;
  constexpr int CPB = BLOCK_WARPS / WPC;  // chains a block
  constexpr bool CHEES = ROUTE != ROUTE_PLAIN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cl = warp / WPC, sub = warp % WPC;
  const int c = blockIdx.x * CPB + cl;
  const bool active = c < p.chains;
  const bool lead = sub == 0;  // the warp that writes the chain's outputs
  const int n_rows = p.n_tr + p.n_te;
  float* s_rows = smem;
  const int row_floats = cls_rows_floats(n_rows, NI);
  float* wb = smem + row_floats + warp * H::WARP;
  float* rec = wb + VEC;
  float* part_base = smem + row_floats + BLOCK_WARPS * H::WARP;
  float* part = part_base + cl * 2 * WPC * H::PART;
  float* ex_base = part_base + BLOCK_WARPS * 2 * H::PART;  // cluster route
  for (int t = threadIdx.x; t < n_rows * (NI + 1); t += HMC_CLS_THREADS) s_rows[t] = p.rows[t];
  __syncthreads();
  if (!CHEES && !active) return;  // without ChEES no barrier of the block follows

  const float sq = p.sigma_sq;
  const float leap_f = (float)p.leapfrog;
  const float* te_rows = s_rows + p.n_tr * (NI + 1);
  // this warp's share of the rows
  const int tr_share = (p.n_tr + WPC - 1) / WPC, te_share = (p.n_te + WPC - 1) / WPC;
  const int r0 = min(p.n_tr, sub * tr_share), r1 = min(p.n_tr, r0 + tr_share);
  const int t0 = min(p.n_te, sub * te_share), t1 = min(p.n_te, t0 + te_share);
  const int bar_id = 1 + cl;  // barrier 0 is __syncthreads'
  float w[PER], wl[PER], gl[PER], pm[PER], p2[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) w[j] = wl[j] = gl[j] = pm[j] = p2[j] = 0.f;
  ClsCarry r{};
  float lt = 0.f, m1 = 0.f, v2 = 0.f;
  if (active) {
    const size_t cw = (size_t)c * W;
    cls_ld<W, PER>(p.w + cw, lane, w);
    cls_ld<W, PER>(p.w_last + cw, lane, wl);
    cls_ld<W, PER>(p.g_like + cw, lane, gl);
    cls_ld<W, PER>(p.pc_mean + cw, lane, pm);
    cls_ld<W, PER>(p.pc_m2 + cw, lane, p2);
    r = cls_load_carry(p, c);
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
          write_trace<W, PER>(p, kc, lane, r.ll, r, r.na, wl);
          if (lane == 0) p.t_traj_len[kc] = 0.f;
        }
        if (CHEES) lt = cls_clip(lt, p.log_traj_lo, logf(eps * leap_f));
        r.lsw = cls_clip(r.lsw, p.log_lo_w, p.log_hi);
      }
      continue;
    }
    const bool warm = i < p.warm_end;
    const bool adapting = i >= p.warm_end && i < p.burn_end;
    float m[PER], w_prop[PER], w_old[PER], p_end[PER];
#pragma unroll
    for (int j = 0; j < PER; ++j) m[j] = w_prop[j] = w_old[j] = p_end[j] = 0.f;
    float a = 0.f, u_t = 0.f, tau_traj = 0.f;
    if (active) {
      float g_cur[PER];
      precond_diag_reg<PER>(p2, i, p, m);
#pragma unroll
      for (int j = 0; j < PER; ++j) g_cur[j] = gl[j] / r.at - w[j] / sq;
      // --- the trajectory schedule ------------------------------------------
      float l_steps = leap_f;
      if (CHEES) {
        u_t = p.u_traj[k];
        tau_traj = expf(lt) * u_t;
        l_steps = cls_clip(ceilf(tau_traj / eps), 1.f, leap_f);
      }
      // --- leapfrog under the mass matrix diag(1/m) -------------------------
      float nw[PER], p_c[PER], w_c[PER], g_c[PER], glr_c[PER];
      cls_ld<W, PER>(p.noise_w + kc * W, lane, nw);
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        p_c[j] = nw[j] / sqrtf(m[j]);
        w_c[j] = w[j];
        g_c[j] = g_cur[j];
        glr_c[j] = gl[j];
      }
      float ki = 0.f;
#pragma unroll
      for (int j = 0; j < PER; ++j) ki += m[j] * p_c[j] * p_c[j];
      const float k_init = 0.5f * cls_warp_sum(ki);
      // --- the evaluations: the leapfrog steps', or the warm start's ---------
      if (warm) {
        const float g_rms = sqrtf(cls_dot<PER>(g_cur, g_cur) / p.w_size_f);
        const float d = fmaxf(g_rms, 1e-12f);
#pragma unroll
        for (int j = 0; j < PER; ++j) w_prop[j] = w[j] + p.warmstart_step * g_cur[j] / d;
      }
      ClsSums tr{0.f, 0.f, 0.f}, te{0.f, 0.f, 0.f};
      const int n_eval = warm ? 1 : (int)l_steps;  // leapfrog >= 1
      for (int n = 0; n < n_eval; ++n) {
        float w_n[PER], gl_n[PER];
#pragma unroll
        for (int j = 0; j < PER; ++j) {
          if (warm) {
            w_n[j] = w_prop[j];
          } else {
            const float p_half = p_c[j] + 0.5f * eps * g_c[j];
            p_c[j] = p_half;
            w_n[j] = w_c[j] + eps * m[j] * p_half;
          }
        }
        // the last evaluation is the proposal's: it takes the test rows too
        const bool last = n == n_eval - 1;
        chain_eval<NI, NH, NO, WPC>(s_rows, r0, r1, te_rows, last ? t0 : 0, last ? t1 : 0, w_n,
                                    wb, rec, part, epar, sub, bar_id, lane, gl_n, tr, te);
#pragma unroll
        for (int j = 0; j < PER; ++j) {
          glr_c[j] = gl_n[j];
          if (!warm) {
            const float g_n = gl_n[j] / r.at - w_n[j] / sq;
            p_c[j] = p_c[j] + 0.5f * eps * g_n;
            w_c[j] = w_n[j];
            g_c[j] = g_n;
          }
        }
      }
      float ke = 0.f;
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        ke += m[j] * p_c[j] * p_c[j];
        p_end[j] = p_c[j];
        if (!warm) w_prop[j] = w_c[j];
      }
      const float k_end = 0.5f * cls_warp_sum(ke);
      const float ssq = cls_dot<PER>(w_prop, w_prop);
      const float pr_p = p.prior_const - ssq / (2.f * sq);
      const float ll_p = tr.ll;
      const float log_mh = (ll_p - r.ll) / r.at + (pr_p - r.pr) + (k_init - k_end);
      a = expf(fminf(log_mh, 0.f));
      const bool accept = p.u[kc] < a || warm;
      const int na_before = r.na;
#pragma unroll
      for (int j = 0; j < PER; ++j) w_old[j] = w[j];
      if (accept) {
        cls_take_metrics(r, tr, te, p);
#pragma unroll
        for (int j = 0; j < PER; ++j) {
          w[j] = w_prop[j];
          wl[j] = w_prop[j];
          gl[j] = glr_c[j];
        }
        r.ll = ll_p;
        r.pr = pr_p;
        r.na += 1;
      }
      if (lead) {
        write_trace<W, PER>(p, kc, lane, ll_p, r, na_before, wl);
        if (lane == 0) p.t_traj_len[kc] = l_steps;
      }
    }
    // --- ChEES: Adam on log_traj from the panel's rung means ----------------
    if constexpr (CHEES) {
      if (adapting) {  // uniform over the grid
        auto slot = [&](int chain) -> float* {
          if constexpr (ROUTE == ROUTE_CLUSTER) {
            cg::cluster_group cluster = cg::this_cluster();
            const int cbase = (int)(blockIdx.x - cluster.block_rank());
            float* local = ex_base + (chain % CPB) * 2 * EX + xpar * EX;
            return cluster.map_shared_rank(local, (unsigned)(chain / CPB - cbase));
          } else {
            return exch + ((size_t)chain * 2 + xpar) * EX;
          }
        };
        float* mine = ROUTE == ROUTE_CLUSTER ? ex_base + cl * 2 * EX + xpar * EX
                                             : exch + ((size_t)c * 2 + xpar) * EX;
        if (active && lead) {
          cls_put<PER>(mine, lane, w_prop);
          cls_put<PER>(mine + VEC, lane, w_old);
          if (lane == 0) mine[2 * VEC] = a;
        }
        ex_sync<ROUTE>();
        float g_ch = 0.f, sa = 0.f;
        if (active) {
          float sp[PER], so[PER];
#pragma unroll
          for (int j = 0; j < PER; ++j) sp[j] = so[j] = 0.f;
          for (int t = 0; t < n_lad; ++t) {
            const float* x = slot(rung0 + t * p.rungs);
#pragma unroll
            for (int j = 0; j < PER; ++j) {
              sp[j] += ex_ld<ROUTE>(x + lane + 32 * j);
              so[j] += ex_ld<ROUTE>(x + VEC + lane + 32 * j);
            }
            sa += ex_ld<ROUTE>(x + 2 * VEC);
          }
          float dp = 0.f, dq = 0.f, in = 0.f;
#pragma unroll
          for (int j = 0; j < PER; ++j) {
            const float dxp = w_prop[j] - sp[j] / p.n_ladders_f;
            const float dx = w_old[j] - so[j] / p.n_ladders_f;
            dp += m[j] * dxp * dxp;
            dq += m[j] * dx * dx;
            in += dxp * p_end[j];
          }
          const float dsq = cls_warp_sum(dp) - cls_warp_sum(dq);
          g_ch = a * dsq * cls_warp_sum(in) * u_t;
          if (lead && lane == 0) mine[2 * VEC + 1] = g_ch;
        }
        ex_sync<ROUTE>();
        if (active) {
          float sg = 0.f;
          for (int t = 0; t < n_lad; ++t)
            sg += ex_ld<ROUTE>(slot(rung0 + t * p.rungs) + 2 * VEC + 1);
          const float wsum = fmaxf(sa, 1e-6f);
          const float g_log = sg / wsum * tau_traj;
          const float t_ad = fmaxf((float)(min(i, p.burn_end) - p.warm_end) + 1.f, 1.f);
          m1 = 0.9f * m1 + 0.1f * g_log;
          v2 = 0.999f * v2 + 0.001f * g_log * g_log;
          const float bc1 = 1.f - expf(t_ad * p.log09);
          const float bc2 = 1.f - expf(t_ad * p.log0999);
          lt = lt + p.chees_rate * (m1 / bc1) / (sqrtf(v2 / bc2) + 1e-8f);
        }
        xpar ^= 1;
      }
      if (active) lt = cls_clip(lt, p.log_traj_lo, logf(eps * leap_f));
    }
    // --- Welford and the Robbins-Monro w scale ------------------------------
    if (active) {
      if (adapting) {
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
  }

  if (active && lead) {
    const size_t cw = (size_t)c * W;
    st_vec<W, PER>(p.o_w + cw, lane, w);
    st_vec<W, PER>(p.o_w_last + cw, lane, wl);
    st_vec<W, PER>(p.o_g_like + cw, lane, gl);
    st_vec<W, PER>(p.o_pc_mean + cw, lane, pm);
    st_vec<W, PER>(p.o_pc_m2 + cw, lane, p2);
    if (lane == 0) {
      cls_store_carry(p, r, c);
      if (CHEES) {
        p.o_log_traj[c] = lt;
        p.o_chees_m1[c] = m1;
        p.o_chees_v2[c] = v2;
      }
    }
  }
  if constexpr (ROUTE == ROUTE_CLUSTER) cg::this_cluster().sync();  // keep the slots alive
}

// The generic route: the step of hmc_cls_block_kernel at a runtime (I, H,
// O) (gen_chain.cuh's layout: blockDim.x = 32 g.warps). ROUTE as above.
template <int ROUTE>
__global__ void __launch_bounds__(GEN_THREADS, 1)
    hmc_cls_gen_kernel(const ClsPrecondParams p, const GenShape g, float* exch, float* vdev) {
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
  for (int t = threadIdx.x; t < n_rows * (NI + 1); t += blockDim.x) s_rows[t] = p.rows[t];
  __syncthreads();
  if (!CHEES && !active) return;  // without ChEES no barrier of the block follows

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
  float* gr = m + V;   // the last evaluation's gradient
  float* pc = gr + V;  // the momentum
  float* wo = pc + V;  // the pre-decision w (ChEES)
  float* wn = L.wb;    // the leapfrog position, then the proposal
  ClsCarry r{};
  float lt = 0.f, m1 = 0.f, v2 = 0.f;
  if (active) {
    const size_t cw = (size_t)c * W;
    gen_load(w, p.w + cw, lane, g);
    gen_load(wl, p.w_last + cw, lane, g);
    gen_load(gl, p.g_like + cw, lane, g);
    gen_load(pm, p.pc_mean + cw, lane, g);
    gen_load(p2, p.pc_m2 + cw, lane, g);
    r = cls_load_carry(p, c);
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
          gen_cls_trace(p, W, kc, lane, r.ll, r, r.na, wl);
          if (lane == 0) p.t_traj_len[kc] = 0.f;
        }
        if (CHEES) lt = cls_clip(lt, p.log_traj_lo, logf(eps * leap_f));
        r.lsw = cls_clip(r.lsw, p.log_lo_w, p.log_hi);
      }
      continue;
    }
    const bool warm = i < p.warm_end;
    const bool adapting = i >= p.warm_end && i < p.burn_end;
    float a = 0.f, u_t = 0.f, tau_traj = 0.f;
    if (active) {
      gen_precond(p, p2, m, i, lane, V);
      // --- the trajectory schedule ------------------------------------------
      float l_steps = leap_f;
      if (CHEES) {
        u_t = p.u_traj[k];
        tau_traj = expf(lt) * u_t;
        l_steps = cls_clip(ceilf(tau_traj / eps), 1.f, leap_f);
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
      const float k_init = 0.5f * gen_warp_sum(ki);
      // --- the evaluations: the leapfrog steps', or the warm start's ---------
      if (warm) {
        float t = 0.f;
        for (int e = lane; e < V; e += 32) {
          const float g_cur = gl[e] / r.at - w[e] / sq;
          t += g_cur * g_cur;
        }
        const float g_rms = sqrtf(gen_warp_sum(t) / p.w_size_f);
        const float d = fmaxf(g_rms, 1e-12f);
        for (int e = lane; e < V; e += 32)
          wn[e] = w[e] + p.warmstart_step * (gl[e] / r.at - w[e] / sq) / d;
      }
      GenSums s{0.f, 0.f, 0.f, 0.f, 0.f};
      const int n_eval = warm ? 1 : (int)l_steps;  // leapfrog >= 1
      for (int n = 0; n < n_eval; ++n) {
        if (!warm) {
          for (int e = lane; e < V; e += 32) {
            const float g_c = gr[e] / r.at - wn[e] / sq;
            const float p_half = pc[e] + 0.5f * eps * g_c;
            pc[e] = p_half;
            wn[e] = wn[e] + eps * m[e] * p_half;
          }
        }
        // the last evaluation is the proposal's: it takes the test rows too
        const bool last = n == n_eval - 1;
        gen_eval<false>(g, s_rows, r0, r1, te_rows, last ? t0 : 0, last ? t1 : 0, wn, L.rec,
                        L.part, epar, sub, bar_id, lane, gr, s);
        if (!warm) {
          for (int e = lane; e < V; e += 32) {
            const float g_n = gr[e] / r.at - wn[e] / sq;
            pc[e] = pc[e] + 0.5f * eps * g_n;
          }
        }
      }
      float ke = 0.f;
      for (int e = lane; e < V; e += 32) ke += m[e] * pc[e] * pc[e];
      const float k_end = 0.5f * gen_warp_sum(ke);
      const float ssq = gen_dot(wn, wn, lane, V);
      const float pr_p = p.prior_const - ssq / (2.f * sq);
      const float ll_p = s.tr;
      const float log_mh = (ll_p - r.ll) / r.at + (pr_p - r.pr) + (k_init - k_end);
      a = expf(fminf(log_mh, 0.f));
      const bool accept = p.u[kc] < a || warm;
      const int na_before = r.na;
      if (CHEES && adapting)
        for (int e = lane; e < V; e += 32) wo[e] = w[e];
      if (accept) {
        cls_take_metrics(r, ClsSums{s.tr, s.err2, s.cnt}, ClsSums{0.f, s.te_err2, s.te_cnt}, p);
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
        gen_cls_trace(p, W, kc, lane, ll_p, r, na_before, wl);
        if (lane == 0) p.t_traj_len[kc] = l_steps;
      }
    }
    // --- ChEES: Adam on log_traj from the panel's rung means ----------------
    if constexpr (CHEES) {
      if (adapting)  // uniform over the grid
        gen_chees<ROUTE>(p, g, L, exch, c, active, lead, lane, rung0, n_lad, wn, wo, m, pc, a,
                         u_t, tau_traj, i, xpar, lt, m1, v2);
      if (active) lt = cls_clip(lt, p.log_traj_lo, logf(eps * leap_f));
    }
    // --- Welford and the Robbins-Monro w scale ------------------------------
    if (active) {
      if (adapting) {
        gen_welford(p, w, pm, p2, i, lane, V);
        r.lsw = r.lsw + p.adapt_rate * (a - p.target);
      }
      r.lsw = cls_clip(r.lsw, p.log_lo_w, p.log_hi);
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
      cls_store_carry(p, r, c);
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
  cfg.blockDim = dim3(HMC_CLS_THREADS, 1, 1);
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

template <int NH, int WPC>
static int max_active_clusters(int smem_bytes, int cluster, int* out) {
  auto kern = hmc_cls_block_kernel<4, NH, 3, WPC, ROUTE_CLUSTER>;
  cudaError_t e = set_attributes(kern, smem_bytes, true);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(cluster, smem_bytes, cluster, 0, attr);
  return (int)cudaOccupancyMaxActiveClusters(out, kern, &cfg);
}

template <int NH, int WPC>
static int coop_blocks(int smem_bytes, int* out) {
  auto kern = hmc_cls_block_kernel<4, NH, 3, WPC, ROUTE_GRID>;
  cudaError_t e = set_attributes(kern, smem_bytes, false);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0, dev = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, HMC_CLS_THREADS, smem_bytes);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *out = per_sm * sms;
  return (int)e;
}

template <int NH, int WPC>
static int launch(const ClsPrecondParams* p, float* exch, int smem_bytes, int cluster, int route,
                  cudaStream_t st) {
  constexpr int CPB = BLOCK_WARPS / WPC;
  const int grid = (p->chains + CPB - 1) / CPB;
  if (route == ROUTE_PLAIN && !p->chees) {
    auto kern = hmc_cls_block_kernel<4, NH, 3, WPC, ROUTE_PLAIN>;
    cudaError_t e = set_attributes(kern, smem_bytes, false);
    if (e != cudaSuccess) return (int)e;
    kern<<<grid, HMC_CLS_THREADS, smem_bytes, st>>>(*p, exch);
    return (int)cudaGetLastError();
  }
  if (route == ROUTE_CLUSTER && p->chees) {
    if (cluster < 1 || cluster > HMC_CLS_MAX_CLUSTER || grid % cluster != 0)
      return (int)cudaErrorInvalidValue;
    auto kern = hmc_cls_block_kernel<4, NH, 3, WPC, ROUTE_CLUSTER>;
    cudaError_t e = set_attributes(kern, smem_bytes, true);
    if (e != cudaSuccess) return (int)e;
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = cluster_config(grid, smem_bytes, cluster, st, attr);
    e = cudaLaunchKernelEx(&cfg, kern, *p, exch);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
  }
  if (route == ROUTE_GRID && p->chees && exch != nullptr) {
    auto kern = hmc_cls_block_kernel<4, NH, 3, WPC, ROUTE_GRID>;
    cudaError_t e = set_attributes(kern, smem_bytes, false);
    if (e != cudaSuccess) return (int)e;
    ClsPrecondParams params = *p;
    void* args[] = {(void*)&params, (void*)&exch};
    e = cudaLaunchCooperativeKernel((const void*)kern, dim3(grid), dim3(HMC_CLS_THREADS), args,
                                    (size_t)smem_bytes, st);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" {

int ptnn_hmc_cls_threads() { return HMC_CLS_THREADS; }

int ptnn_hmc_cls_max_cluster() { return HMC_CLS_MAX_CLUSTER; }

// How many clusters of `cluster` blocks of the cluster-route kernel at `wpc`
// warps a chain and `hidden` units (CLS_PRECOND_HIDDEN) the card holds at
// once, into *out; returns the cudaError_t (0 = success).
int ptnn_hmc_cls_max_active_clusters(int wpc, int hidden, int smem_bytes, int cluster,
                                     int* out) {
#define CLS_CASE(NH, WPC) \
  if (hidden == NH && wpc == WPC) return max_active_clusters<NH, WPC>(smem_bytes, cluster, out);
  CLS_PRECOND_CASES
#undef CLS_CASE
  return (int)cudaErrorInvalidValue;
}

// How many blocks of the grid-route kernel at `wpc` warps a chain and
// `hidden` units the card holds at once (blocks an SM times SMs), into
// *out; returns the cudaError_t.
int ptnn_hmc_cls_coop_blocks(int wpc, int hidden, int smem_bytes, int* out) {
#define CLS_CASE(NH, WPC) \
  if (hidden == NH && wpc == WPC) return coop_blocks<NH, WPC>(smem_bytes, out);
  CLS_PRECOND_CASES
#undef CLS_CASE
  return (int)cudaErrorInvalidValue;
}

// Launches ceil(C / (8 / wpc)) blocks of `wpc` warps a chain of the (4,
// `hidden`, 3) network on `stream` by `route`: ROUTE_PLAIN (no ChEES),
// ROUTE_CLUSTER (clusters of `cluster` blocks, one a panel) or ROUTE_GRID
// (cooperative; `exch` holds the (C, 2, EX) slots). Returns the cudaError_t
// of the attribute call or of the launch (0 = success). Does not
// synchronise.
int ptnn_hmc_cls_block(const ClsPrecondParams* p, float* exch, int smem_bytes, int wpc,
                       int hidden, int cluster, int route, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
#define CLS_CASE(NH, WPC) \
  if (hidden == NH && wpc == WPC) return launch<NH, WPC>(p, exch, smem_bytes, cluster, route, st);
  CLS_PRECOND_CASES
#undef CLS_CASE
  return (int)cudaErrorInvalidValue;
}

// The generic route's occupancy: clusters of `cluster` blocks of `threads`
// threads at once, and blocks of the grid route at once, into *out;
// returns the cudaError_t.
int ptnn_hmc_cls_gen_max_active_clusters(int threads, int smem_bytes, int cluster, int* out) {
  return gen_max_active_clusters(hmc_cls_gen_kernel<ROUTE_CLUSTER>, threads, smem_bytes, cluster,
                                 out);
}

int ptnn_hmc_cls_gen_coop_blocks(int threads, int smem_bytes, int* out) {
  return gen_coop_blocks(hmc_cls_gen_kernel<ROUTE_GRID>, threads, smem_bytes, out);
}

// Launches the generic route at the network and layout `g`: ceil(C /
// (g.warps / g.wpc)) blocks of 32 g.warps threads on `stream` by `route`,
// as ptnn_hmc_cls_block; `vdev` holds the warps' vectors where g.vec_dev.
int ptnn_hmc_cls_gen(const ClsPrecondParams* p, const GenShape* g, float* exch, float* vdev,
                     int smem_bytes, int cluster, int route, void* stream) {
  if (!gen_shape_ok(g, vdev) || g->no < 2) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int cpb = g->warps / g->wpc, threads = 32 * g->warps;
  const int grid = (p->chains + cpb - 1) / cpb;
  if (route == ROUTE_PLAIN && !p->chees) {
    auto kern = hmc_cls_gen_kernel<ROUTE_PLAIN>;
    cudaError_t e = gen_set_attributes(kern, smem_bytes, false);
    if (e != cudaSuccess) return (int)e;
    kern<<<grid, threads, smem_bytes, st>>>(*p, *g, exch, vdev);
    return (int)cudaGetLastError();
  }
  if (route == ROUTE_CLUSTER && p->chees) {
    if (cluster < 1 || cluster > HMC_CLS_MAX_CLUSTER || grid % cluster != 0)
      return (int)cudaErrorInvalidValue;
    auto kern = hmc_cls_gen_kernel<ROUTE_CLUSTER>;
    cudaError_t e = gen_set_attributes(kern, smem_bytes, true);
    if (e != cudaSuccess) return (int)e;
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = gen_cluster_config(grid, threads, smem_bytes, cluster, st, attr);
    e = cudaLaunchKernelEx(&cfg, kern, *p, *g, exch, vdev);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
  }
  if (route == ROUTE_GRID && p->chees && exch != nullptr) {
    auto kern = hmc_cls_gen_kernel<ROUTE_GRID>;
    cudaError_t e = gen_set_attributes(kern, smem_bytes, false);
    if (e != cudaSuccess) return (int)e;
    ClsPrecondParams params = *p;
    GenShape shape = *g;
    void* args[] = {(void*)&params, (void*)&shape, (void*)&exch, (void*)&vdev};
    e = cudaLaunchCooperativeKernel((const void*)kern, dim3(grid), dim3(threads), args,
                                    (size_t)smem_bytes, st);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
