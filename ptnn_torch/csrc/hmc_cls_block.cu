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
// (4, 12, 3) FNN over the 105 train rows, one after the other: a block
// costs K times the latency of one trajectory. Device memory sees only the
// noise and the trace rows.
//
// Design. The MALA kernel's layout (cls_common.cuh): one warp per chain, 16
// chains per 512-thread block, rows in shared memory, the chain's vectors in
// its warp's slots in the lane layout, the gradient through the per-warp
// record tile. Each warp runs its own chain's leapfrog count and skips the
// trajectory on warm-start and dead steps; ptnn masks lanes past their count
// inside the block's longest trajectory, which is the same arithmetic. The
// proposal's ll, train metrics and gradient are the last leapfrog step's;
// only a live warm-start step evaluates its proposal afresh.
//
// ChEES couples the chains of a panel at every adapting step (the rung means
// of w' and of the pre-decision w, then the rung sums of the acceptance and
// of the estimator), as in hmc_block.cu: a panel (all C <= 128 chains, else
// each run of 128) is one thread-block CLUSTER (4 blocks at the 64-chain
// iris flagship, 8 for a 128-chain panel), whose warps exchange those
// values through distributed shared memory between cluster barriers, summed
// in replica order. The slots alternate between two parities, and blocks
// hold their shared memory until a last cluster barrier. Without ChEES the
// kernel runs no cluster and no barrier after the rows are loaded.

#include <cooperative_groups.h>

#include "cls_common.cuh"

namespace cg = cooperative_groups;

template <int NI, int NH, int NO, bool CHEES>
__global__ void __launch_bounds__(CLS_THREADS, 1) hmc_cls_block_kernel(const ClsPrecondParams p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  using N = ClsNet<NI, NH, NO>;
  constexpr int W = N::W, PER = N::PER, VEC = N::VEC;
  constexpr int EX = 2 * VEC + 4;  // one parity of a chain's exchange slot
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x * CLS_WARPS + warp;
  const bool active = c < p.chains;
  const int n_rows = p.n_tr + p.n_te;
  float* s_rows = smem;
  const int row_floats = cls_rows_floats(n_rows, NI);
  const ClsSlots s = cls_slots<NI, NH, NO>(smem, row_floats, warp);
  float* ex_base = smem + row_floats + CLS_WARPS * cls_warp_floats<NI, NH, NO>();
  cls_load_rows(p, s_rows, NI);
  __syncthreads();
  if (!CHEES && !active) return;  // without ChEES no barrier follows

  const float sq = p.sigma_sq;
  const float leap_f = (float)p.leapfrog;
  const float* te_rows = s_rows + p.n_tr * (NI + 1);
  ClsCarry r{};
  float lt = 0.f, m1 = 0.f, v2 = 0.f;
  if (active) {
    cls_load_chain<W, PER>(p, s, c, lane);
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
  int parity = 0;

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
        cls_write_trace<W, PER>(p, s, kc, lane, r.ll, r, r.na);
        if (lane == 0) p.t_traj_len[kc] = 0.f;
        if (CHEES) lt = cls_clip(lt, p.log_traj_lo, logf(eps * leap_f));
        r.lsw = cls_clip(r.lsw, p.log_lo_w, p.log_hi);
      }
      continue;
    }
    const bool warm = i < p.warm_end;
    const bool adapting = i >= p.warm_end && i < p.burn_end;
    float m[PER], w_prop[PER], w_old[PER], p_end[PER];
    float a = 0.f, u_t = 0.f, tau_traj = 0.f;
    if (active) {
      float w[PER], gl[PER], g_cur[PER];
      cls_precond_diag<PER>(s.p2, i, p, lane, m);
      cls_get<PER>(s.w, lane, w);
      cls_get<PER>(s.gl, lane, gl);
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
      ClsSums tr_c{0.f, 0.f, 0.f};
      const int n_leap = warm ? 0 : (int)l_steps;
      for (int n = 0; n < n_leap; ++n) {
        float w_n[PER], gl_n[PER];
#pragma unroll
        for (int j = 0; j < PER; ++j) {
          const float p_half = p_c[j] + 0.5f * eps * g_c[j];
          p_c[j] = p_half;
          w_n[j] = w_c[j] + eps * m[j] * p_half;
        }
        cls_publish<PER>(s.wb, lane, w_n);
        tr_c = cls_fwd_grad<NI, NH, NO>(s_rows, p.n_tr, s.wb, s.rec, lane, gl_n);
#pragma unroll
        for (int j = 0; j < PER; ++j) {
          const float g_n = gl_n[j] / r.at - w_n[j] / sq;
          p_c[j] = p_c[j] + 0.5f * eps * g_n;
          w_c[j] = w_n[j];
          g_c[j] = g_n;
          glr_c[j] = gl_n[j];
        }
      }
      float ke = 0.f;
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        ke += m[j] * p_c[j] * p_c[j];
        p_end[j] = p_c[j];
        w_prop[j] = w_c[j];
      }
      const float k_end = 0.5f * cls_warp_sum(ke);
      // --- the proposal: the trajectory's end, or the warm start ------------
      ClsSums tr = tr_c;
      if (warm) {
        const float g_rms = sqrtf(cls_dot<PER>(g_cur, g_cur) / p.w_size_f);
        const float d = fmaxf(g_rms, 1e-12f);
#pragma unroll
        for (int j = 0; j < PER; ++j) w_prop[j] = w[j] + p.warmstart_step * g_cur[j] / d;
        cls_publish<PER>(s.wb, lane, w_prop);
        tr = cls_fwd_grad<NI, NH, NO>(s_rows, p.n_tr, s.wb, s.rec, lane, glr_c);
      }
      // s.wb holds w_prop: the last leapfrog step or the warm start wrote it
      const ClsSums te = cls_fwd_metrics<NI, NH, NO>(te_rows, p.n_te, s.wb, lane);
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
        cls_put<PER>(s.w, lane, w_prop);
        cls_put<PER>(s.wl, lane, w_prop);
        cls_put<PER>(s.gl, lane, glr_c);
        r.ll = ll_p;
        r.pr = pr_p;
        r.na += 1;
      }
      cls_write_trace<W, PER>(p, s, kc, lane, ll_p, r, na_before);
      if (lane == 0) p.t_traj_len[kc] = l_steps;
    }
    // --- ChEES: Adam on log_traj from the panel's rung means ----------------
    if constexpr (CHEES) {
      if (adapting) {  // uniform over the grid
        cg::cluster_group cluster = cg::this_cluster();
        const int cbase = (int)(blockIdx.x - cluster.block_rank());
        auto slot = [&](int chain) {  // chain's exchange slot in its block
          float* local = ex_base + (chain % CLS_WARPS) * 2 * EX + parity * EX;
          return cluster.map_shared_rank(local, (unsigned)(chain / CLS_WARPS - cbase));
        };
        float* mine = ex_base + warp * 2 * EX + parity * EX;
        if (active) {
          cls_put<PER>(mine, lane, w_prop);
          cls_put<PER>(mine + VEC, lane, w_old);
          if (lane == 0) mine[2 * VEC] = a;
        }
        cluster.sync();
        float g_ch = 0.f, sa = 0.f;
        if (active) {
          float sp[PER], so[PER];
#pragma unroll
          for (int j = 0; j < PER; ++j) sp[j] = so[j] = 0.f;
          for (int t = 0; t < n_lad; ++t) {
            const float* x = slot(rung0 + t * p.rungs);
#pragma unroll
            for (int j = 0; j < PER; ++j) {
              sp[j] += x[lane + 32 * j];
              so[j] += x[VEC + lane + 32 * j];
            }
            sa += x[2 * VEC];
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
          if (lane == 0) mine[2 * VEC + 1] = g_ch;
        }
        cluster.sync();
        if (active) {
          float sg = 0.f;
          for (int t = 0; t < n_lad; ++t) sg += slot(rung0 + t * p.rungs)[2 * VEC + 1];
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
      if (active) lt = cls_clip(lt, p.log_traj_lo, logf(eps * leap_f));
    }
    // --- Welford and the Robbins-Monro w scale ------------------------------
    if (active) {
      if (adapting) {
        cls_welford<PER>(s, lane, i, p);
        r.lsw = r.lsw + p.adapt_rate * (a - p.target);
      }
      r.lsw = cls_clip(r.lsw, p.log_lo_w, p.log_hi);
    }
  }

  if (active) {
    cls_store_chain<W, PER>(p, s, c, lane);
    if (lane == 0) {
      cls_store_carry(p, r, c);
      if (CHEES) {
        p.o_log_traj[c] = lt;
        p.o_chees_m1[c] = m1;
        p.o_chees_v2[c] = v2;
      }
    }
  }
  if constexpr (CHEES) cg::this_cluster().sync();  // keep the slots alive
}

extern "C" {

// Launches ceil(C / CLS_WARPS) blocks on `stream`, under ChEES in clusters
// of `cluster` blocks (one per panel); returns the cudaError_t of the
// attribute call or of the launch (0 = success). Does not synchronise.
int ptnn_hmc_cls_block(const ClsPrecondParams* p, int smem_bytes, int cluster, void* stream) {
  const int grid = (p->chains + CLS_WARPS - 1) / CLS_WARPS;
  if (!p->chees) {
    auto kern = hmc_cls_block_kernel<4, 12, 3, false>;
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes);
    if (e != cudaSuccess) return (int)e;
    kern<<<grid, CLS_THREADS, smem_bytes, (cudaStream_t)stream>>>(*p);
    return (int)cudaGetLastError();
  }
  auto kern = hmc_cls_block_kernel<4, 12, 3, true>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       smem_bytes);
  if (e != cudaSuccess) return (int)e;
  if (cluster < 1 || grid % cluster != 0) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid, 1, 1);
  cfg.blockDim = dim3(CLS_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, *p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
