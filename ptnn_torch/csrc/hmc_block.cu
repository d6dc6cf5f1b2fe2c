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

#include <cooperative_groups.h>

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

}  // extern "C"
