// Device code of the generic route of the MALA and HMC block kernels
// (mala_block.cu, hmc_block.cu, mala_cls_block.cu, hmc_cls_block.cu), for
// Hopper (sm_90a): any two-layer sigmoid FNN (I, H, O) whose shape comes at
// run time (`GenShape`), where the fixed-shape instantiations hold a
// compile-time network's weights and vectors in registers.
//
// Layout. A block of `warps` warps (8 down to 1, ops/precond_step.py
// `gen_layout`) holds warps / wpc chains of `wpc` warps each; the data rows
// [x..., y or class] (train, then test) sit in shared memory once a block.
// A chain's vectors of w_size entries sit in slots of VEC = 32 ceil(W / 32)
// floats, lane l owning entries l, l + 32, ..., so elementwise work is
// lane-local and a dot product is a warp reduction (each lane's entries in
// order, then the warp). Every warp of a chain keeps its own copy of the
// chain's vectors (w, w_last, g_like, the Welford buffers, the
// preconditioner, the last gradient, and for HMC the momentum and the
// pre-decision w) and does the same arithmetic in the same order, so the
// copies stay bit-identical. Those `nv` vectors sit in the warp's shared
// slot when eight warps' slots fit a block, else in device memory (`vdev`,
// each warp its own slots, through L1). The point an evaluation takes
// (the proposal, a leapfrog position) always sits in the warp's shared
// evaluation slot, read by the row loop as broadcasts.
//
// An evaluation (`gen_eval`, the port of ptnn/ops/pallas_step.py
// `_fwd_grad_reg` / `_fwd_grad_cls` at a runtime shape, in their summation
// order) splits the train and the test rows into wpc contiguous shares,
// one a warp. A warp takes its train share in tiles of 32 rows, one a lane:
// each lane runs its row's forward and backward and writes the row's
// RECORD [s (H), dh (H), d2 (O), x (I), 1] to the warp's tile in shared
// memory (odd stride, conflict-free); then each lane adds, over the tile's
// rows in order, the products record[ia] * record[ib] of the entries it owns
// (`gen_entry`: dW1_ih = dh_h x_i, dW2_ho = d2_o s_h, dB = -delta) into its
// partial slot. So a lane holds no gradient in registers whatever W is.
// The chain's warps then publish their sums to the slot's tail, meet at a
// named barrier of the chain's warps alone (bar.sync 1 + chain, 32 wpc
// threads; barrier 0 is __syncthreads') and each sums the wpc partials in
// warp order. The slots alternate between two parities. No atomics: every
// run gives the same bits.
//
// What bounds it: per row and evaluation about 2 I H + 4 H O flops of
// forward and backward and 2 W of gradient accumulation, all from shared
// memory; the steps of a chain are serial. Device memory sees the noise,
// the trace rows and, where the plan puts them there, the vectors.
//
// No fast-math: expf, logf, sqrtf and division are the IEEE-rounded
// versions, so a kernel stays within float rounding of its plain version.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#define GEN_PART 8       // floats after the gradient in a partial slot
#define GEN_THREADS 256  // most threads a block: 8 warps
#define GEN_MASK 0xffffffffu

// The network and the layout of a launch (ops/precond_step.py GenShape).
struct GenShape {
  int ni, nh, no;  // the network (I, H, O)
  int w;           // w_size
  int vec;         // floats a chain vector: w rounded up to 32
  int stride;      // odd stride of a row's record [s, dh, d2, x, 1]
  int warps;       // warps a block
  int wpc;         // warps a chain
  int nv;          // vectors a warp keeps outside its evaluation slot
  int vec_dev;     // 1: those vectors in device memory, 0: in shared memory
};

// Sums of one evaluation. Classification: the train ll, err^2 and
// matches, the test err^2 and matches. Regression: the train SSE in `tr`,
// the test SSE in `te_err2`.
struct GenSums {
  float tr, err2, cnt, te_err2, te_cnt;
};

__device__ __forceinline__ float gen_sigmoid(float z) { return 1.0f / (1.0f + expf(-z)); }

__device__ __forceinline__ float gen_clip(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);  // the upper bound wins, as jnp.clip
}

__device__ __forceinline__ float gen_warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(GEN_MASK, v, off);
  return v;
}

__device__ __forceinline__ float gen_dot(const float* a, const float* b, int lane, int vec) {
  float t = 0.f;
  for (int e = lane; e < vec; e += 32) t += a[e] * b[e];
  return gen_warp_sum(t);
}

// Lane-owned entries of a global (W,) vector into a slot; zero past W.
__device__ __forceinline__ void gen_load(float* dst, const float* src, int lane,
                                         const GenShape& g) {
  for (int e = lane; e < g.vec; e += 32) dst[e] = e < g.w ? src[e] : 0.f;
}

__device__ __forceinline__ void gen_store(float* dst, const float* src, int lane,
                                          const GenShape& g) {
  for (int e = lane; e < g.w; e += 32) dst[e] = src[e];
}

__device__ __forceinline__ void gen_chain_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ int gen_rows_floats(int n_rows, int ni) {
  return (n_rows * (ni + 1) + 3) & ~3;  // 16-byte aligned slots follow
}

// This warp's contiguous share [a, b) of n rows among wpc warps.
__device__ __forceinline__ void gen_share(int n, int wpc, int sub, int& a, int& b) {
  const int share = (n + wpc - 1) / wpc;
  a = min(n, sub * share);
  b = min(n, a + share);
}

// A warp's places: its evaluation slot (VEC floats), its record tile (32 x
// STRIDE), its nv vectors (shared or device memory), its chain's partial
// slots (2 parities x wpc x (VEC + GEN_PART)) and the block's exchange
// slots of the ChEES cluster route (after every warp's partials).
struct GenWarp {
  float* wb;
  float* rec;
  float* v;
  float* part;
  float* ex;
};

__device__ __forceinline__ GenWarp gen_warp(float* smem, int row_floats, const GenShape& g,
                                            int warp, float* vdev) {
  const int own = g.vec_dev ? 0 : g.nv * g.vec;
  const int slot = g.vec + 32 * g.stride + own;
  float* base = smem + row_floats + warp * slot;
  float* parts = smem + row_floats + g.warps * slot;
  GenWarp r;
  r.wb = base;
  r.rec = base + g.vec;
  r.v = g.vec_dev ? vdev + ((size_t)blockIdx.x * g.warps + warp) * g.nv * g.vec
                  : base + g.vec + 32 * g.stride;
  r.part = parts + (warp / g.wpc) * 2 * g.wpc * (g.vec + GEN_PART);
  r.ex = parts + g.warps * 2 * (g.vec + GEN_PART);
  return r;
}

// The record fields (ia, ib) whose product, summed over rows, is the
// gradient of entry e < W (negated for the biases). Flat codec [W1 (I x
// H), W2 (H x O, h-major), B1 (H), B2 (O)].
__device__ __forceinline__ void gen_entry(const GenShape& g, int e, int& ia, int& ib) {
  const int NH = g.nh, NO = g.no;
  const int S1 = g.ni * NH, S2 = S1 + NH * NO, B2 = S2 + NH;
  const int ONE = 2 * NH + NO + g.ni;
  if (e < S1) {  // W1[i, h]: dh_h x_i
    ia = NH + e % NH;
    ib = 2 * NH + NO + e / NH;
  } else if (e < S2) {  // W2[h, o]: d2_o s_h
    ia = 2 * NH + (e - S1) % NO;
    ib = (e - S1) / NO;
  } else if (e < B2) {  // B1[h]: -dh_h
    ia = NH + (e - S2);
    ib = ONE;
  } else {  // B2[o]: -d2_o
    ia = 2 * NH + (e - B2);
    ib = ONE;
  }
}

// One evaluation of a chain at the weights in `wb` by one of its wpc warps:
// this warp's train rows [r0, r1) (ll or SSE, metrics and the gradient of
// the log-likelihood, or of -SSE/2 under REG) and test rows [t0, t1)
// (metrics, or SSE), then the chain's sums over its warps, in warp order:
// the gradient into `gout` (lane layout) and the sums into `out`.
template <bool REG>
__device__ __forceinline__ void gen_eval(const GenShape& g, const float* __restrict__ rows, int r0,
                                      int r1, const float* __restrict__ te_rows, int t0, int t1,
                                      const float* wb, float* rec, float* part, int& epar,
                                      int sub, int bar_id, int lane, float* gout, GenSums& out) {
  const int NI = g.ni, NH = g.nh, NO = g.no, W = g.w, ST = g.stride;
  const int S1 = NI * NH, S2 = S1 + NH * NO, B2 = S2 + NH;
  const int D2 = 2 * NH, X0 = 2 * NH + NO, ONE = X0 + NI;
  const int PART = g.vec + GEN_PART;
  float* mine = part + (epar * g.wpc + sub) * PART;
  __syncwarp();  // the weights are written; the last sums are read
  for (int e = lane; e < g.vec; e += 32) mine[e] = 0.f;
  float s0 = 0.f, s1 = 0.f, s2 = 0.f;
  float* my = rec + lane * ST;
  for (int base = r0; base < r1; base += 32) {
    const int r = base + lane;
    if (r < r1) {
      const float* xr = rows + r * (NI + 1);
      for (int i = 0; i < NI; ++i) my[X0 + i] = xr[i];
      my[ONE] = 1.f;
      if constexpr (REG) {
        float o = 0.f;
        for (int h = 0; h < NH; ++h) {
          float z = -wb[S2 + h];
          for (int i = 0; i < NI; ++i) z += my[X0 + i] * wb[i * NH + h];
          const float s = gen_sigmoid(z);
          my[h] = s;
          o += s * wb[S1 + h];
        }
        const float fx = gen_sigmoid(o - wb[B2]);
        const float resid = xr[NI] - fx;
        s0 += resid * resid;
        const float delta = resid * fx * (1.f - fx);
        my[D2] = delta;
        for (int h = 0; h < NH; ++h) {
          const float s = my[h];
          my[NH + h] = delta * wb[S1 + h] * s * (1.f - s);
        }
      } else {
        const int y = (int)xr[NI];
        for (int o = 0; o < NO; ++o) my[D2 + o] = -wb[B2 + o];
        for (int h = 0; h < NH; ++h) {
          float z = -wb[S2 + h];
          for (int i = 0; i < NI; ++i) z += my[X0 + i] * wb[i * NH + h];
          const float s = gen_sigmoid(z);
          my[h] = s;
          for (int o = 0; o < NO; ++o) my[D2 + o] += s * wb[S1 + h * NO + o];
        }
        float mx = 0.f, best = 0.f, picked = 0.f;
        int pred = 0;
        for (int o = 0; o < NO; ++o) {
          const float v = gen_sigmoid(my[D2 + o]);
          my[D2 + o] = v;
          mx = o == 0 ? v : fmaxf(mx, v);
          if (o == 0 || v > best) {  // first argmax
            best = v;
            pred = o;
          }
          picked = (o == y) ? v : picked;
        }
        float se = 0.f;
        for (int o = 0; o < NO; ++o) se += expf(my[D2 + o] - mx);
        const float lse = mx + logf(se);
        s0 += picked - lse;
        const float err = (float)(pred - y);
        s1 += err * err;
        s2 += (pred == y) ? 1.f : 0.f;
        for (int o = 0; o < NO; ++o) {
          const float v = my[D2 + o];
          const float pr = expf(v - lse);
          my[D2 + o] = ((o == y ? 1.f : 0.f) - pr) * v * (1.f - v);
        }
        for (int h = 0; h < NH; ++h) {
          float dh = 0.f;
          for (int o = 0; o < NO; ++o) dh += my[D2 + o] * wb[S1 + h * NO + o];
          const float s = my[h];
          my[NH + h] = dh * s * (1.f - s);
        }
      }
    }
    __syncwarp();
    const int nr = min(32, r1 - base);
    for (int e = lane; e < W; e += 32) {
      int ia, ib;
      gen_entry(g, e, ia, ib);
      float acc = mine[e];
      for (int t = 0; t < nr; ++t) acc += rec[t * ST + ia] * rec[t * ST + ib];
      mine[e] = acc;
    }
    __syncwarp();  // the tile is read before the next one is written
  }
  for (int e = S2 + lane; e < W; e += 32) mine[e] = -mine[e];  // the biases
  // the test share: metrics (or SSE) only
  float te0 = 0.f, te1 = 0.f;
  for (int r = t0 + lane; r < t1; r += 32) {
    const float* xr = te_rows + r * (NI + 1);
    if constexpr (REG) {
      float o = 0.f;
      for (int h = 0; h < NH; ++h) {
        float z = -wb[S2 + h];
        for (int i = 0; i < NI; ++i) z += xr[i] * wb[i * NH + h];
        o += gen_sigmoid(z) * wb[S1 + h];
      }
      const float resid = xr[NI] - gen_sigmoid(o - wb[B2]);
      te0 += resid * resid;
    } else {
      const int y = (int)xr[NI];
      for (int o = 0; o < NO; ++o) my[D2 + o] = -wb[B2 + o];
      for (int h = 0; h < NH; ++h) {
        float z = -wb[S2 + h];
        for (int i = 0; i < NI; ++i) z += xr[i] * wb[i * NH + h];
        const float s = gen_sigmoid(z);
        for (int o = 0; o < NO; ++o) my[D2 + o] += s * wb[S1 + h * NO + o];
      }
      float best = 0.f;
      int pred = 0;
      for (int o = 0; o < NO; ++o) {
        const float v = gen_sigmoid(my[D2 + o]);
        if (o == 0 || v > best) {
          best = v;
          pred = o;
        }
      }
      const float err = (float)(pred - y);
      te0 += err * err;
      te1 += (pred == y) ? 1.f : 0.f;
    }
  }
  s0 = gen_warp_sum(s0);
  s1 = gen_warp_sum(s1);
  s2 = gen_warp_sum(s2);
  te0 = gen_warp_sum(te0);
  te1 = gen_warp_sum(te1);
  if (lane == 0) {
    mine[g.vec] = s0;
    mine[g.vec + 1] = s1;
    mine[g.vec + 2] = s2;
    mine[g.vec + 3] = te0;
    mine[g.vec + 4] = te1;
  }
  // the chain's sum over its warps, in warp order
  if (g.wpc > 1) {
    gen_chain_barrier(bar_id, 32 * g.wpc);
  } else {
    __syncwarp();
  }
  const float* q0 = part + epar * g.wpc * PART;
  for (int e = lane; e < g.vec; e += 32) {
    float v = q0[e];
    for (int w = 1; w < g.wpc; ++w) v += q0[w * PART + e];
    gout[e] = v;
  }
  float t[5];
  for (int j = 0; j < 5; ++j) t[j] = q0[g.vec + j];
  for (int w = 1; w < g.wpc; ++w)
    for (int j = 0; j < 5; ++j) t[j] += q0[w * PART + g.vec + j];
  out = GenSums{t[0], t[1], t[2], t[3], t[4]};
  if (g.wpc > 1) epar ^= 1;  // the next evaluation writes the other parity
  __syncwarp();              // every lane is done reading the weights
}

// The diagonal preconditioner m at step i from the Welford M2: the
// variances over their mean, clipped to [1e-4, 1e4], to precond_power.
template <class P>
__device__ __forceinline__ void gen_precond(const P& p, const float* p2, float* m, int i,
                                            int lane, int vec) {
  if (i < p.pc_start) {
    for (int e = lane; e < vec; e += 32) m[e] = 1.f;
    return;
  }
  const float cnt = (float)max(min(i, p.burn_end) - p.warm_end, 1);
  float t = 0.f;
  for (int e = lane; e < vec; e += 32) t += p2[e] / cnt;
  const float den = fmaxf(gen_warp_sum(t) / p.w_size_f, 1e-30f);
  for (int e = lane; e < vec; e += 32) {
    float v = gen_clip(p2[e] / cnt / den, 1e-4f, 1e4f);
    if (p.precond_power != 1.f) v = powf(v, p.precond_power);
    m[e] = v;
  }
}

// Welford accumulation of the post-decision w into (pm, p2).
template <class P>
__device__ __forceinline__ void gen_welford(const P& p, const float* w, float* pm, float* p2,
                                            int i, int lane, int vec) {
  const float cnt_new = (float)max(min(i + 1, p.burn_end) - p.warm_end, 1);
  for (int e = lane; e < vec; e += 32) {
    const float d = w[e] - pm[e];
    pm[e] = pm[e] + d / cnt_new;
    p2[e] = p2[e] + d * (w[e] - pm[e]);
  }
}

// The ChEES exchange of the generic HMC kernels: ROUTE 1 (cluster: the
// slots in the cluster's shared memory) or 2 (grid: in device memory).
#define GEN_ROUTE_PLAIN 0
#define GEN_ROUTE_CLUSTER 1
#define GEN_ROUTE_GRID 2

template <int ROUTE>
__device__ __forceinline__ float gen_ex_ld(const float* q) {
  if constexpr (ROUTE == GEN_ROUTE_GRID) return __ldcg(q);
  return *q;
}

template <int ROUTE>
__device__ __forceinline__ void gen_ex_sync() {
  namespace cg = cooperative_groups;
  if constexpr (ROUTE == GEN_ROUTE_CLUSTER) {
    cg::this_cluster().sync();
  } else {
    __threadfence();
    cg::this_grid().sync();
  }
}

// One parity of chain `chain`'s exchange slot [w' (VEC), w_old (VEC), a,
// estimator, 2 pad]: in the cluster's shared memory or in `exch`.
template <int ROUTE>
__device__ __forceinline__ float* gen_ex_slot(const GenWarp& L, const GenShape& g, float* exch,
                                              int chain, int par) {
  const int ex = 2 * g.vec + 4;
  if constexpr (ROUTE == GEN_ROUTE_CLUSTER) {
    namespace cg = cooperative_groups;
    const int cpb = g.warps / g.wpc;
    cg::cluster_group cluster = cg::this_cluster();
    const int cbase = (int)(blockIdx.x - cluster.block_rank());
    float* local = L.ex + (chain % cpb) * 2 * ex + par * ex;
    return cluster.map_shared_rank(local, (unsigned)(chain / cpb - cbase));
  } else {
    return exch + ((size_t)chain * 2 + par) * ex;
  }
}

// The ChEES update of one chain: publish (w', w_old, a), the rung means of
// both over the panel's replicas (in replica order), the estimator, its
// rung sum, and Adam on log_traj. Every block of the panel calls it at the
// same steps; `active` is false for the lanes past the last chain.
template <int ROUTE, class P>
__device__ __forceinline__ void gen_chees(const P& p, const GenShape& g, const GenWarp& L,
                                          float* exch, int c, bool active, bool lead, int lane,
                                          int rung0, int n_lad, const float* wprop,
                                          const float* wold, const float* m, const float* pend,
                                          float a, float u_t, float tau_traj, int i, int& xpar,
                                          float& lt, float& m1, float& v2) {
  const int V = g.vec;
  float* mine = gen_ex_slot<ROUTE>(L, g, exch, c, xpar);
  if (active && lead) {
    for (int e = lane; e < V; e += 32) {
      mine[e] = wprop[e];
      mine[V + e] = wold[e];
    }
    if (lane == 0) mine[2 * V] = a;
  }
  gen_ex_sync<ROUTE>();
  if (active) {
    float dp = 0.f, dq = 0.f, in = 0.f, sa = 0.f;
    for (int e = lane; e < V; e += 32) {
      float sp = 0.f, so = 0.f;
      for (int t = 0; t < n_lad; ++t) {
        const float* x = gen_ex_slot<ROUTE>(L, g, exch, rung0 + t * p.rungs, xpar);
        sp += gen_ex_ld<ROUTE>(x + e);
        so += gen_ex_ld<ROUTE>(x + V + e);
      }
      const float dxp = wprop[e] - sp / p.n_ladders_f;
      const float dx = wold[e] - so / p.n_ladders_f;
      dp += m[e] * dxp * dxp;
      dq += m[e] * dx * dx;
      in += dxp * pend[e];
    }
    for (int t = 0; t < n_lad; ++t)
      sa += gen_ex_ld<ROUTE>(gen_ex_slot<ROUTE>(L, g, exch, rung0 + t * p.rungs, xpar) + 2 * V);
    const float dsq = gen_warp_sum(dp) - gen_warp_sum(dq);
    const float g_ch = a * dsq * gen_warp_sum(in) * u_t;
    if (lead && lane == 0) mine[2 * V + 1] = g_ch;
    gen_ex_sync<ROUTE>();
    float sg = 0.f;
    for (int t = 0; t < n_lad; ++t)
      sg += gen_ex_ld<ROUTE>(gen_ex_slot<ROUTE>(L, g, exch, rung0 + t * p.rungs, xpar) + 2 * V +
                             1);
    const float wsum = fmaxf(sa, 1e-6f);
    const float g_log = sg / wsum * tau_traj;
    const float t_ad = fmaxf((float)(min(i, p.burn_end) - p.warm_end) + 1.f, 1.f);
    m1 = 0.9f * m1 + 0.1f * g_log;
    v2 = 0.999f * v2 + 0.001f * g_log * g_log;
    const float bc1 = 1.f - expf(t_ad * p.log09);
    const float bc2 = 1.f - expf(t_ad * p.log0999);
    lt = lt + p.chees_rate * (m1 / bc1) / (sqrtf(v2 / bc2) + 1e-8f);
  } else {
    gen_ex_sync<ROUTE>();
  }
  xpar ^= 1;
}

// Host side: the attributes and launch configuration of a generic kernel.
template <typename K>
static cudaError_t gen_set_attributes(K kern, int smem_bytes, bool cluster) {
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       smem_bytes);
  if (e == cudaSuccess && cluster)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return e;
}

static cudaLaunchConfig_t gen_cluster_config(int grid, int threads, int smem_bytes, int cluster,
                                             cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
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

// A shape the generic kernels take: 1-8 warps a block, wpc dividing them,
// device vectors given where the shape puts them there.
static bool gen_shape_ok(const GenShape* g, const float* vdev) {
  return g->warps >= 1 && g->warps <= GEN_THREADS / 32 && g->wpc >= 1 &&
         g->warps % g->wpc == 0 && g->vec % 32 == 0 && g->vec >= g->w &&
         (!g->vec_dev || vdev != nullptr);
}

template <typename K>
static int gen_max_active_clusters(K kern, int threads, int smem_bytes, int cluster, int* out) {
  cudaError_t e = gen_set_attributes(kern, smem_bytes, true);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = gen_cluster_config(cluster, threads, smem_bytes, cluster, 0, attr);
  return (int)cudaOccupancyMaxActiveClusters(out, kern, &cfg);
}

template <typename K>
static int gen_coop_blocks(K kern, int threads, int smem_bytes, int* out) {
  cudaError_t e = gen_set_attributes(kern, smem_bytes, false);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0, dev = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, smem_bytes);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *out = per_sm * sms;
  return (int)e;
}

// The host-side queries each library exports; the loader checks them
// against ops/precond_step.py. Each .cu includes this header once.
extern "C" {

int ptnn_gen_shape_size() { return (int)sizeof(GenShape); }

int ptnn_gen_part() { return GEN_PART; }

}  // extern "C"
