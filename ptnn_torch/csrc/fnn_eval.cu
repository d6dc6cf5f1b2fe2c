// The FNN evaluation of every chain on one or two row sets (train and test)
// in one launch: the forward pass, the log-likelihood (Gaussian or
// multinomial), the rmse and the accuracy, for Hopper (sm_90a).
//
// Replaces the TPU kernel ptnn/ops/pallas_eval.py `_eval_kernel` (wrapper
// `fnn_eval_pallas`). The plain PyTorch version of the same function is
// `fnn_eval_reference` in ptnn_torch/ops/fnn_eval.py, whose docstring states
// the semantics. The per-step sampler evaluates every proposal on the train
// and the test rows with one launch of it (`fnn_eval_pair`).
//
// What bounds it. A row costs I * H + H * O multiply-adds, H + O sigmoids and
// the loss: at Sunspot's (4, 10, 1) about 100 flops, at Ionosphere's
// (34, 50, 2) about 3,700. A call moves the weights, the rows and three (C,)
// outputs per set: tens of KB. At 10-64 chains and a few hundred rows both
// bounds are below a microsecond, so the time is the launch and the latency
// of the longest chain of dependent work in one block.
//
// Design: spread each (chain, set) over a thread-block cluster, so that 10
// chains fill far more than 10 SMs and no thread walks the whole network.
//   * One cluster of T <= 8 blocks (the portable size) per (chain, set); the
//     grid is chains x sets x T blocks, cluster index chain * sets + set.
//     Block `rank` of the cluster takes the contiguous rows [rank * R,
//     (rank + 1) * R) of its set, R = `tile_rows`.
//   * A block is RG x HG warps. Its rows go in passes of 32 RG, staged
//     transposed in shared memory (stride 32 RG + 1: conflict-free to write
//     and to read); row group g of the pass is lane l of the HG warps of
//     row group g. Those HG warps split the hidden units: warp q of the
//     group takes HPW units from q * HPW (and every HG * HPW after), each
//     with its own accumulator (HPW independent multiply-add chains a lane),
//     reading the weights as broadcasts from the chain's copy in shared
//     memory. Each warp forms its units' share of the O output sums of its
//     lane's row and writes it to a parity-alternating slot; after a block
//     barrier, the group's first warp sums the HG shares in warp order, takes
//     the output sigmoids and the loss, while the others start the next pass.
//     ops/fnn_eval.py `launch_plan` picks T, R, RG and HG.
//   * Sizes: compile-time (I, H, O, HPW) for the bundled networks
//     (FNN_LAYOUTS of fnn_layouts.cuh, the column HPW), so the
//     loops over inputs, units and outputs unroll; any other network runs
//     the generic instantiation (runtime sizes, GEN_HPW units at a time).
//   * Any width (the generic instantiation; `launch_plan` picks the route):
//     fewer row groups where a block's rows do not fit beside the weights;
//     where the weights do not fit even so, they are read from device
//     memory and only the rows are staged; where one row group's rows do not
//     fit either, the inputs are staged `in_tile` at a time, each hidden
//     chunk's sums carried across the input tiles. Past MAX_OUT outputs
//     the outputs go in chunks of MAX_OUT (the hidden units recomputed for
//     each): the loss warp carries a running softmax over the chunks (the
//     largest output, the sum of exp(v - it) rescaled when it grows, the
//     label's output and the first argmax, a later chunk winning only if
//     strictly larger), so ll, rmse and acc see every class.
//   * Sums without atomics: each loss warp's lanes reduce by an xor
//     butterfly, thread 0 adds the row groups' sums in order, and after a
//     cluster barrier rank 0 reads the blocks' sums (SSE; or ll, err^2,
//     matches) through distributed shared memory in rank order and writes
//     ll, rmse and acc. Every run gives the same bits.
//   * A grid of runs (ptnn_torch/sweeps.py): the cells sit on the chain axis,
//     cell-major, `chains_per_cell` chains a cell. Each cell may have its
//     own rows (x and y `x_cell` / `y_cell` floats apart), its own count of
//     valid rows (`cell_rows`; the padding trails and is skipped, exact
//     against ptnn's masked sums) and of real classes (`cell_classes`; the
//     padded class columns trail and take -1e9 before the softmax and the
//     argmax, as ptnn's fill does). A cluster is one (chain, set) still: it finds
//     its cell's rows, takes R = ceil(rows / T) of them a block, and with
//     `cell_rows` (ptnn's masked metrics) divides by the row count where the
//     plain run multiplies by float32(1 / N).
// Registers: __maxnreg__ (eval_maxreg) rather than launch bounds, under
// which ptxas held several instantiations at 64 registers and spilled a few
// bytes (nvcc 12.9, measured on the H100).
// No fast-math: expf, logf and IEEE division. The sums run in another order
// than in the plain version (per warp, per block, then across the cluster),
// so ll rounds differently; rmse and acc of a classification are exact
// functions of the argmax.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "fnn_layouts.cuh"  // FNN_LAYOUTS: the bundled networks and HPW

namespace cg = cooperative_groups;

#define MAX_CLUSTER 8  // blocks of a (chain, set) cluster: the portable size
#define MAX_OUT 32     // outputs a chunk (the per-row output registers)
#define MAX_WARPS 16   // warps a block (RG x HG)
#define TILE 32        // rows of a row group a pass: one a lane
#define GEN_HPW 4      // generic kernel: hidden units a warp takes at a time
#define GEN_WARPS 10   // generic kernel: warps a block, at most (its registers)
#define FULL_MASK 0xffffffffu

struct EvalSet {
  const float* x;  // (N, I), or (G, N, I) with x_cell = N * I
  const float* y;  // (N,) targets, or class indices as floats; or (G, N)
  const int* cell_rows;      // (G,) valid rows of each cell, or null: n_rows
  long long x_cell, y_cell;  // floats from one cell's rows to the next (0: shared)
  float* ll;       // (C,) untempered log-likelihood
  float* rmse;     // (C,)
  float* acc;      // (C,) percent (0 for regression)
  int n_rows;
  int tile_rows;   // rows a block of the cluster takes
  float ll_const;  // -0.5 * N
  float inv_n;     // float32(1 / N)
  float acc_n;     // float32(100 * float32(1 / N))
};

struct EvalParams {
  const float* w;    // (C, W) flat codec [W1 (I x H), W2 (H x O), B1, B2]
  const float* tau;  // (C,) noise variance (regression); null for classification
  const int* cell_classes;  // (G,) real classes of each cell, or null: n_out
  EvalSet set[2];    // the row sets; set[1] unused when n_sets == 1
  int chains, n_sets, n_in, n_hid, n_out, task_cls;
  int chains_per_cell;  // chain c is in cell c / chains_per_cell
  int cluster;     // T: blocks a (chain, set)
  int row_groups;  // RG
  int hid_groups;  // HG: warps of a row group
  int w_global;    // 1: the weights are read from device memory, not staged
  int in_tile;     // inputs staged at a time (n_in, or fewer: tiled inputs)
  int out_chunk;   // outputs a chunk (n_out, or MAX_OUT: chunked outputs)
  float log_2pi;
};

// What a block reads of its (chain, set)'s EvalSet and of its cell, staged
// in shared memory by thread 0: held in registers through the row loop,
// they cost the wide instantiations a second block an SM.
struct SetView {
  const float* x;  // the cell's rows
  const float* y;
  float *ll, *rmse, *acc;
  int n_rows, tile, classes;
  bool divide;  // with cell_rows: ptnn's masked metrics, true divisions
  float ll_const, inv_n, acc_n;
};

// Dynamic shared memory of a block, in floats: the chain's weights (rounded
// up to 4) unless they stay in device memory (w_smem 0), the staged rows
// (in_tile inputs x (32 RG + 1)), their targets (32 RG), two parities of the
// warps' output shares (2 x RG x HG x out_chunk x 32), the row groups' sums
// (4 RG) and the block's (4).
__host__ __device__ inline int eval_smem_floats(int n_in, int n_hid, int n_out, int rg, int hg,
                                                int w_smem, int in_tile, int out_chunk) {
  const int w = n_in * n_hid + n_hid * n_out + n_hid + n_out;
  return (w_smem ? ((w + 3) & ~3) : 0) + in_tile * (TILE * rg + 1) + TILE * rg +
         2 * rg * hg * out_chunk * TILE + 4 * rg + 4;
}

__device__ __forceinline__ float sigmoid_f(float z) { return 1.0f / (1.0f + expf(-z)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL_MASK, v, off);
  return v;
}

// The register cap of an instantiation: 128, the most a 512-thread block
// allows, except where a row group's warps (HG = ceil(H / HPW)) are so many
// that a block of the most row groups fits twice in an SM's 64K registers at
// 88 or more a thread: then that cap, so that the grid's blocks (chains x
// sets x cluster) take one wave of the SMs, not two (Ionosphere's 10 chains:
// 160 blocks of 320 threads; 0.0143 ms a pair at one block an SM, 0.0088 at
// two, measured on the H100). Past 34 inputs the row's accumulators need
// more (bank-additional's (51, 50, 2) spills at 96), so it keeps 128.
//
// The generic instantiation (h == 0) carries a row's running softmax over
// the output chunks and the wide routes' indices beside its 32 output
// registers: at 128 registers it spilled (nvcc 12.9, on the H100), so its
// blocks take at most GEN_WARPS warps and it the registers those leave,
// 200.
constexpr int eval_maxreg(int i, int h, int hpw) {
  if (h == 0) return (65536 / (32 * GEN_WARPS)) & ~7;
  const int hg = (h + hpw - 1) / hpw;
  const int threads = 32 * hg * (MAX_WARPS / hg);
  const int two = (65536 / (2 * threads)) & ~7;
  return i > 34 || two < 88 ? 128 : two;
}

// CI == 0: the generic instantiation (sizes from the parameters). Only it
// takes the wide routes: weights read from device memory (w_global), the
// inputs staged in_tile at a time, the outputs out_chunk at a time.
template <int CI, int CH, int CO, int HPW>
__global__ void __maxnreg__(eval_maxreg(CI, CH, HPW)) fnn_eval_kernel(const EvalParams p) {
  constexpr bool GEN = CI == 0;
  constexpr int MO = GEN ? MAX_OUT : CO;  // bound of the per-row output registers
  const int I = GEN ? p.n_in : CI, H = GEN ? p.n_hid : CH, O = GEN ? p.n_out : CO;
  const int IT = GEN ? p.in_tile : CI;    // inputs staged at a time
  const int OC = GEN ? p.out_chunk : CO;  // outputs a chunk
  const bool tiled = IT < I;
  const bool w_global = GEN && p.w_global;
  const int s1 = I * H, s2 = s1 + H * O, W = s2 + H + O;
  const int RG = p.row_groups, HG = p.hid_groups;
  const int ROWS = TILE * RG, XS = ROWS + 1, NT = RG * HG * 32;
  extern __shared__ float4 smem4[];
  float* s_w = reinterpret_cast<float*>(smem4);
  float* s_x = s_w + (w_global ? 0 : ((W + 3) & ~3));  // s_x[i * XS + r], i < IT
  float* s_y = s_x + IT * XS;
  float* s_part = s_y + ROWS;  // [parity][row group][warp of the group][o][lane]
  float* s_sum = s_part + 2 * RG * HG * OC * TILE;  // [row group][4], then the block's 4

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cs = (int)blockIdx.x / p.cluster;  // chain * n_sets + set
  const int c = cs / p.n_sets;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rg = warp / HG, hg = warp - rg * HG;
  const int row = rg * TILE + lane;  // the lane's row in a pass

  __shared__ SetView sv;
  if (tid == 0) {
    // the set's fields, each selected on its own (a copy of the whole
    // struct would go to local memory)
    const bool first = (cs - c * p.n_sets) == 0;
#define SET(f) (first ? p.set[0].f : p.set[1].f)
    const int cell = c / p.chains_per_cell;
    const int* cell_rows = SET(cell_rows);
    const int n = cell_rows ? cell_rows[cell] : SET(n_rows);
    sv.x = SET(x) + (size_t)cell * SET(x_cell);
    sv.y = SET(y) + (size_t)cell * SET(y_cell);
    sv.ll = SET(ll);
    sv.rmse = SET(rmse);
    sv.acc = SET(acc);
    sv.n_rows = n;
    sv.tile = cell_rows ? (n + p.cluster - 1) / p.cluster : SET(tile_rows);
    sv.classes = p.cell_classes ? p.cell_classes[cell] : O;
    sv.divide = cell_rows != nullptr;
    sv.ll_const = cell_rows ? -0.5f * (float)n : SET(ll_const);
    sv.inv_n = SET(inv_n);
    sv.acc_n = SET(acc_n);
#undef SET
  }
  const float* wc = p.w + (size_t)c * W;
  if (!w_global)
    for (int k = tid; k < W; k += NT) s_w[k] = wc[k];
  const float* wv = w_global ? wc : s_w;  // the weights, staged or not
  __syncthreads();  // sv is set
  const int r_lo = min(sv.n_rows, rank * sv.tile);
  const int r_hi = min(sv.n_rows, r_lo + sv.tile);
  // hidden chunks a warp: the same count for every warp, so that the
  // barriers of the tiled route are uniform; a chunk past H computes nothing
  const int n_hc = (H + HG * HPW - 1) / (HG * HPW);
  const int n_oc = (O + OC - 1) / OC;

  float a0 = 0.f, a1 = 0.f, a2 = 0.f;  // a loss warp's sums: sse | (ll, err^2, matches)
  int par = 0;
  for (int base = r_lo; base < r_hi; base += ROWS) {
    const int len = min(ROWS, r_hi - base);
    const float* xs = sv.x;
    const float* ys = sv.y;
    // stage the pass's rows: every warp is done with the previous pass's
    // (the barrier after their use), and the loss warps read only shares
    // and registers after it; the tiled route stages its inputs below
    if (!tiled) {
      for (int k = tid; k < ROWS * I; k += NT) {
        const int r = k / I, i = k - r * I;
        s_x[i * XS + r] = r < len ? xs[(size_t)base * I + k] : 0.f;
      }
    }
    for (int k = tid; k < ROWS; k += NT) s_y[k] = k < len ? ys[base + k] : 0.f;
    __syncthreads();
    const float y = s_y[row];
    // the loss warp's running softmax of the row over the output chunks:
    // the largest output so far, the sum of exp(v - it), the label's output,
    // and the first argmax (a later class wins only if strictly larger)
    float m_run = 0.f, den = 0.f, sel = 0.f, best = 0.f;
    int pred = 0;

    for (int oc = 0; oc < n_oc; ++oc) {
      const int o0 = oc * OC, on = min(OC, O - o0);
      // this warp's hidden units for the lane's row, and their share of
      // the chunk's output sums
      float out[MO];
#pragma unroll
      for (int o = 0; o < MO; ++o) out[o] = 0.f;
      for (int k = 0; k < n_hc; ++k) {
        const int h0 = (k * HG + hg) * HPW;
        float z[HPW];
#pragma unroll
        for (int j = 0; j < HPW; ++j) z[j] = 0.f;
        if (!tiled) {
          if (h0 < H) {
#pragma unroll
            for (int i = 0; i < I; ++i) {
              const float xi = s_x[i * XS + row];
              const float* wi = wv + i * H + h0;  // past H: other weights, unused
#pragma unroll
              for (int j = 0; j < HPW; ++j) z[j] += xi * wi[j];
            }
          }
        } else {
          for (int i0 = 0; i0 < I; i0 += IT) {
            const int ni = min(IT, I - i0);
            __syncthreads();  // every warp is done with the previous inputs
            for (int q = tid; q < ROWS * ni; q += NT) {
              const int r = q / ni, i = q - r * ni;
              s_x[i * XS + r] = r < len ? xs[(size_t)(base + r) * I + i0 + i] : 0.f;
            }
            __syncthreads();
            if (h0 < H) {
              for (int i = 0; i < ni; ++i) {
                const float xi = s_x[i * XS + row];
                const float* wi = wv + (i0 + i) * H + h0;
#pragma unroll
                for (int j = 0; j < HPW; ++j) z[j] += xi * wi[j];
              }
            }
          }
        }
        if (h0 < H) {
#pragma unroll
          for (int j = 0; j < HPW; ++j) {
            const int h = h0 + j;
            if (h < H) {
              const float hid = sigmoid_f(z[j] - wv[s2 + h]);
#pragma unroll
              for (int o = 0; o < MO; ++o)
                if (o < on) out[o] += hid * wv[s1 + h * O + o0 + o];
            }
          }
        }
      }
      float* group = s_part + (par * RG + rg) * HG * OC * TILE + lane;
      float* mine = group + hg * OC * TILE;
#pragma unroll
      for (int o = 0; o < MO; ++o)
        if (o < on) mine[o * TILE] = out[o];
      __syncthreads();

      // the row group's first warp: the chunk's outputs from the group's
      // shares, in warp order, then the loss
      if (hg == 0 && row < len) {
        if constexpr (GEN) {
          // one output at a time, recomputed where it is read again (the
          // same bits): the generic instantiation keeps no register array
          // of the chunk's outputs
          const float* bias = wv + s2 + H + o0;
          auto output = [&](int o) {
            float t = group[o * TILE];
            for (int u = 1; u < HG; ++u) t += group[(u * OC + o) * TILE];
            float v = sigmoid_f(t - bias[o]);
            // a grid's padded classes out of the softmax and the argmax
            if (p.cell_classes && o0 + o >= 1 && o0 + o >= sv.classes) v = -1e9f;
            return v;
          };
          if (!p.task_cls) {
            const float d = y - output(0);
            a0 += d * d;
          } else {
            const int yi = (int)y;
            float cm = output(0);
            int carg = 0;
            if (yi == o0) sel = cm;
            for (int o = 1; o < on; ++o) {
              const float v = output(o);
              if (v > cm) {
                cm = v;
                carg = o;
              }
              if (o0 + o == yi) sel = v;
            }
            const float m_new = oc == 0 ? cm : fmaxf(m_run, cm);
            float cden = 0.f;
            for (int o = 0; o < on; ++o) cden += expf(output(o) - m_new);
            if (oc == 0) {
              den = cden;
              best = cm;
              pred = carg;
            } else {
              den = den * expf(m_run - m_new) + cden;
              if (cm > best) {
                best = cm;
                pred = o0 + carg;
              }
            }
            m_run = m_new;
          }
        } else {
          float v[MO];
#pragma unroll
          for (int o = 0; o < MO; ++o) {
            if (o < on) {
              float t = group[o * TILE];
              for (int u = 1; u < HG; ++u) t += group[(u * OC + o) * TILE];
              v[o] = sigmoid_f(t - wv[s2 + H + o0 + o]);
            }
          }
          if (!p.task_cls) {
            const float d = y - v[0];
            a0 += d * d;
          } else {
            // a grid's padded classes out of the softmax and the argmax, as
            // ptnn's -1e9 fill takes them (exp(-1e9 - m) is 0)
            if (p.cell_classes) {
              const int ncls = sv.classes;
#pragma unroll
              for (int o = 0; o < MO; ++o)
                if (o < on && o0 + o >= 1 && o0 + o >= ncls) v[o] = -1e9f;
            }
            // the chunk's largest output and its first argmax
            float cm = v[0];
            int carg = 0;
#pragma unroll
            for (int o = 1; o < MO; ++o) {
              if (o < on && v[o] > cm) {
                cm = v[o];
                carg = o;
              }
            }
            const float m_new = oc == 0 ? cm : fmaxf(m_run, cm);
            float cden = 0.f;
#pragma unroll
            for (int o = 0; o < MO; ++o)
              if (o < on) cden += expf(v[o] - m_new);
            const int yi = (int)y;
            if (yi >= o0 && yi < o0 + on) {
#pragma unroll
              for (int o = 0; o < MO; ++o)
                if (o == yi - o0) sel = v[o];
            }
            if (oc == 0) {
              den = cden;
              best = cm;
              pred = carg;
            } else {
              den = den * expf(m_run - m_new) + cden;
              if (cm > best) {
                best = cm;
                pred = o0 + carg;
              }
            }
            m_run = m_new;
          }
        }
      }
      par ^= 1;
    }
    if (p.task_cls && hg == 0 && row < len) {
      const int yi = (int)y;
      a0 += (sel - m_run) - logf(den);
      const float e = (float)pred - y;
      a1 += e * e;
      a2 += pred == yi ? 1.f : 0.f;
    }
  }

  // the row groups' sums, the block's in row-group order, then the
  // cluster's in rank order
  if (hg == 0) {
    a0 = warp_sum(a0);
    a1 = warp_sum(a1);
    a2 = warp_sum(a2);
    if (lane == 0) {
      s_sum[4 * rg] = a0;
      s_sum[4 * rg + 1] = a1;
      s_sum[4 * rg + 2] = a2;
    }
  }
  __syncthreads();
  float* block_sum = s_sum + 4 * RG;
  if (tid == 0) {
    float b0 = s_sum[0], b1 = s_sum[1], b2 = s_sum[2];
    for (int g = 1; g < RG; ++g) {
      b0 += s_sum[4 * g];
      b1 += s_sum[4 * g + 1];
      b2 += s_sum[4 * g + 2];
    }
    block_sum[0] = b0;
    block_sum[1] = b1;
    block_sum[2] = b2;
  }
  cluster.sync();
  if (rank == 0 && tid == 0) {
    float b0 = 0.f, b1 = 0.f, b2 = 0.f;
    for (int q = 0; q < p.cluster; ++q) {
      const float* rs = cluster.map_shared_rank(block_sum, (unsigned)q);
      b0 += rs[0];
      b1 += rs[1];
      b2 += rs[2];
    }
    // with cell_rows: ptnn's masked metrics, true divisions by the count
    const float nf = (float)sv.n_rows;
    if (p.task_cls) {
      sv.ll[c] = b0;
      sv.rmse[c] = sv.divide ? sqrtf(b1 / nf) : sqrtf(b1 * sv.inv_n);
      sv.acc[c] = sv.divide ? 100.f * b2 / nf : b2 * sv.acc_n;
    } else {
      const float tau = p.tau[c];
      sv.ll[c] = sv.ll_const * (p.log_2pi + logf(tau)) - 0.5f * b0 / tau;
      sv.rmse[c] = sv.divide ? sqrtf(b0 / nf) : sqrtf(b0 * sv.inv_n);
      sv.acc[c] = 0.f;
    }
  }
  cluster.sync();  // no block leaves while rank 0 reads its sums
}

template <int CI, int CH, int CO, int HPW>
static int launch(const EvalParams* p, int smem_bytes, cudaStream_t stream) {
  auto kern = fnn_eval_kernel<CI, CH, CO, HPW>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       smem_bytes);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p->chains * p->n_sets * p->cluster, 1, 1);
  cfg.blockDim = dim3(p->row_groups * p->hid_groups * 32, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p->cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, *p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" {

int ptnn_eval_params_size() { return (int)sizeof(EvalParams); }

int ptnn_eval_max_out() { return MAX_OUT; }

int ptnn_eval_max_cluster() { return MAX_CLUSTER; }

int ptnn_eval_max_warps() { return MAX_WARPS; }

int ptnn_eval_gen_warps() { return GEN_WARPS; }

int ptnn_eval_smem_floats(int n_in, int n_hid, int n_out, int rg, int hg, int w_smem,
                          int in_tile, int out_chunk) {
  return eval_smem_floats(n_in, n_hid, n_out, rg, hg, w_smem, in_tile, out_chunk);
}

// Writes FNN_LAYOUTS as (I, H, O, HPW) rows into `out` (room for `n`
// rows); returns the number of rows in the table.
int ptnn_eval_layouts(int* out, int n) {
  int k = 0;
#define ROW(I, H, O, G, HPW) \
  if (k < n) {               \
    out[4 * k] = I;          \
    out[4 * k + 1] = H;      \
    out[4 * k + 2] = O;      \
    out[4 * k + 3] = HPW;    \
  }                          \
  ++k;
  FNN_LAYOUTS(ROW)
#undef ROW
  return k;
}

// Launches chains x n_sets clusters of `cluster` blocks of row_groups x
// hid_groups warps on `stream`: the compile-time layout of the network if
// FNN_LAYOUTS has it and it takes the staged route, else the generic one.
// Returns the cudaError_t of the attribute call or of the launch (0 =
// success). Does not synchronise.
int ptnn_fnn_eval(const EvalParams* p, int smem_bytes, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (p->n_out < 1 || p->n_sets < 1 || p->n_sets > 2 || p->cluster < 1 ||
      p->cluster > MAX_CLUSTER || p->row_groups < 1 || p->hid_groups < 1 ||
      p->row_groups * p->hid_groups > MAX_WARPS || p->chains_per_cell < 1 ||
      p->chains % p->chains_per_cell != 0 || p->in_tile < 1 || p->in_tile > p->n_in ||
      p->out_chunk < 1 || p->out_chunk > MAX_OUT ||
      (p->out_chunk < p->n_out && p->out_chunk != MAX_OUT) ||
      (p->out_chunk > p->n_out))
    return (int)cudaErrorInvalidValue;
  const bool staged = !p->w_global && p->in_tile == p->n_in && p->out_chunk == p->n_out;
#define TRY(I, H, O, G, HPW)                                     \
  if (staged && p->n_in == I && p->n_hid == H && p->n_out == O) \
    return launch<I, H, O, HPW>(p, smem_bytes, s);
  FNN_LAYOUTS(TRY)
#undef TRY
  if (p->row_groups * p->hid_groups > GEN_WARPS) return (int)cudaErrorInvalidValue;
  return launch<0, 0, 0, GEN_HPW>(p, smem_bytes, s);
}

const char* ptnn_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
