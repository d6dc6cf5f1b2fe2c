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
//     the generic instantiation (runtime sizes, GEN_HPW units at a time, at
//     most MAX_OUT outputs).
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
#define MAX_OUT 32     // outputs the kernel takes
#define MAX_WARPS 16   // warps a block (RG x HG)
#define TILE 32        // rows of a row group a pass: one a lane
#define GEN_HPW 4      // generic kernel: hidden units a warp takes at a time
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
// up to 4), the staged rows (I x (32 RG + 1)), their targets (32 RG), two
// parities of the warps' output shares (2 x RG x HG x O x 32), the row
// groups' sums (4 RG) and the block's (4).
__host__ __device__ inline int eval_smem_floats(int n_in, int n_hid, int n_out, int rg, int hg) {
  const int w = n_in * n_hid + n_hid * n_out + n_hid + n_out;
  return ((w + 3) & ~3) + n_in * (TILE * rg + 1) + TILE * rg + 2 * rg * hg * n_out * TILE +
         4 * rg + 4;
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
constexpr int eval_maxreg(int i, int h, int hpw) {
  const int hg = h == 0 ? 1 : (h + hpw - 1) / hpw;
  const int threads = 32 * hg * (MAX_WARPS / hg);
  const int two = (65536 / (2 * threads)) & ~7;
  return h == 0 || i > 34 || two < 88 ? 128 : two;
}

// CI == 0: the generic instantiation (sizes from the parameters).
template <int CI, int CH, int CO, int HPW>
__global__ void __maxnreg__(eval_maxreg(CI, CH, HPW)) fnn_eval_kernel(const EvalParams p) {
  constexpr bool GEN = CI == 0;
  constexpr int MO = GEN ? MAX_OUT : CO;  // bound of the per-row output registers
  const int I = GEN ? p.n_in : CI, H = GEN ? p.n_hid : CH, O = GEN ? p.n_out : CO;
  const int s1 = I * H, s2 = s1 + H * O, W = s2 + H + O;
  const int RG = p.row_groups, HG = p.hid_groups;
  const int ROWS = TILE * RG, XS = ROWS + 1, NT = RG * HG * 32;
  extern __shared__ float4 smem4[];
  float* s_w = reinterpret_cast<float*>(smem4);
  float* s_x = s_w + ((W + 3) & ~3);  // s_x[i * XS + r]
  float* s_y = s_x + I * XS;
  float* s_part = s_y + ROWS;  // [parity][row group][warp of the group][o][lane]
  float* s_sum = s_part + 2 * RG * HG * O * TILE;  // [row group][4], then the block's 4

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
  for (int k = tid; k < W; k += NT) s_w[k] = wc[k];
  __syncthreads();  // sv is set
  const int r_lo = min(sv.n_rows, rank * sv.tile);
  const int r_hi = min(sv.n_rows, r_lo + sv.tile);

  float a0 = 0.f, a1 = 0.f, a2 = 0.f;  // a loss warp's sums: sse | (ll, err^2, matches)
  int par = 0;
  for (int base = r_lo; base < r_hi; base += ROWS) {
    const int len = min(ROWS, r_hi - base);
    const float* xs = sv.x;
    const float* ys = sv.y;
    // stage the pass's rows: every warp is done with the previous pass's
    // (the barrier after their use), and the loss warps read only shares
    // and registers after it
    for (int k = tid; k < ROWS * I; k += NT) {
      const int r = k / I, i = k - r * I;
      s_x[i * XS + r] = r < len ? xs[(size_t)base * I + k] : 0.f;
    }
    for (int k = tid; k < ROWS; k += NT) s_y[k] = k < len ? ys[base + k] : 0.f;
    __syncthreads();
    const float y = s_y[row];

    // this warp's hidden units for the lane's row, and their share of the
    // output sums
    float out[MO];
#pragma unroll
    for (int o = 0; o < MO; ++o) out[o] = 0.f;
    for (int h0 = hg * HPW; h0 < H; h0 += HG * HPW) {
      float z[HPW];
#pragma unroll
      for (int j = 0; j < HPW; ++j) z[j] = 0.f;
#pragma unroll
      for (int i = 0; i < I; ++i) {
        const float xi = s_x[i * XS + row];
        const float* wi = s_w + i * H + h0;  // past H: other weights, unused
#pragma unroll
        for (int j = 0; j < HPW; ++j) z[j] += xi * wi[j];
      }
#pragma unroll
      for (int j = 0; j < HPW; ++j) {
        const int h = h0 + j;
        if (h < H) {
          const float hid = sigmoid_f(z[j] - s_w[s2 + h]);
#pragma unroll
          for (int o = 0; o < MO; ++o)
            if (o < O) out[o] += hid * s_w[s1 + h * O + o];
        }
      }
    }
    float* group = s_part + (par * RG + rg) * HG * O * TILE + lane;
    float* mine = group + hg * O * TILE;
#pragma unroll
    for (int o = 0; o < MO; ++o)
      if (o < O) mine[o * TILE] = out[o];
    __syncthreads();

    // the row group's first warp: the row's outputs from the group's
    // shares, in warp order, then the loss
    if (hg == 0 && row < len) {
      float v[MO];
#pragma unroll
      for (int o = 0; o < MO; ++o) {
        if (o < O) {
          float t = group[o * TILE];
          for (int u = 1; u < HG; ++u) t += group[(u * O + o) * TILE];
          v[o] = sigmoid_f(t - s_w[s2 + H + o]);
        }
      }
      if (!p.task_cls) {
        const float d = y - v[0];
        a0 += d * d;
      } else {
        // a grid's padded classes out of the softmax and the argmax, as
        // ptnn's -1e9 fill takes them (exp(-1e9 - m) is 0)
        if (p.cell_classes) {
          const int oc = sv.classes;
#pragma unroll
          for (int o = 1; o < MO; ++o)
            if (o < O && o >= oc) v[o] = -1e9f;
        }
        // softmax over the sigmoid outputs; first argmax (a later class
        // wins only if strictly larger)
        float m = v[0], best = v[0];
        int pred = 0;
#pragma unroll
        for (int o = 1; o < MO; ++o) {
          if (o < O) {
            m = fmaxf(m, v[o]);
            if (v[o] > best) {
              best = v[o];
              pred = o;
            }
          }
        }
        const int yi = (int)y;
        float den = 0.f, sel = 0.f;
#pragma unroll
        for (int o = 0; o < MO; ++o) {
          if (o < O) {
            den += expf(v[o] - m);
            if (o == yi) sel = v[o];
          }
        }
        a0 += (sel - m) - logf(den);
        const float e = (float)pred - y;
        a1 += e * e;
        a2 += pred == yi ? 1.f : 0.f;
      }
    }
    par ^= 1;
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

int ptnn_eval_smem_floats(int n_in, int n_hid, int n_out, int rg, int hg) {
  return eval_smem_floats(n_in, n_hid, n_out, rg, hg);
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
// FNN_LAYOUTS has it, else the generic one. Returns the cudaError_t of the
// attribute call or of the launch (0 = success). Does not synchronise.
int ptnn_fnn_eval(const EvalParams* p, int smem_bytes, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (p->n_out < 1 || p->n_out > MAX_OUT || p->n_sets < 1 || p->n_sets > 2 ||
      p->cluster < 1 || p->cluster > MAX_CLUSTER || p->row_groups < 1 || p->hid_groups < 1 ||
      p->row_groups * p->hid_groups > MAX_WARPS || p->chains_per_cell < 1 ||
      p->chains % p->chains_per_cell != 0)
    return (int)cudaErrorInvalidValue;
#define TRY(I, H, O, G, HPW)                          \
  if (p->n_in == I && p->n_hid == H && p->n_out == O) \
    return launch<I, H, O, HPW>(p, smem_bytes, s);
  FNN_LAYOUTS(TRY)
#undef TRY
  return launch<0, 0, 0, GEN_HPW>(p, smem_bytes, s);
}

const char* ptnn_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
