// The Langevin-gradient drift: `depth` epochs of per-row delta-rule SGD in
// dataset order, for every chain of the parallel-tempering ladder, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel ptnn/ops/pallas_drift.py `_drift_kernel` (wrapper
// `sgd_epoch_sequential_pallas_impl`). The plain PyTorch version of the same
// function is `sgd_epoch_sequential` in ptnn_torch/ops/drift.py, whose
// docstring states the update.
//
// What bounds it. An epoch is a strictly serial chain of N dependent row
// updates per chain: each row's forward reads the weights the previous row
// wrote. Chains are independent. A row costs (I + O) * H multiply-adds twice
// (forward and update) and H + O sigmoids, a few hundred flops, so at 10-64
// chains the card is nearly empty and the time is N times the latency of one
// row update (forward -> O output sums -> deltas -> updates), not a flop or
// byte rate. Device memory sees the weights once in and once out and the
// rows once per block.
//
// Two kernels, picked by topology (ops/drift.py `variant`):
//
// * The register kernel, `drift_reg_kernel<I, H, O, G>`, built for the
//   topologies of FNN_LAYOUTS (fnn_layouts.cuh: every network the repository
//   bundles), each with its column G.
//   A lane group of G lanes (a power of two) owns one chain, 32 / G chains a
//   warp. Hidden unit h = j * G + g lives on lane g of the group, U =
//   ceil(H / G) units a lane, and the chain's weights stay in registers for
//   the whole launch: each lane holds the W1 column, the B1 entry and the W2
//   row of its units, and every lane holds all O entries of B2. Sizes are
//   compile-time, so every loop over I, O and a lane's units unrolls. Per
//   row: each lane forms its units' activations (the input sum split over
//   up to four accumulators), the O output sums are butterflies over log2 G
//   levels inside the group, independent of each other, so they overlap;
//   every lane then computes the same output deltas from the same bits (an
//   xor butterfly leaves every lane with the same sum) and updates B2 itself,
//   with no barrier and no store. Rows stream through shared-memory tiles
//   that every lane reads in the same order (broadcast reads); where the
//   registers allow, each lane loads row r + 1 while row r computes, which
//   takes the tile load off the row's critical path. Units past H are zero
//   and never updated, so they add exactly 0 to the output sums.
// * The generic kernel, `drift_epoch_kernel`, for any other topology: one
//   warp a chain, runtime loops, the hidden units in chunks of 32 * HPL, a
//   row's hidden activations and output deltas staged in shared memory, so
//   it fits any width. ops/drift.py `plan` (pure Python) lays it out:
//   WARPS chains a block with the weights in shared memory where they fit
//   beside a tile of rows, else fewer chains a block, down to one (and a
//   shorter tile); where one chain's weights do not fit a block, the
//   weights stay in device memory, the (C, W) output buffer the working
//   copy that the epoch updates in place (GLOBAL).
// Either grid runs every chain in one launch; a tile holds up to 64 KB of
// rows, so PenDigit's 7494 rows stream in 12 tiles and any row count is one
// launch.
//
// A grid of runs (ptnn_torch/sweeps.py) is one launch too: its cells sit on
// the chain axis, cell-major, `chains_per_cell` chains a cell, and each
// cell may have its own rows (x and t `x_cell` / `t_cell` floats apart), its
// own count of valid rows (`cell_rows`: the padding trails and is skipped,
// which is exact against ptnn's `lr * 0` update of a padded row), its own
// parameter mask (`w_mask`, {0, 1}: every per-row update is multiplied by
// it, as ptnn's masked scan does, so a masked parameter keeps its 0) and
// each chain its own rate (`lrates`). A block stages one tile of rows for
// all its chains, so a block never holds chains of two cells: the grid is
// cells x ceil(chains_per_cell / chains a block) blocks. One dataset for
// every chain is the grid of one cell. Two launches per Langevin step (the drift at w, then at the
// proposal) cannot merge: the second input depends on the first output.
//
// No fast-math: expf and IEEE division, so the result stays within float
// rounding of the plain version (the sums run in another order).
//
// Registers: each kernel states __maxnreg__(255) rather than launch bounds.
// Under launch bounds alone ptxas held several instantiations at 64, 72 or
// 128 registers and spilled a few bytes (nvcc 12.9, measured on the H100);
// a block is at most 128 threads, so 255 registers a thread always fit.

#include <cuda_runtime.h>

#include "fnn_layouts.cuh"  // FNN_LAYOUTS: the bundled networks and G

#define WARPS 4  // generic kernel: the most chains a block
#define HPL 4  // generic kernel: hidden units a lane in a chunk of the forward
#define REG_THREADS 128  // register kernel: threads per block
#define FULL_MASK 0xffffffffu

struct DriftParams {
  const float* w;        // (C, W) flat codec [W1 (I x H), W2 (H x O), B1, B2]
  const float* x;        // (N, I), or (G, N, I) with x_cell = N * I
  const float* t;        // (N, O) delta-rule targets, or (G, N, O)
  float* o_w;            // (C, W)
  const float* lrates;   // (C,) a rate a chain, or null: lrate for every chain
  const int* cell_rows;  // (G,) valid rows of each cell, or null: n_rows
  const float* w_mask;   // (G, W) {0, 1} parameter mask of each cell, or null
  long long x_cell, t_cell;  // floats from one cell's rows to the next (0: shared)
  int chains, n_rows, n_in, n_hid, n_out, depth, tile_rows;
  int cells, chains_per_cell;  // chain c is in cell c / chains_per_cell
  int warps;     // generic kernel: chains a block, 1..WARPS
  int w_global;  // generic kernel: 1 = the weights stay in device memory
  float lrate;
};

// The block's cell and the chain of one of its slots: blocks of a cell are
// consecutive, `per_block` chain slots each.
struct CellSlot {
  int cell, chain;
  bool live;
};

__device__ __forceinline__ CellSlot cell_slot(int chains_per_cell, int per_block, int slot) {
  const int bpc = (chains_per_cell + per_block - 1) / per_block;
  const int cell = (int)blockIdx.x / bpc;
  const int k = ((int)blockIdx.x - cell * bpc) * per_block + slot;
  return {cell, cell * chains_per_cell + k, k < chains_per_cell};
}

__device__ __forceinline__ float sigmoid_f(float z) {
  return 1.0f / (1.0f + expf(-z));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL_MASK, v, off);
  return v;
}

// The generic kernel: one warp a chain, `warps` chains a block. GLOBAL:
// the weights stay in device memory, in the flat codec, with the output
// buffer as the working copy; else they are staged in shared memory, W2
// transposed. A row's hidden activations and output deltas are staged in
// shared memory (H + O floats a chain), so no register holds a whole layer
// and any width runs: the forward takes the hidden units in chunks of
// 32 * HPL (HPL independent sums a lane), the O output sums reduce over the
// warp one by one, and only then, with every output delta known, does the
// second pass over the units form each hidden delta from W2 before its
// update and update W2, W1 and B1. Lane l owns the units h = l + 32 k in
// both passes, so no lane reads a unit another lane writes.
template <bool GLOBAL>
__global__ void __maxnreg__(255) drift_epoch_kernel(const DriftParams p) {
  extern __shared__ float smem[];
  const int I = p.n_in, H = p.n_hid, O = p.n_out;
  const int W = I * H + H * O + H + O;
  const int stride = I + O;
  const int nt = p.warps * 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const CellSlot cs = cell_slot(p.chains_per_cell, p.warps, warp);
  const int c = cs.chain;
  const bool live = cs.live;
  const int n_rows = p.cell_rows ? p.cell_rows[cs.cell] : p.n_rows;
  const float* xg = p.x + (size_t)cs.cell * p.x_cell;
  const float* tg = p.t + (size_t)cs.cell * p.t_cell;
  const bool masked = p.w_mask != nullptr;
  const int s1 = I * H, s2 = s1 + H * O;
  float* s_tile = smem;  // tile_rows x (I + O)
  // the cell's parameter mask, in the layout of the weights (staged only
  // beside staged weights)
  float* s_mask = s_tile + p.tile_rows * stride;
  const int per_chain = (GLOBAL ? 0 : W) + H + O;
  float* s_chain = s_mask + (masked && !GLOBAL ? W : 0) + warp * per_chain;
  float* s_hid = s_chain + (GLOBAL ? 0 : W);  // the row's hidden activations
  float* s_od = s_hid + H;                    // and output deltas
  const float lr = p.lrates ? p.lrates[live ? c : 0] : p.lrate;
  // W1[i, h] = w1[i * H + h], B1 = b1, W2[h, o] = w2[o * o_step + h *
  // h_step], B2 = b2; the mask alike (m1, mb1, m2, mb2)
  float *w1, *b1, *w2, *b2;
  const float *m1 = nullptr, *mb1 = nullptr, *m2 = nullptr, *mb2 = nullptr;
  int o_step, h_step;
  const float* mc = masked ? p.w_mask + (size_t)cs.cell * W : nullptr;
  if (GLOBAL) {
    w1 = p.o_w + (size_t)(live ? c : 0) * W;
    w2 = w1 + s1;
    b1 = w1 + s2;
    b2 = b1 + H;
    o_step = 1;
    h_step = O;
    if (masked) {
      m1 = mc;
      m2 = mc + s1;
      mb1 = mc + s2;
      mb2 = mb1 + H;
    }
  } else {
    w1 = s_chain;
    b1 = w1 + s1;
    w2 = b1 + H;
    b2 = w2 + O * H;
    o_step = H;
    h_step = 1;
    if (masked) {
      for (int k = threadIdx.x; k < s1; k += nt) s_mask[k] = mc[k];
      for (int k = threadIdx.x; k < H; k += nt) s_mask[s1 + k] = mc[s2 + k];
      for (int k = threadIdx.x; k < H * O; k += nt)
        s_mask[s1 + H + (k % O) * H + k / O] = mc[s1 + k];
      for (int k = threadIdx.x; k < O; k += nt) s_mask[s1 + H + O * H + k] = mc[s2 + H + k];
      m1 = s_mask;
      mb1 = m1 + s1;
      m2 = mb1 + H;
      mb2 = m2 + O * H;
    }
  }
  if (live) {
    const float* wc = p.w + (size_t)c * W;
    if (GLOBAL) {
      for (int k = lane; k < W; k += 32) w1[k] = wc[k];
    } else {
      for (int k = lane; k < s1; k += 32) w1[k] = wc[k];
      for (int k = lane; k < H * O; k += 32) w2[(k % O) * H + k / O] = wc[s1 + k];
      for (int k = lane; k < H; k += 32) b1[k] = wc[s2 + k];
      for (int k = lane; k < O; k += 32) b2[k] = wc[s2 + H + k];
    }
  }

  const int total = n_rows * p.depth;  // < 2^31 (ops/drift.py checks)
  for (int base = 0; base < total; base += p.tile_rows) {
    const int len = min(total - base, p.tile_rows);
    __syncthreads();  // the previous tile is consumed (and the weights loaded)
    for (int k = threadIdx.x; k < len * stride; k += nt) {
      const int r = k / stride, f = k - r * stride;
      const int n = (base + r) % n_rows;
      s_tile[k] = f < I ? xg[(size_t)n * I + f] : tg[(size_t)n * O + (f - I)];
    }
    __syncthreads();  // the tile is visible
    if (!live) continue;

    for (int r = 0; r < len; ++r) {
      const float* xr = s_tile + r * stride;
      const float* tr = xr + I;
      // forward: the hidden units in chunks of 32 HPL
      for (int h0 = 0; h0 < H; h0 += 32 * HPL) {
        float z[HPL];
#pragma unroll
        for (int j = 0; j < HPL; ++j) z[j] = 0.f;
        for (int i = 0; i < I; ++i) {
          const float xi = xr[i];
          const float* wi = w1 + i * H + h0 + lane;
#pragma unroll
          for (int j = 0; j < HPL; ++j)
            if (h0 + lane + 32 * j < H) z[j] += xi * wi[32 * j];
        }
#pragma unroll
        for (int j = 0; j < HPL; ++j) {
          const int h = h0 + lane + 32 * j;
          if (h < H) s_hid[h] = sigmoid_f(z[j] - b1[h]);
        }
      }
      // the O output sums over the warp, each output's delta and B2
      for (int o = 0; o < O; ++o) {
        float part = 0.f;
        for (int h = lane; h < H; h += 32) part += s_hid[h] * w2[o * o_step + h * h_step];
        const float bo = b2[o];
        const float out = sigmoid_f(warp_sum(part) - bo);
        const float od = (tr[o] - out) * out * (1.0f - out);
        __syncwarp();  // every lane has read B2[o]
        if (lane == 0) {
          s_od[o] = od;
          b2[o] = bo + lr * (masked ? -od * mb2[o] : -od);
        }
      }
      __syncwarp();  // the deltas are visible
      // the hidden deltas (W2 before this row's update), then the updates
      for (int h = lane; h < H; h += 32) {
        const float hv = s_hid[h];
        float hd = 0.f;
        for (int o = 0; o < O; ++o) {
          const int k = o * o_step + h * h_step;
          const float wv = w2[k], odv = s_od[o];
          hd += wv * odv;
          const float u = hv * odv;
          w2[k] = wv + lr * (masked ? u * m2[k] : u);
        }
        const float d = hd * hv * (1.0f - hv);
        for (int i = 0; i < I; ++i) {
          const float u = xr[i] * d;
          w1[i * H + h] += lr * (masked ? u * m1[i * H + h] : u);
        }
        b1[h] += lr * (masked ? -d * mb1[h] : -d);
      }
      __syncwarp();  // B2 and the deltas are read before the next row writes them
    }
  }

  if (live && !GLOBAL) {
    __syncwarp();
    float* oc = p.o_w + (size_t)c * W;
    for (int k = lane; k < s1; k += 32) oc[k] = w1[k];
    for (int k = lane; k < H * O; k += 32) oc[s1 + k] = w2[(k % O) * H + k / O];
    for (int k = lane; k < H; k += 32) oc[s2 + k] = b1[k];
    for (int k = lane; k < O; k += 32) oc[s2 + H + k] = b2[k];
  }
}


// ---------------------------------------------------------------------------
// The register kernel.

template <int I, int O, int U>
struct RegRow {
  // Registers a lane holds for the weights and the row; above this budget
  // the next row is read from shared memory at the top of each row instead
  // of being prefetched into registers.
  static constexpr int WEIGHTS = U * (I + 1 + O) + O;
  static constexpr bool PREFETCH = WEIGHTS + 2 * (I + O) <= 160;
  static constexpr int ACCS = I >= 16 ? 4 : (I >= 8 ? 2 : 1);
};

template <int I, int O>
__device__ __forceinline__ void load_row(const float* __restrict__ src, float (&x)[I + O]) {
#pragma unroll
  for (int f = 0; f < I + O; ++f) x[f] = src[f];
}

// MASKED: the parameter mask of the block's cell is staged in shared memory
// after the row tile, in the flat codec's layout, and read at every update
// through a volatile pointer, so that the compiler cannot hold it in
// registers (the unmasked instantiation is the kernel without it).
template <int I, int H, int O, int G, bool MASKED>
__global__ void __maxnreg__(255) drift_reg_kernel(const DriftParams p) {
  static_assert(G >= 1 && G <= 32 && (G & (G - 1)) == 0, "G is a power of two <= 32");
  constexpr int U = (H + G - 1) / G;  // hidden units a lane
  constexpr int CPB = REG_THREADS / G;  // chains a block
  constexpr int S1 = I * H, S2 = S1 + H * O, W = S2 + H + O;
  constexpr int STRIDE = I + O;
  using R = RegRow<I, O, U>;
  constexpr int NA = R::ACCS;
  extern __shared__ float s_tile[];  // tile_rows x (I + O)
  const int g = threadIdx.x % G;
  const CellSlot cs = cell_slot(p.chains_per_cell, CPB, threadIdx.x / G);
  const int c = cs.chain;
  const bool live = cs.live;
  const int n_rows = p.cell_rows ? p.cell_rows[cs.cell] : p.n_rows;
  const float* xg = p.x + (size_t)cs.cell * p.x_cell;
  const float* tg = p.t + (size_t)cs.cell * p.t_cell;
  const float lr = p.lrates ? p.lrates[live ? c : 0] : p.lrate;

  float w1[U][I], b1[U], w2[U][O], b2[O];
  const float* wc = p.w + (size_t)(live ? c : 0) * W;
#pragma unroll
  for (int j = 0; j < U; ++j) {
    const int h = j * G + g;
    const bool own = live && h < H;
#pragma unroll
    for (int i = 0; i < I; ++i) w1[j][i] = own ? wc[i * H + h] : 0.f;
    b1[j] = own ? wc[S2 + h] : 0.f;
#pragma unroll
    for (int o = 0; o < O; ++o) w2[j][o] = own ? wc[S1 + h * O + o] : 0.f;
  }
#pragma unroll
  for (int o = 0; o < O; ++o) b2[o] = live ? wc[S2 + H + o] : 0.f;
  volatile float* s_mask = s_tile + p.tile_rows * STRIDE;  // W floats (MASKED)
  if constexpr (MASKED) {
    const float* mc = p.w_mask + (size_t)cs.cell * W;
    for (int k = threadIdx.x; k < W; k += REG_THREADS) s_mask[k] = mc[k];
  }

  const int total = n_rows * p.depth;  // < 2^31 (ops/drift.py checks)
  for (int base = 0; base < total; base += p.tile_rows) {
    const int len = min(total - base, p.tile_rows);
    __syncthreads();  // the previous tile is consumed
    for (int k = threadIdx.x; k < len * STRIDE; k += REG_THREADS) {
      const int r = k / STRIDE, f = k - r * STRIDE;
      const int n = (base + r) % n_rows;
      s_tile[k] = f < I ? xg[(size_t)n * I + f] : tg[(size_t)n * O + (f - I)];
    }
    __syncthreads();  // the tile is visible

    float x[STRIDE];  // the row: inputs, then targets
    load_row<I, O>(s_tile, x);
    for (int r = 0; r < len; ++r) {
      float nx[STRIDE];
      if constexpr (R::PREFETCH) {
        load_row<I, O>(s_tile + (r + 1 < len ? r + 1 : r) * STRIDE, nx);
      } else if (r > 0) {
        load_row<I, O>(s_tile + r * STRIDE, x);
      }
      // forward: this lane's hidden units
      float hid[U];
#pragma unroll
      for (int j = 0; j < U; ++j) {
        float acc[NA];
#pragma unroll
        for (int a = 0; a < NA; ++a) acc[a] = 0.f;
#pragma unroll
        for (int i = 0; i < I; ++i) acc[i % NA] += x[i] * w1[j][i];
        float z = acc[0];
        if constexpr (NA == 2) z = acc[0] + acc[1];
        if constexpr (NA == 4) z = (acc[0] + acc[1]) + (acc[2] + acc[3]);
        hid[j] = sigmoid_f(z - b1[j]);
      }
      // the O output sums: independent butterflies over the group
      float od[O];
#pragma unroll
      for (int o = 0; o < O; ++o) {
        float part = 0.f;
#pragma unroll
        for (int j = 0; j < U; ++j) part += hid[j] * w2[j][o];
#pragma unroll
        for (int off = G / 2; off > 0; off >>= 1) part += __shfl_xor_sync(FULL_MASK, part, off);
        const float out = sigmoid_f(part - b2[o]);
        od[o] = (x[I + o] - out) * out * (1.0f - out);
      }
      // hidden deltas (W2 before this row's update), then the updates
#pragma unroll
      for (int j = 0; j < U; ++j) {
        float hd = 0.f;
#pragma unroll
        for (int o = 0; o < O; ++o) hd += w2[j][o] * od[o];
        const float d = hd * hid[j] * (1.0f - hid[j]);
        if (j * G + g < H) {
#pragma unroll
          for (int o = 0; o < O; ++o) {
            float u = hid[j] * od[o];
            if constexpr (MASKED) u *= s_mask[S1 + (j * G + g) * O + o];
            w2[j][o] += lr * u;
          }
#pragma unroll
          for (int i = 0; i < I; ++i) {
            float u = x[i] * d;
            if constexpr (MASKED) u *= s_mask[i * H + j * G + g];
            w1[j][i] += lr * u;
          }
          float u = -d;
          if constexpr (MASKED) u *= s_mask[S2 + j * G + g];
          b1[j] += lr * u;
        }
      }
#pragma unroll
      for (int o = 0; o < O; ++o) {
        float u = -od[o];
        if constexpr (MASKED) u *= s_mask[S2 + H + o];
        b2[o] += lr * u;
      }
      if constexpr (R::PREFETCH) {
#pragma unroll
        for (int f = 0; f < STRIDE; ++f) x[f] = nx[f];
      }
    }
  }

  if (live) {
    float* oc = p.o_w + (size_t)c * W;
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const int h = j * G + g;
      if (h < H) {
#pragma unroll
        for (int i = 0; i < I; ++i) oc[i * H + h] = w1[j][i];
        oc[S2 + h] = b1[j];
#pragma unroll
        for (int o = 0; o < O; ++o) oc[S1 + h * O + o] = w2[j][o];
      }
    }
    if (g == 0) {
#pragma unroll
      for (int o = 0; o < O; ++o) oc[S2 + H + o] = b2[o];
    }
  }
}

template <int I, int H, int O, int G, bool MASKED>
static int launch_reg(const DriftParams* p, int smem_bytes, cudaStream_t stream) {
  auto kern = drift_reg_kernel<I, H, O, G, MASKED>;
  if (smem_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  constexpr int CPB = REG_THREADS / G;
  const int blocks = p->cells * ((p->chains_per_cell + CPB - 1) / CPB);
  kern<<<blocks, REG_THREADS, smem_bytes, stream>>>(*p);
  return (int)cudaGetLastError();
}

extern "C" {

int ptnn_drift_params_size() { return (int)sizeof(DriftParams); }

int ptnn_drift_warps() { return WARPS; }

int ptnn_drift_hid_per_lane() { return HPL; }

int ptnn_drift_reg_threads() { return REG_THREADS; }

// Writes the register layouts, four ints each (I, H, O, G), into `out`
// (room for `max` of them); returns how many there are.
int ptnn_drift_reg_layouts(int* out, int max) {
  int n = 0;
#define PUT(I, H, O, G, HPW)                                                   \
  if (n < max) {                                                               \
    out[4 * n] = I; out[4 * n + 1] = H; out[4 * n + 2] = O; out[4 * n + 3] = G; \
  }                                                                            \
  ++n;
  FNN_LAYOUTS(PUT)
#undef PUT
  return n;
}

// Launches the register kernel of (n_in, n_hid, n_out) with its lane-group
// size (the masked instantiation when w_mask is set): cells x
// ceil(chains_per_cell / (REG_THREADS / G)) blocks on `stream`. Returns
// cudaErrorInvalidValue for a topology that is not instantiated, else the
// cudaError_t of the attribute call or of the launch (0 = success). Does
// not synchronise.
int ptnn_drift_epoch_reg(const DriftParams* p, int smem_bytes, void* stream) {
  if (p->cells < 1 || p->chains_per_cell < 1 || p->cells * p->chains_per_cell != p->chains)
    return (int)cudaErrorInvalidValue;
#define TRY(I, H, O, G, HPW)                                                      \
  if (p->n_in == I && p->n_hid == H && p->n_out == O)                             \
    return p->w_mask ? launch_reg<I, H, O, G, true>(p, smem_bytes, (cudaStream_t)stream) \
                     : launch_reg<I, H, O, G, false>(p, smem_bytes, (cudaStream_t)stream);
  FNN_LAYOUTS(TRY)
#undef TRY
  return (int)cudaErrorInvalidValue;
}

// Launches the generic kernel: cells x ceil(chains_per_cell / warps)
// blocks of `warps` warps on `stream`, the weights in shared memory or, with
// w_global, in device memory (the output buffer); returns the cudaError_t of
// the attribute call or of the launch (0 = success). Does not synchronise.
int ptnn_drift_epoch(const DriftParams* p, int smem_bytes, void* stream) {
  if (p->cells < 1 || p->chains_per_cell < 1 || p->cells * p->chains_per_cell != p->chains ||
      p->warps < 1 || p->warps > WARPS)
    return (int)cudaErrorInvalidValue;
  auto kern = p->w_global ? drift_epoch_kernel<true> : drift_epoch_kernel<false>;
  if (smem_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = p->cells * ((p->chains_per_cell + p->warps - 1) / p->warps);
  kern<<<blocks, p->warps * 32, smem_bytes, (cudaStream_t)stream>>>(*p);
  return (int)cudaGetLastError();
}

const char* ptnn_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
