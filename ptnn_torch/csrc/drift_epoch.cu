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
// * The generic kernel, `drift_epoch_kernel`, for any other topology with
//   H <= 32 * HPL: one warp per chain, WARPS chains a block, the weights in
//   shared memory and runtime loops.
//
// Either grid runs every chain in one launch; a tile holds up to 64 KB of
// rows, so PenDigit's 7494 rows stream in 12 tiles and any row count is one
// launch. Two launches per Langevin step (the drift at w, then at the
// proposal) cannot merge: the second input depends on the first output.
//
// No fast-math: expf and IEEE division, so the result stays within float
// rounding of the plain version (the sums run in another order).

#include <cuda_runtime.h>

#include "fnn_layouts.cuh"  // FNN_LAYOUTS: the bundled networks and G

#define WARPS 4  // generic kernel: chains per block
#define THREADS (WARPS * 32)
#define HPL 4  // generic kernel: hidden units per lane, n_hid <= 32 * HPL
#define REG_THREADS 128  // register kernel: threads per block
#define FULL_MASK 0xffffffffu

struct DriftParams {
  const float* w;  // (C, W) flat codec [W1 (I x H), W2 (H x O), B1, B2]
  const float* x;  // (N, I)
  const float* t;  // (N, O) delta-rule targets
  float* o_w;      // (C, W)
  int chains, n_rows, n_in, n_hid, n_out, depth, tile_rows;
  float lrate;
};

__device__ __forceinline__ float sigmoid_f(float z) {
  return 1.0f / (1.0f + expf(-z));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL_MASK, v, off);
  return v;
}

__global__ void __launch_bounds__(THREADS) drift_epoch_kernel(const DriftParams p) {
  extern __shared__ float smem[];
  const int I = p.n_in, H = p.n_hid, O = p.n_out;
  const int W = I * H + H * O + H + O;
  const int stride = I + O;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x * WARPS + warp;
  const bool live = c < p.chains;
  const int s1 = I * H, s2 = s1 + H * O;
  float* s_tile = smem;  // tile_rows x (I + O)
  float* s_w1 = s_tile + p.tile_rows * stride + warp * W;
  float* s_b1 = s_w1 + I * H;
  float* s_w2t = s_b1 + H;  // s_w2t[o * H + h] = W2[h, o]
  float* s_b2 = s_w2t + O * H;
  const float lr = p.lrate;

  if (live) {
    const float* wc = p.w + (size_t)c * W;
    for (int k = lane; k < s1; k += 32) s_w1[k] = wc[k];
    for (int k = lane; k < H * O; k += 32) s_w2t[(k % O) * H + k / O] = wc[s1 + k];
    for (int k = lane; k < H; k += 32) s_b1[k] = wc[s2 + k];
    for (int k = lane; k < O; k += 32) s_b2[k] = wc[s2 + H + k];
  }

  const long total = (long)p.n_rows * p.depth;
  for (long base = 0; base < total; base += p.tile_rows) {
    const int len = total - base < p.tile_rows ? (int)(total - base) : p.tile_rows;
    __syncthreads();  // the previous tile is consumed (and the weights loaded)
    for (int k = threadIdx.x; k < len * stride; k += THREADS) {
      const int r = k / stride, f = k - r * stride;
      const long n = (base + r) % p.n_rows;
      s_tile[k] = f < I ? p.x[n * I + f] : p.t[n * O + (f - I)];
    }
    __syncthreads();  // the tile is visible
    if (!live) continue;

    for (int r = 0; r < len; ++r) {
      const float* xr = s_tile + r * stride;
      const float* tr = xr + I;
      float hid[HPL], hd[HPL];
#pragma unroll
      for (int j = 0; j < HPL; ++j) {
        const int h = lane + 32 * j;
        hid[j] = 0.f;
        hd[j] = 0.f;
        if (h < H) {
          float z = 0.f;
          for (int i = 0; i < I; ++i) z += xr[i] * s_w1[i * H + h];
          hid[j] = sigmoid_f(z - s_b1[h]);
        }
      }
      for (int o = 0; o < O; ++o) {
        float part = 0.f;
#pragma unroll
        for (int j = 0; j < HPL; ++j) {
          const int h = lane + 32 * j;
          if (h < H) part += hid[j] * s_w2t[o * H + h];
        }
        const float b2 = s_b2[o];
        const float out = sigmoid_f(warp_sum(part) - b2);
        const float od = (tr[o] - out) * out * (1.0f - out);
#pragma unroll
        for (int j = 0; j < HPL; ++j) {
          const int h = lane + 32 * j;
          if (h < H) {
            const float w2 = s_w2t[o * H + h];
            hd[j] += w2 * od;  // hid_delta sees W2 before this row's update
            s_w2t[o * H + h] = w2 + lr * (hid[j] * od);
          }
        }
        __syncwarp();  // every lane has read B2[o]
        if (lane == 0) s_b2[o] = b2 + lr * -od;
      }
#pragma unroll
      for (int j = 0; j < HPL; ++j) {
        const int h = lane + 32 * j;
        if (h < H) {
          const float d = hd[j] * hid[j] * (1.0f - hid[j]);
          for (int i = 0; i < I; ++i) s_w1[i * H + h] += lr * (xr[i] * d);
          s_b1[h] += lr * -d;
        }
      }
      __syncwarp();  // B2 is visible to the next row
    }
  }

  if (live) {
    __syncwarp();
    float* oc = p.o_w + (size_t)c * W;
    for (int k = lane; k < s1; k += 32) oc[k] = s_w1[k];
    for (int k = lane; k < H * O; k += 32) oc[s1 + k] = s_w2t[(k % O) * H + k / O];
    for (int k = lane; k < H; k += 32) oc[s2 + k] = s_b1[k];
    for (int k = lane; k < O; k += 32) oc[s2 + H + k] = s_b2[k];
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

template <int I, int H, int O, int G>
__global__ void __launch_bounds__(REG_THREADS) drift_reg_kernel(const DriftParams p) {
  static_assert(G >= 1 && G <= 32 && (G & (G - 1)) == 0, "G is a power of two <= 32");
  constexpr int U = (H + G - 1) / G;  // hidden units a lane
  constexpr int CPB = REG_THREADS / G;  // chains a block
  constexpr int S1 = I * H, S2 = S1 + H * O, W = S2 + H + O;
  constexpr int STRIDE = I + O;
  using R = RegRow<I, O, U>;
  constexpr int NA = R::ACCS;
  extern __shared__ float s_tile[];  // tile_rows x (I + O)
  const int g = threadIdx.x % G;
  const int c = blockIdx.x * CPB + threadIdx.x / G;
  const bool live = c < p.chains;
  const float lr = p.lrate;

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

  const long total = (long)p.n_rows * p.depth;
  for (long base = 0; base < total; base += p.tile_rows) {
    const int len = total - base < p.tile_rows ? (int)(total - base) : p.tile_rows;
    __syncthreads();  // the previous tile is consumed
    for (int k = threadIdx.x; k < len * STRIDE; k += REG_THREADS) {
      const int r = k / STRIDE, f = k - r * STRIDE;
      const long n = (base + r) % p.n_rows;
      s_tile[k] = f < I ? p.x[n * I + f] : p.t[n * O + (f - I)];
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
          for (int o = 0; o < O; ++o) w2[j][o] += lr * (hid[j] * od[o]);
#pragma unroll
          for (int i = 0; i < I; ++i) w1[j][i] += lr * (x[i] * d);
          b1[j] += lr * -d;
        }
      }
#pragma unroll
      for (int o = 0; o < O; ++o) b2[o] += lr * -od[o];
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

template <int I, int H, int O, int G>
static int launch_reg(const DriftParams* p, int smem_bytes, cudaStream_t stream) {
  auto kern = drift_reg_kernel<I, H, O, G>;
  if (smem_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  constexpr int CPB = REG_THREADS / G;
  const int blocks = (p->chains + CPB - 1) / CPB;
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
// size: ceil(C / (REG_THREADS / G)) blocks on `stream`. Returns
// cudaErrorInvalidValue for a topology that is not instantiated, else the
// cudaError_t of the attribute call or of the launch (0 = success). Does
// not synchronise.
int ptnn_drift_epoch_reg(const DriftParams* p, int smem_bytes, void* stream) {
#define TRY(I, H, O, G, HPW)                                                   \
  if (p->n_in == I && p->n_hid == H && p->n_out == O)                          \
    return launch_reg<I, H, O, G>(p, smem_bytes, (cudaStream_t)stream);
  FNN_LAYOUTS(TRY)
#undef TRY
  return (int)cudaErrorInvalidValue;
}

// Launches the generic kernel: ceil(C / WARPS) blocks on `stream`; returns
// the cudaError_t of the attribute call or of the launch (0 = success). Does
// not synchronise.
int ptnn_drift_epoch(const DriftParams* p, int smem_bytes, void* stream) {
  if (smem_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        drift_epoch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (p->chains + WARPS - 1) / WARPS;
  drift_epoch_kernel<<<blocks, THREADS, smem_bytes, (cudaStream_t)stream>>>(*p);
  return (int)cudaGetLastError();
}

const char* ptnn_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
