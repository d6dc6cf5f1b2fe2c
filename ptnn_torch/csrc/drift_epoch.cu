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
// row update (forward -> O warp reductions -> deltas -> updates), not a
// flop or byte rate. Device memory sees the weights once in and once out and
// the rows once per block.
//
// Design. The TPU kernel puts 128 chains on the lanes and keeps one plane
// per weight in VMEM. Here one warp owns one chain, and the hidden units lie
// over the lanes (hidden unit h on lane h % 32, up to HPL = 4 per lane):
//   * the chain's W1 (I x H, as in the codec), B1 (H), W2 transposed to
//     (O x H) and B2 (O) sit in shared memory for the whole launch; lane l
//     owns the columns of its hidden units, so W1, B1 and W2 need no
//     barrier; B2 is written by lane 0 between two __syncwarp;
//   * rows go through shared-memory tiles of (x, t) that every warp of the
//     block reads in the same order (broadcast reads); a tile holds up to
//     64 KB, so PenDigit's 7494 rows stream in 12 tiles and an epoch over
//     more rows than the TPU's SMEM allowed is one launch;
//   * per row: each lane forms its hidden activations, the O output sums
//     are warp butterfly reductions (every lane gets every output), the
//     output deltas are computed redundantly on every lane, and each lane
//     then updates the weights it owns, W2 after reading it for hid_delta.
// The grid is ceil(C / WARPS) blocks of WARPS warps; warps past the last
// chain only help stage the tiles. Two launches per Langevin step (the
// drift at w, then at the proposal) cannot merge: the second input depends
// on the first output.
//
// No fast-math: expf and IEEE division, so the result stays within float
// rounding of the plain version (the sums run in another order).

#include <cuda_runtime.h>

#define WARPS 4
#define THREADS (WARPS * 32)
#define HPL 4  // hidden units per lane: n_hid <= 32 * HPL

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
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
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

extern "C" {

int ptnn_drift_params_size() { return (int)sizeof(DriftParams); }

int ptnn_drift_warps() { return WARPS; }

int ptnn_drift_hid_per_lane() { return HPL; }

// Launches ceil(C / WARPS) blocks on `stream`; returns the cudaError_t of the
// attribute call or of the launch (0 = success). Does not synchronise.
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
