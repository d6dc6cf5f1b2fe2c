// Stage 1 of the chain-batched CNN eval for Hopper (sm_90a): a 3x3 SAME
// convolution of chain-SHARED images with PER-CHAIN taps, bias, ReLU and the
// 2x2 average pool, in one pass that never writes the pre-pool tensor.
//
// Replaces the TPU kernel ptnn/ops/pallas_conv.py `_kernel` (wrapper
// `conv1_relu_pool`). The plain PyTorch version of the same function is
// `conv1_relu_pool_reference` in ptnn_torch/ops/conv_stage.py. The per-step
// sampler's eval of `cnn.digits_spec(fused_eval=True)` runs it on the train
// and on the test images for every proposal.
//
//   x   (N, hw, hw, IC)        images, the same for every chain
//   w   (C, 3, 3, IC, OC)      taps of each chain
//   b   (C, OC)
//   out (C, N, hw/2, hw/2, OC)
//   out[c,n,py,px,o] = 1/4 sum_{dy,dx in 0..1} relu(b[c,o] + sum_{ky,kx,i}
//       xpad[n, 2py+dy+ky, 2px+dx+kx, i] * w[c,ky,kx,i,o])
//
// What bounds it. At the digits shape (C 256, N 1257, hw 8, 1 -> 8) the
// output is 165 MB against 0.3 MB of images and 0.08 MB of taps, and a
// pooled value costs 4 * 9 * IC multiply-adds: the write of the output at
// the card's memory rate and the arithmetic at its float32 rate take about
// the same time, with the write slightly ahead. The pre-pool tensor (four
// times the output) stays in registers.
//
// Design. The TPU kernel puts 128 chains on the lanes, reads im2col patches
// that XLA materialised outside it and pads N to 8 and C to 128. Here:
//   * a block owns a tile of images and CB consecutive chains. The tile sits
//     in shared memory, channel-planar, with its one-pixel zero halo, so SAME
//     padding costs no branch in the inner loop; the CB chains' taps and
//     biases sit beside it and are read as broadcasts;
//   * a thread owns one group of V = 4 neighbouring output channels of one
//     pooled pixel (V = 1 when OC is not a multiple of 4): it reads the 4x4
//     input patch of each input channel once, holds the 4 x V pre-pool sums
//     in registers, and writes its V results as ONE 16-byte store. Threads
//     are numbered in the output's own order (image, pooled pixel, channel
//     group), so a warp writes 512 contiguous bytes and the whole block one
//     contiguous run of the output per chain;
//   * ragged edges (the last image tile, the last chain group) are masked;
//     nothing is padded in memory.
// The public layout is ptnn's. Stage 2 of the port reads exactly this
// layout (chains, images, pixels, channels), so there is no second entry.
// No fast-math; the multiply-adds contract into FMAs, which the plain
// version's do not: the two agree to about 1e-6.

#include <cuda_runtime.h>

#define THREADS 256

struct ConvParams {
  const float* x;  // (N, hw * hw * IC)
  const float* w;  // (C, 9 * IC * OC)
  const float* b;  // (C, OC)
  float* out;      // (C, N, (hw/2)^2, OC)
  int chains, n_img, hw, in_ch, out_ch;
  int tile_img;          // images per block
  int chains_per_block;  // CB: chains that share the staged image tile
  int x_floats;          // floats reserved for the image tile (multiple of 4)
};

template <int V>
struct Vec;
template <>
struct Vec<4> {
  typedef float4 type;
};
template <>
struct Vec<1> {
  typedef float type;
};

template <int V>
__global__ void __launch_bounds__(THREADS) conv1_relu_pool_kernel(const ConvParams p) {
  extern __shared__ __align__(16) float smem[];
  const int hw = p.hw, IC = p.in_ch, OC = p.out_ch;
  const int P = hw + 2;       // padded side (even: hw is even)
  const int h2 = hw / 2, Q = h2 * h2;
  const int G = OC / V;       // channel groups of a pooled pixel
  const int KW = 9 * IC * OC; // taps of one chain
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * p.tile_img;
  const int n_here = min(p.tile_img, p.n_img - n0);
  const int c0 = blockIdx.y * p.chains_per_block;
  const int c_here = min(p.chains_per_block, p.chains - c0);

  float* s_x = smem;                       // (tile, IC, P, P)
  float* s_w = smem + p.x_floats;          // (CB, KW)
  float* s_b = s_w + p.chains_per_block * KW;  // (CB, OC)

  // the image tile with its zero halo, channel-planar
  const int plane = P * P;
  const int img_floats = hw * hw * IC;
  for (int k = tid; k < n_here * IC * plane; k += THREADS) {
    const int xx = k % P, yy = (k / P) % P;
    const int ic = (k / plane) % IC, nl = k / (plane * IC);
    float v = 0.f;
    if (yy >= 1 && yy <= hw && xx >= 1 && xx <= hw)
      v = p.x[(size_t)(n0 + nl) * img_floats + ((yy - 1) * hw + (xx - 1)) * IC + ic];
    s_x[k] = v;
  }
  // taps and biases of this block's chains (contiguous in w and b)
  for (int k = tid; k < c_here * KW; k += THREADS) s_w[k] = p.w[(size_t)c0 * KW + k];
  for (int k = tid; k < c_here * OC; k += THREADS) s_b[k] = p.b[(size_t)c0 * OC + k];
  __syncthreads();

  typedef typename Vec<V>::type vec_t;
  const int per_img = Q * G;
  const int n_elem = n_here * per_img;  // output vectors of one chain's tile
  for (int cc = 0; cc < c_here; ++cc) {
    const float* wc = s_w + cc * KW;
    const float* bc = s_b + cc * OC;
    vec_t* out = reinterpret_cast<vec_t*>(p.out) +
                 ((size_t)(c0 + cc) * p.n_img + n0) * per_img;
    for (int e = tid; e < n_elem; e += THREADS) {
      const int g = e % G, pe = e / G;
      const int q = pe % Q, nl = pe / Q;
      const int py = q / h2, px = q - py * h2;
      float acc[4][V];
#pragma unroll
      for (int s = 0; s < 4; ++s)
#pragma unroll
        for (int v = 0; v < V; ++v) acc[s][v] = 0.f;
      for (int ic = 0; ic < IC; ++ic) {
        // the 4x4 patch under this pooled pixel's four 3x3 windows; its
        // rows start at an even offset, so they load as two float2
        const float* base = s_x + ((nl * IC + ic) * P + 2 * py) * P + 2 * px;
        float in[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float2* row = reinterpret_cast<const float2*>(base + r * P);
          const float2 lo = row[0], hi = row[1];
          in[r][0] = lo.x;
          in[r][1] = lo.y;
          in[r][2] = hi.x;
          in[r][3] = hi.y;
        }
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
          for (int kx = 0; kx < 3; ++kx) {
            const float* wt = wc + ((ky * 3 + kx) * IC + ic) * OC + g * V;
            float wv[V];
            if constexpr (V == 4) {
              const float4 t = *reinterpret_cast<const float4*>(wt);
              wv[0] = t.x;
              wv[1] = t.y;
              wv[2] = t.z;
              wv[3] = t.w;
            } else {
              wv[0] = wt[0];
            }
#pragma unroll
            for (int dy = 0; dy < 2; ++dy)
#pragma unroll
              for (int dx = 0; dx < 2; ++dx)
#pragma unroll
                for (int v = 0; v < V; ++v)
                  acc[dy * 2 + dx][v] += in[dy + ky][dx + kx] * wv[v];
          }
        }
      }
      float res[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float bias = bc[g * V + v];
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < 4; ++k) s += fmaxf(acc[k][v] + bias, 0.f);
        res[v] = s * 0.25f;  // the mean of the 2x2 block: sum / 4.0, exactly
      }
      if constexpr (V == 4) {
        out[e] = make_float4(res[0], res[1], res[2], res[3]);
      } else {
        out[e] = res[0];
      }
    }
  }
}

template <int V>
static int launch(const ConvParams* p, int smem_bytes, cudaStream_t stream) {
  if (smem_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        conv1_relu_pool_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((p->n_img + p->tile_img - 1) / p->tile_img,
                  (p->chains + p->chains_per_block - 1) / p->chains_per_block);
  conv1_relu_pool_kernel<V><<<grid, THREADS, smem_bytes, stream>>>(*p);
  return (int)cudaGetLastError();
}

extern "C" {

int ptnn_conv_params_size() { return (int)sizeof(ConvParams); }

// Launches the grid (image tiles, chain groups) on `stream`; returns the
// cudaError_t of the attribute call or of the launch (0 = success). Does not
// synchronise.
int ptnn_conv1_relu_pool(const ConvParams* p, int smem_bytes, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (p->hw < 2 || p->hw % 2 != 0 || p->in_ch < 1 || p->out_ch < 1 || p->tile_img < 1 ||
      p->chains_per_block < 1 || p->x_floats % 4 != 0)
    return (int)cudaErrorInvalidValue;
  if (p->out_ch % 4 == 0) return launch<4>(p, smem_bytes, s);
  return launch<1>(p, smem_bytes, s);
}

const char* ptnn_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
