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
// the same time (0.049 and 0.052 ms on an H100 SXM). The pre-pool tensor
// (four times the output) stays in registers. What is left to cut is every
// instruction that is not one of those multiply-adds or stores.
//
// Design. The TPU kernel puts 128 chains on the lanes, reads im2col patches
// that XLA materialised outside it and pads N to 8 and C to 128. Here a
// block owns a tile of images and a group of consecutive chains; the tile
// sits in shared memory, channel-planar, with its one-pixel zero halo (SAME
// padding costs no branch), the group's taps and biases beside it, read as
// broadcasts. A thread owns one group of V = 4 neighbouring output channels
// of one pooled pixel (V = 1 when OC is not a multiple of 4), holds the 4 x V
// pre-pool sums in registers and writes its V results as ONE 16-byte store.
// Threads are numbered in the output's own order (image, pooled pixel,
// channel group), so a warp writes 512 contiguous bytes. Ragged edges (the
// last image tile, the last chain group) are masked; nothing is padded in
// memory. Two kernels:
//   * conv_fixed_kernel, for the bundled stage-1 shape (hw 8, IC 1, OC 8):
//     the shape is compile-time, so all index math folds; chains are the
//     INNER loop: a thread loads the 4x4 patches of its EPT elements into
//     registers once, then for each of the block's chains reads the taps of
//     its channel group (nine float4 broadcasts and the bias) and issues one
//     16-byte streaming store (__stcs) an element; a store is in flight
//     while the next chain is computed;
//   * conv1_relu_pool_kernel, any other shape (MNIST's 28, other channel
//     counts): runtime shape, chains the outer loop, the patch reloaded for
//     each chain.
// The public layout is ptnn's. Stage 2 of the port reads exactly this
// layout (chains, images, pixels, channels), so there is no second entry.
// No fast-math; the multiply-adds contract into FMAs, which the plain
// version's do not: the two agree to about 1e-6.

#include <cuda_runtime.h>

#define THREADS 256
// the compiled shape of conv_fixed_kernel (hw, in_ch, out_ch) and its plan
#define FIXED_HW 8
#define FIXED_IN 1
#define FIXED_OUT 8
#define FIXED_EPT 2      // output vectors a thread, one chain
#define FIXED_CHAINS 16  // chains a block

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

// The bundled stage-1 shape, compile-time. A block covers TILE = THREADS *
// EPT / (Q * G) images (16 at hw 8, OC 8) and p.chains_per_block chains;
// thread t owns output vectors t + THREADS * e (e < EPT) of each chain's
// run, all of one channel group g = t % G.
template <int HW, int IC, int OC, int EPT>
__global__ void __launch_bounds__(THREADS) conv_fixed_kernel(const ConvParams p) {
  extern __shared__ __align__(16) float smem[];
  constexpr int P = HW + 2, H2 = HW / 2, Q = H2 * H2, G = OC / 4;
  constexpr int PER_IMG = Q * G;  // output vectors an image
  constexpr int TILE = THREADS * EPT / PER_IMG;
  constexpr int KW = 9 * IC * OC;
  constexpr int PLANE = P * P;
  static_assert(OC % 4 == 0 && THREADS % PER_IMG == 0, "fixed-shape layout");
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * TILE;
  const int n_here = min(TILE, p.n_img - n0);
  const int c0 = blockIdx.y * p.chains_per_block;
  const int c_here = min(p.chains_per_block, p.chains - c0);
  float* s_x = smem;                            // (TILE, IC, P, P)
  float* s_w = smem + p.x_floats;               // (CB, KW)
  float* s_b = s_w + p.chains_per_block * KW;   // (CB, OC)

  for (int k = tid; k < TILE * IC * PLANE; k += THREADS) {
    const int xx = k % P, yy = (k / P) % P;
    const int ic = (k / PLANE) % IC, nl = k / (PLANE * IC);
    float v = 0.f;
    if (nl < n_here && yy >= 1 && yy <= HW && xx >= 1 && xx <= HW)
      v = p.x[(size_t)(n0 + nl) * (HW * HW * IC) + ((yy - 1) * HW + (xx - 1)) * IC + ic];
    s_x[k] = v;
  }
  for (int k = tid; k < c_here * KW; k += THREADS) s_w[k] = p.w[(size_t)c0 * KW + k];
  for (int k = tid; k < c_here * OC; k += THREADS) s_b[k] = p.b[(size_t)c0 * OC + k];
  __syncthreads();

  // this thread's elements: their patches, once
  const int g = tid % G;
  float in[EPT][IC][4][4];
  bool live[EPT];
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    const int el = tid + THREADS * e;
    const int q = (el / G) % Q, nl = el / PER_IMG;
    const int py = q / H2, px = q % H2;
    live[e] = nl < n_here;
#pragma unroll
    for (int ic = 0; ic < IC; ++ic) {
      const float* base = s_x + ((nl * IC + ic) * P + 2 * py) * P + 2 * px;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float2* row = reinterpret_cast<const float2*>(base + r * P);
        const float2 lo = row[0], hi = row[1];
        in[e][ic][r][0] = lo.x;
        in[e][ic][r][1] = lo.y;
        in[e][ic][r][2] = hi.x;
        in[e][ic][r][3] = hi.y;
      }
    }
  }
  float4* out = reinterpret_cast<float4*>(p.out) + ((size_t)c0 * p.n_img + n0) * PER_IMG + tid;
  const size_t chain_stride = (size_t)p.n_img * PER_IMG;  // float4s a chain
  for (int cc = 0; cc < c_here; ++cc) {
    const float* wc = s_w + cc * KW + g * 4;
    float acc[EPT][4][4];
#pragma unroll
    for (int e = 0; e < EPT; ++e)
#pragma unroll
      for (int s = 0; s < 4; ++s)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[e][s][v] = 0.f;
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
#pragma unroll
        for (int ic = 0; ic < IC; ++ic) {
          const float4 t = *reinterpret_cast<const float4*>(wc + ((ky * 3 + kx) * IC + ic) * OC);
          const float wv[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
          for (int e = 0; e < EPT; ++e)
#pragma unroll
            for (int dy = 0; dy < 2; ++dy)
#pragma unroll
              for (int dx = 0; dx < 2; ++dx)
#pragma unroll
                for (int v = 0; v < 4; ++v)
                  acc[e][dy * 2 + dx][v] += in[e][ic][dy + ky][dx + kx] * wv[v];
        }
      }
    }
    const float4 bt = *reinterpret_cast<const float4*>(s_b + cc * OC + g * 4);
    const float bias[4] = {bt.x, bt.y, bt.z, bt.w};
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      float res[4];
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < 4; ++k) s += fmaxf(acc[e][k][v] + bias[v], 0.f);
        res[v] = s * 0.25f;  // the mean of the 2x2 block: sum / 4.0, exactly
      }
      // streaming stores: the output (165 MB at the digits shape) passes
      // through the 50 MB L2 once and is read by the next stage, not here
      if (live[e]) __stcs(out + cc * chain_stride + THREADS * e,
                          make_float4(res[0], res[1], res[2], res[3]));
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

static int launch_fixed(const ConvParams* p, int smem_bytes, cudaStream_t stream) {
  constexpr int tile = THREADS * FIXED_EPT / ((FIXED_HW / 2) * (FIXED_HW / 2) * (FIXED_OUT / 4));
  auto kern = conv_fixed_kernel<FIXED_HW, FIXED_IN, FIXED_OUT, FIXED_EPT>;
  if (p->tile_img != tile) return (int)cudaErrorInvalidValue;
  if (smem_bytes > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((p->n_img + tile - 1) / tile,
                  (p->chains + p->chains_per_block - 1) / p->chains_per_block);
  kern<<<grid, THREADS, smem_bytes, stream>>>(*p);
  return (int)cudaGetLastError();
}

extern "C" {

int ptnn_conv_params_size() { return (int)sizeof(ConvParams); }

int ptnn_conv_fixed(int* out) {  // (hw, in_ch, out_ch, ept, chains a block)
  out[0] = FIXED_HW;
  out[1] = FIXED_IN;
  out[2] = FIXED_OUT;
  out[3] = FIXED_EPT;
  out[4] = FIXED_CHAINS;
  return 5;
}

// Launches the grid (image tiles, chain groups) on `stream`: the fixed-shape
// kernel for the bundled shape, the generic one otherwise; returns the
// cudaError_t of the attribute call or of the launch (0 = success). Does not
// synchronise.
int ptnn_conv1_relu_pool(const ConvParams* p, int smem_bytes, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (p->hw < 2 || p->hw % 2 != 0 || p->in_ch < 1 || p->out_ch < 1 || p->tile_img < 1 ||
      p->chains_per_block < 1 || p->x_floats % 4 != 0)
    return (int)cudaErrorInvalidValue;
  if (p->hw == FIXED_HW && p->in_ch == FIXED_IN && p->out_ch == FIXED_OUT)
    return launch_fixed(p, smem_bytes, s);
  if (p->out_ch % 4 == 0) return launch<4>(p, smem_bytes, s);
  return launch<1>(p, smem_bytes, s);
}

const char* ptnn_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
