// The FNN evaluation of every chain on one dataset: the forward pass, the
// log-likelihood (Gaussian or multinomial), the rmse and the accuracy, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel ptnn/ops/pallas_eval.py `_eval_kernel` (wrapper
// `fnn_eval_pallas`). The plain PyTorch version of the same function is
// `fnn_eval_reference` in ptnn_torch/ops/fnn_eval.py, whose docstring states
// the semantics. The per-step sampler evaluates every proposal on the train
// and the test rows with it, twice a step.
//
// What bounds it. A row costs I * H + H * O multiply-adds, H + O sigmoids and
// the loss: at Sunspot's (4, 10, 1) about 100 flops, at Ionosphere's
// (34, 50, 2) about 3,700. A call moves the weights, the rows and three (C,)
// outputs: tens of KB. At 10-64 chains and a few hundred rows both bounds
// are below a microsecond, so the launch latency and the per-row latency of
// one thread set the time.
//
// Design. The TPU kernel lays rows on sublanes and 128 chains on lanes.
// Here one block of 128 threads owns one chain:
//   * the chain's flat weights sit in shared memory and are read as
//     broadcasts (every thread reads the same entry at the same time);
//   * rows go through tiles of 128, one row per thread, staged transposed
//     ((I, 128): neighbouring threads read neighbouring words);
//   * the O outputs of a row live in registers (the template's MO >= O);
//   * the per-thread partial sums (SSE; or the multinomial ll, the squared
//     class-index error and the matches) are reduced by a warp butterfly and
//     then by thread 0 over the warps in a fixed order: no atomics, the same
//     bits on every run.
// No fast-math: expf, logf and IEEE division.

#include <cuda_runtime.h>

#define THREADS 128
#define WARPS (THREADS / 32)

struct EvalParams {
  const float* w;    // (C, W) flat codec [W1 (I x H), W2 (H x O), B1, B2]
  const float* x;    // (N, I)
  const float* y;    // (N,) targets, or class indices as floats
  const float* tau;  // (C,) noise variance (regression); null for classification
  float* ll;         // (C,) untempered log-likelihood
  float* rmse;       // (C,)
  float* acc;        // (C,) percent (0 for regression)
  int chains, n_rows, n_in, n_hid, n_out, task_cls;
  float ll_const;  // -0.5 * N
  float log_2pi;
  float inv_n;     // float32(1 / N)
  float acc_n;     // float32(100 * float32(1 / N))
};

__device__ __forceinline__ float sigmoid_f(float z) {
  return 1.0f / (1.0f + expf(-z));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int MO>
__global__ void __launch_bounds__(THREADS) fnn_eval_kernel(const EvalParams p) {
  extern __shared__ float smem[];
  __shared__ float s_red[3][WARPS];
  const int I = p.n_in, H = p.n_hid, O = p.n_out;
  const int s1 = I * H, s2 = s1 + H * O;
  const int W = s2 + H + O;
  const int c = blockIdx.x, tid = threadIdx.x;
  float* s_w = smem;
  float* s_x = s_w + W;            // (I, THREADS): s_x[i * THREADS + r]
  float* s_y = s_x + I * THREADS;  // (THREADS,)

  const float* wc = p.w + (size_t)c * W;
  for (int k = tid; k < W; k += THREADS) s_w[k] = wc[k];

  float a0 = 0.f, a1 = 0.f, a2 = 0.f;  // sse | (ll, err^2, matches)
  for (int base = 0; base < p.n_rows; base += THREADS) {
    const int len = min(THREADS, p.n_rows - base);
    __syncthreads();  // the previous tile is consumed (and the weights loaded)
    for (int k = tid; k < len * I; k += THREADS) {
      const int r = k / I, i = k - r * I;
      s_x[i * THREADS + r] = p.x[(size_t)(base + r) * I + i];
    }
    if (tid < len) s_y[tid] = p.y[base + tid];
    __syncthreads();
    if (tid >= len) continue;

    float out[MO];
#pragma unroll
    for (int o = 0; o < MO; ++o) out[o] = 0.f;
    for (int h = 0; h < H; ++h) {
      float z = 0.f;
      for (int i = 0; i < I; ++i) z += s_x[i * THREADS + tid] * s_w[i * H + h];
      const float hid = sigmoid_f(z - s_w[s2 + h]);
#pragma unroll
      for (int o = 0; o < MO; ++o)
        if (o < O) out[o] += hid * s_w[s1 + h * O + o];
    }
#pragma unroll
    for (int o = 0; o < MO; ++o)
      if (o < O) out[o] = sigmoid_f(out[o] - s_w[s2 + H + o]);
    const float y = s_y[tid];
    if (!p.task_cls) {
      const float d = y - out[0];
      a0 += d * d;
      continue;
    }
    // softmax over the sigmoid outputs; first argmax (a later class wins
    // only if strictly larger)
    float m = out[0], best = out[0];
    int pred = 0;
#pragma unroll
    for (int o = 1; o < MO; ++o) {
      if (o < O) {
        m = fmaxf(m, out[o]);
        if (out[o] > best) {
          best = out[o];
          pred = o;
        }
      }
    }
    const int yi = (int)y;
    float den = 0.f, sel = 0.f;
#pragma unroll
    for (int o = 0; o < MO; ++o) {
      if (o < O) {
        den += expf(out[o] - m);
        if (o == yi) sel = out[o];
      }
    }
    a0 += (sel - m) - logf(den);
    const float e = (float)pred - y;
    a1 += e * e;
    a2 += pred == yi ? 1.f : 0.f;
  }

  a0 = warp_sum(a0);
  a1 = warp_sum(a1);
  a2 = warp_sum(a2);
  const int warp = tid >> 5, lane = tid & 31;
  if (lane == 0) {
    s_red[0][warp] = a0;
    s_red[1][warp] = a1;
    s_red[2][warp] = a2;
  }
  __syncthreads();
  if (tid != 0) return;
  float b0 = 0.f, b1 = 0.f, b2 = 0.f;
#pragma unroll
  for (int q = 0; q < WARPS; ++q) {
    b0 += s_red[0][q];
    b1 += s_red[1][q];
    b2 += s_red[2][q];
  }
  if (p.task_cls) {
    p.ll[c] = b0;
    p.rmse[c] = sqrtf(b1 * p.inv_n);
    p.acc[c] = b2 * p.acc_n;
  } else {
    const float tau = p.tau[c];
    p.ll[c] = p.ll_const * (p.log_2pi + logf(tau)) - 0.5f * b0 / tau;
    p.rmse[c] = sqrtf(b0 * p.inv_n);
    p.acc[c] = 0.f;
  }
}

template <int MO>
static int launch(const EvalParams* p, int smem_bytes, cudaStream_t stream) {
  if (smem_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fnn_eval_kernel<MO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  fnn_eval_kernel<MO><<<p->chains, THREADS, smem_bytes, stream>>>(*p);
  return (int)cudaGetLastError();
}

extern "C" {

int ptnn_eval_params_size() { return (int)sizeof(EvalParams); }

int ptnn_eval_threads() { return THREADS; }

int ptnn_eval_max_out() { return 32; }

// Launches one block per chain on `stream`; returns the cudaError_t of the
// attribute call or of the launch (0 = success). Does not synchronise.
int ptnn_fnn_eval(const EvalParams* p, int smem_bytes, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int o = p->n_out;
  if (o <= 1) return launch<1>(p, smem_bytes, s);
  if (o <= 4) return launch<4>(p, smem_bytes, s);
  if (o <= 16) return launch<16>(p, smem_bytes, s);
  if (o <= 32) return launch<32>(p, smem_bytes, s);
  return (int)cudaErrorInvalidValue;
}

const char* ptnn_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
