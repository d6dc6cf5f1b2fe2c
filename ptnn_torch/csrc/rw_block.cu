// A fused block of K random-walk Metropolis-Hastings steps for every chain
// of the parallel-tempering ladder, regression task, for Hopper (sm_90a).
//
// Replaces the TPU kernel ptnn/ops/pallas_step.py `_rw_block_kernel`
// (regression branch; wrapper `fused_rw_block_impl`). The plain PyTorch
// version of the same function is `rw_block_reference` in
// ptnn_torch/ops/block_step.py, whose docstring states the semantics.
//
// What bounds it. One chain-step evaluates the two-layer FNN on every data
// row: at Sunspot (4, 10, 1) that is 496 rows x (40 FMA + 11 sigmoids),
// about 25k flops, then a block-wide reduction and one MH decision. The
// steps of a chain are serial, so a block's time is K times the latency of
// one step, not a bandwidth or a flop rate: the data (10 KB) lives in
// shared memory, and device memory sees only the noise read and the trace
// rows written once per step.
//
// The TPU kernel puts 128 chains on the lanes and unrolls the forward onto
// (rows, chains) planes. Here one thread block owns one chain, and the
// K-step loop runs inside the block; threads split the data rows. Two
// kernels:
//   * rw_fixed_kernel<I, H, WARPS>, for every (I, H, 1) of the bundled
//     networks (fnn_layouts.cuh, the lines with O = 1; WARPS 8 while the
//     grid fits one wave of one block an SM, else 4: ops/block_step.py
//     `rw_launch_plan`). Compile-time shapes: a row's forward is unrolled
//     over I and H, the H hidden units independent. One barrier a step:
//       - every thread forms the proposal w' = w + step * noise itself, in
//         registers, from the current w and the step's noise row in shared
//         memory (read as float4 broadcasts); the thread that owns entry t
//         (t < w_size) also writes w'[t] to the other of two weight slots,
//         where it becomes the current w if accepted;
//       - step k+1's noise row, eta noise and uniform depend on no state:
//         their loads are issued before step k's forward and stored to the
//         other of two noise slots after it, so no step starts with a
//         dependent device-memory load;
//       - each warp reduces its (train SSE, test SSE, sum w'^2 of its
//         owned entries) and writes them to parity-alternating slots; after
//         the step's one __syncthreads every thread sums the warps' partials
//         in warp order, so every thread computes the same bits, takes the
//         same MH decision and holds the same carries (eta, ll, prior,
//         rmse, accept count, log step) without a broadcast barrier.
//     Thread 0 alone writes the scalar trace rows; the owner of an entry
//     writes the w trace.
//   * rw_block_kernel, the generic kernel for any other (I, H, 1): runtime
//     shapes, 128 threads, the weights read from shared memory as
//     broadcasts, three barriers a step (proposal written, partial sums
//     written, decision written) and thread 0 deciding.
// The grid is one block per chain.
//
// Steps k >= length decide nothing and write the carries into their trace
// rows, as the TPU kernel does. No fast-math: expf and IEEE division, so the
// result stays within float rounding of the plain version.

#include <cuda_runtime.h>

#include "fnn_layouts.cuh"  // FNN_LAYOUTS: the bundled networks

#define THREADS 128  // threads a block of the generic kernel
#define WARPS (THREADS / 32)

struct RwParams {
  // inputs
  const float* rows;       // (n_tr + n_te, n_in + 1): x..., y; train first
  const float* at;         // (C,) adaptive temperature
  const float* w;          // (C, W)
  const float* w_last;     // (C, W)
  const float* eta;        // (C,)
  const float* ll;         // (C,) untempered
  const float* prior;      // (C,)
  const float* rmse_tr;    // (C,)
  const float* rmse_te;    // (C,)
  const int* n_accept;     // (C,)
  const float* log_step;   // (C,)
  const float* noise_w;    // (K, C, W)
  const float* noise_eta;  // (K, C)
  const float* u;          // (K, C)
  // outputs: new state
  float* o_w;
  float* o_w_last;
  float* o_eta;
  float* o_ll;
  float* o_prior;
  float* o_rmse_tr;
  float* o_rmse_te;
  int* o_n_accept;
  float* o_log_step;
  // outputs: trace rows (K, C), and (K, C, W) weights or null
  float* t_ll;
  float* t_rmse_tr;
  float* t_rmse_te;
  int* t_accept;
  float* t_w;
  int n_tr, n_te, n_in, n_hid, chains, w_size, k_max, start, length, adapt,
      burn_end;
  float step_w, step_eta, prior_const, two_sigma_sq, one_plus_nu1, nu2,
      ll_const, log_2pi, adapt_rate, adapt_target, log_step_lo, log_step_hi,
      n_tr_f, n_te_f;
};

__device__ __forceinline__ float sigmoid_f(float z) {
  return 1.0f / (1.0f + expf(-z));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(THREADS) rw_block_kernel(const RwParams p) {
  extern __shared__ float smem[];
  __shared__ float s_step;    // proposal scale of the next step
  __shared__ int s_accept;    // this step's decision

  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const int W = p.w_size;
  const int stride = p.n_in + 1;
  const int n_rows = p.n_tr + p.n_te;
  float* s_rows = smem;
  float* s_w = s_rows + n_rows * stride;
  float* s_wl = s_w + W;
  float* s_wp = s_wl + W;
  float* s_red = s_wp + W;  // 3 * WARPS partial sums

  for (int i = tid; i < n_rows * stride; i += THREADS) s_rows[i] = p.rows[i];
  const size_t cw = (size_t)c * W;
  for (int i = tid; i < W; i += THREADS) {
    s_w[i] = p.w[cw + i];
    s_wl[i] = p.w_last[cw + i];
  }
  // scalar carries, held by thread 0
  float eta = 0.f, ll = 0.f, pr = 0.f, rtr = 0.f, rte = 0.f, lsw = 0.f,
        at = 1.f;
  int na = 0;
  if (tid == 0) {
    eta = p.eta[c];
    ll = p.ll[c];
    pr = p.prior[c];
    rtr = p.rmse_tr[c];
    rte = p.rmse_te[c];
    na = p.n_accept[c];
    lsw = p.log_step[c];
    at = p.at[c];
    s_step = p.adapt ? expf(lsw) : p.step_w;
  }
  __syncthreads();

  // flat codec [W1 (I x H), W2 (H), B1 (H), B2]
  const int s1 = p.n_in * p.n_hid;
  const int s2 = s1 + p.n_hid;
  const int b2 = s2 + p.n_hid;
  const int warp = tid >> 5, lane = tid & 31;

  for (int k = 0; k < p.k_max; ++k) {
    const size_t kc = (size_t)k * p.chains + c;
    if (k < p.length) {  // uniform over the block
      float ne = 0.f, u = 0.f;
      if (tid == 0) {  // loaded early; used after the forward
        ne = p.noise_eta[kc];
        u = p.u[kc];
      }
      const float step = s_step;
      const float* nw = p.noise_w + kc * W;
      float ssq = 0.f;
      for (int i = tid; i < W; i += THREADS) {
        const float v = s_w[i] + step * nw[i];
        s_wp[i] = v;
        ssq += v * v;
      }
      __syncthreads();  // proposal visible

      float sse_tr = 0.f, sse_te = 0.f;
      for (int r = tid; r < n_rows; r += THREADS) {
        const float* xr = s_rows + r * stride;
        float out = 0.f;
        for (int h = 0; h < p.n_hid; ++h) {
          float z = -s_wp[s2 + h];
          for (int i = 0; i < p.n_in; ++i) z += xr[i] * s_wp[i * p.n_hid + h];
          out += sigmoid_f(z) * s_wp[s1 + h];
        }
        const float d = xr[p.n_in] - sigmoid_f(out - s_wp[b2]);
        if (r < p.n_tr) {
          sse_tr += d * d;
        } else {
          sse_te += d * d;
        }
      }
      sse_tr = warp_sum(sse_tr);
      sse_te = warp_sum(sse_te);
      ssq = warp_sum(ssq);
      if (lane == 0) {
        s_red[warp] = sse_tr;
        s_red[WARPS + warp] = sse_te;
        s_red[2 * WARPS + warp] = ssq;
      }
      __syncthreads();  // partial sums visible

      if (tid == 0) {
        float a_tr = 0.f, a_te = 0.f, a_sq = 0.f;
#pragma unroll
        for (int q = 0; q < WARPS; ++q) {
          a_tr += s_red[q];
          a_te += s_red[WARPS + q];
          a_sq += s_red[2 * WARPS + q];
        }
        const float eta_p = eta + p.step_eta * ne;
        const float tau = expf(eta_p);
        const float pr_p = p.prior_const - a_sq / p.two_sigma_sq -
                           p.one_plus_nu1 * eta_p - p.nu2 / tau;
        const float ll_p = p.ll_const * (p.log_2pi + eta_p) - 0.5f * a_tr / tau;
        const float log_mh = (ll_p - ll) / at + (pr_p - pr);
        const float a = expf(fminf(log_mh, 0.f));
        const bool accept = u < a;
        p.t_ll[kc] = ll_p / at;
        if (accept) {
          rtr = sqrtf(a_tr / p.n_tr_f);
          rte = sqrtf(a_te / p.n_te_f);
          eta = eta_p;
          ll = ll_p;
          pr = pr_p;
        }
        p.t_rmse_tr[kc] = rtr;
        p.t_rmse_te[kc] = rte;
        p.t_accept[kc] = na;  // count BEFORE this step's decision
        na += accept ? 1 : 0;
        if (p.adapt) {
          if (p.start + k < p.burn_end) lsw += p.adapt_rate * (a - p.adapt_target);
          lsw = fminf(fmaxf(lsw, p.log_step_lo), p.log_step_hi);
          s_step = expf(lsw);
        }
        s_accept = accept ? 1 : 0;
      }
      __syncthreads();  // decision visible

      if (s_accept) {
        for (int i = tid; i < W; i += THREADS) {
          s_w[i] = s_wp[i];
          s_wl[i] = s_wp[i];
        }
      }
    } else if (tid == 0) {
      p.t_ll[kc] = ll / at;
      p.t_rmse_tr[kc] = rtr;
      p.t_rmse_te[kc] = rte;
      p.t_accept[kc] = na;
      if (p.adapt) lsw = fminf(fmaxf(lsw, p.log_step_lo), p.log_step_hi);
    }
    if (p.t_w != nullptr) {
      // each thread writes the w_last entries it owns (it also updated them)
      float* tw = p.t_w + kc * W;
      for (int i = tid; i < W; i += THREADS) tw[i] = s_wl[i];
    }
  }

  for (int i = tid; i < W; i += THREADS) {
    p.o_w[cw + i] = s_w[i];
    p.o_w_last[cw + i] = s_wl[i];
  }
  if (tid == 0) {
    p.o_eta[c] = eta;
    p.o_ll[c] = ll;
    p.o_prior[c] = pr;
    p.o_rmse_tr[c] = rtr;
    p.o_rmse_te[c] = rte;
    p.o_n_accept[c] = na;
    p.o_log_step[c] = lsw;
  }
}

// Floats of a weight or noise slot of the fixed-shape kernel: w_size, then
// (noise slots) the eta noise and the uniform, padded to float4.
__host__ __device__ constexpr int rw_slot(int w) { return (w + 2 + 3) / 4 * 4; }

// Shared memory of the fixed-shape kernel in floats: the data rows (padded
// to 16 bytes), two weight slots, two noise slots and two parities of a
// 4-float partial slot per warp.
__host__ __device__ constexpr int rw_fixed_smem_floats(int n_rows, int n_in, int w,
                                                       int warps) {
  return (n_rows * (n_in + 1) + 3) / 4 * 4 + 4 * rw_slot(w) + 2 * warps * 4;
}

// Step k's noise entry t: the w row (t < w_size), then the eta noise and
// the uniform.
template <int W>
__device__ __forceinline__ float rw_noise(const RwParams& p, int k, int c, int t) {
  const size_t kc = (size_t)k * p.chains + c;
  if (t < W) return p.noise_w[kc * W + t];
  return t == W ? p.noise_eta[kc] : p.u[kc];
}

template <int NI, int NH, int NW>
__global__ void __launch_bounds__(NW * 32) rw_fixed_kernel(const RwParams p) {
  constexpr int T = NW * 32;
  constexpr int S1 = NI * NH, S2 = S1 + NH, B2 = S2 + NH, W = B2 + 1;
  constexpr int WP = rw_slot(W);
  static_assert(WP <= T, "a thread owns each weight and noise entry");
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int c = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_rows = p.n_tr + p.n_te;
  float* s_rows = smem;
  float* s_w = smem + (n_rows * (NI + 1) + 3) / 4 * 4;  // 2 slots: w, w'
  float* s_nz = s_w + 2 * WP;                          // 2 slots by step parity
  float* s_red = s_nz + 2 * WP;                        // 2 parities x NW x 4

  for (int i = tid; i < n_rows * (NI + 1); i += T) s_rows[i] = p.rows[i];
  const size_t cw = (size_t)c * W;
  const bool owner = tid < W;  // of entry tid of w, w_last and w'
  float my_w = 0.f, my_wl = 0.f;
  if (owner) {
    my_w = p.w[cw + tid];
    my_wl = p.w_last[cw + tid];
  }
  if (tid < WP) {  // zero past w_size
    s_w[tid] = my_w;
    s_w[WP + tid] = 0.f;
  }
  if (p.length > 0 && tid < W + 2) s_nz[tid] = rw_noise<W>(p, 0, c, tid);
  // scalar carries: every thread holds the same values
  float eta = p.eta[c], ll = p.ll[c], pr = p.prior[c], rtr = p.rmse_tr[c],
        rte = p.rmse_te[c], lsw = p.log_step[c];
  const float at = p.at[c];
  int na = p.n_accept[c];
  float step = p.adapt ? expf(lsw) : p.step_w;
  int cur = 0;  // the weight slot that holds w
  __syncthreads();

  for (int k = 0; k < p.k_max; ++k) {
    const size_t kc = (size_t)k * p.chains + c;
    if (k < p.length) {  // uniform over the block
      const float* nz = s_nz + (k & 1) * WP;
      const float* wc = s_w + cur * WP;
      // the proposal, in registers; every read of this step's slots comes
      // before the step's barrier
      float wp[WP];
#pragma unroll
      for (int e = 0; e < WP / 4; ++e) {
        const float4 a = reinterpret_cast<const float4*>(wc)[e];
        const float4 b = reinterpret_cast<const float4*>(nz)[e];
        wp[4 * e] = __fmaf_rn(step, b.x, a.x);
        wp[4 * e + 1] = __fmaf_rn(step, b.y, a.y);
        wp[4 * e + 2] = __fmaf_rn(step, b.z, a.z);
        wp[4 * e + 3] = __fmaf_rn(step, b.w, a.w);
      }
      const float ne = nz[W], u = nz[W + 1];
      float my_wp = 0.f;
      if (owner) {
        my_wp = __fmaf_rn(step, nz[tid], wc[tid]);
        s_w[(cur ^ 1) * WP + tid] = my_wp;
      }
      // step k+1's noise: issued now, stored after the forward
      const bool fetch = k + 1 < p.length && tid < W + 2;
      float pf = 0.f;
      if (fetch) pf = rw_noise<W>(p, k + 1, c, tid);

      float sse_tr = 0.f, sse_te = 0.f;
#pragma unroll 2
      for (int r = tid; r < n_rows; r += T) {
        const float* xr = s_rows + r * (NI + 1);
        float x[NI];
#pragma unroll
        for (int i = 0; i < NI; ++i) x[i] = xr[i];
        float out = 0.f;
#pragma unroll
        for (int h = 0; h < NH; ++h) {
          float z = -wp[S2 + h];
#pragma unroll
          for (int i = 0; i < NI; ++i) z += x[i] * wp[i * NH + h];
          out += sigmoid_f(z) * wp[S1 + h];
        }
        const float d = xr[NI] - sigmoid_f(out - wp[B2]);
        if (r < p.n_tr) {
          sse_tr += d * d;
        } else {
          sse_te += d * d;
        }
      }
      sse_tr = warp_sum(sse_tr);
      sse_te = warp_sum(sse_te);
      const float ssq = warp_sum(my_wp * my_wp);
      float* red = s_red + (k & 1) * NW * 4;
      if (lane == 0) {
        red[4 * warp] = sse_tr;
        red[4 * warp + 1] = sse_te;
        red[4 * warp + 2] = ssq;
      }
      if (fetch) s_nz[((k + 1) & 1) * WP + tid] = pf;
      __syncthreads();  // partial sums, w' and the next noise visible

      float a_tr = 0.f, a_te = 0.f, a_sq = 0.f;
#pragma unroll
      for (int q = 0; q < NW; ++q) {
        a_tr += red[4 * q];
        a_te += red[4 * q + 1];
        a_sq += red[4 * q + 2];
      }
      const float eta_p = eta + p.step_eta * ne;
      const float tau = expf(eta_p);
      const float pr_p =
          p.prior_const - a_sq / p.two_sigma_sq - p.one_plus_nu1 * eta_p - p.nu2 / tau;
      const float ll_p = p.ll_const * (p.log_2pi + eta_p) - 0.5f * a_tr / tau;
      const float log_mh = (ll_p - ll) / at + (pr_p - pr);
      const float a = expf(fminf(log_mh, 0.f));
      const bool accept = u < a;
      if (accept) {
        rtr = sqrtf(a_tr / p.n_tr_f);
        rte = sqrtf(a_te / p.n_te_f);
        eta = eta_p;
        ll = ll_p;
        pr = pr_p;
        cur ^= 1;
        my_w = my_wp;
        my_wl = my_wp;
      }
      if (tid == 0) {
        p.t_ll[kc] = ll_p / at;
        p.t_rmse_tr[kc] = rtr;
        p.t_rmse_te[kc] = rte;
        p.t_accept[kc] = na;  // count BEFORE this step's decision
      }
      na += accept ? 1 : 0;
      if (p.adapt) {
        if (p.start + k < p.burn_end) lsw += p.adapt_rate * (a - p.adapt_target);
        lsw = fminf(fmaxf(lsw, p.log_step_lo), p.log_step_hi);
        step = expf(lsw);
      }
    } else {
      if (tid == 0) {
        p.t_ll[kc] = ll / at;
        p.t_rmse_tr[kc] = rtr;
        p.t_rmse_te[kc] = rte;
        p.t_accept[kc] = na;
      }
      if (p.adapt) lsw = fminf(fmaxf(lsw, p.log_step_lo), p.log_step_hi);
    }
    if (p.t_w != nullptr && owner) p.t_w[kc * W + tid] = my_wl;
  }

  if (owner) {
    p.o_w[cw + tid] = my_w;
    p.o_w_last[cw + tid] = my_wl;
  }
  if (tid == 0) {
    p.o_eta[c] = eta;
    p.o_ll[c] = ll;
    p.o_prior[c] = pr;
    p.o_rmse_tr[c] = rtr;
    p.o_rmse_te[c] = rte;
    p.o_n_accept[c] = na;
    p.o_log_step[c] = lsw;
  }
}

template <int NI, int NH, int NW>
static int launch_fixed(const RwParams* p, int smem_bytes, cudaStream_t stream) {
  auto kern = rw_fixed_kernel<NI, NH, NW>;
  if (smem_bytes > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<p->chains, NW * 32, smem_bytes, stream>>>(*p);
  return (int)cudaGetLastError();
}

// The fixed-shape launch of the bundled network (I, H, O) at `warps` warps
// a chain; -1 when the table has no such regression network.
template <int NI, int NH, int NO>
static int try_fixed(const RwParams* p, int smem_bytes, int warps, cudaStream_t stream) {
  if constexpr (NO == 1) {
    if (p->n_in == NI && p->n_hid == NH) {
      if (warps == 8) return launch_fixed<NI, NH, 8>(p, smem_bytes, stream);
      if (warps == 4) return launch_fixed<NI, NH, 4>(p, smem_bytes, stream);
      return (int)cudaErrorInvalidValue;
    }
  }
  return -1;
}

extern "C" {

int ptnn_rw_params_size() { return (int)sizeof(RwParams); }

int ptnn_rw_block_threads() { return THREADS; }

int ptnn_rw_fixed_smem_floats(int n_rows, int n_in, int w, int warps) {
  return rw_fixed_smem_floats(n_rows, n_in, w, warps);
}

// Writes the (I, H) of the networks the fixed-shape kernel is built for
// (the O = 1 lines of FNN_LAYOUTS) into `out` (room for `n` rows); returns
// their number.
int ptnn_rw_fixed_layouts(int* out, int n) {
  int k = 0;
#define ROW(I, H, O, G, HPW) \
  if (O == 1) {              \
    if (k < n) {             \
      out[2 * k] = I;        \
      out[2 * k + 1] = H;    \
    }                        \
    ++k;                     \
  }
  FNN_LAYOUTS(ROW)
#undef ROW
  return k;
}

// Launches one block per chain on `stream`: the fixed-shape kernel at
// `warps` warps a chain (`fixed` != 0; the network must be a bundled
// one), else the generic kernel of THREADS threads. Returns the cudaError_t
// of the attribute call or of the launch (0 = success). Does not
// synchronise.
int ptnn_rw_block(const RwParams* p, int smem_bytes, int fixed, int warps, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (fixed) {
#define TRY(I, H, O, G, HPW)                                   \
  {                                                            \
    const int e = try_fixed<I, H, O>(p, smem_bytes, warps, st); \
    if (e >= 0) return e;                                      \
  }
    FNN_LAYOUTS(TRY)
#undef TRY
    return (int)cudaErrorInvalidValue;
  }
  if (smem_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        rw_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  rw_block_kernel<<<p->chains, THREADS, smem_bytes, st>>>(*p);
  return (int)cudaGetLastError();
}

const char* ptnn_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
