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
// one step (proposal -> forward -> two block reductions -> decision), not
// a bandwidth or a flop rate: the data (10 KB) and the weights live in
// shared memory, and device memory sees only the noise read and the trace
// rows written once per step.
//
// Design. The TPU kernel puts 128 chains on the lanes and unrolls the
// forward onto (rows, chains) planes. Here one thread block of 128 threads
// owns one chain, and the K-step loop runs inside the block:
//   * the data rows [x..., y] and the chain's current, last-accepted and
//     proposed weights sit in shared memory; the weights are read as
//     broadcasts, the rows with a stride of I+1 words (conflict-free for
//     odd I+1);
//   * threads split the data rows; warp shuffles then one shared-memory pass
//     reduce (train SSE, test SSE, sum w'^2) together;
//   * thread 0 takes the MH decision, owns the scalar carries (eta, ll,
//     prior, rmse, accept count, log step) and writes the (K, C) trace rows;
//   * three barriers a step: proposal written, partial sums written,
//     decision written.
// The grid is one block per chain, so the card holds all chains at once up
// to about 2000 of them (16 blocks of 128 threads per SM).
//
// Steps k >= length decide nothing and write the carries into their trace
// rows, as the TPU kernel does. No fast-math: expf and IEEE division, so the
// result stays within float rounding of the plain version.

#include <cuda_runtime.h>

#define THREADS 128
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

extern "C" {

int ptnn_rw_params_size() { return (int)sizeof(RwParams); }

int ptnn_rw_block_threads() { return THREADS; }

// Launches one block per chain on `stream`; returns the cudaError_t of the
// attribute call or of the launch (0 = success). Does not synchronise.
int ptnn_rw_block(const RwParams* p, int smem_bytes, void* stream) {
  if (smem_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        rw_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  rw_block_kernel<<<p->chains, THREADS, smem_bytes, (cudaStream_t)stream>>>(*p);
  return (int)cudaGetLastError();
}

const char* ptnn_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
