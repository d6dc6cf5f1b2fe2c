// A fused block of K random-walk Metropolis-Hastings steps for every chain
// of the parallel-tempering ladder, classification task, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel ptnn/ops/pallas_step.py `_rw_block_kernel`,
// classification branch (`task_cls`; wrapper `fused_rw_block_impl`). The
// plain PyTorch version of the same function is `rw_block_reference` in
// ptnn_torch/ops/block_step.py (with `scal["task_cls"]`), whose docstring
// states the semantics; the regression branch is rw_block.cu.
//
// What bounds it. One chain-step evaluates the (4, 12, 3) FNN on the 150
// iris rows (105 train, 45 test): per row 12 hidden units of 4 FMAs and a
// sigmoid, 36 FMAs and 3 sigmoids to the outputs, then the log-sum-exp and
// the argmax; about 300 flops a row, 45k a step. The steps of a chain are
// serial, so a block's time is K times the latency of one step (proposal
// -> forward -> block reduction -> decision), not a bandwidth or a flop
// rate: the data (3 KB) and the weights live in shared memory, and device
// memory sees only the noise read and the trace rows written once a step.
//
// Design. As rw_block.cu: one thread block of 128 threads per chain, the
// K-step loop inside the block; the data rows and the chain's current,
// last-accepted and proposed weights in shared memory; threads split the
// rows (two at most each); warp shuffles then one shared-memory pass reduce
// the six sums (train ll, train and test squared class-index errors and
// matches, sum w'^2); thread 0 takes the MH decision, owns the scalar
// carries and writes the trace rows. The forward is cls_common.cuh's, the
// MALA/HMC kernels' own, instantiated for (4, 12, 3). Eta is not touched:
// the multinomial likelihood has no noise parameter.
//
// Steps k >= length decide nothing and write the carries into their trace
// rows. No fast-math.

#include "cls_common.cuh"

#define RW_THREADS 128
#define RW_WARPS (RW_THREADS / 32)
#define N_SUMS 6

struct ClsRwParams {
  // inputs
  const float* rows;  // (n_tr + n_te, NI + 1): x..., class index; train first
  const float* at;    // (C,) adaptive temperature
  const float* w;     // (C, W)
  const float* w_last;
  const float* ll;  // (C,) untempered
  const float* prior;
  const float* rmse_tr;
  const float* rmse_te;
  const float* acc_tr;
  const float* acc_te;
  const int* n_accept;
  const float* log_step;
  const float* noise_w;  // (K, C, W)
  const float* u;        // (K, C)
  // outputs: new state
  float* o_w;
  float* o_w_last;
  float* o_ll;
  float* o_prior;
  float* o_rmse_tr;
  float* o_rmse_te;
  float* o_acc_tr;
  float* o_acc_te;
  int* o_n_accept;
  float* o_log_step;
  // outputs: trace rows (K, C), and (K, C, W) weights or null
  float* t_ll;
  float* t_rmse_tr;
  float* t_rmse_te;
  float* t_acc_tr;
  float* t_acc_te;
  int* t_accept;
  float* t_w;
  int n_tr, n_te, chains, k_max, start, length, adapt, burn_end;
  float step_w, prior_const, two_sigma_sq, adapt_rate, adapt_target, log_step_lo,
      log_step_hi, inv_n_tr, inv_n_te, acc_n_tr, acc_n_te;
};

template <int NI, int NH, int NO>
__global__ void __launch_bounds__(RW_THREADS) rw_cls_block_kernel(const ClsRwParams p) {
  extern __shared__ float smem[];
  __shared__ float s_step;  // proposal scale of the next step
  __shared__ int s_accept;  // this step's decision
  using N = ClsNet<NI, NH, NO>;
  constexpr int W = N::W;

  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int n_rows = p.n_tr + p.n_te;
  float* s_rows = smem;
  float* s_w = s_rows + n_rows * (NI + 1);
  float* s_wl = s_w + W;
  float* s_wp = s_wl + W;
  float* s_red = s_wp + W;  // N_SUMS * RW_WARPS partial sums

  for (int i = tid; i < n_rows * (NI + 1); i += RW_THREADS) s_rows[i] = p.rows[i];
  const size_t cw = (size_t)c * W;
  for (int i = tid; i < W; i += RW_THREADS) {
    s_w[i] = p.w[cw + i];
    s_wl[i] = p.w_last[cw + i];
  }
  // scalar carries, held by thread 0
  float ll = 0.f, pr = 0.f, rtr = 0.f, rte = 0.f, atr = 0.f, ate = 0.f, lsw = 0.f,
        at = 1.f;
  int na = 0;
  if (tid == 0) {
    ll = p.ll[c];
    pr = p.prior[c];
    rtr = p.rmse_tr[c];
    rte = p.rmse_te[c];
    atr = p.acc_tr[c];
    ate = p.acc_te[c];
    na = p.n_accept[c];
    lsw = p.log_step[c];
    at = p.at[c];
    s_step = p.adapt ? expf(lsw) : p.step_w;
  }
  __syncthreads();

  for (int k = 0; k < p.k_max; ++k) {
    const size_t kc = (size_t)k * p.chains + c;
    if (k < p.length) {  // uniform over the block
      const float u = tid == 0 ? p.u[kc] : 0.f;  // loaded early
      const float step = s_step;
      const float* nw = p.noise_w + kc * W;
      float ssq = 0.f;
      for (int i = tid; i < W; i += RW_THREADS) {
        const float v = s_w[i] + step * nw[i];
        s_wp[i] = v;
        ssq += v * v;
      }
      __syncthreads();  // proposal visible

      // train ll, train err^2, train matches, test err^2, test matches
      float sums[N_SUMS] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      for (int r = tid; r < n_rows; r += RW_THREADS) {
        float x[NI], s[NH], out[NO];
        const int y = cls_load_row<NI>(s_rows + r * (NI + 1), x);
        cls_forward<NI, NH, NO>(x, s_wp, s, out);
        const int pred = cls_argmax<NO>(out);
        const float err = (float)(pred - y);
        const float hit = (pred == y) ? 1.f : 0.f;
        if (r < p.n_tr) {
          sums[0] += cls_pick<NO>(out, y) - cls_lse<NO>(out);
          sums[1] += err * err;
          sums[2] += hit;
        } else {
          sums[3] += err * err;
          sums[4] += hit;
        }
      }
      sums[5] = ssq;
#pragma unroll
      for (int q = 0; q < N_SUMS; ++q) {
        const float v = cls_warp_sum(sums[q]);
        if (lane == 0) s_red[q * RW_WARPS + warp] = v;
      }
      __syncthreads();  // partial sums visible

      if (tid == 0) {
        float tot[N_SUMS];
#pragma unroll
        for (int q = 0; q < N_SUMS; ++q) {
          tot[q] = 0.f;
#pragma unroll
          for (int v = 0; v < RW_WARPS; ++v) tot[q] += s_red[q * RW_WARPS + v];
        }
        const float pr_p = p.prior_const - tot[5] / p.two_sigma_sq;
        const float ll_p = tot[0];
        const float log_mh = (ll_p - ll) / at + (pr_p - pr);
        const float a = expf(fminf(log_mh, 0.f));
        const bool accept = u < a;
        p.t_ll[kc] = ll_p;  // classification records the UNTEMPERED ll
        if (accept) {
          rtr = sqrtf(tot[1] * p.inv_n_tr);
          atr = tot[2] * p.acc_n_tr;
          rte = sqrtf(tot[3] * p.inv_n_te);
          ate = tot[4] * p.acc_n_te;
          ll = ll_p;
          pr = pr_p;
        }
        p.t_rmse_tr[kc] = rtr;
        p.t_rmse_te[kc] = rte;
        p.t_acc_tr[kc] = atr;
        p.t_acc_te[kc] = ate;
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
        for (int i = tid; i < W; i += RW_THREADS) {
          s_w[i] = s_wp[i];
          s_wl[i] = s_wp[i];
        }
      }
    } else if (tid == 0) {
      p.t_ll[kc] = ll;
      p.t_rmse_tr[kc] = rtr;
      p.t_rmse_te[kc] = rte;
      p.t_acc_tr[kc] = atr;
      p.t_acc_te[kc] = ate;
      p.t_accept[kc] = na;
      if (p.adapt) lsw = fminf(fmaxf(lsw, p.log_step_lo), p.log_step_hi);
    }
    if (p.t_w != nullptr) {
      // each thread writes the w_last entries it owns (it also updated them)
      float* tw = p.t_w + kc * W;
      for (int i = tid; i < W; i += RW_THREADS) tw[i] = s_wl[i];
    }
  }

  for (int i = tid; i < W; i += RW_THREADS) {
    p.o_w[cw + i] = s_w[i];
    p.o_w_last[cw + i] = s_wl[i];
  }
  if (tid == 0) {
    p.o_ll[c] = ll;
    p.o_prior[c] = pr;
    p.o_rmse_tr[c] = rtr;
    p.o_rmse_te[c] = rte;
    p.o_acc_tr[c] = atr;
    p.o_acc_te[c] = ate;
    p.o_n_accept[c] = na;
    p.o_log_step[c] = lsw;
  }
}

extern "C" {

int ptnn_rw_cls_params_size() { return (int)sizeof(ClsRwParams); }

int ptnn_rw_cls_block_threads() { return RW_THREADS; }

// Launches one block per chain on `stream`; returns the cudaError_t of the
// attribute call or of the launch (0 = success). Does not synchronise.
int ptnn_rw_cls_block(const ClsRwParams* p, int smem_bytes, void* stream) {
  auto kern = rw_cls_block_kernel<4, 12, 3>;
  if (smem_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<p->chains, RW_THREADS, smem_bytes, (cudaStream_t)stream>>>(*p);
  return (int)cudaGetLastError();
}

}  // extern "C"
