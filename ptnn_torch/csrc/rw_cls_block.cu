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
// What bounds it. One chain-step evaluates the (I, H, O) FNN on every data
// row (iris (4, 12, 3): 150 rows of ~300 flops; Ionosphere (34, 50, 2): 354
// rows of ~3800), then one MH decision. The steps of a chain are serial, so
// a block's time is K times the latency of one step, not a bandwidth: the
// data rows and the weights live in shared memory, and device memory sees
// only the noise read and the trace rows written once a step.
//
// The TPU kernel puts 128 chains on the lanes and unrolls the forward onto
// (rows, chains) planes. Here one thread block owns one chain, the K-step
// loop runs inside the block and its threads split the data rows. Two
// kernels:
//   * rw_cls_fixed_kernel<I, H, O, WARPS>, for the networks of RW_CLS_FIXED
//     below (the classification sets the JAX package fuses), at the warps
//     a chain of RW_CLS_WARPS (ops/block_step.py `rw_cls_launch_plan`: as
//     many as the rows need while the grid fits one wave, else 4).
//     Compile-time shapes; a row a thread per pass; two barriers a step:
//       - weights up to W = 1852 do not fit a thread's registers, so the
//         forward reads them from shared memory as float4 broadcasts, in a
//         padded layout (`ClsPad`: each W1 row, B1 and each W2 column padded
//         to a multiple of 4 hidden units). The thread that owns entry t
//         (threads own t, t + T, ...) keeps w[t], w_last[t] and the step's
//         noise in registers, forms w'[t] = w[t] + step * noise[t] and
//         writes it to the proposal's slot; a barrier; every thread runs
//         its rows' forward from the slot.
//       - step k+1's noise and uniform depend on no state: their loads are
//         issued before step k's forward, into the owners' registers.
//       - each warp reduces its six sums (train err^2, train matches, test
//         err^2, test matches in six shuffles, `warp_reduce4`; the train ll
//         and sum w'^2 of its owned entries in float64, `warp_reduce2d`) and
//         writes them to its partial slot; after the second barrier every
//         thread sums the warps' partials in warp order, so every thread
//         takes the same MH decision, in float64 (`mh_accept`), and holds
//         the same carries (ll, prior, rmse and acc on train and test,
//         accept count, log step) without a broadcast barrier.
//     One barrier a step is possible (each thread forms w' itself in the
//     forward, from a w slot and a noise slot, two shared reads a weight)
//     and was measured: on the H100 80GB HBM3 it is 5 % slower at iris and
//     14-33 % at the larger networks (PERF.md), since a warp's broadcast
//     reads of the weights, not the barrier, bound the forward.
//     Thread 0 alone writes the scalar trace rows; the owner of an entry
//     writes its w trace.
//   * rw_cls_block_kernel, the generic kernel for any other (I, H, O) whose
//     block fits shared memory: runtime shapes, RW_THREADS threads, the
//     weights read from shared memory in the flat codec, each thread's
//     hidden and output activations in a column of shared scratch, three
//     barriers a step (proposal written, partial sums written, decision
//     written) and thread 0 deciding.
// The grid is one block per chain.
//
// Steps k >= length decide nothing and write the carries into their trace
// rows. Eta is not touched: the multinomial likelihood has no noise
// parameter. No fast-math: expf, logf and IEEE division, so the result
// stays within float rounding of the plain version; acc and rmse are exact
// functions of the first argmax.

#include "cls_common.cuh"

#define RW_THREADS 128  // threads a block of the generic kernel
#define RW_WARPS (RW_THREADS / 32)

// The (I, H, O) networks the fixed-shape kernel is built for, and its warps
// a chain. ops/block_step.py reads both tables from this file, and the
// library's queries are checked against them when it loads.
#define RW_CLS_FIXED(X) \
  X(4, 12, 3)           \
  X(9, 12, 2)           \
  X(9, 25, 2)           \
  X(34, 50, 2)
#define RW_CLS_WARPS(X) \
  X(16)                 \
  X(8)                  \
  X(4)

struct ClsRwParams {
  // inputs
  const float* rows;  // (n_tr + n_te, n_in + 1): x..., class index; train first
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
  int n_tr, n_te, n_in, n_hid, n_out, w_size, chains, k_max, start, length, adapt,
      burn_end;
  float step_w, adapt_rate, adapt_target, log_step_lo, log_step_hi, inv_n_tr, inv_n_te,
      acc_n_tr, acc_n_te;
  double prior_const, inv_two_sigma_sq;
};

// The block's decision sums: the train log-likelihood and sum w'^2 in
// float64; train err^2 and matches, test err^2 and matches (small integers,
// exact in float32).
//
// A chain-step's ll is a sum over hundreds of rows of size ~1 (|ll| 100 at
// iris, 600 at TicTac), so two float32 sums in different orders part by
// ~1e-4, and with them the acceptance probabilities: a decision within
// ~1e-4 of u may go either way, in the plain float32 version as in any
// other float32 order. Summed and decided in float64, as the plain version
// run in float64, the kernel's decisions part from the exact ones only
// within ~1e-7 of u.
__device__ __forceinline__ double warp_sum_d(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(CLS_MASK, v, off);
  return v;
}

// The MH decision from the float64 sums, as rw_block_reference takes it:
// the proposal's prior, log_mh = (ll' - ll) / T + (prior' - prior), accept
// iff u < a = exp(min(log_mh, 0)), taken as log u < min(log_mh, 0) with log
// u computed ahead; the divisions by T and 2 sigma^2 are products with
// reciprocals computed once. Returns the decision; `lmh` = min(log_mh, 0).
__device__ __forceinline__ bool mh_accept(const ClsRwParams& p, double ll_p, double ssq,
                                          double ll, double pr, double inv_at, double log_u,
                                          double& pr_p, double& lmh) {
  pr_p = p.prior_const - ssq * p.inv_two_sigma_sq;
  lmh = fmin((ll_p - ll) * inv_at + (pr_p - pr), 0.0);
  return log_u < lmh;
}

// ---------------------------------------------------------------------------
// The generic kernel.

__global__ void __launch_bounds__(RW_THREADS) rw_cls_block_kernel(const ClsRwParams p) {
  extern __shared__ double smem_d[];
  __shared__ float s_step;  // proposal scale of the next step
  __shared__ int s_accept;  // this step's decision

  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int NI = p.n_in, NH = p.n_hid, NO = p.n_out, W = p.w_size;
  const int stride = NI + 1;
  const int n_rows = p.n_tr + p.n_te;
  double* s_redd = smem_d;  // RW_WARPS x (ll, sum w'^2) partial sums
  float* s_red = reinterpret_cast<float*>(s_redd + 2 * RW_WARPS);  // RW_WARPS x 4
  float* s_rows = s_red + 4 * RW_WARPS;
  float* s_w = s_rows + n_rows * stride;
  float* s_wl = s_w + W;
  float* s_wp = s_wl + W;
  float* s_hid = s_wp + W;                 // (H, RW_THREADS): column tid
  float* s_out = s_hid + NH * RW_THREADS;  // (O, RW_THREADS)
  // flat codec [W1 (I x H), W2 (H x O, h-major), B1 (H), B2 (O)]
  const int S1 = NI * NH, S2 = S1 + NH * NO, B2 = S2 + NH;

  for (int i = tid; i < n_rows * stride; i += RW_THREADS) s_rows[i] = p.rows[i];
  const size_t cw = (size_t)c * W;
  for (int i = tid; i < W; i += RW_THREADS) {
    s_w[i] = p.w[cw + i];
    s_wl[i] = p.w_last[cw + i];
  }
  // scalar carries, held by thread 0
  double ll = 0.0, pr = 0.0;
  float rtr = 0.f, rte = 0.f, atr = 0.f, ate = 0.f, lsw = 0.f, at = 1.f;
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
      double ssq = 0.0;
      for (int i = tid; i < W; i += RW_THREADS) {
        const float v = s_w[i] + step * nw[i];
        s_wp[i] = v;
        ssq += (double)v * v;
      }
      __syncthreads();  // proposal visible

      // train err^2, train matches, test err^2, test matches; the train ll
      double ll_sum = 0.0;
      float sums[4] = {0.f, 0.f, 0.f, 0.f};
      float* hid = s_hid + tid;
      float* out = s_out + tid;
      for (int r = tid; r < n_rows; r += RW_THREADS) {
        const float* xr = s_rows + r * stride;
        for (int h = 0; h < NH; ++h) {  // as fixed_forward: bias last
          float z = 0.f;
          for (int i = 0; i < NI; ++i) z = __fmaf_rn(xr[i], s_wp[i * NH + h], z);
          hid[h * RW_THREADS] = cls_sigmoid(z - s_wp[S2 + h]);
        }
        float mx = 0.f, best = 0.f;
        int pred = 0;
        const int y = (int)xr[NI];
        for (int o = 0; o < NO; ++o) {
          float a = 0.f;
          for (int h = 0; h < NH; ++h)
            a = __fmaf_rn(hid[h * RW_THREADS], s_wp[S1 + h * NO + o], a);
          const float v = cls_sigmoid(a - s_wp[B2 + o]);
          out[o * RW_THREADS] = v;
          if (o == 0 || v > best) {  // first argmax
            best = v;
            pred = o;
          }
          mx = o == 0 ? v : fmaxf(mx, v);
        }
        float se = 0.f;
        for (int o = 0; o < NO; ++o) se += expf(out[o * RW_THREADS] - mx);
        const float err = (float)(pred - y);
        const float hit = (pred == y) ? 1.f : 0.f;
        if (r < p.n_tr) {
          ll_sum += out[y * RW_THREADS] - (mx + logf(se));
          sums[0] += err * err;
          sums[1] += hit;
        } else {
          sums[2] += err * err;
          sums[3] += hit;
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float v = cls_warp_sum(sums[q]);
        if (lane == 0) s_red[4 * warp + q] = v;
      }
      ll_sum = warp_sum_d(ll_sum);
      ssq = warp_sum_d(ssq);
      if (lane == 0) {
        s_redd[2 * warp] = ll_sum;
        s_redd[2 * warp + 1] = ssq;
      }
      __syncthreads();  // partial sums visible

      if (tid == 0) {
        float tot[4] = {0.f, 0.f, 0.f, 0.f};
        double ll_p = 0.0, sq = 0.0, pr_p, lmh;
#pragma unroll
        for (int v = 0; v < RW_WARPS; ++v) {
          ll_p += s_redd[2 * v];
          sq += s_redd[2 * v + 1];
#pragma unroll
          for (int q = 0; q < 4; ++q) tot[q] += s_red[4 * v + q];
        }
        const bool accept = mh_accept(p, ll_p, sq, ll, pr, 1.0 / at, log((double)u), pr_p, lmh);
        p.t_ll[kc] = (float)ll_p;  // classification records the UNTEMPERED ll
        if (accept) {
          rtr = sqrtf(tot[0] * p.inv_n_tr);
          atr = tot[1] * p.acc_n_tr;
          rte = sqrtf(tot[2] * p.inv_n_te);
          ate = tot[3] * p.acc_n_te;
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
          if (p.start + k < p.burn_end)
            lsw += p.adapt_rate * (expf((float)lmh) - p.adapt_target);
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
      p.t_ll[kc] = (float)ll;
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
    p.o_ll[c] = (float)ll;
    p.o_prior[c] = (float)pr;
    p.o_rmse_tr[c] = rtr;
    p.o_rmse_te[c] = rte;
    p.o_acc_tr[c] = atr;
    p.o_acc_te[c] = ate;
    p.o_n_accept[c] = na;
    p.o_log_step[c] = lsw;
  }
}

// Floats of the generic kernel's shared memory: the partial sums (two
// doubles and four floats a warp), the data rows, three weight vectors and
// the (H + O) x RW_THREADS activation scratch.
__host__ __device__ constexpr int rw_cls_generic_smem_floats(int n_rows, int ni, int nh,
                                                             int no) {
  return 8 * RW_WARPS + n_rows * (ni + 1) + 3 * (ni * nh + nh * no + nh + no) +
         (nh + no) * RW_THREADS;
}

// ---------------------------------------------------------------------------
// The fixed-shape kernel.

// The padded weight layout of a slot: W1 as I rows of HP floats, B1, then W2
// as O columns of HP floats (o-major), then B2; HP is H rounded up to 4, so
// the forward reads each as float4. Entries past H (and past O) hold zeros.
template <int NI, int NH, int NO>
struct ClsPad {
  static constexpr int HP = (NH + 3) / 4 * 4;
  static constexpr int B1 = NI * HP;
  static constexpr int W2 = B1 + HP;
  static constexpr int B2 = W2 + NO * HP;
  static constexpr int SLOT = B2 + (NO + 3) / 4 * 4;  // floats of a slot

  // the slot position of flat-codec entry t
  __device__ static int pos(int t) {
    using N = ClsNet<NI, NH, NO>;
    if (t < N::S1) return (t / NH) * HP + t % NH;
    if (t < N::S2) return W2 + ((t - N::S1) % NO) * HP + (t - N::S1) / NO;
    if (t < N::B2) return B1 + (t - N::S2);
    return B2 + (t - N::B2);
  }
};

__host__ __device__ constexpr int rw_cls_slot(int ni, int nh, int no) {
  return (ni + 1 + no) * ((nh + 3) / 4 * 4) + (no + 3) / 4 * 4;
}

// Floats of the fixed-shape kernel's shared memory: the data rows (padded
// to 16 bytes), the proposal's slot and an 8-float partial slot per warp.
__host__ __device__ constexpr int rw_cls_fixed_smem_floats(int n_rows, int ni, int nh, int no,
                                                           int warps) {
  return (n_rows * (ni + 1) + 3) / 4 * 4 + rw_cls_slot(ni, nh, no) + warps * 8;
}

// The warp's sums of v[0..3] in six shuffles: a reduce-scatter over lane
// bits 4 and 3 halves the values a lane holds, then three butterflies; lane
// l ends with the sum of v[(l >> 3) & 3].
__device__ __forceinline__ float warp_reduce4(const float (&v)[4], int lane) {
  const bool h4 = lane & 16, h3 = lane & 8;
  float a[2];
#pragma unroll
  for (int j = 0; j < 2; ++j)
    a[j] = (h4 ? v[j + 2] : v[j]) + __shfl_xor_sync(CLS_MASK, h4 ? v[j] : v[j + 2], 16);
  float s = (h3 ? a[1] : a[0]) + __shfl_xor_sync(CLS_MASK, h3 ? a[0] : a[1], 8);
  s += __shfl_xor_sync(CLS_MASK, s, 4);
  s += __shfl_xor_sync(CLS_MASK, s, 2);
  s += __shfl_xor_sync(CLS_MASK, s, 1);
  return s;
}

// The warp's sums of two doubles in five shuffles: lanes below 16 end with
// the sum of a, the others with the sum of b.
__device__ __forceinline__ double warp_reduce2d(double a, double b, int lane) {
  const bool h4 = lane & 16;
  double s = (h4 ? b : a) + __shfl_xor_sync(CLS_MASK, h4 ? a : b, 16);
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) s += __shfl_xor_sync(CLS_MASK, s, off);
  return s;
}

// The forward of the row at xr under the proposal in the slot `wp`:
// sigmoid outputs `out`. Each layer sums its products from the first input
// on and then subtracts the bias, in the order of the plain version's
// matrix products (`fnn.batched_forward`), so that the two round alike and
// a first argmax that rounding could flip is rare. The hidden units go in
// groups of G, each summed over the inputs, squashed and added into the
// outputs before the next, so a thread holds G hidden sums, not H.
template <int NI, int NH, int NO>
__device__ __forceinline__ void fixed_forward(const float* xr, const float* wp,
                                              float (&out)[NO]) {
  using P = ClsPad<NI, NH, NO>;
  constexpr int G = P::HP < 16 ? P::HP : 16;
  // inputs unrolled in full for the small networks; by 2 for Ionosphere's
  // 34, whose loads issued ahead would otherwise take more registers than
  // 16 warps a block leave a thread (128)
  constexpr int UI = NI <= 16 ? NI : 2;
  const float4* w4 = reinterpret_cast<const float4*>(wp);
  float a[NO];
#pragma unroll
  for (int o = 0; o < NO; ++o) a[o] = 0.f;
#pragma unroll
  for (int h0 = 0; h0 < P::HP; h0 += G) {
    float z[G];
#pragma unroll
    for (int j = 0; j < G; ++j) z[j] = 0.f;
#pragma unroll (UI)
    for (int i = 0; i < NI; ++i) {
      const float x = xr[i];
#pragma unroll
      for (int q = 0; q < G / 4; ++q) {
        if (h0 + 4 * q < P::HP) {
          const float4 v = w4[(i * P::HP + h0) / 4 + q];
          z[4 * q] = __fmaf_rn(x, v.x, z[4 * q]);
          if (h0 + 4 * q + 1 < NH) z[4 * q + 1] = __fmaf_rn(x, v.y, z[4 * q + 1]);
          if (h0 + 4 * q + 2 < NH) z[4 * q + 2] = __fmaf_rn(x, v.z, z[4 * q + 2]);
          if (h0 + 4 * q + 3 < NH) z[4 * q + 3] = __fmaf_rn(x, v.w, z[4 * q + 3]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < G / 4; ++q) {
      if (h0 + 4 * q < P::HP) {
        const float4 b = w4[(P::B1 + h0) / 4 + q];
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (h0 + 4 * q + j < NH) z[4 * q + j] = cls_sigmoid(z[4 * q + j] - bv[j]);
      }
    }
#pragma unroll
    for (int o = 0; o < NO; ++o) {
#pragma unroll
      for (int q = 0; q < G / 4; ++q) {
        if (h0 + 4 * q < P::HP) {
          const float4 v = w4[(P::W2 + o * P::HP + h0) / 4 + q];
          a[o] = __fmaf_rn(z[4 * q], v.x, a[o]);
          if (h0 + 4 * q + 1 < NH) a[o] = __fmaf_rn(z[4 * q + 1], v.y, a[o]);
          if (h0 + 4 * q + 2 < NH) a[o] = __fmaf_rn(z[4 * q + 2], v.z, a[o]);
          if (h0 + 4 * q + 3 < NH) a[o] = __fmaf_rn(z[4 * q + 3], v.w, a[o]);
        }
      }
    }
  }
  const float4 b2 = w4[P::B2 / 4];
  const float b2v[4] = {b2.x, b2.y, b2.z, b2.w};
#pragma unroll
  for (int o = 0; o < NO; ++o) out[o] = cls_sigmoid(a[o] - b2v[o]);
}

template <int NI, int NH, int NO, int NW>
__global__ void __launch_bounds__(NW * 32, 1) rw_cls_fixed_kernel(const ClsRwParams p) {
  using N = ClsNet<NI, NH, NO>;
  using P = ClsPad<NI, NH, NO>;
  constexpr int T = NW * 32, W = N::W;
  constexpr int E = (W + T - 1) / T;  // entries a thread owns: tid, tid + T, ...
  static_assert(NO <= 4, "B2 fills one float4");
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int c = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_rows = p.n_tr + p.n_te;
  float* s_rows = smem;
  float* s_wp = smem + (n_rows * (NI + 1) + 3) / 4 * 4;  // the proposal
  // NW x (ll, sum w'^2) double and NW x 4 float partial sums
  double* s_redd = reinterpret_cast<double*>(s_wp + P::SLOT);
  float* s_red = reinterpret_cast<float*>(s_redd + 2 * NW);

  for (int i = tid; i < n_rows * (NI + 1); i += T) s_rows[i] = p.rows[i];
  for (int i = tid; i < P::SLOT; i += T) s_wp[i] = 0.f;  // the pads stay 0
  const size_t cw = (size_t)c * W;
  const float* nw0 = p.noise_w + cw;  // step k's noise row: nw0 + k * C * W
  const size_t nstep = (size_t)p.chains * W;
  // the entries this thread owns: w, w_last, this step's noise
  float my_w[E], my_wl[E], my_nz[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int t = tid + e * T;
    my_w[e] = t < W ? p.w[cw + t] : 0.f;
    my_wl[e] = t < W ? p.w_last[cw + t] : 0.f;
    my_nz[e] = t < W && p.length > 0 ? nw0[t] : 0.f;
  }
  double log_u = log(p.length > 0 ? (double)p.u[c] : 0.0);  // this step's
  // scalar carries: every thread holds the same values
  double ll = p.ll[c], pr = p.prior[c];
  float rtr = p.rmse_tr[c], rte = p.rmse_te[c], atr = p.acc_tr[c], ate = p.acc_te[c],
        lsw = p.log_step[c];
  const double inv_at = 1.0 / (double)p.at[c];
  int na = p.n_accept[c];
  float step = p.adapt ? expf(lsw) : p.step_w;
  __syncthreads();  // the pads zeroed before any owner writes

  for (int k = 0; k < p.k_max; ++k) {
    const size_t kc = (size_t)k * p.chains + c;
    if (k < p.length) {  // uniform over the block
      // the owned entries of w', written to the proposal's slot: every read
      // of the slot and of the partials happened before the last barrier
      float my_wp[E];
      double ssq = 0.0;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        my_wp[e] = __fmaf_rn(step, my_nz[e], my_w[e]);
        if (tid + e * T < W) {
          s_wp[P::pos(tid + e * T)] = my_wp[e];
          ssq += (double)my_wp[e] * my_wp[e];
        }
      }
      // step k+1's noise and uniform: loads issued now, used next step
      const bool fetch = k + 1 < p.length;
      float u_next = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e)
        my_nz[e] = fetch && tid + e * T < W ? nw0[(k + 1) * nstep + tid + e * T] : 0.f;
      if (fetch) u_next = p.u[kc + p.chains];
      __syncthreads();  // the proposal visible

      // train err^2, train matches, test err^2, test matches; the train ll
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      double ll_sum = 0.0;
#pragma unroll 1
      for (int r = tid; r < n_rows; r += T) {
        const float* xr = s_rows + r * (NI + 1);
        // a slot offset the compiler cannot see through: the weights are
        // loaded row by row, not hoisted out of the loop into W registers
        int off = 0;
        asm volatile("" : "+r"(off));
        float out[NO];
        fixed_forward<NI, NH, NO>(xr, s_wp + off, out);
        const int y = (int)xr[NI];
        const int pred = cls_argmax<NO>(out);
        const float err = (float)(pred - y);
        const float hit = (pred == y) ? 1.f : 0.f;
        if (r < p.n_tr) {
          ll_sum += cls_pick<NO>(out, y) - cls_lse<NO>(out);
          v[0] += err * err;
          v[1] += hit;
        } else {
          v[2] += err * err;
          v[3] += hit;
        }
      }
      const float part = warp_reduce4(v, lane);
      if ((lane & 7) == 0) s_red[4 * warp + (lane >> 3)] = part;
      const double part_d = warp_reduce2d(ll_sum, ssq, lane);
      if ((lane & 15) == 0) s_redd[2 * warp + (lane >> 4)] = part_d;
      const double log_u_next = log((double)u_next);  // the load has landed
      __syncthreads();  // the partial sums visible

      float tot[4] = {0.f, 0.f, 0.f, 0.f};
      double ll_p = 0.0, sq = 0.0;
#pragma unroll
      for (int q = 0; q < NW; ++q) {
        const double2 d = reinterpret_cast<const double2*>(s_redd)[q];
        const float4 f = reinterpret_cast<const float4*>(s_red)[q];
        ll_p += d.x;
        sq += d.y;
        tot[0] += f.x;
        tot[1] += f.y;
        tot[2] += f.z;
        tot[3] += f.w;
      }
      double pr_p, lmh;
      const bool accept = mh_accept(p, ll_p, sq, ll, pr, inv_at, log_u, pr_p, lmh);
      if (accept) {
        rtr = sqrtf(tot[0] * p.inv_n_tr);
        atr = tot[1] * p.acc_n_tr;
        rte = sqrtf(tot[2] * p.inv_n_te);
        ate = tot[3] * p.acc_n_te;
        ll = ll_p;
        pr = pr_p;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          my_w[e] = my_wp[e];
          my_wl[e] = my_wp[e];
        }
      }
      if (tid == 0) {
        p.t_ll[kc] = (float)ll_p;  // classification records the UNTEMPERED ll
        p.t_rmse_tr[kc] = rtr;
        p.t_rmse_te[kc] = rte;
        p.t_acc_tr[kc] = atr;
        p.t_acc_te[kc] = ate;
        p.t_accept[kc] = na;  // count BEFORE this step's decision
      }
      na += accept ? 1 : 0;
      if (p.adapt) {
        if (p.start + k < p.burn_end)
          lsw += p.adapt_rate * (expf((float)lmh) - p.adapt_target);
        lsw = fminf(fmaxf(lsw, p.log_step_lo), p.log_step_hi);
        step = expf(lsw);
      }
      log_u = log_u_next;
    } else {
      if (tid == 0) {
        p.t_ll[kc] = (float)ll;
        p.t_rmse_tr[kc] = rtr;
        p.t_rmse_te[kc] = rte;
        p.t_acc_tr[kc] = atr;
        p.t_acc_te[kc] = ate;
        p.t_accept[kc] = na;
      }
      if (p.adapt) lsw = fminf(fmaxf(lsw, p.log_step_lo), p.log_step_hi);
    }
    if (p.t_w != nullptr) {
      float* tw = p.t_w + kc * W;
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (tid + e * T < W) tw[tid + e * T] = my_wl[e];
    }
  }

#pragma unroll
  for (int e = 0; e < E; ++e) {
    if (tid + e * T < W) {
      p.o_w[cw + tid + e * T] = my_w[e];
      p.o_w_last[cw + tid + e * T] = my_wl[e];
    }
  }
  if (tid == 0) {
    p.o_ll[c] = (float)ll;
    p.o_prior[c] = (float)pr;
    p.o_rmse_tr[c] = rtr;
    p.o_rmse_te[c] = rte;
    p.o_acc_tr[c] = atr;
    p.o_acc_te[c] = ate;
    p.o_n_accept[c] = na;
    p.o_log_step[c] = lsw;
  }
}

static int set_smem(const void* kern, int smem_bytes) {
  if (smem_bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   smem_bytes);
}

template <int NI, int NH, int NO, int NW>
static int launch_fixed(const ClsRwParams* p, int smem_bytes, cudaStream_t stream) {
  auto kern = rw_cls_fixed_kernel<NI, NH, NO, NW>;
  const int e = set_smem((const void*)kern, smem_bytes);
  if (e != 0) return e;
  kern<<<p->chains, NW * 32, smem_bytes, stream>>>(*p);
  return (int)cudaGetLastError();
}

// The fixed-shape launch of (I, H, O) at `warps` warps a chain; -1 when p
// is another network.
template <int NI, int NH, int NO>
static int try_fixed(const ClsRwParams* p, int smem_bytes, int warps, cudaStream_t stream) {
  if (p->n_in != NI || p->n_hid != NH || p->n_out != NO) return -1;
#define WARPS_CASE(NW) \
  if (warps == NW) return launch_fixed<NI, NH, NO, NW>(p, smem_bytes, stream);
  RW_CLS_WARPS(WARPS_CASE)
#undef WARPS_CASE
  return (int)cudaErrorInvalidValue;
}

extern "C" {

int ptnn_rw_cls_params_size() { return (int)sizeof(ClsRwParams); }

int ptnn_rw_cls_block_threads() { return RW_THREADS; }

// Writes the (I, H, O) of RW_CLS_FIXED (or the warps of RW_CLS_WARPS, one
// int a row) into `out` (room for `n` rows); returns their number.
int ptnn_rw_cls_fixed_layouts(int* out, int n) {
  int k = 0;
#define ROW(I, H, O)     \
  if (k < n) {           \
    out[3 * k] = I;      \
    out[3 * k + 1] = H;  \
    out[3 * k + 2] = O;  \
  }                      \
  ++k;
  RW_CLS_FIXED(ROW)
#undef ROW
  return k;
}

int ptnn_rw_cls_warps(int* out, int n) {
  int k = 0;
#define ROW(NW) \
  if (k < n) out[k] = NW; \
  ++k;
  RW_CLS_WARPS(ROW)
#undef ROW
  return k;
}

int ptnn_rw_cls_smem_floats(int n_rows, int ni, int nh, int no, int fixed, int warps) {
  return fixed ? rw_cls_fixed_smem_floats(n_rows, ni, nh, no, warps)
               : rw_cls_generic_smem_floats(n_rows, ni, nh, no);
}

// Launches one block per chain on `stream`: the fixed-shape kernel at
// `warps` warps a chain (`fixed` != 0; the network must be one of
// RW_CLS_FIXED), else the generic kernel of RW_THREADS threads. Returns the
// cudaError_t of the attribute call or of the launch (0 = success). Does
// not synchronise.
int ptnn_rw_cls_block(const ClsRwParams* p, int smem_bytes, int fixed, int warps, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (fixed) {
#define TRY(I, H, O)                                                \
  {                                                                 \
    const int e = try_fixed<I, H, O>(p, smem_bytes, warps, st);     \
    if (e >= 0) return e;                                           \
  }
    RW_CLS_FIXED(TRY)
#undef TRY
    return (int)cudaErrorInvalidValue;
  }
  const int e = set_smem((const void*)rw_cls_block_kernel, smem_bytes);
  if (e != 0) return e;
  rw_cls_block_kernel<<<p->chains, RW_THREADS, smem_bytes, st>>>(*p);
  return (int)cudaGetLastError();
}

}  // extern "C"
