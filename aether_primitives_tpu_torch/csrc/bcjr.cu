// Windowed max-log BCJR for Hopper (sm_90a): one thread per span column.
//
// Replaces the TPU kernel aether_primitives_tpu/ops/pallas/bcjr.py:
// _bcjr_kernel (wrapper bcjr_windowed_llr) and is bit-identical to the JAX
// package's windowed scan (ops/turbo.py _bcjr_maxlog_windowed). It takes any
// binary trellis with two LLR streams as the tables (nxt, prev_s, fw0, fw1,
// bw0, bw1) [S][2]: the RSC-8 turbo constituent (S = 8) or a rate-1/2
// feedforward code (S = 64 at K = 7). Per column, over Lw steps, from
// uniform (zero) metrics at both ends:
//   backward  store beta (the metrics after step t), then
//             beta'[s] = max_u beta[nxt[s][u]] + (bw0[s][u] ls + bw1[s][u] lp),
//             beta' -= max over states
//   forward   llr[t] = max_s ((alpha[s] + (bw0[s][0] ls + bw1[s][0] lp))
//                             + beta_t[nxt[s][0]])  - the same for u = 1,
//             alpha'[s'] = max_j alpha[prev_s[s'][j]]
//                          + (fw0[s'][j] ls + fw1[s'][j] lp), alpha' -= max
// with exactly that parenthesisation, every add and multiply as __fadd_rn /
// __fmul_rn, and no fast math, so the LLRs equal the scan's bit for bit.
//
// What bounds it on an H100: the serial chain. At the turbo path's shape
// (Lw 96, 2,560 columns, S 8) a launch does 67 M FP32 operations (34 S + 1
// per step and column: 1.0 us at 67 TFLOP/s, the roofline bound) and must
// read 2 x 0.98 MB of LLR spans and write 0.98 MB of LLRs (0.9 us at
// 3.35 TB/s); both are far below what 2,560 threads, 20 blocks on 132 SMs,
// each walking a 192-step dependent chain, can reach: the launch is
// latency-bound.
// What the design does about it: the recursions run one column per thread
// with the trellis tables as kernel parameters (constant bank) and each
// thread's metric column in shared memory ([S][threads], so the table-indexed
// reads of a warp hit 32 consecutive words); the beta history, Lw x S x 4
// bytes per column (7.9 MB at the path's shape), goes to a global scratch
// laid out [Lw][S][N] so that every store and load is coalesced along N and
// stays in the 50 MB L2. A ragged N is masked per thread.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

template <int S>
struct Tables {
  int nxt[2 * S];
  int prev[2 * S];
  float fw0[2 * S];
  float fw1[2 * S];
  float bw0[2 * S];
  float bw1[2 * S];
};

__device__ __forceinline__ float branch_metric(float c0, float c1, float ls, float lp) {
  return __fadd_rn(__fmul_rn(c0, ls), __fmul_rn(c1, lp));
}

template <int S>
__global__ void __launch_bounds__(kThreads)
bcjr_kernel(const float* __restrict__ ls, const float* __restrict__ lp,
            float* __restrict__ llr, float* __restrict__ beta_hist, int lw,
            long long ncols, const Tables<S> tb) {
  extern __shared__ float metric[];  // [S][kThreads]: this thread's column
  const long long col = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (col >= ncols) return;  // no block-wide sync below
  float* m = metric + threadIdx.x;

#pragma unroll
  for (int s = 0; s < S; ++s) m[s * kThreads] = 0.0f;
  for (int i = 0; i < lw; ++i) {
    const int t = lw - 1 - i;
    const float ls_t = __ldg(ls + t * ncols + col);
    const float lp_t = __ldg(lp + t * ncols + col);
    float* hist = beta_hist + static_cast<long long>(t) * S * ncols + col;
    float b[S];
#pragma unroll
    for (int s = 0; s < S; ++s) hist[s * ncols] = m[s * kThreads];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float c0 = __fadd_rn(m[tb.nxt[2 * s] * kThreads],
                                 branch_metric(tb.bw0[2 * s], tb.bw1[2 * s], ls_t, lp_t));
      const float c1 = __fadd_rn(m[tb.nxt[2 * s + 1] * kThreads],
                                 branch_metric(tb.bw0[2 * s + 1], tb.bw1[2 * s + 1], ls_t, lp_t));
      b[s] = fmaxf(c0, c1);
    }
    float mx = b[0];
#pragma unroll
    for (int s = 1; s < S; ++s) mx = fmaxf(mx, b[s]);
#pragma unroll
    for (int s = 0; s < S; ++s) m[s * kThreads] = __fsub_rn(b[s], mx);
  }

#pragma unroll
  for (int s = 0; s < S; ++s) m[s * kThreads] = 0.0f;
  for (int t = 0; t < lw; ++t) {
    const float ls_t = __ldg(ls + t * ncols + col);
    const float lp_t = __ldg(lp + t * ncols + col);
    const float* hist = beta_hist + static_cast<long long>(t) * S * ncols + col;
    float m0 = 0.0f, m1 = 0.0f;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float a = m[s * kThreads];
      const float c0 = __fadd_rn(__fadd_rn(a, branch_metric(tb.bw0[2 * s], tb.bw1[2 * s], ls_t, lp_t)),
                                 hist[tb.nxt[2 * s] * ncols]);
      const float c1 = __fadd_rn(__fadd_rn(a, branch_metric(tb.bw0[2 * s + 1], tb.bw1[2 * s + 1], ls_t, lp_t)),
                                 hist[tb.nxt[2 * s + 1] * ncols]);
      m0 = s == 0 ? c0 : fmaxf(m0, c0);
      m1 = s == 0 ? c1 : fmaxf(m1, c1);
    }
    llr[t * ncols + col] = __fsub_rn(m0, m1);
    float a_new[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float c0 = __fadd_rn(m[tb.prev[2 * s] * kThreads],
                                 branch_metric(tb.fw0[2 * s], tb.fw1[2 * s], ls_t, lp_t));
      const float c1 = __fadd_rn(m[tb.prev[2 * s + 1] * kThreads],
                                 branch_metric(tb.fw0[2 * s + 1], tb.fw1[2 * s + 1], ls_t, lp_t));
      a_new[s] = fmaxf(c0, c1);
    }
    float mx = a_new[0];
#pragma unroll
    for (int s = 1; s < S; ++s) mx = fmaxf(mx, a_new[s]);
#pragma unroll
    for (int s = 0; s < S; ++s) m[s * kThreads] = __fsub_rn(a_new[s], mx);
  }
}

template <int S>
int launch(const void* ls, const void* lp, void* llr, void* scratch, int lw,
           long long ncols, const int* idx, const float* coef, cudaStream_t stream) {
  Tables<S> tb;
  for (int i = 0; i < 2 * S; ++i) {
    tb.nxt[i] = idx[i];
    tb.prev[i] = idx[2 * S + i];
    tb.fw0[i] = coef[i];
    tb.fw1[i] = coef[2 * S + i];
    tb.bw0[i] = coef[4 * S + i];
    tb.bw1[i] = coef[6 * S + i];
  }
  const size_t smem = static_cast<size_t>(S) * kThreads * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      bcjr_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (ncols + kThreads - 1) / kThreads;
  bcjr_kernel<S><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const float*>(ls), static_cast<const float*>(lp),
      static_cast<float*>(llr), static_cast<float*>(scratch), lw, ncols, tb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, loaded with ctypes. Returns the cudaError_t of the
// launch (0 = success). The caller guarantees: ls, lp, llr float32 [lw, ncols]
// and scratch float32 [lw, s_count, ncols], contiguous; s_count in
// {4, 8, 16, 32, 64}; idx a host int32 array [nxt; prev_s] of 2 x s_count x 2
// entries with every entry in [0, s_count); coef a host float32 array
// [fw0; fw1; bw0; bw1] of 4 x s_count x 2 entries.
extern "C" int bcjr_launch(const void* ls, const void* lp, void* llr, void* scratch,
                           int lw, long long ncols, int s_count, const int* idx,
                           const float* coef, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (s_count) {
    case 4: return launch<4>(ls, lp, llr, scratch, lw, ncols, idx, coef, s);
    case 8: return launch<8>(ls, lp, llr, scratch, lw, ncols, idx, coef, s);
    case 16: return launch<16>(ls, lp, llr, scratch, lw, ncols, idx, coef, s);
    case 32: return launch<32>(ls, lp, llr, scratch, lw, ncols, idx, coef, s);
    case 64: return launch<64>(ls, lp, llr, scratch, lw, ncols, idx, coef, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
