// Windowed max-log BCJR for Hopper (sm_90a), in two instances.
//
// Replaces the TPU kernel aether_primitives_tpu/ops/pallas/bcjr.py:
// _bcjr_kernel (wrapper bcjr_windowed_llr) and is bit-identical to the JAX
// package's windowed scan (ops/turbo.py _bcjr_maxlog_windowed). It takes any
// binary trellis with two LLR streams as the tables (nxt, prev_s, fw0, fw1,
// bw0, bw1) [S][2]: the RSC-8 turbo constituent (S = 8) or a rate-1/2
// feedforward code (S = 64 at K = 7). Per column of the [Lw, N] spans, over
// Lw steps, from uniform (zero) metrics at both ends:
//   backward  beta_t = the metrics after step t (zero at t = Lw - 1),
//             beta'[s] = max_u beta[nxt[s][u]] + (bw0[s][u] ls + bw1[s][u] lp),
//             beta' -= max over states
//   forward   llr[t] = max_s ((alpha[s] + (bw0[s][0] ls + bw1[s][0] lp))
//                             + beta_t[nxt[s][0]])  - the same for u = 1,
//             alpha'[s'] = max_j alpha[prev_s[s'][j]]
//                          + (fw0[s'][j] ls + fw1[s'][j] lp), alpha' -= max
// with exactly that parenthesisation, every add and multiply as __fadd_rn /
// __fmul_rn, and no fast math, so the LLRs equal the scan's bit for bit. The
// order of the maxima does not matter: no metric is ever -0 (x - x is +0,
// and +0 + -0 is +0), so fmaxf is order-free on them; NaN input is outside
// the contract.
//
// What bounds it on an H100: the serial chain. At the turbo path's shape
// (Lw 96, 2,560 columns, S 8) a launch does 67 M FP32 operations (34 S + 1
// per step and column: 1.0 us at 67 TFLOP/s, the roofline bound) and must
// read 2 x 0.98 MB of LLR spans and write 0.98 MB of LLRs (0.9 us at
// 3.35 TB/s). Each column is a chain of Lw dependent steps of about six
// dependent FP32 operations (add, max, a three-level max tree, subtract):
// with the two directions side by side, 96 x 6 x 4 cycles, 1.2 us at
// 1.98 GHz, the chain floor.
//
// bcjr_kernel_meet<Rsc8, kCols>, the turbo path's instance (the wrapper
// picks it when the tables' nxt and prev_s equal the copy in Rsc8 and every
// transition's coefficients are those of its branch-metric class):
// - The trellis's index pattern is a compile-time constant, so a column's S
//   metrics live in registers; the classes' coefficients stay kernel
//   parameters (uniform, in the constant bank).
// - Two warps per CTA over the same kCols columns: warp 0 runs alpha forward,
//   warp 1 runs beta backward, at the same time. Each stores half of its
//   history in shared memory (alpha_t for t < mid, beta_t for t >= mid,
//   mid = Lw / 2), one barrier at the midpoint, then each computes the LLRs
//   of its second half from the other's stored metrics. The chain falls
//   from 2 Lw to Lw steps and nothing but the LLRs goes to device memory.
// - The CTA's spans come into shared memory once, by cp.async, before the
//   chain. A step's branch metrics depend only on them: the next step's are
//   computed while this step's chain runs.
// - A warp issues one instruction a cycle at best, so the work a step is
//   the floor once the chain is short. Every transition's coefficients are
//   those of its class (2 u + parity, four classes; the turbo tables are
//   so, the wrapper checks), so a step computes four branch metrics for
//   both directions instead of 2 x 16: 12 FP32 operations instead of 96,
//   the same values bit for bit.
// - Shared memory is Lw x kCols x (S + 2) x 4 bytes (60 KB at Lw 96 and
//   kCols 16). kCols is 16 (benches/torch_bcjr_sweep.py), or 8 for spans
//   too long for 227 KB at 16 (Lw 364-726); a longer span takes the generic
//   instance.
//
// bcjr_kernel<S>, the generic instance (any table set, S in 4..64): one
// thread per column, the metric column in shared memory ([S][threads], so
// the table-indexed reads of a warp hit 32 consecutive words), the beta
// history in a global scratch laid out [Lw][S][N] (coalesced along N, in L2),
// backward pass then forward pass.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;         // the generic instance's block
constexpr int kMeetThreads = 64;      // the meet instance's block: two warps
constexpr int kMaxSmem = 232448;      // opt-in shared memory of a block on sm_90

// The turbo RSC-8 trellis of ops/turbo.py _trellis(): nxt[s][u] and
// prev_s[s'][j], row-major [8][2], and the branch-metric class of each
// transition (s, u): 2 u + parity[s][u], so that transitions of one class
// carry one branch metric for the turbo tables. tests/test_torch_bcjr.py
// pins all three to the Python trellis.
struct Rsc8 {
  static constexpr int kStates = 8;
  static constexpr int kClasses = 4;
  static constexpr int kNxt[16] = {0, 4, 4, 0, 5, 1, 1, 5, 2, 6, 6, 2, 7, 3, 3, 7};
  static constexpr int kPrev[16] = {0, 1, 2, 3, 4, 5, 6, 7, 0, 1, 2, 3, 4, 5, 6, 7};
  static constexpr int kClass[16] = {0, 3, 0, 3, 1, 2, 1, 2, 1, 2, 1, 2, 0, 3, 0, 3};
};

template <int S>
struct Tables {
  int nxt[2 * S];
  int prev[2 * S];
  float fw0[2 * S];
  float fw1[2 * S];
  float bw0[2 * S];
  float bw1[2 * S];
};

// The meet instance's coefficients: the classes' pairs (c0[k], c1[k]).
template <int K>
struct Classes {
  float c0[K];
  float c1[K];
};

__device__ __forceinline__ float branch_metric(float c0, float c1, float ls, float lp) {
  return __fadd_rn(__fmul_rn(c0, ls), __fmul_rn(c1, lp));
}

// f(std::integral_constant<int, I>) for I in [I0, N): the state index is a
// constant expression in the body, so it can index the trellis tables and
// the register arrays.
template <int I, int N, class F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (I < N) {
    f(std::integral_constant<int, I>{});
    static_for<I + 1, N>(f);
  }
}

template <int S>
__device__ __forceinline__ float max_tree(const float (&v)[S]) {
  static_assert((S & (S - 1)) == 0, "a power of two");
  float m[S];
#pragma unroll
  for (int s = 0; s < S; ++s) m[s] = v[s];
#pragma unroll
  for (int w = S / 2; w >= 1; w /= 2) {
#pragma unroll
    for (int s = 0; s < w; ++s) m[s] = fmaxf(m[s], m[s + w]);
  }
  return m[0];
}

// ------------------------------------------------------------- meet instance

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem), "r"(bytes)
               : "memory");
}

// Branch metrics of a step from its LLRs: g[k] = c0[k] ls + c1[k] lp.
template <int K>
__device__ __forceinline__ void branch_metrics(const Classes<K>& cf, float ls, float lp,
                                               float (&g)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) g[k] = branch_metric(cf.c0[k], cf.c1[k], ls, lp);
}

// The input u of the transition prev_s[s'][j] -> s': nxt[prev_s[s'][j]][u] == s'.
template <class T>
__host__ __device__ constexpr int prev_u(int sp, int j) {
  return T::kNxt[2 * T::kPrev[2 * sp + j]] == sp ? 0 : 1;
}

// The class of a transition, whose branch metric it carries: backward
// (s, u), and forward (s', j), the transition prev_s[s'][j] -> s'.
template <class T>
__host__ __device__ constexpr int bw_at(int s, int u) {
  return T::kClass[2 * s + u];
}

template <class T>
__host__ __device__ constexpr int fw_at(int sp, int j) {
  return T::kClass[2 * T::kPrev[2 * sp + j] + prev_u<T>(sp, j)];
}

// alpha <- the forward update of a step (its forward branch metrics gf).
template <class T>
__device__ __forceinline__ void forward_step(float (&a)[T::kStates], const float (&gf)[T::kClasses]) {
  constexpr int S = T::kStates;
  float n[S];
  static_for<0, S>([&](auto si) {
    constexpr int s = decltype(si)::value;
    constexpr int p0 = T::kPrev[2 * s], p1 = T::kPrev[2 * s + 1];
    constexpr int g0 = fw_at<T>(s, 0), g1 = fw_at<T>(s, 1);
    n[s] = fmaxf(__fadd_rn(a[p0], gf[g0]), __fadd_rn(a[p1], gf[g1]));
  });
  const float mx = max_tree<S>(n);
#pragma unroll
  for (int s = 0; s < S; ++s) a[s] = __fsub_rn(n[s], mx);
}

// beta <- the backward update of a step (its backward branch metrics gb).
template <class T>
__device__ __forceinline__ void backward_step(float (&b)[T::kStates], const float (&gb)[T::kClasses]) {
  constexpr int S = T::kStates;
  float n[S];
  static_for<0, S>([&](auto si) {
    constexpr int s = decltype(si)::value;
    constexpr int n0 = T::kNxt[2 * s], n1 = T::kNxt[2 * s + 1];
    constexpr int g0 = bw_at<T>(s, 0), g1 = bw_at<T>(s, 1);
    n[s] = fmaxf(__fadd_rn(b[n0], gb[g0]), __fadd_rn(b[n1], gb[g1]));
  });
  const float mx = max_tree<S>(n);
#pragma unroll
  for (int s = 0; s < S; ++s) b[s] = __fsub_rn(n[s], mx);
}

// The LLR of step t from alpha_t, beta_t and the step's backward branch
// metrics, in the scan's order: states in turn, candidates (alpha + g) + beta.
template <class T>
__device__ __forceinline__ float step_llr(const float (&a)[T::kStates],
                                          const float (&beta)[T::kStates],
                                          const float (&gb)[T::kClasses]) {
  constexpr int S = T::kStates;
  float m0 = 0.0f, m1 = 0.0f;
  static_for<0, S>([&](auto si) {
    constexpr int s = decltype(si)::value;
    constexpr int n0 = T::kNxt[2 * s], n1 = T::kNxt[2 * s + 1];
    constexpr int g0 = bw_at<T>(s, 0), g1 = bw_at<T>(s, 1);
    const float c0 = __fadd_rn(__fadd_rn(a[s], gb[g0]), beta[n0]);
    const float c1 = __fadd_rn(__fadd_rn(a[s], gb[g1]), beta[n1]);
    m0 = s == 0 ? c0 : fmaxf(m0, c0);
    m1 = s == 0 ? c1 : fmaxf(m1, c1);
  });
  return __fsub_rn(m0, m1);
}

// A step computes kClasses branch metrics from the classes' coefficients,
// shared by both directions.
template <class T, int kCols>
__global__ void __launch_bounds__(kMeetThreads)
bcjr_kernel_meet(const float* __restrict__ ls, const float* __restrict__ lp,
                 float* __restrict__ llr, int lw, long long ncols, int vec,
                 const Classes<T::kClasses> cf) {
  constexpr int S = T::kStates;
  constexpr int K = T::kClasses;
  static_assert(kCols >= 1 && kCols <= 32, "one lane per column");
  extern __shared__ __align__(16) float smem[];
  float* const sls = smem;                  // [lw][kCols]
  float* const slp = sls + lw * kCols;      // [lw][kCols]
  float* const hist = slp + lw * kCols;     // [lw][S][kCols]
  const long long col0 = static_cast<long long>(blockIdx.x) * kCols;

  // 1. the CTA's two spans into shared memory; columns past N read as zero
  if (vec) {  // ncols % 4 == 0, both spans 16-byte aligned, kCols % 4 == 0
    constexpr int kQuads = kCols / 4;
    const int total = 2 * lw * kQuads;
    for (int i = threadIdx.x; i < total; i += kMeetThreads) {
      const int row = i / kQuads, q = i - row * kQuads;
      const int t = row < lw ? row : row - lw;
      const long long c = col0 + 4 * q;
      const float* src = (row < lw ? ls : lp) + static_cast<long long>(t) * ncols;
      const bool in = c < ncols;
      cp_async16(sls + row * kCols + 4 * q, in ? src + c : ls, in ? 16 : 0);
    }
  } else {
    const int total = 2 * lw * kCols;
    for (int i = threadIdx.x; i < total; i += kMeetThreads) {
      const int row = i / kCols, q = i - row * kCols;
      const int t = row < lw ? row : row - lw;
      const long long c = col0 + q;
      const float* src = (row < lw ? ls : lp) + static_cast<long long>(t) * ncols;
      const bool in = c < ncols;
      cp_async4(sls + row * kCols + q, in ? src + c : ls, in ? 4 : 0);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // 2. the two recursions, one warp each, meeting at mid. The branch
  // metrics of the next step are computed while a step's chain runs (same
  // basic block, no dependence), so the chain never waits on shared memory.
  const int lane = threadIdx.x & 31;
  const bool forward = threadIdx.x < 32;
  const bool active = lane < kCols;
  const long long col = col0 + lane;
  const bool store = active && col < ncols;
  const int mid = lw >> 1;
  const float* const xs = sls + lane;
  const float* const xp = slp + lane;
  float* const h = hist + lane;
  float m[S];
#pragma unroll
  for (int s = 0; s < S; ++s) m[s] = 0.0f;
  float g[K], gn[K];  // this step's and the next step's branch metrics

  if (active) {
    if (forward) {  // alpha_t for t < mid into the history
      branch_metrics(cf, xs[0], xp[0], g);
#pragma unroll 2
      for (int t = 0; t < mid; ++t) {
        const int tn = (t + 1) * kCols;  // t + 1 <= mid < lw
        branch_metrics(cf, xs[tn], xp[tn], gn);
#pragma unroll
        for (int s = 0; s < S; ++s) h[(t * S + s) * kCols] = m[s];
        forward_step<T>(m, g);
#pragma unroll
        for (int k = 0; k < K; ++k) g[k] = gn[k];
      }
    } else {  // beta_t for t >= mid into the history
      branch_metrics(cf, xs[(lw - 1) * kCols], xp[(lw - 1) * kCols], g);
#pragma unroll 2
      for (int t = lw - 1; t >= mid; --t) {
        const int tn = (t > 0 ? t - 1 : 0) * kCols;
        branch_metrics(cf, xs[tn], xp[tn], gn);
#pragma unroll
        for (int s = 0; s < S; ++s) h[(t * S + s) * kCols] = m[s];
        backward_step<T>(m, g);
#pragma unroll
        for (int k = 0; k < K; ++k) g[k] = gn[k];
      }
    }
  }
  __syncthreads();
  if (active) {
    float other[S];
    if (forward) {  // t >= mid: alpha_t in registers, beta_t stored
      branch_metrics(cf, xs[mid * kCols], xp[mid * kCols], g);
#pragma unroll 2
      for (int t = mid; t < lw; ++t) {
        const int tn = (t + 1 < lw ? t + 1 : t) * kCols;
        branch_metrics(cf, xs[tn], xp[tn], gn);
#pragma unroll
        for (int s = 0; s < S; ++s) other[s] = h[(t * S + s) * kCols];
        const float out = step_llr<T>(m, other, g);
        if (store) llr[static_cast<long long>(t) * ncols + col] = out;
        forward_step<T>(m, g);
#pragma unroll
        for (int k = 0; k < K; ++k) g[k] = gn[k];
      }
    } else if (mid > 0) {  // t < mid: beta_t in registers, alpha_t stored
      branch_metrics(cf, xs[(mid - 1) * kCols], xp[(mid - 1) * kCols], g);
#pragma unroll 2
      for (int t = mid - 1; t >= 0; --t) {
        const int tn = (t > 0 ? t - 1 : 0) * kCols;
        branch_metrics(cf, xs[tn], xp[tn], gn);
#pragma unroll
        for (int s = 0; s < S; ++s) other[s] = h[(t * S + s) * kCols];
        const float out = step_llr<T>(other, m, g);
        if (store) llr[static_cast<long long>(t) * ncols + col] = out;
        backward_step<T>(m, g);
#pragma unroll
        for (int k = 0; k < K; ++k) g[k] = gn[k];
      }
    }
  }
}

template <int kCols>
int launch_meet(const float* ls, const float* lp, float* llr, int lw, long long ncols,
                int vec, const float* cls, cudaStream_t stream) {
  using T = Rsc8;
  constexpr int S = T::kStates;
  Classes<T::kClasses> cf = {};
  for (int k = 0; k < T::kClasses; ++k) {
    cf.c0[k] = cls[k];
    cf.c1[k] = cls[T::kClasses + k];
  }
  const long long smem = static_cast<long long>(lw) * kCols * (S + 2) * sizeof(float);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  // the opt-in above 48 KB, once per card for the largest size asked so far
  static int opted[64] = {};
  int dev = 0;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= 64 || opted[dev] < smem) {
      err = cudaFuncSetAttribute(bcjr_kernel_meet<T, kCols>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
      if (dev < 64) opted[dev] = static_cast<int>(smem);
    }
  }
  const long long blocks = (ncols + kCols - 1) / kCols;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  bcjr_kernel_meet<T, kCols><<<static_cast<unsigned>(blocks), kMeetThreads,
                               static_cast<size_t>(smem), stream>>>(ls, lp, llr, lw, ncols,
                                                                    vec, cf);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------- generic instance

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

// Runs launch() with card `device` current (and the caller's put back).
template <class F>
int on_device(int device, F&& launch) {
  int prev = device;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  const int rc = launch();
  if (prev != device) cudaSetDevice(prev);
  return rc;
}

}  // namespace

// Plain C entry points, loaded with ctypes. Each returns the cudaError_t of
// the launch (0 = success) and launches on `stream` of card `device`, made
// current for the launch where it is not.
//
// bcjr_launch, the generic instance. The caller guarantees: ls, lp, llr
// float32 [lw, ncols] and scratch float32 [lw, s_count, ncols], contiguous;
// s_count in {4, 8, 16, 32, 64}; idx a host int32 array [nxt; prev_s] of
// 2 x s_count x 2 entries with every entry in [0, s_count); coef a host
// float32 array [fw0; fw1; bw0; bw1] of 4 x s_count x 2 entries.
extern "C" int bcjr_launch(const void* ls, const void* lp, void* llr, void* scratch,
                           int lw, long long ncols, int s_count, const int* idx,
                           const float* coef, int device, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_device(device, [&] {
    switch (s_count) {
      case 4: return launch<4>(ls, lp, llr, scratch, lw, ncols, idx, coef, s);
      case 8: return launch<8>(ls, lp, llr, scratch, lw, ncols, idx, coef, s);
      case 16: return launch<16>(ls, lp, llr, scratch, lw, ncols, idx, coef, s);
      case 32: return launch<32>(ls, lp, llr, scratch, lw, ncols, idx, coef, s);
      case 64: return launch<64>(ls, lp, llr, scratch, lw, ncols, idx, coef, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  });
}

// bcjr_rsc8_launch, the meet instance for tables whose nxt and prev_s equal
// Rsc8's and whose coefficients factor through its classes (checked by the
// wrapper). ls, lp, llr float32 [lw, ncols], contiguous, lw >= 1; cols
// (columns per CTA) 16, or 8, with lw x cols x 40 bytes within 227 KB; vec
// != 0 only when ncols % 4 == 0 and ls, lp are 16-byte aligned; cls a host
// float32 array [c0; c1] of 2 x 4 entries, the classes' coefficients: every
// transition's (backward bw[s][u], and forward fw[s'][j] for the transition
// prev_s[s'][j] -> s') equal its class's.
extern "C" int bcjr_rsc8_launch(const void* ls, const void* lp, void* llr, int lw,
                                long long ncols, int cols, int vec, const float* cls,
                                int device, void* stream) {
  if (lw < 1 || ncols < 1) return static_cast<int>(cudaErrorInvalidValue);
  const float* a = static_cast<const float*>(ls);
  const float* b = static_cast<const float*>(lp);
  float* o = static_cast<float*>(llr);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_device(device, [&] {
    switch (cols) {
      case 8: return launch_meet<8>(a, b, o, lw, ncols, vec, cls, s);
      case 16: return launch_meet<16>(a, b, o, lw, ncols, vec, cls, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  });
}
