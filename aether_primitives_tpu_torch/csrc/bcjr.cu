// Windowed max-log BCJR for Hopper (sm_90a), in three instances.
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
// What bounds it on an H100: its FP32 instructions, counted as the
// arithmetic the function needs a step and column. For any tables, each
// direction takes its 2 S branch metrics of three operations, 2 S adds, S
// maxima, S - 1 for the state maximum and S subtractions (11 S - 1); the
// LLR reuses the backward step's branch metrics and adds 4 S adds, 2 (S - 1)
// maxima and one subtraction (6 S - 1): 28 S - 3 in all. Where every
// transition's coefficients are those of one of four classes (the RSC-8
// turbo tables and the conv codes' 0.5 sgn tables), a direction needs only
// four branch metrics, 12 operations, which the LLR shares: 16 S + 21. None
// is an FMA and none can contract to one, so each takes an FMA's issue
// slot: 33.5 T a second, half the data sheet's 67 TFLOP/s. At the ccsds +
// erasures launch (K=7, S 64, Lw 224 = window 96 + 2 x guard 64, N 5,632 =
// 256 captures x 22 windows) that is 2.257 G operations, 0.0674 ms, for
// tables as the lanes instance takes them, and 1.318 G, 0.0394 ms, with the
// four classes; its bytes (two spans in, the LLRs out: 15.1 MB) take 0.0045
// ms at 3.35 TB/s. At the turbo path's shape (Lw 96, N 2,560, S 8, the four
// classes of the meet instance): 36.6 M operations, 0.0011 ms. Each column
// is also a chain of Lw dependent steps of about six dependent operations a
// step (add, max, the state maximum, subtract): with the two directions
// side by side, 96 x 6 x 4 cycles, 1.2 us at 1.98 GHz, the chain floor of
// the turbo shape.
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
//   too long for 227 KB at 16 (Lw 364-726); a longer span takes the lanes
//   instance.
//
// bcjr_kernel_lanes<S, kShift>, the lanes instance, for every other table
// set (S in 4..64; the ccsds + erasures path's K=7 code), the same schedule
// with a column's states spread over lanes:
// - State-parallel: a column's S metrics live in registers of L = min(S,
//   32) lanes, S / L a lane (two at S 64), 32 / L columns a warp (S <= 16).
//   A step gathers each transition's other end: by shuffles where the
//   tables are the shift-register pattern (the conv codes; the wrapper
//   checks), else through shared memory by the tables (a store, one
//   __syncwarp, the table-indexed loads; two alternating buffers). The
//   state maximum is one redux.sync of an order-preserving integer key at
//   L = 32 (the float bits of the maximum come back exactly; one
//   instruction in place of five levels of shuffle and max), a shuffle
//   butterfly within the column's lanes below; the LLR's two maxima the
//   same. The gather takes the last update's values before they are
//   normalised, beside the maximum, and both then subtract it (the same
//   floats: one subtraction of one maximum), so a step's chain is the
//   maximum's and not the maximum's and the exchange's.
// - A forward and a backward warp a CTA over the same columns at once,
//   meeting at mid = Lw / 2, as in the meet instance: the chain falls from
//   2 Lw to Lw steps.
// - No history in device memory: the half-histories (alpha_t for t < mid,
//   beta_t for t >= mid) are Lw x S x 4 bytes a column in shared memory,
//   57 KB at the ccsds launch (60,160 bytes a CTA with the spans and the
//   exchange buffers: at most 3 CTAs an SM, 6 warps) and 25 KB at Lw 96
//   (26,368 a CTA: 8 CTAs an SM). (The column instance keeps the beta
//   history in a [Lw][S][N] scratch in device memory: 323 MB at the ccsds
//   launch, written and read back. Half-histories in an L2-resident scratch that
//   persistent CTAs reuse ran slower than in shared memory; PERF.md.)
// - The CTA's spans come into shared memory once, by cp.async, while the
//   lanes load their table entries from the card (a table in the kernel's
//   parameters, read at a lane-dependent index, would serialise on the
//   constant bank).
// - Shared memory is Lw x G x (S + 2) x 4 + 16 G S bytes (G = 32 / L): the
//   spans Lw 876 at S 64, 1,705 at S 32, 1,610 at 16, 1,449 at 8 and 1,208
//   at 4 fit 227 KB. A longer span takes the column instance.
//
// bcjr_kernel<S>, the column instance, for spans past the lanes instance's
// limit (any table set, S in 4..64) and for every span at S 2 and 3: one
// thread per column, the metric column in shared memory ([S][threads], so
// the table-indexed reads of a warp hit 32 consecutive words), the beta
// history in a global scratch laid out [Lw][S][N] (coalesced along N),
// backward pass then forward pass. Its code does not need S to be a power of
// two.
//
// bcjr_block_kernel, the block instance, for every other state count (5-7,
// 9-15, ..., 128, 256 and up): one CTA of 256 threads a column, states s,
// s + 256, ... a thread, the tables read from the card. Each direction keeps
// two buffers of S metrics (read one, write the other), in shared memory
// while both fit (S <= 28,928) and in a device scratch past that; a buffer
// holds a step's metrics before the subtraction of their maximum, which the
// next step subtracts as it reads them (the same floats as the twin's). The
// maxima (the state maximum, and the LLR's two) are redux.sync on
// order-preserving keys and one barrier a step. The beta history goes to a
// device scratch [N][Lw][S]. Its limit is the card's memory; it is written
// for reach, not speed.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;         // the generic instance's block
constexpr int kMeetThreads = 64;      // the meet instance's block: two warps
constexpr int kLanesThreads = 64;     // the lanes instance's block: two warps
constexpr int kMaxSmem = 232448;      // opt-in shared memory of a block on sm_90
constexpr int kBlockThreads = 256;    // the block instance's CTA

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

// ------------------------------------------------------------ lanes instance

// The lanes instance's shape at S states: L lanes of a warp hold a column's
// metrics, R = S / L states a lane (state li + r L in lane li, slot r), and
// a warp holds G = 32 / L columns side by side.
template <int S>
struct Lanes {
  static_assert(S >= 4 && S <= 64 && (S & (S - 1)) == 0, "S in 4..64, a power of two");
  static constexpr int L = S < 32 ? S : 32;
  static constexpr int R = S / L;
  static constexpr int G = 32 / L;
  // floats of shared memory a CTA needs besides lw x G x (S + 2): the two
  // warps' double-buffered exchange, [2][2][G][S]
  static constexpr int kExchange = 4 * G * S;
};

// An order-preserving map of float32 to int32 (NaN aside): the integer max
// of the keys is the key of the float max, so one redux.sync takes a warp's
// maximum. Its own inverse.
__device__ __forceinline__ int max_key(int bits) { return bits ^ ((bits >> 31) & 0x7fffffff); }

// The maximum of v over the L lanes of this lane's column.
template <int L>
__device__ __forceinline__ float column_max(float v) {
  if constexpr (L == 32) {
    return __int_as_float(max_key(__reduce_max_sync(0xffffffffu, max_key(__float_as_int(v)))));
  } else {
#pragma unroll
    for (int o = L / 2; o >= 1; o /= 2) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
  }
}

template <int R>
__device__ __forceinline__ float local_max(const float (&v)[R]) {
  float m = v[0];
#pragma unroll
  for (int r = 1; r < R; ++r) m = fmaxf(m, v[r]);
  return m;
}

// A lane's transitions: for each of its R states s and each input or
// predecessor, the table index and the two coefficients.
template <int R>
struct LaneEdges {
  int at[R][2];
  float c0[R][2];
  float c1[R][2];
};

template <int R>
__device__ __forceinline__ void edge_metrics(const LaneEdges<R>& e, float ls, float lp,
                                             float (&g)[R][2]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int k = 0; k < 2; ++k) g[r][k] = branch_metric(e.c0[r][k], e.c1[r][k], ls, lp);
  }
}

// The other ends' values of a lane's transitions, v[r][k] = n[at[r][k]]
// for the column's values n (a lane's own in registers): through shared
// memory by the tables (stored into the column's [S] row x, a __syncwarp,
// the table-indexed loads), or, where the tables are the shift-register
// pattern of ops/fec.py _conv_soft_coeffs (nxt[s][u] = (2 s + u) mod S,
// prev_s[s'][j] = (s' >> 1) + j S / 2), by shuffles: forward the
// predecessors', backward the successors'. `base` is the column's first
// lane.
template <int S, bool kShift, bool kForward>
__device__ __forceinline__ void gather(const float (&n)[Lanes<S>::R], float* x, int li,
                                       int base, const LaneEdges<Lanes<S>::R>& e,
                                       float (&v)[Lanes<S>::R][2]) {
  constexpr int L = Lanes<S>::L, R = Lanes<S>::R;
  if constexpr (!kShift) {
#pragma unroll
    for (int r = 0; r < R; ++r) x[li + r * L] = n[r];
    __syncwarp();
#pragma unroll
    for (int r = 0; r < R; ++r) { v[r][0] = x[e.at[r][0]]; v[r][1] = x[e.at[r][1]]; }
  } else if constexpr (R == 1) {  // state li in lane base + li
    const int s0 = kForward ? li >> 1 : (2 * li) & (S - 1);
    const int s1 = kForward ? (li >> 1) + S / 2 : (2 * li + 1) & (S - 1);
    v[0][0] = __shfl_sync(0xffffffffu, n[0], base + s0);
    v[0][1] = __shfl_sync(0xffffffffu, n[0], base + s1);
  } else if constexpr (kForward) {  // S 64: states li and li + 32 in lane li
    const int l0 = li >> 1, l1 = 16 + (li >> 1);  // prev_s[s'][j]: slot j of these lanes
    v[0][0] = __shfl_sync(0xffffffffu, n[0], l0);
    v[0][1] = __shfl_sync(0xffffffffu, n[1], l0);
    v[1][0] = __shfl_sync(0xffffffffu, n[0], l1);
    v[1][1] = __shfl_sync(0xffffffffu, n[1], l1);
  } else {  // S 64: nxt[s][u] = (2 li + u) mod 64 for both of the lane's states
    const float a0 = __shfl_sync(0xffffffffu, n[0], (2 * li) & 31);
    const float a1 = __shfl_sync(0xffffffffu, n[1], (2 * li) & 31);
    const float b0 = __shfl_sync(0xffffffffu, n[0], (2 * li + 1) & 31);
    const float b1 = __shfl_sync(0xffffffffu, n[1], (2 * li + 1) & 31);
    const bool hi = li >= 16;
    v[0][0] = v[1][0] = hi ? a1 : a0;
    v[0][1] = v[1][1] = hi ? b1 : b0;
  }
}

// A step's normalisation, with its gather beside the state maximum: the
// values n (the last update's, before normalisation) are gathered while
// the column's maximum mx is reduced, then both subtract it: m = n - mx
// (the lane's metrics of this step) and v = n[at] - mx (its transitions'
// other ends; the same floats as gathering m, since a subtraction of the
// one mx is the same operation wherever it runs).
template <int S, bool kShift, bool kForward>
__device__ __forceinline__ void normalise(const float (&n)[Lanes<S>::R], float* x, int li,
                                          int base, const LaneEdges<Lanes<S>::R>& e,
                                          float (&m)[Lanes<S>::R],
                                          float (&v)[Lanes<S>::R][2]) {
  constexpr int R = Lanes<S>::R;
  const float mx = column_max<Lanes<S>::L>(local_max<R>(n));
  gather<S, kShift, kForward>(n, x, li, base, e, v);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = __fsub_rn(n[r], mx);
    v[r][0] = __fsub_rn(v[r][0], mx);
    v[r][1] = __fsub_rn(v[r][1], mx);
  }
}

// n <- the recursion's update from the gathered metrics v: n[s] = max_k
// (v[s][k] + g[s][k]).
template <int R>
__device__ __forceinline__ void update(float (&n)[R], const float (&v)[R][2],
                                       const float (&g)[R][2]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    n[r] = fmaxf(__fadd_rn(v[r][0], g[r][0]), __fadd_rn(v[r][1], g[r][1]));
  }
}

// The LLR of a step: the column maxima of c_u = (alpha[s] + gb[s][u]) +
// beta[nxt[s][u]] over its transitions with u = 0, less those with u = 1.
template <int S>
__device__ __forceinline__ float lanes_llr(const float (&a)[Lanes<S>::R],
                                           const float (&bn)[Lanes<S>::R][2],
                                           const float (&gb)[Lanes<S>::R][2]) {
  constexpr int R = Lanes<S>::R;
  float c0[R], c1[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    c0[r] = __fadd_rn(__fadd_rn(a[r], gb[r][0]), bn[r][0]);
    c1[r] = __fadd_rn(__fadd_rn(a[r], gb[r][1]), bn[r][1]);
  }
  const float m0 = column_max<Lanes<S>::L>(local_max<R>(c0));
  const float m1 = column_max<Lanes<S>::L>(local_max<R>(c1));
  return __fsub_rn(m0, m1);
}

template <int R>
__device__ __forceinline__ void copy_metrics(float (&to)[R][2], const float (&from)[R][2]) {
#pragma unroll
  for (int r = 0; r < R; ++r) { to[r][0] = from[r][0]; to[r][1] = from[r][1]; }
}

// Two warps a CTA over the same G columns: warp 0 runs alpha forward, warp
// 1 runs beta backward, at once, each to the middle of the span storing its
// metrics in the history, then each on through the other half computing the
// LLRs from the other's stored metrics (the meet instance's schedule, with
// a column's states spread over lanes). A lane carries the last update's
// values n; a step normalises them (the gather beside the maximum), then
// updates, and its LLR (off the chain) comes after. idx: int32 [nxt;
// prev_s] [2][S][2], coef: float32 [fw0; fw1; bw0; bw1] [4][S][2], both on
// the card. kShift: the tables are the shift-register pattern (the wrapper
// checks), so the values are gathered by shuffles.
template <int S, bool kShift>
__global__ void __launch_bounds__(kLanesThreads, 8)
bcjr_kernel_lanes(const float* __restrict__ ls, const float* __restrict__ lp,
                  float* __restrict__ llr, int lw, long long ncols,
                  const int* __restrict__ idx, const float* __restrict__ coef) {
  using Sh = Lanes<S>;
  constexpr int L = Sh::L, R = Sh::R, G = Sh::G;
  extern __shared__ __align__(16) float smem[];
  float* const sls = smem;                  // [lw][G]
  float* const slp = sls + lw * G;          // [lw][G]
  float* const hist = slp + lw * G;         // [G][lw][S]
  float* const xch = hist + G * lw * S;     // [2 warps][2 buffers][G][S]
  const long long col0 = static_cast<long long>(blockIdx.x) * G;

  // 1. the CTA's two spans into shared memory; columns past N read as zero
  for (int i = threadIdx.x; i < 2 * lw * G; i += kLanesThreads) {
    const int row = i / G, q = i - row * G;
    const int t = row < lw ? row : row - lw;
    const long long c = col0 + q;
    const float* src = (row < lw ? ls : lp) + static_cast<long long>(t) * ncols;
    const bool in = c < ncols;
    cp_async4(sls + row * G + q, in ? src + c : ls, in ? 4 : 0);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  // 2. this lane's transitions, while the spans arrive
  const bool forward = threadIdx.x < 32;
  const int lane = threadIdx.x & 31;
  const int g = lane / L, li = lane - g * L, base = g * L;
  LaneEdges<R> fe, be;  // forward (s', j): prev_s, fw; backward (s, u): nxt, bw
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int s = li + r * L;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int e = 2 * s + k;
      be.at[r][k] = __ldg(idx + e);
      fe.at[r][k] = __ldg(idx + 2 * S + e);
      fe.c0[r][k] = __ldg(coef + e);
      fe.c1[r][k] = __ldg(coef + 2 * S + e);
      be.c0[r][k] = __ldg(coef + 4 * S + e);
      be.c1[r][k] = __ldg(coef + 6 * S + e);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const long long col = col0 + g;
  const bool store = li == 0 && col < ncols;
  const int mid = lw >> 1;
  const float* const xs = sls + g;
  const float* const xp = slp + g;
  float* const h = hist + g * lw * S;  // [lw][S]: alpha_t for t < mid, beta_t for t >= mid
  float* const xb = xch + ((forward ? 0 : 2) * G + g) * S;  // buffer b at xb + b G S
  float n[R], m[R];  // the last update's values (zero: uniform metrics), a step's metrics
#pragma unroll
  for (int r = 0; r < R; ++r) n[r] = 0.0f;
  float gf[R][2], gb[R][2], gn[R][2], v[R][2];

  // 3. to the middle: each warp stores its metrics of step t in the history
  if (forward) {
    edge_metrics(fe, xs[0], xp[0], gf);
#pragma unroll 2
    for (int t = 0; t < mid; ++t) {
      edge_metrics(fe, xs[(t + 1) * G], xp[(t + 1) * G], gn);  // t + 1 <= mid < lw
      normalise<S, kShift, true>(n, xb + (t & 1) * G * S, li, base, fe, m, v);
#pragma unroll
      for (int r = 0; r < R; ++r) h[t * S + li + r * L] = m[r];
      update(n, v, gf);
      copy_metrics(gf, gn);
    }
  } else {
    edge_metrics(be, xs[(lw - 1) * G], xp[(lw - 1) * G], gb);
#pragma unroll 2
    for (int t = lw - 1; t >= mid; --t) {
      const int tn = t > 0 ? t - 1 : 0;
      edge_metrics(be, xs[tn * G], xp[tn * G], gn);
      normalise<S, kShift, false>(n, xb + (t & 1) * G * S, li, base, be, m, v);
#pragma unroll
      for (int r = 0; r < R; ++r) h[t * S + li + r * L] = m[r];
      update(n, v, gb);
      copy_metrics(gb, gn);
    }
  }
  __syncthreads();

  // 4. on through the other half, each step's LLR from the other warp's
  // stored metrics
  if (forward) {  // t >= mid: alpha_t in registers, beta_t stored
    edge_metrics(fe, xs[mid * G], xp[mid * G], gf);
    float* out = llr + static_cast<long long>(mid) * ncols + col;
#pragma unroll 2
    for (int t = mid; t < lw; ++t, out += ncols) {
      const int tn = t + 1 < lw ? t + 1 : t;
      edge_metrics(fe, xs[tn * G], xp[tn * G], gn);
      edge_metrics(be, xs[t * G], xp[t * G], gb);
      normalise<S, kShift, true>(n, xb + (t & 1) * G * S, li, base, fe, m, v);
      update(n, v, gf);
      const float* const beta = h + t * S;
#pragma unroll
      for (int r = 0; r < R; ++r) { v[r][0] = beta[be.at[r][0]]; v[r][1] = beta[be.at[r][1]]; }
      const float o = lanes_llr<S>(m, v, gb);
      if (store) *out = o;
      copy_metrics(gf, gn);
    }
  } else if (mid > 0) {  // t < mid: beta_t in registers, alpha_t stored
    edge_metrics(be, xs[(mid - 1) * G], xp[(mid - 1) * G], gb);
    float* out = llr + static_cast<long long>(mid - 1) * ncols + col;
#pragma unroll 2
    for (int t = mid - 1; t >= 0; --t, out -= ncols) {
      const int tn = t > 0 ? t - 1 : 0;
      edge_metrics(be, xs[tn * G], xp[tn * G], gn);
      normalise<S, kShift, false>(n, xb + (t & 1) * G * S, li, base, be, m, v);
      update(n, v, gb);
      const float* const alpha = h + t * S;
#pragma unroll
      for (int r = 0; r < R; ++r) m[r] = alpha[li + r * L];
      const float o = lanes_llr<S>(m, v, gb);
      if (store) *out = o;
      copy_metrics(gb, gn);
    }
  }
}

// The lanes instance's shared memory a CTA at span length lw, in bytes.
template <int S>
constexpr long long lanes_smem(int lw) {
  return (static_cast<long long>(lw) * Lanes<S>::G * (S + 2) + Lanes<S>::kExchange) *
         static_cast<long long>(sizeof(float));
}

// Sets a kernel's shared-memory attributes once per card, and again for a
// larger size than asked so far (`opted`: a table per kernel): the largest
// carveout, so that an SM holds as many CTAs as their shared memory allows,
// and the opt-in above 48 KB of dynamic shared memory.
template <class K>
int opt_in(K kernel, long long smem, int (&opted)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 64 && opted[dev] >= smem) return 0;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             static_cast<int>(cudaSharedmemCarveoutMaxShared));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (dev < 64) opted[dev] = static_cast<int>(smem);
  return 0;
}

template <int S, bool kShift>
int launch_lanes(const float* ls, const float* lp, float* llr, int lw, long long ncols,
                 const int* idx, const float* coef, cudaStream_t stream) {
  const long long smem = lanes_smem<S>(lw);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  static int opted[64] = {};
  const int rc = opt_in(bcjr_kernel_lanes<S, kShift>, smem, opted);
  if (rc) return rc;
  const long long blocks = (ncols + Lanes<S>::G - 1) / Lanes<S>::G;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  bcjr_kernel_lanes<S, kShift><<<static_cast<unsigned>(blocks), kLanesThreads,
                                 static_cast<size_t>(smem), stream>>>(ls, lp, llr, lw, ncols,
                                                                      idx, coef);
  return static_cast<int>(cudaGetLastError());
}

template <int S>
int launch_lanes(const float* ls, const float* lp, float* llr, int lw, long long ncols,
                 int shift, const int* idx, const float* coef, cudaStream_t stream) {
  return shift ? launch_lanes<S, true>(ls, lp, llr, lw, ncols, idx, coef, stream)
               : launch_lanes<S, false>(ls, lp, llr, lw, ncols, idx, coef, stream);
}

// ----------------------------------------------------------- column instance

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

// ------------------------------------------------------------ block instance

constexpr int kNoKey = static_cast<int>(0x80000000u);  // below every max_key

__device__ __forceinline__ int key_of(float v) { return max_key(__float_as_int(v)); }
__device__ __forceinline__ float of_key(int k) { return __int_as_float(max_key(k)); }

// The block maximum of R max_keys a thread (redux.sync a warp, then the
// warps' through shared memory, one barrier); red: [2][R][warps],
// alternating by `parity` so that one barrier a step suffices.
template <int R>
__device__ __forceinline__ void block_max(int (&k)[R], int (*red)[kBlockThreads / 32],
                                          int parity) {
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    k[r] = __reduce_max_sync(0xffffffffu, k[r]);
    if ((threadIdx.x & 31) == 0) red[parity * R + r][warp] = k[r];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < R; ++r) {
    k[r] = red[parity * R + r][0];
#pragma unroll
    for (int w = 1; w < kBlockThreads / 32; ++w) k[r] = max(k[r], red[parity * R + r][w]);
  }
}

// One CTA a column (blockIdx.x). idx: int32 [nxt; prev_s] and coef: float32
// [fw0; fw1; bw0; bw1], each [S][2], on the card; hist: the column's beta
// history [lw][S] at hist + col lw S; mscratch: two buffers of S floats a
// column, or null for shared memory.
__global__ void __launch_bounds__(kBlockThreads)
bcjr_block_kernel(const float* __restrict__ ls, const float* __restrict__ lp,
                  float* __restrict__ llr, float* hist, float* mscratch, int lw,
                  long long ncols, int S, const int* __restrict__ idx,
                  const float* __restrict__ coef) {
  extern __shared__ float smb[];
  __shared__ int red[2 * 3][kBlockThreads / 32];
  const int tid = threadIdx.x;
  const long long col = blockIdx.x;
  float* ma = mscratch != nullptr ? mscratch + col * 2 * S : smb;
  float* mb = ma + S;
  float* h = hist + col * lw * S;
  const int* nxt = idx;
  const int* prv = idx + 2 * S;
  const float* fw0 = coef;
  const float* fw1 = coef + 2 * S;
  const float* bw0 = coef + 4 * S;
  const float* bw1 = coef + 6 * S;

  // backward: beta[s] = ma[s] - mx, zero at t = lw - 1
  for (int s = tid; s < S; s += kBlockThreads) ma[s] = 0.0f;
  float mx = 0.0f;
  __syncthreads();
  for (int i = 0; i < lw; ++i) {
    const int t = lw - 1 - i;
    const float ls_t = __ldg(ls + t * ncols + col);
    const float lp_t = __ldg(lp + t * ncols + col);
    float* ht = h + static_cast<long long>(t) * S;
    int k[1] = {kNoKey};
    for (int s = tid; s < S; s += kBlockThreads) {
      ht[s] = __fsub_rn(ma[s], mx);
      const float c0 = __fadd_rn(__fsub_rn(ma[__ldg(nxt + 2 * s)], mx),
                                 branch_metric(__ldg(bw0 + 2 * s), __ldg(bw1 + 2 * s), ls_t, lp_t));
      const float c1 = __fadd_rn(__fsub_rn(ma[__ldg(nxt + 2 * s + 1)], mx),
                                 branch_metric(__ldg(bw0 + 2 * s + 1), __ldg(bw1 + 2 * s + 1),
                                               ls_t, lp_t));
      const float b = fmaxf(c0, c1);
      mb[s] = b;
      k[0] = max(k[0], key_of(b));
    }
    block_max<1>(k, red, i & 1);  // its barrier: mb and ht written, ma read
    mx = of_key(k[0]);
    float* tmp = ma;
    ma = mb;
    mb = tmp;
  }

  // forward: alpha[s] = ma[s] - mx, zero at t = 0; the LLR from alpha, the
  // backward step's branch metrics and beta_t
  for (int s = tid; s < S; s += kBlockThreads) ma[s] = 0.0f;
  mx = 0.0f;
  __syncthreads();
  for (int t = 0; t < lw; ++t) {
    const float ls_t = __ldg(ls + t * ncols + col);
    const float lp_t = __ldg(lp + t * ncols + col);
    const float* ht = h + static_cast<long long>(t) * S;
    int k[3] = {kNoKey, kNoKey, kNoKey};
    for (int s = tid; s < S; s += kBlockThreads) {
      const float a = __fsub_rn(ma[s], mx);
      const float c0 = __fadd_rn(
          __fadd_rn(a, branch_metric(__ldg(bw0 + 2 * s), __ldg(bw1 + 2 * s), ls_t, lp_t)),
          ht[__ldg(nxt + 2 * s)]);
      const float c1 = __fadd_rn(
          __fadd_rn(a, branch_metric(__ldg(bw0 + 2 * s + 1), __ldg(bw1 + 2 * s + 1), ls_t, lp_t)),
          ht[__ldg(nxt + 2 * s + 1)]);
      k[0] = max(k[0], key_of(c0));
      k[1] = max(k[1], key_of(c1));
      const float n0 = __fadd_rn(__fsub_rn(ma[__ldg(prv + 2 * s)], mx),
                                 branch_metric(__ldg(fw0 + 2 * s), __ldg(fw1 + 2 * s), ls_t, lp_t));
      const float n1 = __fadd_rn(__fsub_rn(ma[__ldg(prv + 2 * s + 1)], mx),
                                 branch_metric(__ldg(fw0 + 2 * s + 1), __ldg(fw1 + 2 * s + 1),
                                               ls_t, lp_t));
      const float an = fmaxf(n0, n1);
      mb[s] = an;
      k[2] = max(k[2], key_of(an));
    }
    block_max<3>(k, red, t & 1);
    if (tid == 0) llr[t * ncols + col] = __fsub_rn(of_key(k[0]), of_key(k[1]));
    mx = of_key(k[2]);
    float* tmp = ma;
    ma = mb;
    mb = tmp;
  }
}

int launch_block(const float* ls, const float* lp, float* llr, float* hist, float* mscratch,
                 int lw, long long ncols, int s_count, const int* idx, const float* coef,
                 cudaStream_t stream) {
  const size_t smem = mscratch != nullptr ? 0 : 2 * static_cast<size_t>(s_count) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(bcjr_block_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  bcjr_block_kernel<<<static_cast<unsigned>(ncols), kBlockThreads, smem, stream>>>(
      ls, lp, llr, hist, mscratch, lw, ncols, s_count, idx, coef);
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
// bcjr_lanes_launch, the lanes instance. ls, lp, llr float32 [lw, ncols],
// contiguous, lw >= 1, ncols >= 1; s_count in {4, 8, 16, 32, 64}, with
// lw x G x (s_count + 2) x 4 + 16 G s_count bytes within 227 KB (G = 32 /
// min(s_count, 32)); idx int32 [nxt; prev_s] (2 x s_count x 2 entries, each
// in [0, s_count)) and coef float32 [fw0; fw1; bw0; bw1] (4 x s_count x 2),
// both on the card; shift != 0 only when nxt[s][u] = (2 s + u) mod s_count
// and prev_s[s'][j] = (s' >> 1) + j s_count / 2.
extern "C" int bcjr_lanes_launch(const void* ls, const void* lp, void* llr, int lw,
                                 long long ncols, int s_count, int shift, const void* idx,
                                 const void* coef, int device, void* stream) {
  if (lw < 1 || ncols < 1) return static_cast<int>(cudaErrorInvalidValue);
  const float* a = static_cast<const float*>(ls);
  const float* b = static_cast<const float*>(lp);
  float* o = static_cast<float*>(llr);
  const int* i = static_cast<const int*>(idx);
  const float* c = static_cast<const float*>(coef);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_device(device, [&] {
    switch (s_count) {
      case 4: return launch_lanes<4>(a, b, o, lw, ncols, shift, i, c, s);
      case 8: return launch_lanes<8>(a, b, o, lw, ncols, shift, i, c, s);
      case 16: return launch_lanes<16>(a, b, o, lw, ncols, shift, i, c, s);
      case 32: return launch_lanes<32>(a, b, o, lw, ncols, shift, i, c, s);
      case 64: return launch_lanes<64>(a, b, o, lw, ncols, shift, i, c, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  });
}

// bcjr_launch, the column instance, for spans too long for the lanes
// instance's shared memory and for 2 and 3 states. The caller guarantees:
// ls, lp, llr float32 [lw, ncols] and scratch float32 [lw, s_count, ncols],
// contiguous; s_count in {2, 3, 4, 8, 16, 32, 64}; idx a host int32 array [nxt; prev_s] of
// 2 x s_count x 2 entries with every entry in [0, s_count); coef a host
// float32 array [fw0; fw1; bw0; bw1] of 4 x s_count x 2 entries.
extern "C" int bcjr_launch(const void* ls, const void* lp, void* llr, void* scratch,
                           int lw, long long ncols, int s_count, const int* idx,
                           const float* coef, int device, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_device(device, [&] {
    switch (s_count) {
      case 2: return launch<2>(ls, lp, llr, scratch, lw, ncols, idx, coef, s);
      case 3: return launch<3>(ls, lp, llr, scratch, lw, ncols, idx, coef, s);
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

// bcjr_block_launch, the block instance (one CTA a column), for any state
// count. ls, lp, llr float32 [lw, ncols], contiguous, lw >= 1, 1 <= ncols <
// 2^31, s_count >= 2; idx int32 [nxt; prev_s] (2 x s_count x 2 entries, each
// in [0, s_count)) and coef float32 [fw0; fw1; bw0; bw1] (4 x s_count x 2),
// both on the card; hist float32 [ncols, lw, s_count] on the card; mscratch
// float32 [ncols, 2, s_count] on the card, or null where 2 s_count floats
// fit the card's opt-in shared memory beside the block's 192 bytes.
extern "C" int bcjr_block_launch(const void* ls, const void* lp, void* llr, void* hist,
                                 void* mscratch, int lw, long long ncols, int s_count,
                                 const void* idx, const void* coef, int device, void* stream) {
  if (lw < 1 || ncols < 1 || ncols > 0x7fffffffLL || s_count < 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_device(device, [&] {
    return launch_block(static_cast<const float*>(ls), static_cast<const float*>(lp),
                        static_cast<float*>(llr), static_cast<float*>(hist),
                        static_cast<float*>(mscratch), lw, ncols, s_count,
                        static_cast<const int*>(idx), static_cast<const float*>(coef), s);
  });
}
