// Windowed max-log BCJR for Hopper (sm_90a), in three instances.
//
// Replaces the TPU kernel aether_primitives_tpu/ops/pallas/bcjr.py:
// _bcjr_kernel (wrapper bcjr_windowed_llr) and is bit-identical to the JAX
// package's windowed scan (ops/turbo.py _bcjr_maxlog_windowed). It takes any
// binary trellis with two LLR streams as the tables (nxt, prev_s, fw0, fw1,
// bw0, bw1) [S][2]: the RSC-8 turbo constituent (S = 8), a rate-1/2
// feedforward code (S = 2^(K-1)) or any other. Per column of the [Lw, N]
// spans, over Lw steps, from uniform (zero) metrics at both ends:
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
//   (26,368 a CTA: 8 CTAs an SM). (Half-histories in an L2-resident
//   scratch that persistent CTAs reuse ran slower than in shared memory;
//   PERF.md.)
// - The CTA's spans come into shared memory once, by cp.async, while the
//   lanes load their table entries from the card (a table in the kernel's
//   parameters, read at a lane-dependent index, would serialise on the
//   constant bank).
// - Shared memory is Lw x G x (S + 2) x 4 + 16 G S bytes (G = 32 / L): the
//   spans Lw 876 at S 64, 1,705 at S 32, 1,610 at 16, 1,449 at 8 and 1,208
//   at 4 fit 227 KB. A longer span takes the block instance.
//
// bcjr_kernel_block and bcjr_kernel_thin, the block instance, for every
// other call: every state count outside 4-64 and every span past the lanes
// instance's shared memory. The meet instances' schedule (forward and
// backward side by side to the middle, then on through the other half),
// the history off the step chain:
// - bcjr_kernel_block<R, L, W> (S >= 4): a column's states over the lanes
//   of W warps a direction, R = 1, 2, 4 or 8 a lane, the state count padded
//   to P = L R W (L = 4-32 lanes a column, 32 / L columns a warp below 32
//   states; the geometry compile-time). A lane keeps its transitions' table entries and coefficients
//   in registers, loaded once; a step exchanges the metrics through shared
//   memory (a store, __syncwarp or, with W > 1 warps, one named barrier of
//   the direction's warps, the table-indexed loads; two alternating
//   buffers) and takes the state maximum beside it (shuffles, or redux.sync
//   on order-preserving keys and the warps' partials through shared
//   memory), as the lanes instance does. Padded states point at themselves
//   with zero coefficients and hold -inf, so they change no maximum.
// - bcjr_kernel_thin<S, kResident> (S 2 and 3): a column a lane, its
//   metrics in registers, its tables the kernel's parameters, the gather by
//   selects; no exchange and no barrier a step; its spans and
//   half-histories in shared memory where they fit (to 363-454 steps).
// - bcjr_kernel_block writes each direction's half of the history (alpha_t
//   for t < mid, beta_t for t >= mid) to a device scratch as it goes (fire
//   and forget), and reads the other half back in the second half through a
//   ring in shared memory that cp.async fills kDepth steps ahead; the spans
//   come through a ring the same way. So a step's chain never waits on
//   device memory, and the span may be any length. The history costs Lw x P
//   x 4 bytes a column, written once and read once: 0.94 GB, 0.28 ms at
//   3.35 TB/s, at S 256, Lw 224, N 2,048; with the history's traffic taken
//   out (a scratch copy of the kernel) the time barely moves (PERF.md), so
//   the kernel is held by its instructions and their latency, not by that
//   floor. At R = 2 a step's branch metrics are computed a step ahead.
// - bcjr_kernel_thin keeps its spans and half-histories in shared memory
//   up to 454 steps (S 2) or 363 (S 3), as the meet instance does; past
//   that they go through the scratch and a ring of 32 steps.
// - Past 1,024 states (W > 4 warps) a column's tables no longer fit one
//   CTA's registers. Over columns that fill the card, to 2,048 states,
//   bcjr_kernel_block<8, 32, 8, true> (the shared route) keeps them in
//   shared memory instead: one CTA of 16 warps a column, the transitions'
//   ends alone in registers. Every other call takes bcjr_kernel_cluster,
//   bcjr_kernel_block's design across a thread-block cluster of 2-8 CTAs a
//   column: to 8 x 1,024 states its tables stay in registers and each
//   step's metrics and partial maxima are pushed to every CTA's copy of the
//   column by st.async under an mbarrier (no cluster barrier a step, local
//   gathers); past that the tables are read through L1 and each CTA's
//   exchange by the others, with one cluster barrier a step. See its
//   section.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <tuple>
#include <type_traits>

namespace {

namespace cg = cooperative_groups;

constexpr int kMeetThreads = 64;      // the meet instance's block: two warps
constexpr int kLanesThreads = 64;     // the lanes instance's block: two warps
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

// ------------------------------------------------------------ block instance

constexpr int kNoKey = static_cast<int>(0x80000000u);  // below every max_key

__device__ __forceinline__ int key_of(float v) { return max_key(__float_as_int(v)); }
__device__ __forceinline__ float of_key(int k) { return __int_as_float(max_key(k)); }

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The maximum of v over the L lanes of this lane's column (L a power of two,
// 4 to 32): redux.sync of order-preserving keys at L = 32, else a butterfly.
__device__ __forceinline__ float lanes_max(float v, int L) {
  if (L == 32) return of_key(__reduce_max_sync(0xffffffffu, key_of(v)));
  for (int o = L >> 1; o >= 1; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

constexpr int kBlockWarps = 4;                      // the most warps a direction
constexpr int kBlockStates = 32 * 8 * kBlockWarps;  // past this, the cluster route

// Steps copied ahead through the rings at R states a lane: enough to cover
// a read from device memory at each R's step time.
template <int R>
struct BlockRing {
  static constexpr int kDepth = R == 1 ? 16 : (R == 2 ? 8 : 4);
};

// The block kernel's shared memory in bytes: the exchange buffers [2
// directions][2][row], the history ring [2 directions][kDepth][row], the
// span rings [2 W warps][kDepth][2][G], the warps' key partials [2
// directions][2][3][W] (row = 32 R W floats: the padded states of a CTA's
// columns) and, with kShared, the coefficients [fw; bw][row][2] (float2).
template <int R, int L, int W, bool kShared = false>
constexpr int block_smem() {
  constexpr int row = 32 * R * W, D = BlockRing<R>::kDepth, G = 32 / L;
  return (4 * row + 2 * D * row + 4 * W * D * G) * 4 + 12 * W * 4 + (kShared ? 4 * row * 8 : 0);
}

// Warps 0..W-1 run alpha forward, warps W..2W-1 beta backward, over the
// CTA's G = 32 / L columns (one column at L = 32), meeting at mid = Lw / 2
// as the lanes instance does. A lane of column g = lane / L holds R states:
// state s = w L R + r L + li in slot r of warp w of its direction, li = lane
// mod L; states from S to P - 1 are padding. The lane carries the last
// update's values n, before normalisation; a step publishes them to the
// exchange buffer, takes their maximum mx beside it, gathers its
// transitions' other ends from the buffer and subtracts mx from both (m = n
// - mx are the step's metrics, v the gathered ones: the twin's floats, one
// subtraction of one maximum), then updates n = max_k (v[k] + g[k]) with
// the step's branch metrics from the spans copied ahead. The first
// half stores m to history row t in the scratch; the second half computes
// the LLR of step t from the other direction's stored row, copied ahead
// into the ring. The geometry (R, L, W) is compile-time, so every index is
// a register and an immediate; the loop runs two steps an iteration, so the
// exchange buffer's parity is one too. hist: float32 [ceil(N / G)][lw][32 R
// W], the CTA's rows at blockIdx.x; idx int32 [nxt; prev_s] and coef
// float32 [fw0; fw1; bw0; bw1], each [S][2], on the card.
//
// kShared (past 1,024 states to 2,048, where the columns fill the card: one
// CTA a column of 8 warps a direction of 8 states a lane): every
// transition's coefficients come from shared memory, loaded once a CTA, at
// a compile-time offset from the lane's first state, so a lane keeps only
// its transitions' ends in registers and 16 warps fit one CTA's registers.
template <int R, int L, int W, bool kShared = false>
__global__ void __launch_bounds__(64 * W)
bcjr_kernel_block(const float* __restrict__ ls, const float* __restrict__ lp,
                  float* __restrict__ llr, float* __restrict__ hist, int lw,
                  long long ncols, int S, const int* __restrict__ idx,
                  const float* __restrict__ coef) {
  constexpr bool kMulti = W > 1;
  // branch metrics a step ahead at R = 2, where that measured faster (6% at
  // S 64); at R = 1 it measured slower (8 lanes a column) or even, and at
  // larger R the registers it takes cost occupancy (PERF.md, PR 21)
  constexpr bool kAhead = R == 2;
  constexpr int D = BlockRing<R>::kDepth;
  constexpr int G = 32 / L, P = L * R * W, row = 32 * R * W;
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool forward = warp < W;
  const int w = forward ? warp : warp - W;  // the warp within its direction
  const int g = lane / L, li = lane % L;
  const long long col0 = static_cast<long long>(blockIdx.x) * G;
  const long long col = col0 + g;
  const int xbase = forward ? 0 : 2 * row;  // this direction's exchange buffers
  float* const hr = smem + 4 * row + (forward ? 0 : D * row);          // [D][row]
  float* const sr = smem + 4 * row + 2 * D * row + warp * D * 2 * G;  // [D][2][G]
  int* const pd = reinterpret_cast<int*>(smem + 4 * row + 2 * D * row + 4 * W * D * G) +
                  (forward ? 0 : 6 * W);  // [2][3][W]
  // kShared: the coefficients (c0, c1) of transition (s, k), [fw; bw][row][2]
  float2* const cs =
      reinterpret_cast<float2*>(smem + 4 * row + 2 * D * row + 4 * W * D * G + 12 * W);
  float* const hcta = hist + static_cast<long long>(blockIdx.x) * lw * row;

  // this lane's transitions: the offsets of their other ends (exchange
  // buffer 0 for the recursion, a history row for the LLR) and their
  // coefficients, and (forward) the LLR's: nxt and the backward coefficients
  const int own = g * P + w * L * R + li;  // slot r at own + r L
  int at[R][2], lat[R][2];
  constexpr int RC = kShared ? 1 : R;
  float c0[RC][2], c1[RC][2], l0[RC][2], l1[RC][2], n[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int s = w * L * R + r * L + li;
    n[r] = s < S ? 0.0f : -INFINITY;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int e = 2 * s + k;
      if (s < S) {
        const int nx = __ldg(idx + e);
        at[r][k] = xbase + g * P + (forward ? __ldg(idx + 2 * S + e) : nx);
        lat[r][k] = g * P + nx;
        if constexpr (!kShared) {
          c0[r][k] = __ldg(coef + (forward ? 0 : 4 * S) + e);
          c1[r][k] = __ldg(coef + (forward ? 2 * S : 6 * S) + e);
          l0[r][k] = __ldg(coef + 4 * S + e);
          l1[r][k] = __ldg(coef + 6 * S + e);
        }
      } else {  // padding: its own end, zero coefficients, -inf throughout
        at[r][k] = xbase + own + r * L;
        lat[r][k] = own + r * L;
        if constexpr (!kShared) c0[r][k] = c1[r][k] = l0[r][k] = l1[r][k] = 0.0f;
      }
    }
  }
  if constexpr (kShared) {  // every transition's coefficients, zero for padding
    for (int e = threadIdx.x; e < 4 * row; e += 64 * W) {
      const int bw = e >= 2 * row, t = e - (bw ? 2 * row : 0), s = t >> 1;
      cs[e] = s < S ? make_float2(__ldg(coef + 4 * bw * S + t), __ldg(coef + (4 * bw + 2) * S + t))
                    : make_float2(0.0f, 0.0f);
    }
    __syncthreads();
  }
  // kShared: this lane's slots' coefficients (the recursion's, and forward the LLR's)
  const float2* const crec = cs + (forward ? 0 : 2 * row) + 2 * own;
  const float2* const cllr = cs + 2 * row + 2 * own;
  const int dt = forward ? 1 : -1;
  const long long span_step = dt * ncols;
  auto sync_dir = [&] {
    if constexpr (kMulti) {
      asm volatile("bar.sync %0, %1;\n" ::"r"(forward ? 1 : 2), "n"(32 * W) : "memory");
    } else {
      __syncwarp();
    }
  };
  // the span source of lanes below 2 G (a column each; past N it copies
  // nothing and the ring reads zero)
  const int q = lane < G ? lane : lane - G;
  const bool copier = lane < 2 * G && col0 + q < ncols;
  const float* const sbase = (lane < G ? ls : lp) + (copier ? col0 + q : 0);

  // one half: `steps` steps from row t0 in this warp's direction; kLLR: the
  // second half (the LLRs from the ring's rows), else the first (m to the
  // history)
  auto half = [&](auto llr_c, int t0, int steps) {
    constexpr bool kLLR = decltype(llr_c)::value;
    // the copies of the next step to issue (its ring slot, span source,
    // history row), advanced a step at a time
    int jn = 0;
    const float* sn = sbase + t0 * ncols;
    const float* hn = hcta + static_cast<long long>(t0) * row;
    auto issue = [&] {
      if (jn < steps) {
        const int slot = jn & (D - 1);
        if (lane < 2 * G) cp_async4(sr + slot * 2 * G + lane, sn, copier ? 4 : 0);
        if constexpr (kLLR) {
          for (int c = w * 32 + lane; c < row / 4; c += 32 * W) {
            cp_async16(hr + slot * row + 4 * c, hn + 4 * c, 16);
          }
        }
      }
      cp_commit();
      ++jn;
      sn += span_step;
      hn += dt * row;
    };
    // the branch metrics of step j from its ring slot: the recursion's,
    // and (forward, second half) the LLR's
    float gb[R][2], gl[R][2];
    auto metrics = [&](int j, float (&to)[R][2], float (&lo)[R][2]) {
      const int slot = j & (D - 1);
      const float x = sr[slot * 2 * G + g], y = sr[slot * 2 * G + G + g];
      if constexpr (kShared) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const float2 c = crec[2 * r * L + k];
            to[r][k] = branch_metric(c.x, c.y, x, y);
            if (kLLR && forward) {
              const float2 u = cllr[2 * r * L + k];
              lo[r][k] = branch_metric(u.x, u.y, x, y);
            }
          }
        }
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r) {
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            to[r][k] = branch_metric(c0[r][k], c1[r][k], x, y);
            if (kLLR && forward) lo[r][k] = branch_metric(l0[r][k], l1[r][k], x, y);
          }
        }
      }
    };
    for (int j = 0; j < D - 1; ++j) issue();
    if constexpr (kAhead) {
      cp_wait<D - 2>();  // step 0's copies
      sync_dir();
      metrics(0, gb, gl);
    }
    float* hw = hcta + static_cast<long long>(t0) * row + own;        // m's row (first half)
    float* out = llr + static_cast<long long>(t0) * ncols + col;       // the LLR (second half)
    int pend0 = kNoKey, pend1 = kNoKey;  // kMulti: the last step's LLR keys

    auto step = [&](int i, auto parity_c) {
      constexpr int par = decltype(parity_c)::value;
      float* const xb = smem + par * row;
      int* const pb = pd + par * 3 * W;
      cp_wait<kAhead ? D - 3 : D - 2>();  // this thread's copies of step i (+ 1)
      float lm = n[0];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        xb[xbase + own + r * L] = n[r];
        lm = fmaxf(lm, n[r]);
      }
      if constexpr (kMulti) {
        const int k = __reduce_max_sync(0xffffffffu, key_of(lm));
        if (lane == 0) {
          pb[w] = k;
          if (kLLR) {
            pb[W + w] = pend0;
            pb[2 * W + w] = pend1;
          }
        }
      }
      sync_dir();  // the buffer, the partials and the step's copies visible
      issue();     // step i + D - 1, into the slot of step i - 1
      float gbn[R][2], gln[R][2];
      if constexpr (kAhead) {
        metrics(i + 1, gbn, gln);  // off the chain
      } else {
        metrics(i, gb, gl);
      }
      float mx;
      if constexpr (kMulti) {
        int k = pb[0];
#pragma unroll
        for (int u = 1; u < W; ++u) k = max(k, pb[u]);
        mx = of_key(k);
        if (kLLR && i > 0 && w == 0 && lane == 0) {  // step i - 1's LLR
          int a = pb[W], b = pb[2 * W];
#pragma unroll
          for (int u = 1; u < W; ++u) {
            a = max(a, pb[W + u]);
            b = max(b, pb[2 * W + u]);
          }
          out[-span_step] = __fsub_rn(of_key(a), of_key(b));
        }
      } else {
        mx = lanes_max(lm, L);
      }
      float m[R], v[R][2];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        m[r] = __fsub_rn(n[r], mx);
        v[r][0] = __fsub_rn(xb[at[r][0]], mx);
        v[r][1] = __fsub_rn(xb[at[r][1]], mx);
      }
      if constexpr (!kLLR) {
#pragma unroll
        for (int r = 0; r < R; ++r) hw[r * L] = m[r];
        hw += dt * row;
      } else {
        // (alpha + gb) + beta[nxt] over the lane's states, u = 0 and 1:
        // forward, alpha = m and beta the row's; backward, alpha the row's,
        // gb its own step's and beta[nxt] its gather v
        const float* const o = hr + (i & (D - 1)) * row;
        float k0 = -INFINITY, k1 = -INFINITY;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float a, q0, q1, b0, b1;
          if (forward) {
            a = m[r];
            q0 = gl[r][0];
            q1 = gl[r][1];
            b0 = o[lat[r][0]];
            b1 = o[lat[r][1]];
          } else {
            a = o[own + r * L];
            q0 = gb[r][0];
            q1 = gb[r][1];
            b0 = v[r][0];
            b1 = v[r][1];
          }
          k0 = fmaxf(k0, __fadd_rn(__fadd_rn(a, q0), b0));
          k1 = fmaxf(k1, __fadd_rn(__fadd_rn(a, q1), b1));
        }
        if constexpr (kMulti) {
          pend0 = __reduce_max_sync(0xffffffffu, key_of(k0));
          pend1 = __reduce_max_sync(0xffffffffu, key_of(k1));
        } else {
          const float o0 = lanes_max(k0, L), o1 = lanes_max(k1, L);
          if (li == 0 && col < ncols) *out = __fsub_rn(o0, o1);
        }
        out += span_step;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        n[r] = fmaxf(__fadd_rn(v[r][0], gb[r][0]), __fadd_rn(v[r][1], gb[r][1]));
        if constexpr (kAhead) {
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            gb[r][k] = gbn[r][k];
            gl[r][k] = gln[r][k];
          }
        }
      }
    };

    int i = 0;
    for (; i + 1 < steps; i += 2) {
      step(i, std::integral_constant<int, 0>{});
      step(i + 1, std::integral_constant<int, 1>{});
    }
    if (i < steps) step(i, std::integral_constant<int, 0>{});
    if constexpr (kMulti && kLLR) {  // the last step's LLR
      if (steps > 0) {
        int* const pb = pd + (steps & 1) * 3 * W;
        if (lane == 0) {
          pb[W + w] = pend0;
          pb[2 * W + w] = pend1;
        }
        sync_dir();
        if (w == 0 && lane == 0) {
          int a = pb[W], b = pb[2 * W];
#pragma unroll
          for (int u = 1; u < W; ++u) {
            a = max(a, pb[W + u]);
            b = max(b, pb[2 * W + u]);
          }
          out[-span_step] = __fsub_rn(of_key(a), of_key(b));
        }
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  };

  const int mid = lw >> 1;
  half(std::false_type{}, forward ? 0 : lw - 1, forward ? mid : lw - mid);
  __syncthreads();  // the meet: each half of the history written
  half(std::true_type{}, forward ? mid : mid - 1, forward ? lw - mid : mid);
}

// x[a] for a state index a < S held in registers: selects.
template <int S>
__device__ __forceinline__ float pick(const float (&x)[S], int a) {
  float v = x[0];
#pragma unroll
  for (int s = 1; s < S; ++s) v = a == s ? x[s] : v;
  return v;
}

constexpr int kThinRing = 32;  // steps the thin kernel copies ahead

// The thin kernel's tables, passed by value: its parameters, uniform across
// the CTA and read at compile-time indices, so a coefficient is an operand
// of the constant bank and a pick's predicate is a uniform one.
template <int S>
struct ThinTables {
  int nxt[2 * S];
  int prev[2 * S];
  float fw0[2 * S];
  float fw1[2 * S];
  float bw0[2 * S];
  float bw1[2 * S];
};

// The thin kernel's shared memory in bytes: resident, the CTA's spans [2]
// [lw][32] and half-histories [lw][S][32]; else the rings [2 warps][kThinRing]
// [S + 2][32].
template <int S, bool kResident>
constexpr long long thin_smem(int lw) {
  return kResident ? 4LL * lw * (S + 2) * 32 : 4LL * 2 * kThinRing * (S + 2) * 32;
}

// One direction of the thin kernel, both halves (kForward: alpha from t =
// 0, else beta from t = lw - 1), for the lane's column col0 + lane.
template <int S, bool kResident, bool kForward>
__device__ __forceinline__ void thin_direction(const float* __restrict__ ls,
                                               const float* __restrict__ lp,
                                               float* __restrict__ llr, float* __restrict__ hist,
                                               int lw, long long ncols, const ThinTables<S>& tb,
                                               float* tsm, long long col0) {
  constexpr int D = kThinRing;
  constexpr int dt = kForward ? 1 : -1;
  const int lane = threadIdx.x & 31;
  const long long col = col0 + lane;
  const bool in = col < ncols;
  const long long cc = in ? col : 0;
  float* const ring = tsm + (kForward ? 0 : D * (S + 2) * 32);  // [D][S + 2][32]
  float* const hres = tsm + 2 * lw * 32;                        // [lw][S][32]
  const int* const at = kForward ? tb.prev : tb.nxt;
  const float* const c0 = kForward ? tb.fw0 : tb.bw0;
  const float* const c1 = kForward ? tb.fw1 : tb.bw1;
  const long long step_span = dt * ncols, step_hist = dt * S * ncols;
  float n[S];
#pragma unroll
  for (int s = 0; s < S; ++s) n[s] = 0.0f;

  auto half = [&](auto llr_c, int t0, int steps) {
    constexpr bool kLLR = decltype(llr_c)::value;
    int jn = 0;
    const float* sn = ls + t0 * ncols + cc;
    const float* pn = lp + t0 * ncols + cc;
    const float* hn = hist + static_cast<long long>(t0) * S * ncols + cc;
    auto issue = [&] {  // the ring: step jn's copies into its slot
      if (jn < steps) {
        float* const q = ring + (jn & (D - 1)) * (S + 2) * 32 + lane;
        cp_async4(q, sn, in ? 4 : 0);
        cp_async4(q + 32, pn, in ? 4 : 0);
        if constexpr (kLLR) {
#pragma unroll
          for (int s = 0; s < S; ++s) cp_async4(q + (2 + s) * 32, hn + s * ncols, in ? 4 : 0);
        }
      }
      cp_commit();
      ++jn;
      sn += step_span;
      pn += step_span;
      hn += step_hist;
    };
    // step j's branch metrics: the recursion's, and (forward, second half)
    // the LLR's, by the backward coefficients
    float gb[S][2], gl[S][2];
    auto metrics = [&](int j, float (&to)[S][2], float (&lo)[S][2]) {
      float x, y;
      if constexpr (kResident) {
        const int t = min(max(t0 + dt * j, 0), lw - 1);
        x = tsm[t * 32 + lane];
        y = tsm[(lw + t) * 32 + lane];
      } else {
        const float* const q = ring + (j & (D - 1)) * (S + 2) * 32 + lane;
        x = q[0];
        y = q[32];
      }
#pragma unroll
      for (int e = 0; e < 2 * S; ++e) {
        to[e >> 1][e & 1] = branch_metric(c0[e], c1[e], x, y);
        if (kLLR && kForward) lo[e >> 1][e & 1] = branch_metric(tb.bw0[e], tb.bw1[e], x, y);
      }
    };
    if constexpr (!kResident) {
      for (int j = 0; j < D - 1; ++j) issue();
      cp_wait<D - 2>();
    }
    metrics(0, gb, gl);
    float* hw = hist + static_cast<long long>(t0) * S * ncols + cc;
    float* out = llr + t0 * ncols + cc;
    for (int i = 0; i < steps; ++i) {
      const int t = t0 + dt * i;
      if constexpr (!kResident) {
        cp_wait<D - 3>();  // this lane's copies of step i + 1
        issue();           // step i + D - 1, into the slot of step i - 1
      }
      float gbn[S][2], gln[S][2];
      metrics(i + 1, gbn, gln);  // off the chain
      float mx = n[0];
#pragma unroll
      for (int s = 1; s < S; ++s) mx = fmaxf(mx, n[s]);
      float m[S], v[S][2];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        m[s] = __fsub_rn(n[s], mx);
        v[s][0] = __fsub_rn(pick<S>(n, at[2 * s]), mx);
        v[s][1] = __fsub_rn(pick<S>(n, at[2 * s + 1]), mx);
      }
      if constexpr (!kLLR) {
        if constexpr (kResident) {
#pragma unroll
          for (int s = 0; s < S; ++s) hres[(t * S + s) * 32 + lane] = m[s];
        } else {
          if (in) {
#pragma unroll
            for (int s = 0; s < S; ++s) hw[s * ncols] = m[s];
          }
          hw += step_hist;
        }
      } else {
        float o[S];
        if constexpr (kResident) {
#pragma unroll
          for (int s = 0; s < S; ++s) o[s] = hres[(t * S + s) * 32 + lane];
        } else {
          const float* const q = ring + (i & (D - 1)) * (S + 2) * 32 + lane;
#pragma unroll
          for (int s = 0; s < S; ++s) o[s] = q[(2 + s) * 32];
        }
        // (alpha + gb) + beta[nxt]: forward alpha = m and beta the row's;
        // backward alpha the row's, gb its own and beta[nxt] its gather v
        float k0 = 0.0f, k1 = 0.0f;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          float e0, e1;
          if constexpr (kForward) {
            e0 = __fadd_rn(__fadd_rn(m[s], gl[s][0]), pick<S>(o, tb.nxt[2 * s]));
            e1 = __fadd_rn(__fadd_rn(m[s], gl[s][1]), pick<S>(o, tb.nxt[2 * s + 1]));
          } else {
            e0 = __fadd_rn(__fadd_rn(o[s], gb[s][0]), v[s][0]);
            e1 = __fadd_rn(__fadd_rn(o[s], gb[s][1]), v[s][1]);
          }
          k0 = s == 0 ? e0 : fmaxf(k0, e0);
          k1 = s == 0 ? e1 : fmaxf(k1, e1);
        }
        if (in) *out = __fsub_rn(k0, k1);
        out += step_span;
      }
#pragma unroll
      for (int s = 0; s < S; ++s) {
        n[s] = fmaxf(__fadd_rn(v[s][0], gb[s][0]), __fadd_rn(v[s][1], gb[s][1]));
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          gb[s][k] = gbn[s][k];
          gl[s][k] = gln[s][k];
        }
      }
    }
    if constexpr (!kResident) asm volatile("cp.async.wait_all;\n" ::: "memory");
  };

  const int mid = lw >> 1;
  half(std::false_type{}, kForward ? 0 : lw - 1, kForward ? mid : lw - mid);
  // the meet (both warps, from their own code): each half of the history written
  asm volatile("bar.sync 1, 64;\n" ::: "memory");
  half(std::true_type{}, kForward ? mid : mid - 1, kForward ? lw - mid : mid);
}

// S 2 and 3: warp 0 runs alpha forward and warp 1 beta backward over the
// CTA's 32 columns, a column a lane, its S metrics in registers; the gather
// picks among them by the tables (the kernel's parameters), and a step's
// branch metrics are computed a step ahead. kResident (spans to 454 steps
// at S 2, 363 at S 3): the CTA's spans come into shared memory once and the
// half-histories stay there, as in the meet instance; else the spans and,
// in the second half, the other direction's history row come through a
// ring of the lane's own cp.async copies from the scratch, so no step waits
// on another lane, and rarely on device memory. hist: float32 [lw][S][N]
// (not resident).
template <int S, bool kResident>
__global__ void __launch_bounds__(64)
bcjr_kernel_thin(const float* __restrict__ ls, const float* __restrict__ lp,
                 float* __restrict__ llr, float* __restrict__ hist, int lw,
                 long long ncols, const __grid_constant__ ThinTables<S> tb) {
  extern __shared__ __align__(16) float tsm[];
  const long long col0 = static_cast<long long>(blockIdx.x) * 32;
  if constexpr (kResident) {  // the CTA's spans [2][lw][32]; past N as zero
    for (int i = threadIdx.x; i < 2 * lw * 32; i += 64) {
      const int r = i >> 5, q = i & 31;
      const int t = r < lw ? r : r - lw;
      const bool ok = col0 + q < ncols;
      const float* src = (r < lw ? ls : lp) + static_cast<long long>(t) * ncols + (ok ? col0 + q : 0);
      cp_async4(tsm + i, src, ok ? 4 : 0);
    }
    cp_commit();
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
  }
  if (threadIdx.x < 32) {
    thin_direction<S, kResident, true>(ls, lp, llr, hist, lw, ncols, tb, tsm, col0);
  } else {
    thin_direction<S, kResident, false>(ls, lp, llr, hist, lw, ncols, tb, tsm, col0);
  }
}

// ------------------------------------------------------------ cluster route
//
// bcjr_kernel_cluster<R, W, kPlace>, the block instance past 1,024 states
// (ops/cuda/bcjr.py block_layout "cluster"): bcjr_kernel_block's design
// carried across a thread-block cluster of q CTAs a column (2-8). Each CTA
// holds SC = 32 W R' of the column's P = q SC padded states (state s in the
// CTA of rank s / SC), over W warps a direction (warps 0..W-1 forward,
// W..2W-1 backward) of R' states a lane: state rank SC + w 32 R' + 32 r +
// lane in slot r. The two directions run side by side to the middle (one
// cluster barrier there: the history written), then on through the other
// half, as in block: the chain is Lw steps, not 2 Lw. A step of a
// direction: the state maximum mx from the q W warps' partial keys (a lane
// a partial, one redux.sync); each state's metric m = n - mx (n, the last
// update, before its normalisation) and its transitions' other ends v =
// n[at] - mx (the twin's floats: one subtraction of one maximum); the
// first half writes m to the history in the device scratch ([N][Lw][P]),
// the second half takes its LLR's terms as block does, forward (m + g_bw)
// + beta_t[nxt], backward (alpha_t + g_bw) + v, their warps' partial maxima
// going to rank 0, which writes the LLR a step later; then the update n =
// max_k (v[k] + g[k]) and its warp's partial maximum.
//
// kPlace, where the tables and the exchange live:
// - kPlaceRegs (to 8 x 1,024 states): R states a lane, each transition's
//   table entries and coefficients in registers, loaded once, as block.
//   Every CTA keeps a whole copy of the column's metrics, [2 directions][2]
//   [P], so a step's gathers are local shared-memory loads: a lane writes
//   its updates to its own copy and pushes them to the q - 1 others with
//   st.async, whose bytes complete the transaction count of the receiving
//   CTA's mbarrier of that direction and parity (the partial keys likewise;
//   the CTA's own warps arrive on it with the bytes they expect). A step
//   waits on its mbarrier alone: no cluster barrier, no remote load, and no
//   release of the history's stores a step. The spans and, in the second
//   half, the other direction's history entries that the lane's own
//   transitions read (beta_t at nxt forward, alpha_t at its own states
//   backward) come through a ring of the lane's own cp.async copies
//   kClusterRing steps ahead, so no row of the history need fit a CTA.
// - kPlaceGlobal (past that): R' states a lane at run time, the tables read
//   a step through the read-only path (L1-resident); each CTA's own states'
//   metrics in an exchange in the device scratch ([N][2][2][P]) that the
//   others read (ld.global.cg); one cluster barrier a step
//   (barrier.cluster.arrive.release / wait.acquire), the partial keys
//   pushed to every CTA before it; the spans and the history read directly.
// What bounds it on an H100 (80GB HBM3, 700 W; PERF.md §6): at few
// columns the step chain, whose exchange alone (an empty kernel of the same
// mbarrier waits and pushes: chip_smoke.py phase 7's floor) takes a quarter
// of phase 7's launch at S 1,500; at many columns the registers: 219 a
// thread at 8 states a lane hold one CTA of 8 warps an SM (the K 12 code's
// 512 columns would take ~8 waves: 2.95 ms), so from 34 columns to 2,048
// states the shared route takes the call (1.10 ms there).

constexpr int kPlaceRegs = 0, kPlaceGlobal = 1, kPlaceShared = 2;
constexpr int kClusterRing = 4;  // steps the registers placement copies ahead
constexpr int kClusterMaxQ = 8;
constexpr int kClusterKeys = 32;  // a direction's partial keys: q W <= 32

__device__ __forceinline__ unsigned cluster_map(const void* p, int rank) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(a), "r"(rank));
  return r;
}

__device__ __forceinline__ void cluster_st(unsigned a, int v) {
  asm volatile("st.shared::cluster.s32 [%0], %1;\n" ::"r"(a), "r"(v) : "memory");
}

// st.async of v to the shared::cluster address a, its bytes completing the
// transaction count of the mbarrier at the shared::cluster address bar. No
// memory clobber: the compiler may move this thread's loads past a push (no
// load reads what it writes); the pushes keep their order to the volatile
// arrive that follows them.
__device__ __forceinline__ void push_f32(unsigned a, float v, unsigned bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, [%2];\n"
               ::"r"(a), "f"(v), "r"(bar));
}

__device__ __forceinline__ void push_v2(unsigned a, int x, int y, unsigned bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.s32 [%0], {%1, %2}, [%3];\n"
               ::"r"(a), "r"(x), "r"(y), "r"(bar));
}

__device__ __forceinline__ void push_s32(unsigned a, int v, unsigned bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.s32 [%0], %1, [%2];\n"
               ::"r"(a), "r"(v), "r"(bar));
}

__device__ __forceinline__ void bar_wait(unsigned bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// Floats of shared memory a CTA of the cluster route takes. Registers: the
// metrics' copies [2 directions][2][P], the partial keys [2][2][32], the
// LLR's [2][2][32][2], four mbarriers, the ring [kClusterRing][2 + 2 R][64
// W]. Global: the keys and the LLR's keys.
__host__ __device__ constexpr long long cluster_smem_floats(int R, int W, int place, long long sc,
                                                            int q) {
  return place == kPlaceRegs ? 4 * q * sc + 12 * kClusterKeys + 8 +
                                   static_cast<long long>(kClusterRing) * (2 + 2 * R) * 64 * W
                             : 12 * kClusterKeys;
}

// The registers placement (bcjr_kernel_cluster's comment).
template <int R, int W>
__device__ __forceinline__ void cluster_regs(const float* __restrict__ ls,
                                             const float* __restrict__ lp,
                                             float* __restrict__ llr, float* __restrict__ hist,
                                             int lw, long long ncols, int S,
                                             const int* __restrict__ idx,
                                             const float* __restrict__ coef, float* smc) {
  constexpr int D = kClusterRing, E = 2 + 2 * R, T = 64 * W, SC = 32 * W * R;
  constexpr unsigned kAll = 0xffffffffu;
  cg::cluster_group cluster = cg::this_cluster();
  const int q = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int P = q * SC;
  const long long col = blockIdx.x / q;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bool forward = warp < W;
  const int d = forward ? 0 : 1, w = forward ? warp : warp - W;
  const int own = rank * SC + w * 32 * R + lane;  // slot r's state: own + 32 r
  const int key_slot = rank * W + w;
  float* const xf = smc;                                         // [2 d][2 parity][P]
  int* const keys = reinterpret_cast<int*>(smc + 4 * P);         // [2 d][2 parity][32]
  int* const lkeys = keys + 4 * kClusterKeys;                    // [2 d][2 parity][32][2]
  unsigned long long* const bars =
      reinterpret_cast<unsigned long long*>(lkeys + 8 * kClusterKeys);  // [2 d][2 parity]
  float* const ring = reinterpret_cast<float*>(bars + 4);        // [D][E][T]
  float* const hcol = hist + col * lw * static_cast<long long>(P);
  const unsigned bar_s = static_cast<unsigned>(__cvta_generic_to_shared(bars));

  // the copies of parity 0 (every state's initial metric: 0, -inf padded)
  // and their partial keys are the same in every CTA: each fills its own
  if (tid == 0) {
    for (int i = 0; i < 4; ++i) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar_s + 8 * i), "r"(W)
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int e = tid; e < 2 * P; e += T) {
    const int s = e % P;
    xf[(e / P) * 2 * P + s] = s < S ? 0.0f : -INFINITY;
  }
  for (int e = tid; e < 2 * q * W; e += T) {
    const int k = e % (q * W);
    const int first = (k / W) * SC + (k % W) * 32 * R;  // that warp's first state
    keys[(e / (q * W)) * 2 * kClusterKeys + k] = key_of(first < S ? 0.0f : -INFINITY);
  }

  // each transition's other end (its copy index, parity 0), history index
  // (forward: nxt, the LLR's beta) and coefficients (the direction's, and
  // forward the LLR's backward ones), loaded once; padded states point at
  // themselves with zero coefficients and hold -inf
  int at[R][2], nx[R][2];
  float c0[R][2], c1[R][2], l0[R][2], l1[R][2], n[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int s = own + 32 * r;
    n[r] = s < S ? 0.0f : -INFINITY;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int e = 2 * s + k;
      if (s < S) {
        at[r][k] = 2 * d * P + __ldg(idx + (forward ? 2 * S : 0) + e);
        nx[r][k] = __ldg(idx + e);
        c0[r][k] = __ldg(coef + (forward ? 0 : 4 * S) + e);
        c1[r][k] = __ldg(coef + (forward ? 2 * S : 6 * S) + e);
        l0[r][k] = __ldg(coef + 4 * S + e);
        l1[r][k] = __ldg(coef + 6 * S + e);
      } else {
        at[r][k] = 2 * d * P + s;
        nx[r][k] = s;
        c0[r][k] = c1[r][k] = l0[r][k] = l1[r][k] = 0.0f;
      }
    }
  }
  // the other CTAs' copies and mbarriers, as shared::cluster addresses
  unsigned rx[kClusterMaxQ], rb[kClusterMaxQ];
#pragma unroll
  for (int j = 0; j < kClusterMaxQ; ++j) {
    rx[j] = j < q ? cluster_map(xf, j) : 0u;
    rb[j] = j < q ? cluster_map(bars, j) : 0u;
  }
  cluster.sync();  // every CTA's mbarriers set up before any pushes to it

  int jd = 0;         // this direction's steps so far: parity jd & 1
  unsigned ph = 0u;   // bit p: the phase parity mbarrier (d, p) completes next
  int tp = -1;        // the step whose LLR is pending (its keys come with the next phase)
  // the remote bytes a warp of this CTA expects in a phase: its share of the
  // q - 1 other CTAs' metrics and keys (and at rank 0 the LLR's keys)
  const unsigned share_base = static_cast<unsigned>((q - 1) * (128 * R + 4));
  const unsigned share_llr = rank == 0 ? static_cast<unsigned>((q - 1) * 8) : 0u;
  auto wait = [&](int p) {
    bar_wait(bar_s + 8 * (2 * d + p), (ph >> p) & 1u);
    ph ^= 1u << p;
  };
  auto write_llr = [&](int p) {  // rank 0's first warp: the pending step's LLR
    if (tp >= 0 && rank == 0 && w == 0) {
      const int* const pk = lkeys + (2 * d + p) * 2 * kClusterKeys;
      const int a = __reduce_max_sync(kAll, lane < q * W ? pk[2 * lane] : kNoKey);
      const int b = __reduce_max_sync(kAll, lane < q * W ? pk[2 * lane + 1] : kNoKey);
      if (lane == 0) llr[tp * ncols + col] = __fsub_rn(of_key(a), of_key(b));
    }
    tp = -1;
  };

  // one half: `steps` steps of this direction from step t0
  auto half = [&](auto llr_c, int t0, int steps) {
    constexpr bool kLLR = decltype(llr_c)::value;
    const int dt = forward ? 1 : -1;
    int jn = 0;
    // the ring: step j's copies in slot j mod D, element e (0, 1: the spans;
    // then forward beta_t at nxt, backward alpha_t at the lane's states) of
    // this thread at (slot E + e) T + tid
    auto rs = [&](int j, int e) -> float* { return ring + ((j & (D - 1)) * E + e) * T + tid; };
    auto issue = [&] {  // step jn's copies into its slot
      if (jn < steps) {
        const int t = t0 + dt * jn;
        cp_async4(rs(jn, 0), ls + t * ncols + col, 4);
        cp_async4(rs(jn, 1), lp + t * ncols + col, 4);
        if constexpr (kLLR) {
          const float* const row = hcol + static_cast<long long>(t) * P;
#pragma unroll
          for (int r = 0; r < R; ++r) {
            if (forward) {
              cp_async4(rs(jn, 2 + 2 * r), row + nx[r][0], 4);
              cp_async4(rs(jn, 3 + 2 * r), row + nx[r][1], 4);
            } else {
              cp_async4(rs(jn, 2 + r), row + own + 32 * r, 4);
            }
          }
        }
      }
      cp_commit();
      ++jn;
    };
    for (int j = 0; j < D - 1; ++j) issue();
    for (int i = 0; i < steps; ++i) {
      const int t = t0 + dt * i, p = jd & 1;
      cp_wait<D - 2>();  // this thread's copies of step i
      if (jd > 0) wait(p);
      write_llr(p);
      issue();  // step i + D - 1, into the slot of step i - 1
      const float x = *rs(i, 0), y = *rs(i, 1);
      const float* const cur = xf + p * P;
      float e[R][2];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        e[r][0] = cur[at[r][0]];
        e[r][1] = cur[at[r][1]];
      }
      const float mx = of_key(__reduce_max_sync(
          kAll, lane < q * W ? keys[(2 * d + p) * kClusterKeys + lane] : kNoKey));
      float lm = -INFINITY, k0 = -INFINITY, k1 = -INFINITY;
      float* const hrow = hcol + static_cast<long long>(t) * P;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float m = __fsub_rn(n[r], mx);
        const float v0 = __fsub_rn(e[r][0], mx), v1 = __fsub_rn(e[r][1], mx);
        const float g0 = branch_metric(c0[r][0], c1[r][0], x, y);
        const float g1 = branch_metric(c0[r][1], c1[r][1], x, y);
        if constexpr (!kLLR) {
          hrow[own + 32 * r] = m;
        } else if (forward) {
          k0 = fmaxf(k0, __fadd_rn(__fadd_rn(m, branch_metric(l0[r][0], l1[r][0], x, y)),
                                   *rs(i, 2 + 2 * r)));
          k1 = fmaxf(k1, __fadd_rn(__fadd_rn(m, branch_metric(l0[r][1], l1[r][1], x, y)),
                                   *rs(i, 3 + 2 * r)));
        } else {
          const float a = *rs(i, 2 + r);
          k0 = fmaxf(k0, __fadd_rn(__fadd_rn(a, g0), v0));
          k1 = fmaxf(k1, __fadd_rn(__fadd_rn(a, g1), v1));
        }
        n[r] = fmaxf(__fadd_rn(v0, g0), __fadd_rn(v1, g1));
        lm = fmaxf(lm, n[r]);
      }
      // the updates to this CTA's copy and pushed to the others', after every
      // state's loads
      const int pn = p ^ 1;
      const unsigned to = static_cast<unsigned>(4 * (2 * d + pn) * P);  // the next copy
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const unsigned off = to + 4u * static_cast<unsigned>(own + 32 * r);
        xf[(2 * d + pn) * P + own + 32 * r] = n[r];
#pragma unroll
        for (int j = 0; j < kClusterMaxQ; ++j) {
          if (j < q && j != rank) push_f32(rx[j] + off, n[r], rb[j] + 8 * (2 * d + pn));
        }
      }
      // the warp's partial key to every CTA, and (second half) its LLR's to rank 0
      const int km = __reduce_max_sync(kAll, key_of(lm));
      const int ki = (2 * d + pn) * kClusterKeys + key_slot;
      if (lane == rank) {
        keys[ki] = km;
      } else if (lane < q) {
        push_s32(cluster_map(keys + ki, lane), km, cluster_map(bars + 2 * d + pn, lane));
      }
      if constexpr (kLLR) {
        const int a = __reduce_max_sync(kAll, key_of(k0)), b = __reduce_max_sync(kAll, key_of(k1));
        if (lane == 0) {
          if (rank == 0) {
            lkeys[2 * ki] = a;
            lkeys[2 * ki + 1] = b;
          } else {
            push_v2(cluster_map(lkeys + 2 * ki, 0), a, b, rb[0] + 8 * (2 * d + pn));
          }
        }
        tp = t;
      }
      __syncwarp();
      if (lane == 0) {  // the warp's own writes released, its share of the remote bytes expected
        asm volatile("mbarrier.arrive.expect_tx.release.cta.shared::cta.b64 _, [%0], %1;\n"
                     ::"r"(bar_s + 8 * (2 * d + pn)),
                     "r"(share_base + (kLLR ? share_llr : 0u))
                     : "memory");
      }
      ++jd;
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  };

  const int mid = lw >> 1;
  half(std::false_type{}, forward ? 0 : lw - 1, forward ? mid : lw - mid);
  cluster.sync();  // the meet: each half of the history written
  half(std::true_type{}, forward ? mid : mid - 1, forward ? lw - mid : mid);
  wait(jd & 1);  // the last step's pushes have arrived: the last LLR's keys
  write_llr(jd & 1);
  cluster.sync();  // no CTA leaves while another's pushes may reach it
}

// The global placement (bcjr_kernel_cluster's comment).
__device__ __forceinline__ void cluster_far(const float* __restrict__ ls,
                                            const float* __restrict__ lp,
                                            float* __restrict__ llr, float* __restrict__ hist,
                                            float* __restrict__ xg, int lw, long long ncols,
                                            int S, int rl, const int* __restrict__ idx,
                                            const float* __restrict__ coef, float* smc) {
  constexpr int W = 4;
  constexpr unsigned kAll = 0xffffffffu;
  cg::cluster_group cluster = cg::this_cluster();
  const int q = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const long long col = blockIdx.x / q;
  const int SC = 32 * W * rl, P = q * SC;  // states a CTA, and a column (padded)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bool forward = warp < W;
  const int d = forward ? 0 : 1, w = forward ? warp : warp - W;
  const int own = w * 32 * rl + lane;  // slot r's state rank SC + own + 32 r
  int* const pd = reinterpret_cast<int*>(smc);  // [2 parity][2 d][32]
  int* const pl = pd + 4 * kClusterKeys;         // [2 parity][2 d][2 u][32]
  float* const hcol = hist + col * lw * static_cast<long long>(P);
  float* const xgc = xg + col * 4 * static_cast<long long>(P);  // [2 d][2 parity][P]
  const int key_slot = rank * W + w;

  // this direction's exchange, parity p: a value of this CTA's state, and
  // the value of any state a
  auto put = [&](int p, int local, float v) {
    xgc[(2 * d + p) * static_cast<long long>(P) + rank * SC + local] = v;
  };
  auto get = [&](int p, int a) -> float {
    return __ldcg(xgc + (2 * d + p) * static_cast<long long>(P) + a);
  };
  // the warp's partial key pushed to every CTA's slot (parity p)
  auto push_max = [&](int p, float lm) {
    const int k = __reduce_max_sync(kAll, key_of(lm));
    if (lane < q) cluster_st(cluster_map(pd + (2 * p + d) * kClusterKeys + key_slot, lane), k);
  };

  cluster.sync();  // every CTA has started before any reaches another's shared memory
  {
    float lm = -INFINITY;
    for (int r = 0; r < rl; ++r) {
      const float v = rank * SC + own + 32 * r < S ? 0.0f : -INFINITY;
      put(0, own + 32 * r, v);
      lm = fmaxf(lm, v);
    }
    push_max(0, lm);
  }

  int jd = 0;            // this direction's steps so far: the exchange's parity
  int tp = -1, tpp = 0;  // the step whose LLR is pending, and its parity
  auto write_llr = [&] {  // rank 0's first warp: the pending step's LLR
    if (tp >= 0 && rank == 0 && w == 0) {
      const int* const pk = pl + (2 * tpp + d) * 2 * kClusterKeys;
      const int a = __reduce_max_sync(kAll, lane < q * W ? pk[lane] : kNoKey);
      const int b = __reduce_max_sync(kAll, lane < q * W ? pk[kClusterKeys + lane] : kNoKey);
      if (lane == 0) llr[tp * ncols + col] = __fsub_rn(of_key(a), of_key(b));
    }
    tp = -1;
  };
  // one half: `steps` steps of this direction from step t0 over `iters`
  // cluster barriers (the other direction may take one more)
  auto half = [&](auto llr_c, int t0, int steps, int iters) {
    constexpr bool kLLR = decltype(llr_c)::value;
    const int dt = forward ? 1 : -1;
    for (int i = 0; i < iters; ++i) {
      cluster.sync();
      write_llr();
      if (i >= steps) continue;
      const int t = t0 + dt * i, p = jd & 1;
      const float x = __ldg(ls + t * ncols + col), y = __ldg(lp + t * ncols + col);
      const float mx = of_key(__reduce_max_sync(
          kAll, lane < q * W ? pd[(2 * p + d) * kClusterKeys + lane] : kNoKey));
      float lm = -INFINITY, k0 = -INFINITY, k1 = -INFINITY;
      float* const hrow = hcol + static_cast<long long>(t) * P;
      for (int r = 0; r < rl; ++r) {
        const int local = own + 32 * r, s = rank * SC + local;
        const bool real = s < S;
        int a[2], nxs[2];
        float cf0[2], cf1[2], lf0[2], lf1[2];
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int e = 2 * s + k;
          a[k] = real ? __ldg(idx + (forward ? 2 * S : 0) + e) : s;
          nxs[k] = real ? __ldg(idx + e) : s;
          cf0[k] = real ? __ldg(coef + (forward ? 0 : 4 * S) + e) : 0.0f;
          cf1[k] = real ? __ldg(coef + (forward ? 2 * S : 6 * S) + e) : 0.0f;
          lf0[k] = real ? __ldg(coef + 4 * S + e) : 0.0f;
          lf1[k] = real ? __ldg(coef + 6 * S + e) : 0.0f;
        }
        const float m = __fsub_rn(get(p, s), mx);
        const float v0 = __fsub_rn(get(p, a[0]), mx), v1 = __fsub_rn(get(p, a[1]), mx);
        const float g0 = branch_metric(cf0[0], cf1[0], x, y);
        const float g1 = branch_metric(cf0[1], cf1[1], x, y);
        if constexpr (!kLLR) {
          hrow[s] = m;
        } else if (forward) {
          k0 = fmaxf(k0, __fadd_rn(__fadd_rn(m, branch_metric(lf0[0], lf1[0], x, y)),
                                   __ldcg(hrow + nxs[0])));
          k1 = fmaxf(k1, __fadd_rn(__fadd_rn(m, branch_metric(lf0[1], lf1[1], x, y)),
                                   __ldcg(hrow + nxs[1])));
        } else {
          const float al = __ldcg(hrow + s);
          k0 = fmaxf(k0, __fadd_rn(__fadd_rn(al, g0), v0));
          k1 = fmaxf(k1, __fadd_rn(__fadd_rn(al, g1), v1));
        }
        const float nn = fmaxf(__fadd_rn(v0, g0), __fadd_rn(v1, g1));
        put(p ^ 1, local, nn);
        lm = fmaxf(lm, nn);
      }
      if constexpr (kLLR) {  // the warp's LLR partials to rank 0
        const int a = __reduce_max_sync(kAll, key_of(k0)), b = __reduce_max_sync(kAll, key_of(k1));
        if (lane == 0) {
          const unsigned dst = cluster_map(pl + (2 * p + d) * 2 * kClusterKeys + key_slot, 0);
          cluster_st(dst, a);
          cluster_st(dst + 4 * kClusterKeys, b);
        }
        tp = t;
        tpp = p;
      }
      push_max(p ^ 1, lm);
      ++jd;
    }
  };

  const int mid = lw >> 1, iters = lw - mid;
  half(std::false_type{}, forward ? 0 : lw - 1, forward ? mid : lw - mid, iters);
  cluster.sync();  // the meet: each half of the history written
  half(std::true_type{}, forward ? mid : mid - 1, forward ? lw - mid : mid, iters);
  cluster.sync();  // the last steps' LLR partials at rank 0; no CTA reads another's after
  write_llr();
}

// idx int32 [nxt; prev_s] and coef float32 [fw0; fw1; bw0; bw1], each [S][2],
// on the card; hist float32 [N][lw][P]; xg (kPlaceGlobal) float32
// [N][2][2][P]; rl the states a lane of the global placement.
template <int R, int W, int kPlace>
__global__ void __launch_bounds__(64 * W)
bcjr_kernel_cluster(const float* __restrict__ ls, const float* __restrict__ lp,
                    float* __restrict__ llr, float* __restrict__ hist, float* __restrict__ xg,
                    int lw, long long ncols, int S, int rl, const int* __restrict__ idx,
                    const float* __restrict__ coef) {
  extern __shared__ __align__(16) float smc[];
  if constexpr (kPlace == kPlaceRegs) {
    cluster_regs<R, W>(ls, lp, llr, hist, lw, ncols, S, idx, coef, smc);
  } else {
    cluster_far(ls, lp, llr, hist, xg, lw, ncols, S, rl, idx, coef, smc);
  }
}

template <int R, int W, int kPlace>
int launch_cluster(const float* ls, const float* lp, float* llr, float* hist, float* xg, int lw,
                   long long ncols, int S, int q, int rl, const int* idx, const float* coef,
                   cudaStream_t stream) {
  const long long sc = 32LL * W * (kPlace == kPlaceRegs ? R : rl);
  const long long smem = 4 * cluster_smem_floats(R, W, kPlace, sc, q);
  if (q < 2 || q > kClusterMaxQ || q * W > kClusterKeys || q * sc < S || smem > kMaxSmem ||
      ncols * q > 0x7fffffffLL || (kPlace == kPlaceGlobal && xg == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = bcjr_kernel_cluster<R, W, kPlace>;
  static int opted[64] = {};
  const int rc = opt_in(kernel, smem, opted);
  if (rc) return rc;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(ncols * q));
  cfg.blockDim = dim3(64 * W);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = q;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, ls, lp, llr, hist, xg, lw, ncols, S,
                                             rl, idx, coef);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The cluster route's instance: the registers placement at R states a lane
// and W warps a direction (R 2, 4, 8; W 3, 4: ops/cuda/bcjr.py
// cluster_layout), else the global placement (W 4, rl states a lane).
int launch_cluster_route(const float* ls, const float* lp, float* llr, float* hist, float* xg,
                         int lw, long long ncols, int S, int q, int R, int W, int place, int rl,
                         const int* idx, const float* coef, cudaStream_t stream) {
  const auto a = std::make_tuple(ls, lp, llr, hist, xg, lw, ncols, S, q, rl, idx, coef, stream);
  auto go = [&](auto f) { return std::apply(f, a); };
  if (place == kPlaceGlobal && W == 4) return go(launch_cluster<1, 4, kPlaceGlobal>);
  if (place != kPlaceRegs) return static_cast<int>(cudaErrorInvalidValue);
  switch (10 * R + W) {
    case 23: return go(launch_cluster<2, 3, kPlaceRegs>);
    case 24: return go(launch_cluster<2, 4, kPlaceRegs>);
    case 43: return go(launch_cluster<4, 3, kPlaceRegs>);
    case 44: return go(launch_cluster<4, 4, kPlaceRegs>);
    case 83: return go(launch_cluster<8, 3, kPlaceRegs>);
    case 84: return go(launch_cluster<8, 4, kPlaceRegs>);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int R, int L, int W, bool kShared = false>
int launch_block(const float* ls, const float* lp, float* llr, float* hist, int lw,
                 long long ncols, int S, const int* idx, const float* coef,
                 cudaStream_t stream) {
  constexpr int smem = block_smem<R, L, W, kShared>();
  static int opted[64] = {};
  const int rc = opt_in(bcjr_kernel_block<R, L, W, kShared>, smem, opted);
  if (rc) return rc;
  const long long blocks = (ncols + 32 / L - 1) / (32 / L);
  bcjr_kernel_block<R, L, W, kShared><<<static_cast<unsigned>(blocks), 64 * W, smem, stream>>>(
      ls, lp, llr, hist, lw, ncols, S, idx, coef);
  return static_cast<int>(cudaGetLastError());
}

template <int S, bool kResident>
int launch_thin(const float* ls, const float* lp, float* llr, float* hist, int lw,
                long long ncols, const int* hidx, const float* hcoef, cudaStream_t stream) {
  ThinTables<S> tb;
  for (int e = 0; e < 2 * S; ++e) {
    tb.nxt[e] = hidx[e];
    tb.prev[e] = hidx[2 * S + e];
    tb.fw0[e] = hcoef[e];
    tb.fw1[e] = hcoef[2 * S + e];
    tb.bw0[e] = hcoef[4 * S + e];
    tb.bw1[e] = hcoef[6 * S + e];
  }
  const long long smem = thin_smem<S, kResident>(lw);
  static int opted[64] = {};
  const int rc = opt_in(bcjr_kernel_thin<S, kResident>, smem, opted);
  if (rc) return rc;
  const long long blocks = (ncols + 31) / 32;
  bcjr_kernel_thin<S, kResident><<<static_cast<unsigned>(blocks), 64,
                                   static_cast<size_t>(smem), stream>>>(ls, lp, llr, hist, lw,
                                                                        ncols, tb);
  return static_cast<int>(cudaGetLastError());
}

template <int S>
int launch_thin(const float* ls, const float* lp, float* llr, float* hist, int lw,
                long long ncols, const int* hidx, const float* hcoef, cudaStream_t stream) {
  return thin_smem<S, true>(lw) <= kMaxSmem
             ? launch_thin<S, true>(ls, lp, llr, hist, lw, ncols, hidx, hcoef, stream)
             : launch_thin<S, false>(ls, lp, llr, hist, lw, ncols, hidx, hcoef, stream);
}

// The block instance's route at S states (ops/cuda/bcjr.py block_layout
// mirrors it): S 2-3 thin; 4-32 a state a lane, L the power of two >= S;
// 33-256 one warp a direction, R the power of two >= S / 32; 257-1,024 W =
// ceil(S / 256) warps a direction of 8 states a lane; past that, with
// place kPlaceShared, the shared route (bcjr_kernel_block's kShared: one CTA
// a column of cw = 8 warps a direction of cr = 8 states a lane, to 2,048
// states), else the cluster route in the
// geometry the caller gives (q, R, W, place, rl: block_layout's; xg its
// exchange in the global placement, else null).
int launch_block_route(const float* ls, const float* lp, float* llr, float* hist, float* xg,
                       int lw, long long ncols, int S, int q, int cr, int cw, int place, int rl,
                       const int* idx, const float* coef, const int* hidx, const float* hcoef,
                       cudaStream_t stream) {
  const auto a = std::make_tuple(ls, lp, llr, hist, lw, ncols, S, idx, coef, stream);
  auto go = [&](auto f) { return std::apply(f, a); };
  if (place == kPlaceShared) {
    if (S <= kBlockStates || S > 32 * cr * cw || cr != 8 || cw != 8)
      return static_cast<int>(cudaErrorInvalidValue);
    return go(launch_block<8, 32, 8, true>);
  }
  if (S == 2) return launch_thin<2>(ls, lp, llr, hist, lw, ncols, hidx, hcoef, stream);
  if (S == 3) return launch_thin<3>(ls, lp, llr, hist, lw, ncols, hidx, hcoef, stream);
  if (S <= 4) return go(launch_block<1, 4, 1>);
  if (S <= 8) return go(launch_block<1, 8, 1>);
  if (S <= 16) return go(launch_block<1, 16, 1>);
  if (S <= 32) return go(launch_block<1, 32, 1>);
  if (S <= 64) return go(launch_block<2, 32, 1>);
  if (S <= 128) return go(launch_block<4, 32, 1>);
  if (S <= 256) return go(launch_block<8, 32, 1>);
  if (S <= 512) return go(launch_block<8, 32, 2>);
  if (S <= 768) return go(launch_block<8, 32, 3>);
  if (S <= kBlockStates) return go(launch_block<8, 32, 4>);
  return launch_cluster_route(ls, lp, llr, hist, xg, lw, ncols, S, q, cr, cw, place, rl, idx,
                              coef, stream);
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

// bcjr_block_launch, the block instance, for any state count and span. ls,
// lp, llr float32 [lw, ncols], contiguous, lw >= 1, 1 <= ncols < 2^31,
// s_count >= 2; idx int32 [nxt; prev_s] (2 x s_count x 2 entries, each in
// [0, s_count)) and coef float32 [fw0; fw1; bw0; bw1] (4 x s_count x 2),
// both on the card, and hidx, hcoef the same tables on the host (the thin
// route's parameters); hist on the card, float32: [lw][s_count][ncols] at
// s_count 2-3 past thin_smem's span (else unused), [ceil(ncols / G)][lw][G
// P] to 1,024 states (block_layout's G and P), [ncols][lw][P] past that,
// where q, cr, cw, place and rl are the cluster geometry (bcjr.py
// cluster_layout)
// (P = q x 32 cw x (cr, or rl in the global placement)); xg
// float32 [ncols][2][2][P] on the card in the global placement, else null.
extern "C" int bcjr_block_launch(const void* ls, const void* lp, void* llr, void* hist, void* xg,
                                 int lw, long long ncols, int s_count, int q, int cr, int cw,
                                 int place, int rl, const void* idx, const void* coef,
                                 const int* hidx, const float* hcoef, int device, void* stream) {
  if (lw < 1 || ncols < 1 || ncols > 0x7fffffffLL || s_count < 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_device(device, [&] {
    return launch_block_route(static_cast<const float*>(ls), static_cast<const float*>(lp),
                              static_cast<float*>(llr), static_cast<float*>(hist),
                              static_cast<float*>(xg), lw, ncols, s_count, q, cr, cw, place, rl,
                              static_cast<const int*>(idx), static_cast<const float*>(coef),
                              hidx, hcoef, s);
  });
}
