// Batched hard-decision Viterbi for Hopper (sm_90a): one warp per trellis.
//
// Replaces the TPU kernel aether_primitives_tpu/ops/pallas/viterbi.py:
// _viterbi_kernel (wrapper viterbi_lanes), and is bit-identical to the JAX
// package's Viterbi scans (ops/fec.py viterbi_decode, _viterbi_windowed).
// Each trellis is one row of LLR spans sym [N, Lw, n]; per step t:
//   branch    g(s', j) = sum_m o_m(s', j) * llr_m[t], m left to right, with
//             o in {0, 1} the encoder output of the transition into s' from
//             predecessor (s' >> 1) | (j << (K-2))
//   ACS       c_j = pm[pred_j] + g(s', j); decision c1 < c0 (strict);
//             pm'[s'] = min(c0, c1); pm' -= min over states (every step)
// then a traceback from state 0 (terminated full block) or from the first
// argmin of the final metrics, writing bit t = (state after step t) & 1 as
// uint8 bits [N, Lw]. Initial metrics are 0 / 1e9 (state-0 start) or all
// zero (windowed spans). Every add and multiply is __fadd_rn / __fmul_rn and
// the file is built without fast math, so no contraction can round
// differently from the plain PyTorch version.
//
// What bounds it on an H100: the serial chain. At the burst path's shape
// (256 trellises of 638 steps, 64 states, rate 1/2) the arithmetic is about
// 0.1 G FP32 operations and the traffic 1.5 MB, both about a microsecond;
// the time is 638 dependent ACS steps and a 638-step traceback. What the
// design does about it: the chain of a step holds the ACS and nothing else.
//   - The LLRs come through a ring in registers: lane i holds step 32c + i
//     of chunk c, the current chunk and the next one; the chunk after that
//     is loaded (coalesced, __ldg) when the next one becomes current, 32
//     steps before its first use, and a step's LLRs reach every lane by
//     __shfl_sync. Shared memory holds the decisions alone, max(1, S/32)
//     words a step. Where one trellis's history does not fit a block's
//     shared memory (past 29,056 steps at 64 states), the scratch instance
//     keeps it in a device scratch the wrapper allocates (one history a
//     trellis, in global memory, L2-resident while it is read back); the
//     ACS, the tie-break and the traceback are the same code, the
//     traceback reading 32 steps' words ahead instead of 8.
//   - Step t+1's branch metrics (they do not depend on the path metrics)
//     are computed while step t's ACS runs, from 0/1 encoder outputs held
//     per lane as floats, with the generator count fixed at compile time
//     for rate 1/2 and 1/3 (at run time, up to 8, otherwise).
//   - Path metrics stay in registers (S / 32 states a lane, S >= 32;
//     replicated below); the predecessors come by __shfl_sync; the minimum
//     over the states is one __reduce_min_sync (redux.sync) on
//     order-preserving uint32 keys of the floats. The minimum is exact in
//     any order, and no candidate pm + g is ever -0 (a path metric x - min
//     is never -0), so the keys order the candidates as the floats do and
//     the decisions are the twin's.
//   - One trellis a warp (benches/torch_viterbi_sweep.py also times two a
//     warp, two chains interleaved in one instruction stream, from its own
//     source).
//   - The traceback (lane 0) loads the decision words of 8 steps (one
//     64-bit load a step at 64 states) before it walks them, so most of a
//     step's chain is register arithmetic; bit t goes to the first byte of
//     step t's words once they are read, and the bits leave as coalesced
//     stores of the whole warp.
//
// The block instance takes every code the warp instance does not: more
// than 256 states (K >= 10) or more than 8 generators. Two routes:
//   - cluster (viterbi_cta_kernel, up to 131,072 states, K <= 18): one CTA
//     a trellis, or a thread-block cluster of 2-8 where trellises are fewer
//     than the SMs or the metrics outgrow one CTA; the metrics in shared
//     memory split by state range over the cluster, a thread a pair of
//     states, the branch metrics once a step per output pattern, one
//     barrier a step, the decisions in shared memory where they fit, a
//     warp's traceback five steps a round. See its section below;
//   - scratch (viterbi_block_kernel, past that, or where a CTA's two chunks
//     of LLRs of many generators outgrow its shared memory, block_plan
//     None): one CTA of 256 threads a
//     trellis, state s' and s' + 256, ... a thread, the path metrics in two
//     buffers of S floats in the device scratch and the decisions there as
//     ballot words (S / 32 a step), thread 0 walking the traceback. A
//     buffer holds the step's metrics before the subtraction of their
//     minimum, and the next step subtracts it as it reads them, so every
//     value is the twin's; its limit is the card's memory. It was written
//     for reach, not speed: the metrics cross device memory every step.
// The scratch route's branch metric reads each generator's output from S x 2
// rows of ceil(n / 32) mask words on the card (any n).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kMaxN = 8;        // generators per code
constexpr int kMaxStates = 256; // 2^(K-1), K <= 9 (the warp instance)
constexpr int kBlockThreads = 256;  // the block instance's CTA
constexpr int kAhead = 8;       // traceback steps whose words load together (shared)
constexpr int kAheadScratch = 32;  // ... from the device scratch
constexpr unsigned kFull = 0xffffffffu;

// out_mask[2 * s' + j]: bit m is o_m of the transition into s' from
// predecessor j (the JAX package's _trellis outs table).
struct Masks {
  unsigned char m[2 * kMaxStates];
};

// g = sum_m o_m * l_m, m left to right, o_m in {0.0f, 1.0f} held per lane.
template <int NM>
__device__ __forceinline__ float branch(const float* o, const float* l, int n) {
  float g = __fmul_rn(o[0], l[0]);
#pragma unroll
  for (int m = 1; m < NM; ++m) {
    if (m < n) g = __fadd_rn(g, __fmul_rn(o[m], l[m]));
  }
  return g;
}

// Order-preserving uint32 key of a float (no NaN), and back.
__device__ __forceinline__ unsigned fkey(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float unkey(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// Chunk c of the LLR ring: lane i's registers take step 32c + i's n values
// (zeros past the span).
template <int NT, int NM>
__device__ __forceinline__ void load_chunk(const float* __restrict__ y, int lw, int n, int c,
                                           int lane, float* r) {
  const int t = 32 * c + lane;
#pragma unroll
  for (int m = 0; m < NM; ++m) {
    r[m] = (t < lw && (NT != 0 || m < n)) ? __ldg(y + static_cast<long long>(t) * n + m)
                                          : 0.0f;
  }
}

// The LLRs of step t (from the lane that holds it in chunk register r) and
// the branch metrics of each of this lane's states.
template <int kSpl, int NT, int NM>
__device__ __forceinline__ void branches(const float* r, int t, int n, float (*o0)[NM],
                                         float (*o1)[NM], float* g0, float* g1) {
  float l[NM];
#pragma unroll
  for (int m = 0; m < NM; ++m) l[m] = __shfl_sync(kFull, r[m], t & 31);
#pragma unroll
  for (int j = 0; j < kSpl; ++j) {
    g0[j] = branch<NM>(o0[j], l, NT != 0 ? NT : n);
    g1[j] = branch<NM>(o1[j], l, NT != 0 ? NT : n);
  }
}

// NT: the code's generators n when 2 or 3 (compile time), else 0 (n at run
// time, at most kMaxN). kScratch: the decision histories live in `scratch`
// ([n_trellis, lw, max(1, S/32)] words) instead of shared memory.
template <int S, int NT, bool kScratch>
__global__ void viterbi_kernel(const float* __restrict__ sym,
                               unsigned char* __restrict__ bits,
                               long long n_trellis, int lw, int n,
                               int init_state0, int end_state0, Masks masks,
                               unsigned* __restrict__ scratch) {
  constexpr int kSpl = S >= 32 ? S / 32 : 1;  // states (and words) per lane/step
  constexpr int NM = NT != 0 ? NT : kMaxN;    // LLRs a step, at most
  extern __shared__ unsigned int smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long tr = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (tr >= n_trellis) return;  // whole warps only: nothing below syncs the block
  unsigned* dec;
  if constexpr (kScratch) {
    dec = scratch + tr * lw * kSpl;
  } else {
    dec = smem + static_cast<size_t>(warp) * lw * kSpl;
  }
  const float* y = sym + tr * static_cast<long long>(lw) * n;

  float cur[NM], nxt[NM];  // the LLR ring: chunks c and c + 1
  load_chunk<NT, NM>(y, lw, n, 0, lane, cur);
  load_chunk<NT, NM>(y, lw, n, 1, lane, nxt);

  int st[kSpl];
  float o0[kSpl][NM], o1[kSpl][NM];  // the encoder outputs as 0.0f / 1.0f
  float pm[kSpl];
#pragma unroll
  for (int j = 0; j < kSpl; ++j) {
    st[j] = S >= 32 ? lane + 32 * j : lane % S;
#pragma unroll
    for (int m = 0; m < NM; ++m) {
      o0[j][m] = (masks.m[2 * st[j]] >> m) & 1u ? 1.0f : 0.0f;
      o1[j][m] = (masks.m[2 * st[j] + 1] >> m) & 1u ? 1.0f : 0.0f;
    }
    pm[j] = init_state0 ? (st[j] == 0 ? 0.0f : 1e9f) : 0.0f;
  }

  float g0[kSpl], g1[kSpl];
  branches<kSpl, NT, NM>(cur, 0, n, o0, o1, g0, g1);

  for (int t = 0; t < lw; ++t) {
    // step t+1's branch metrics, off the chain; at a chunk's end the next
    // chunk becomes current and the one after it starts to load
    const int tn = t + 1;
    if ((tn & 31) == 0) {  // the same for the whole warp
#pragma unroll
      for (int m = 0; m < NM; ++m) cur[m] = nxt[m];
      load_chunk<NT, NM>(y, lw, n, (tn >> 5) + 1, lane, nxt);
    }
    float h0[kSpl], h1[kSpl];
    branches<kSpl, NT, NM>(cur, tn, n, o0, o1, h0, h1);
    float nw[kSpl];
#pragma unroll
    for (int j = 0; j < kSpl; ++j) {
      float a0, a1;
      if constexpr (S >= 64) {
        // pred0 = s' >> 1 sits at lane (lane >> 1) + 16 (j & 1), slot j >> 1;
        // pred1 = pred0 + S/2 at the same lane, slot (j >> 1) + kSpl / 2
        const int src = (lane >> 1) + 16 * (j & 1);
        a0 = __shfl_sync(kFull, pm[j >> 1], src);
        a1 = __shfl_sync(kFull, pm[(j >> 1) + kSpl / 2], src);
      } else {
        const int p0 = st[0] >> 1;
        a0 = __shfl_sync(kFull, pm[0], p0);
        a1 = __shfl_sync(kFull, pm[0], p0 + S / 2);
      }
      const float c0 = __fadd_rn(a0, g0[j]);
      const float c1 = __fadd_rn(a1, g1[j]);
      const bool d = c1 < c0;
      nw[j] = d ? c1 : c0;
      const unsigned word = __ballot_sync(kFull, d);
      if (lane == j) dec[t * kSpl + j] = word;
    }
    float mn = nw[0];
#pragma unroll
    for (int j = 1; j < kSpl; ++j) mn = fminf(mn, nw[j]);
    mn = unkey(__reduce_min_sync(kFull, fkey(mn)));
#pragma unroll
    for (int j = 0; j < kSpl; ++j) {
      pm[j] = __fsub_rn(nw[j], mn);
      g0[j] = h0[j];
      g1[j] = h1[j];
    }
  }

  // ---- traceback (lane 0) ---------------------------------------------------
  int state = 0;
  if (!end_state0) {  // first argmin of the final metrics
    float mn = pm[0];
#pragma unroll
    for (int j = 1; j < kSpl; ++j) mn = fminf(mn, pm[j]);
    mn = unkey(__reduce_min_sync(kFull, fkey(mn)));
    unsigned best = S;
#pragma unroll
    for (int j = kSpl - 1; j >= 0; --j) {
      if (pm[j] == mn && static_cast<unsigned>(st[j]) < best) best = st[j];
    }
    state = static_cast<int>(__reduce_min_sync(kFull, best));
  }
  __syncwarp();
  unsigned char* out = reinterpret_cast<unsigned char*>(dec);  // bit t: step t's first byte
  if (lane == 0) {
    if constexpr (kSpl <= 2) {
      constexpr int kA = kScratch ? kAheadScratch : kAhead;
      int t = lw - 1;
      for (; t >= kA - 1; t -= kA) {
        uint2 w[kA];
#pragma unroll
        for (int i = 0; i < kA; ++i) {
          const unsigned* p = dec + (t - i) * kSpl;
          if constexpr (kSpl == 2) {
            w[i] = *reinterpret_cast<const uint2*>(p);
          } else {
            w[i] = make_uint2(*p, 0u);
          }
        }
#pragma unroll
        for (int i = 0; i < kA; ++i) {
          out[(t - i) * kSpl * 4] = static_cast<unsigned char>(state & 1);
          const unsigned word = (kSpl == 2 && (state >> 5)) ? w[i].y : w[i].x;
          state = (state >> 1) | (((word >> (state & 31)) & 1u) ? S / 2 : 0);
        }
      }
      for (; t >= 0; --t) {
        const unsigned* p = dec + t * kSpl;
        const unsigned word = (kSpl == 2 && (state >> 5)) ? p[1] : p[0];
        out[t * kSpl * 4] = static_cast<unsigned char>(state & 1);
        state = (state >> 1) | (((word >> (state & 31)) & 1u) ? S / 2 : 0);
      }
    } else {
      for (int t = lw - 1; t >= 0; --t) {
        const unsigned word = dec[t * kSpl + (state >> 5)];
        out[t * kSpl * 4] = static_cast<unsigned char>(state & 1);
        state = (state >> 1) | (((word >> (state & 31)) & 1u) ? S / 2 : 0);
      }
    }
  }
  __syncwarp();
  unsigned char* dst = bits + tr * static_cast<long long>(lw);
  for (int t = lane; t < lw; t += 32) dst[t] = out[t * kSpl * 4];
}

// ---- the block instance's scratch route -------------------------------------

// g = sum_m o_m * l_m, m left to right, o_m bit m of the transition's words.
__device__ __forceinline__ float branch_words(const unsigned* __restrict__ w,
                                              const float* __restrict__ l, int n) {
  float g = __fmul_rn((__ldg(w) & 1u) ? 1.0f : 0.0f, __ldg(l));
  for (int m = 1; m < n; ++m) {
    const float o = ((__ldg(w + (m >> 5)) >> (m & 31)) & 1u) ? 1.0f : 0.0f;
    g = __fadd_rn(g, __fmul_rn(o, __ldg(l + m)));
  }
  return g;
}

// One CTA a trellis (blockIdx.x). masks: [2 S][mw] words on the card, bit m
// of row 2 s' + j the output o_m of the transition into s' from predecessor
// j; dec: the trellis's [lw][max(1, S/32)] decision words; pm_scratch: two
// buffers of S floats a trellis, or null for shared memory.
__global__ void __launch_bounds__(kBlockThreads)
viterbi_block_kernel(const float* __restrict__ sym, unsigned char* __restrict__ bits,
                     int lw, int n, int s_count, int init_state0, int end_state0,
                     const unsigned* __restrict__ masks, int mw,
                     unsigned* dec_scratch, float* pm_scratch) {
  extern __shared__ float smf[];
  __shared__ unsigned red[2][kBlockThreads / 32];
  __shared__ int first;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const long long tr = blockIdx.x;
  const int S = s_count;
  const int words = S >= 32 ? S / 32 : 1;
  float* pa = pm_scratch != nullptr ? pm_scratch + tr * 2 * S : smf;
  float* pb = pa + S;
  unsigned* dec = dec_scratch + tr * lw * words;
  const float* y = sym + tr * static_cast<long long>(lw) * n;

  for (int s = tid; s < S; s += kBlockThreads) {
    pa[s] = init_state0 ? (s == 0 ? 0.0f : 1e9f) : 0.0f;
  }
  float mn = 0.0f;  // the minimum of pa (pm = pa - mn); 0 before the first step
  __syncthreads();
  for (int t = 0; t < lw; ++t) {
    const float* l = y + static_cast<long long>(t) * n;
    unsigned kmin = 0xffffffffu;
    for (int base = 0; base < S; base += kBlockThreads) {
      const int s = base + tid;
      bool d = false;
      if (s < S) {
        const int p0 = s >> 1;
        const float c0 = __fadd_rn(__fsub_rn(pa[p0], mn),
                                   branch_words(masks + static_cast<long long>(2 * s) * mw, l, n));
        const float c1 = __fadd_rn(__fsub_rn(pa[p0 + S / 2], mn),
                                   branch_words(masks + static_cast<long long>(2 * s + 1) * mw,
                                                l, n));
        d = c1 < c0;
        const float nw = d ? c1 : c0;
        pb[s] = nw;
        kmin = min(kmin, fkey(nw));
      }
      const unsigned word = __ballot_sync(kFull, d);
      if (lane == 0 && base + 32 * warp < S) {
        dec[static_cast<long long>(t) * words + (base >> 5) + warp] = word;
      }
    }
    kmin = __reduce_min_sync(kFull, kmin);
    if (lane == 0) red[t & 1][warp] = kmin;
    __syncthreads();  // pb and the warps' minima written; pa read by all
    kmin = red[t & 1][0];
#pragma unroll
    for (int w = 1; w < kBlockThreads / 32; ++w) kmin = min(kmin, red[t & 1][w]);
    mn = unkey(kmin);
    float* tmp = pa;
    pa = pb;
    pb = tmp;
  }

  // ---- traceback (thread 0) from state 0 or the first argmin: the first s
  // whose metric pa[s] - mn is the minimum's, 0, i.e. pa[s] == mn
  if (tid == 0) first = S;
  __syncthreads();
  if (!end_state0) {
    for (int s = tid; s < S; s += kBlockThreads) {
      if (pa[s] == mn) {
        atomicMin(&first, s);
        break;
      }
    }
  }
  __syncthreads();
  if (tid == 0) {
    int state = end_state0 ? 0 : first;
    unsigned char* out = bits + tr * static_cast<long long>(lw);
    for (int t = lw - 1; t >= 0; --t) {
      out[t] = static_cast<unsigned char>(state & 1);
      const unsigned word = dec[static_cast<long long>(t) * words + (state >> 5)];
      state = (state >> 1) | (((word >> (state & 31)) & 1u) ? S / 2 : 0);
    }
  }
}

// ---- the block instance's cluster route ------------------------------------
//
// One CTA, or a thread-block cluster of q CTAs, a trellis (blockIdx.x / q;
// the states split by range over the cluster's CTAs, S / q each). A thread
// takes pairs of states (2i, 2i + 1), which share their predecessors i and
// i + S/2: one load of each a pair, from the shared memory of the CTA that
// holds them (distributed shared memory in a cluster). A step:
//   - the branch metrics: one per distinct output pattern of the code (at
//     most 256; the host maps each transition to its pattern, a byte, four
//     a pair of states held in registers), computed for the next step while
//     this one runs, from the LLRs that cp.async stages 32 steps at a time a
//     chunk ahead; past 256 patterns, each transition's from its mask words.
//     Either is sum_m o_m l_m left to right (__fmul_rn, __fadd_rn): the
//     twin's floats;
//   - the ACS of the CTA's states into the other of two metric buffers
//     (the metrics before the subtraction of their minimum, which the next
//     step subtracts as it reads them, as the scratch route does);
//   - the decisions as ballot words (even and odd states interleaved), in
//     shared memory where a trellis's history fits, else the device scratch;
//   - the minimum: a redux.sync a warp, each warp's pushed to every CTA of
//     the cluster, one barrier (cluster.sync() in a cluster) a step.
// The traceback is one warp of rank 0: it loads the words of the 31
// candidate states of the next five steps at once (2^j candidates j steps
// back) and resolves them in order by shuffles. Bit-identical to the twin:
// the tie-break c1 < c0, order-preserving keys for the minimum, the first
// argmin of an unterminated span. What bounds it on an H100: the step chain,
// a barrier and a minimum over the states every step (the operations, n
// FMAs a distinct output pattern and 6 a state a step, take microseconds:
// PERF.md §6 row 4).

constexpr int kCtaMaxThreads = 512;
constexpr int kPairIters = 16;   // pairs a thread at most (S / q / 2 <= 16 x 512)
constexpr int kMaxPatterns = 256;
constexpr int kLlrChunk = 32;    // steps of LLRs staged at once
constexpr int kTraceAhead = 5;   // steps a traceback round resolves (31 candidate words)

__device__ __forceinline__ unsigned spread16(unsigned x) {  // bit i to bit 2 i
  x = (x | (x << 8)) & 0x00ff00ffu;
  x = (x | (x << 4)) & 0x0f0f0f0fu;
  x = (x | (x << 2)) & 0x33333333u;
  return (x | (x << 1)) & 0x55555555u;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// kCluster: q > 1 (a cluster launch); kTable: at most kMaxPatterns patterns;
// kIters: pairs a thread (S / q / 2 = kIters x threads, or fewer pairs than
// threads at 1). codes: kTable, the pattern byte of each transition row
// (uint8 [2 S]) then the patterns' output bits (uint32 [npat][mw]); else the
// rows' output bits (uint32 [2 S][mw]).
template <bool kCluster, bool kTable, int kIters>
__global__ void __launch_bounds__(kCtaMaxThreads, 1)
viterbi_cta_kernel(const float* __restrict__ sym, unsigned char* __restrict__ bits, int lw,
                   int n, int s_count, int init_state0, int end_state0,
                   const unsigned* __restrict__ codes, int npat, int mw, int q, int dec_smem,
                   unsigned* __restrict__ dec_scratch) {
  extern __shared__ __align__(16) float smv[];
  __shared__ int first;
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int threads = blockDim.x, warps = threads >> 5;
  const int S = s_count, K2 = __ffs(S) - 2;  // K - 2
  const int sc = S / q, pc = sc / 2;          // states and pairs a CTA
  const int rank = kCluster ? static_cast<int>(cluster.block_rank()) : 0;
  const long long tr = blockIdx.x / q;
  const int words = S >= 32 ? S / 32 : 1, wc = sc >= 32 ? sc / 32 : 1;
  // shared memory: two metric buffers, the decisions, the branch metrics,
  // the LLR chunks, the minima
  float* buf0 = smv;
  float* buf1 = smv + sc;
  unsigned* dec_s = reinterpret_cast<unsigned*>(smv + 2 * sc);
  float* gm = smv + 2 * sc + (dec_smem ? lw * wc : 0);  // [2][kMaxPatterns]
  float* llr = gm + 2 * kMaxPatterns;                    // [2][kLlrChunk][n]
  unsigned* red = reinterpret_cast<unsigned*>(llr + 2 * kLlrChunk * n);  // [2][q warps]
  const float* y = sym + tr * static_cast<long long>(lw) * n;

  // the predecessors of the CTA's pairs: i (owner g0 / sc) and i + S/2
  const int g0 = rank * pc, g1 = rank * pc + S / 2;
  auto remote = [&](float* b, int owner) -> const float* {
    if constexpr (kCluster) return cluster.map_shared_rank(b, owner);
    return b;
  };
  const float* lo0 = remote(buf0, g0 / sc) + g0 % sc;
  const float* lo1 = remote(buf1, g0 / sc) + g0 % sc;
  const float* hi0 = remote(buf0, g1 / sc) + g1 % sc;
  const float* hi1 = remote(buf1, g1 / sc) + g1 % sc;

  auto stage = [&](int c) {  // the LLRs of steps 32 c .. into chunk slot c & 1
    const int steps = min(kLlrChunk, lw - kLlrChunk * c);
    float* d = llr + (c & 1) * kLlrChunk * n;
    const float* src = y + static_cast<long long>(kLlrChunk) * c * n;
    for (int e = tid; e < steps * n; e += threads) cp_async4(d + e, src + e);
    cp_async_commit();
  };
  // sum_m o_m l_m of the output bits w (mw words), m left to right
  auto branch = [&](const unsigned* w, const float* l) -> float {
    unsigned word = w[0];
    float g = __fmul_rn((word & 1u) ? 1.0f : 0.0f, l[0]);
    for (int m = 1; m < n; ++m) {
      if ((m & 31) == 0) word = w[m >> 5];
      g = __fadd_rn(g, __fmul_rn(((word >> (m & 31)) & 1u) ? 1.0f : 0.0f, l[m]));
    }
    return g;
  };
  const unsigned char* pid = reinterpret_cast<const unsigned char*>(codes);
  const unsigned* pbits = codes + (2 * S + 3) / 4;  // the patterns' bits after the bytes
  // a thread's pattern (tid < npat <= threads) and its output bits, held
  // where they are one word
  const unsigned pword = kTable && tid < npat ? __ldg(pbits + tid * mw) : 0u;
  auto metrics = [&](int t) {  // the patterns' metrics of step t into gm[t & 1]
    if constexpr (kTable) {
      if (tid < npat) {
        const float* l = llr + ((t / kLlrChunk) & 1) * kLlrChunk * n + (t % kLlrChunk) * n;
        gm[(t & 1) * kMaxPatterns + tid] = mw == 1 ? branch(&pword, l) : branch(pbits + tid * mw, l);
      }
    }
  };

  // the pattern bytes of the thread's pairs (rows 4 i .. 4 i + 3), held
  unsigned mk[kIters];
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int u = it * threads + tid;
    mk[it] = kTable && u < pc ? __ldg(reinterpret_cast<const unsigned*>(pid) + g0 + u) : 0u;
  }
  if (tid == 0) first = S;
  for (int u = tid; u < sc; u += threads) {
    buf0[u] = init_state0 ? (rank * sc + u == 0 ? 0.0f : 1e9f) : 0.0f;
  }
  stage(0);
  cp_async_wait_group<0>();
  __syncthreads();
  metrics(0);
  if constexpr (kCluster) {
    cluster.sync();  // every CTA's metrics are set before one reads them
  } else {
    __syncthreads();
  }

  float mn = 0.0f;  // the minimum of the buffer the step reads
  for (int t = 0; t < lw; ++t) {
    const int rd = t & 1;
    // the next chunk's LLRs load 32 steps ahead of their first use; they are
    // waited for two steps before it, so a barrier publishes them
    if (t % kLlrChunk == 0 && t + kLlrChunk < lw) stage(t / kLlrChunk + 1);
    if (t + 1 < lw) metrics(t + 1);
    const float* bd = gm + rd * kMaxPatterns;
    const float* lt = llr + ((t / kLlrChunk) & 1) * kLlrChunk * n + (t % kLlrChunk) * n;
    const float* plo = rd ? lo1 : lo0;
    const float* phi = rd ? hi1 : hi0;
    float* out = rd ? buf0 : buf1;
    unsigned kmin = 0xffffffffu;
    // the predecessors of kPre pairs at a time, loaded before their ACS (the
    // fastest group at each width: at 16 pairs a thread more spill registers)
    constexpr int kPre = kIters < 8 ? kIters : (kIters >= 16 ? 2 : 8);
#pragma unroll
    for (int g = 0; g < kIters; g += kPre) {
      float pa0[kPre], pa1[kPre];
#pragma unroll
      for (int j = 0; j < kPre; ++j) {
        const int u = (g + j) * threads + tid;
        if (u < pc) {
          pa0[j] = plo[u];
          pa1[j] = phi[u];
        }
      }
#pragma unroll
      for (int j = 0; j < kPre; ++j) {
        const int it = g + j;
        const int base = it * threads;
        const int u = base + tid;
        bool de = false, dodd = false;
        if (u < pc) {
          const int i = g0 + u;  // the pair's states 2i, 2i + 1
          const float a0 = __fsub_rn(pa0[j], mn), a1 = __fsub_rn(pa1[j], mn);
          float m0e, m1e, m0o, m1o;  // rows 4 i .. 4 i + 3
          if constexpr (kTable) {
            m0e = bd[mk[it] & 255u];
            m1e = bd[(mk[it] >> 8) & 255u];
            m0o = bd[(mk[it] >> 16) & 255u];
            m1o = bd[mk[it] >> 24];
          } else {
            const unsigned* w = codes + static_cast<long long>(4 * i) * mw;
            m0e = branch(w, lt);
            m1e = branch(w + mw, lt);
            m0o = branch(w + 2 * mw, lt);
            m1o = branch(w + 3 * mw, lt);
          }
          const float c0e = __fadd_rn(a0, m0e), c1e = __fadd_rn(a1, m1e);
          const float c0o = __fadd_rn(a0, m0o), c1o = __fadd_rn(a1, m1o);
          de = c1e < c0e;
          dodd = c1o < c0o;
          const float ne = de ? c1e : c0e, no = dodd ? c1o : c0o;
          reinterpret_cast<float2*>(out)[u] = make_float2(ne, no);
          kmin = min(kmin, min(fkey(ne), fkey(no)));
        }
        const unsigned e = __ballot_sync(kFull, de), o = __ballot_sync(kFull, dodd);
        // lane 0: the word of the warp's first 16 pairs, lane 1 of the next 16
        if (lane < 2 && base + 32 * warp + 16 * lane < pc) {
          const int w = (g0 + base + 32 * warp) / 16 + lane;  // states 32 w ..
          const unsigned half_e = lane == 0 ? e & 0xffffu : e >> 16;
          const unsigned half_o = lane == 0 ? o & 0xffffu : o >> 16;
          const unsigned word = spread16(half_e) | (spread16(half_o) << 1);
          if (dec_smem) {
            dec_s[t * wc + (w - rank * wc)] = word;
          } else {
            dec_scratch[(tr * lw + t) * words + w] = word;
          }
        }
      }
    }
    if (t % kLlrChunk == kLlrChunk - 2) cp_async_wait_group<0>();
    kmin = __reduce_min_sync(kFull, kmin);
    if constexpr (kCluster) {
      if (lane < q) cluster.map_shared_rank(red, lane)[rd * q * warps + rank * warps + warp] = kmin;
      cluster.sync();
    } else {
      if (lane == 0) red[rd * warps + warp] = kmin;
      __syncthreads();
    }
    unsigned m = 0xffffffffu;
    for (int i = lane; i < q * warps; i += 32) m = min(m, red[rd * q * warps + i]);
    mn = unkey(__reduce_min_sync(kFull, m));
  }

  // the start of the traceback: state 0, or the first argmin of the final
  // metrics (the first s whose buffered metric equals their minimum)
  const float* fin = (lw & 1) ? buf1 : buf0;
  if (!end_state0) {
    for (int u = tid; u < sc; u += threads) {
      if (fin[u] == mn) {
        atomicMin(&first, rank * sc + u);
        break;
      }
    }
  }
  __syncthreads();
  if constexpr (kCluster) {
    if (tid == 0 && rank != 0) atomicMin(cluster.map_shared_rank(&first, 0), first);
    cluster.sync();
  }
  if (rank == 0 && warp == 0) {
    auto word = [&](int t, int w) -> unsigned {
      if (dec_smem) {
        const int r = w / wc;
        const unsigned* d = dec_s;
        if constexpr (kCluster) d = cluster.map_shared_rank(dec_s, r);
        return d[t * wc + (w - r * wc)];
      }
      return __ldcg(dec_scratch + (tr * lw + t) * words + w);
    };
    unsigned char* ob = bits + tr * static_cast<long long>(lw);
    int s = end_state0 ? 0 : first;
    // lane l holds the candidate j = floor(log2(l + 1)) steps back whose
    // decisions on the way are the bits of l + 1 - 2^j (step t's the lowest)
    const int lj = 31 - __clz(lane + 1), lb = lane + 1 - (1 << lj);
    for (int t = lw - 1; t >= 0;) {
      const int steps = min(kTraceAhead, t + 1);
      unsigned wd = 0;
      if (lj < steps) {
        int st = s;
        for (int i = 0; i < lj; ++i) st = (st >> 1) | (((lb >> i) & 1) << K2);
        wd = word(t - lj, st >> 5);
      }
      int taken = 0;
      for (int j = 0; j < steps; ++j) {
        const unsigned w = __shfl_sync(kFull, wd, (1 << j) - 1 + taken);
        if (lane == 0) ob[t - j] = static_cast<unsigned char>(s & 1);
        const int b = (w >> (s & 31)) & 1;
        s = (s >> 1) | (b << K2);
        taken |= b << j;
      }
      t -= steps;
    }
  }
  if constexpr (kCluster) cluster.sync();  // rank 0 has read every CTA's decisions
}

template <bool kCluster, bool kTable, int kIters>
int launch_cta(const void* sym, void* bits, long long n_trellis, int lw, int n, int s_count,
               int init_state0, int end_state0, const void* codes, int npat, int mw, int q,
               int threads, int dec_smem, void* dec_scratch, size_t smem, cudaStream_t stream) {
  auto kernel = viterbi_cta_kernel<kCluster, kTable, kIters>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(n_trellis * q));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = q;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = kCluster ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const float*>(sym),
                           static_cast<unsigned char*>(bits), lw, n, s_count, init_state0,
                           end_state0, static_cast<const unsigned*>(codes), npat, mw, q, dec_smem,
                           static_cast<unsigned*>(dec_scratch));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The instance of a launch: q > 1, the pattern table, the pairs a thread.
template <bool kCluster, bool kTable>
int launch_cta_iters(int iters, const void* sym, void* bits, long long n_trellis, int lw, int n,
                     int s_count, int init_state0, int end_state0, const void* codes, int npat,
                     int mw, int q, int threads, int dec_smem, void* dec_scratch, size_t smem,
                     cudaStream_t s) {
  switch (iters) {
#define VITERBI_CTA_ITERS(I)                                                                      \
  case I:                                                                                         \
    return launch_cta<kCluster, kTable, I>(sym, bits, n_trellis, lw, n, s_count, init_state0,     \
                                           end_state0, codes, npat, mw, q, threads, dec_smem,     \
                                           dec_scratch, smem, s);
    VITERBI_CTA_ITERS(1)
    VITERBI_CTA_ITERS(2)
    VITERBI_CTA_ITERS(4)
    VITERBI_CTA_ITERS(8)
    VITERBI_CTA_ITERS(16)
#undef VITERBI_CTA_ITERS
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int S, int NT, bool kScratch>
int launch_kernel(const void* sym, void* bits, long long n_trellis, int lw, int n,
                  int init_state0, int end_state0, int warps, const Masks& masks,
                  void* scratch, cudaStream_t stream) {
  constexpr int kSpl = S >= 32 ? S / 32 : 1;
  const size_t smem =
      kScratch ? 0 : static_cast<size_t>(warps) * lw * kSpl * sizeof(unsigned int);
  cudaError_t err = cudaFuncSetAttribute(
      viterbi_kernel<S, NT, kScratch>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (n_trellis + warps - 1) / warps;
  viterbi_kernel<S, NT, kScratch><<<static_cast<unsigned>(blocks), 32 * warps, smem, stream>>>(
      static_cast<const float*>(sym), static_cast<unsigned char*>(bits), n_trellis,
      lw, n, init_state0, end_state0, masks, static_cast<unsigned*>(scratch));
  return static_cast<int>(cudaGetLastError());
}

template <int S, int NT>
int launch(const void* sym, void* bits, long long n_trellis, int lw, int n,
           int init_state0, int end_state0, int warps, const Masks& masks,
           void* scratch, cudaStream_t stream) {
  return scratch != nullptr
             ? launch_kernel<S, NT, true>(sym, bits, n_trellis, lw, n, init_state0,
                                          end_state0, warps, masks, scratch, stream)
             : launch_kernel<S, NT, false>(sym, bits, n_trellis, lw, n, init_state0,
                                           end_state0, warps, masks, nullptr, stream);
}

template <int S>
int launch_n(const void* sym, void* bits, long long n_trellis, int lw, int n,
             int init_state0, int end_state0, int warps, const Masks& masks, void* scratch,
             cudaStream_t s) {
  switch (n) {
    case 2: return launch<S, 2>(sym, bits, n_trellis, lw, n, init_state0, end_state0, warps,
                                masks, scratch, s);
    case 3: return launch<S, 3>(sym, bits, n_trellis, lw, n, init_state0, end_state0, warps,
                                masks, scratch, s);
    default: return launch<S, 0>(sym, bits, n_trellis, lw, n, init_state0, end_state0, warps,
                                 masks, scratch, s);
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. Returns the cudaError_t of the
// launch (0 = success). The caller guarantees: sym float32 [n_trellis, lw, n]
// and bits uint8 [n_trellis, lw], contiguous; s_count a power of two in
// [2, 256]; 1 <= n <= 8; out_mask a host array of 2 * s_count bytes;
// warps trellises a block (one a warp); scratch null and warps * lw *
// max(1, s_count / 32) * 4 bytes of shared memory within the card's per-block
// limit, or scratch a device buffer of n_trellis * lw * max(1, s_count / 32)
// uint32 words on the stream's card (the histories then take no shared memory).
// s_count 2 runs with lanes replicating its two states, as 4-16 do.
extern "C" int viterbi_launch(const void* sym, void* bits, long long n_trellis,
                              int lw, int n, int s_count, int init_state0,
                              int end_state0, int warps,
                              const unsigned char* out_mask, void* scratch, void* stream) {
  if (n < 1 || n > kMaxN || s_count > kMaxStates || warps < 1 || warps > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  Masks masks = {};
  for (int i = 0; i < 2 * s_count; ++i) masks.m[i] = out_mask[i];
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (s_count) {
    case 2:
      return launch_n<2>(sym, bits, n_trellis, lw, n, init_state0, end_state0,
                           warps, masks, scratch, s);
    case 4:
      return launch_n<4>(sym, bits, n_trellis, lw, n, init_state0, end_state0,
                           warps, masks, scratch, s);
    case 8:
      return launch_n<8>(sym, bits, n_trellis, lw, n, init_state0, end_state0,
                           warps, masks, scratch, s);
    case 16:
      return launch_n<16>(sym, bits, n_trellis, lw, n, init_state0, end_state0,
                            warps, masks, scratch, s);
    case 32:
      return launch_n<32>(sym, bits, n_trellis, lw, n, init_state0, end_state0,
                            warps, masks, scratch, s);
    case 64:
      return launch_n<64>(sym, bits, n_trellis, lw, n, init_state0, end_state0,
                            warps, masks, scratch, s);
    case 128:
      return launch_n<128>(sym, bits, n_trellis, lw, n, init_state0, end_state0,
                             warps, masks, scratch, s);
    case 256:
      return launch_n<256>(sym, bits, n_trellis, lw, n, init_state0, end_state0,
                             warps, masks, scratch, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Plain C entry point of the block instance (one CTA a trellis), loaded with
// ctypes. Returns the cudaError_t of the launch (0 = success). The caller
// guarantees: sym float32 [n_trellis, lw, n] and bits uint8 [n_trellis, lw],
// contiguous, 1 <= n_trellis < 2^31; s_count a power of two >= 2; masks the
// encoder outputs on the card, uint32 [2 s_count][mw], mw = ceil(n / 32);
// dec_scratch n_trellis * lw * max(1, s_count / 32) uint32 words on the card;
// pm_scratch n_trellis * 2 * s_count floats on the card, or null where
// 2 * s_count floats fit the card's opt-in shared memory.
extern "C" int viterbi_block_launch(const void* sym, void* bits, long long n_trellis, int lw,
                                    int n, int s_count, int init_state0, int end_state0,
                                    const void* masks, int mw, void* dec_scratch,
                                    void* pm_scratch, void* stream) {
  if (n < 1 || lw < 1 || s_count < 2 || (s_count & (s_count - 1)) || n_trellis < 1 ||
      n_trellis > 0x7fffffffLL || mw < (n + 31) / 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = pm_scratch != nullptr ? 0 : 2 * static_cast<size_t>(s_count) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(viterbi_block_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  viterbi_block_kernel<<<static_cast<unsigned>(n_trellis), kBlockThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sym), static_cast<unsigned char*>(bits), lw, n, s_count,
      init_state0, end_state0, static_cast<const unsigned*>(masks), mw,
      static_cast<unsigned*>(dec_scratch), static_cast<float*>(pm_scratch));
  return static_cast<int>(cudaGetLastError());
}

// Plain C entry point of the block instance's cluster route (one CTA, or a
// cluster of q CTAs, a trellis), loaded with ctypes. Returns the cudaError_t
// of the launch (0 = success). The caller guarantees: sym float32
// [n_trellis, lw, n] and bits uint8 [n_trellis, lw], contiguous; s_count a
// power of two >= 2; q 1, 2, 4 or 8, and s_count / q >= 64 where q > 1;
// threads a multiple of 32 up to 512, at least s_count / q / 32 and, with
// npat <= 256 patterns, at least npat; codes on the card as uint32 words: with
// npat <= 256, each transition row's pattern byte (uint8 [2 s_count],
// padded to whole words) then the patterns' output bits ([npat][mw]); else
// the rows' output bits ([2 s_count][mw]); mw = ceil(n / 32); dec_smem 1: the
// decisions in shared memory (lw max(1, s_count / q / 32) words a CTA),
// else dec_scratch n_trellis * lw * max(1, s_count / 32) uint32 words on
// the card; the shared memory (ops/cuda/viterbi.py _cta_smem) within the
// opt-in limit.
extern "C" int viterbi_cta_launch(const void* sym, void* bits, long long n_trellis, int lw,
                                  int n, int s_count, int init_state0, int end_state0,
                                  const void* codes, int npat, int mw, int q, int threads,
                                  int dec_smem, void* dec_scratch, void* stream) {
  const int sc = s_count / (q > 0 ? q : 1);
  if (n < 1 || lw < 1 || s_count < 2 || (s_count & (s_count - 1)) || n_trellis < 1 ||
      (q != 1 && q != 2 && q != 4 && q != 8) || (q > 1 && sc < 64) || threads < 32 ||
      threads > kCtaMaxThreads || threads % 32 || sc / 2 > kPairIters * threads ||
      mw < (n + 31) / 32 || n_trellis * q > 0x7fffffffLL || npat < 1 ||
      (npat <= kMaxPatterns && npat > threads) || (!dec_smem && dec_scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t floats = 2 * static_cast<size_t>(sc) +
                        (dec_smem ? static_cast<size_t>(lw) * (sc >= 32 ? sc / 32 : 1) : 0) +
                        2 * kMaxPatterns + 2 * static_cast<size_t>(kLlrChunk) * n +
                        2 * static_cast<size_t>(q) * (threads / 32);
  const size_t smem = floats * sizeof(float);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int iters = (sc / 2 + threads - 1) / threads;  // a power of two up to kPairIters
  if (npat <= kMaxPatterns) {
    return q > 1 ? launch_cta_iters<true, true>(iters, sym, bits, n_trellis, lw, n, s_count,
                                                init_state0, end_state0, codes, npat, mw, q,
                                                threads, dec_smem, dec_scratch, smem, s)
                 : launch_cta_iters<false, true>(iters, sym, bits, n_trellis, lw, n, s_count,
                                                 init_state0, end_state0, codes, npat, mw, q,
                                                 threads, dec_smem, dec_scratch, smem, s);
  }
  return q > 1 ? launch_cta_iters<true, false>(iters, sym, bits, n_trellis, lw, n, s_count,
                                               init_state0, end_state0, codes, npat, mw, q,
                                               threads, dec_smem, dec_scratch, smem, s)
               : launch_cta_iters<false, false>(iters, sym, bits, n_trellis, lw, n, s_count,
                                                init_state0, end_state0, codes, npat, mw, q,
                                                threads, dec_smem, dec_scratch, smem, s);
}
