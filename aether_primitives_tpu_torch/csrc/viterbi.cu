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
//   - grid (viterbi_grid_kernel, past that, or where a CTA's two chunks of
//     LLRs of many generators outgrow its shared memory, block_plan None):
//     one cooperative launch of the co-resident CTAs, the trellises' states
//     spread by range over all of them, the metrics in two buffers in the
//     device scratch (L2-resident), the branch metrics per output pattern
//     once a step a CTA, the decisions as ballot words in the scratch, one
//     grid barrier a step, a warp's traceback five steps a round. See its
//     section below; its limit is the card's memory.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kMaxN = 8;        // generators per code
constexpr int kMaxStates = 256; // 2^(K-1), K <= 9 (the warp instance)
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
//     step subtracts as it reads them, as the grid route does);
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

// ---- the block instance's grid route ----------------------------------------
//
// Every code the cluster route does not take (ops/cuda/viterbi.py block_plan
// None: past 131,072 states, or where a CTA's two chunks of LLRs of many
// generators outgrow its shared memory): one cooperative launch of
// co-resident CTAs (cg::this_grid(), cudaLaunchCooperativeKernel, the grid
// from the occupancy), the trellises' states spread by range over every CTA
// the card holds, not one CTA a trellis. The unit of the split is a
// decision word: min(S, 32) states of a trellis a step, U = min(S / 2, 16)
// pairs; a batch's T_u units go to the G CTAs in ragged ranges (CTA b takes
// [b T_u / G, (b + 1) T_u / G)), so a CTA may hold part of one trellis or
// several whole ones. A thread takes pairs of states (2i, 2i + 1), which
// share their predecessors i and i + S/2. A step:
//   - the ACS of the CTA's pairs from the last step's metric buffer: two
//     buffers of S floats a trellis in the device scratch (2 MB a K 19
//     trellis, L2-resident), holding the metrics before the subtraction of
//     their minimum, which the step subtracts as it reads them (__ldcg);
//   - the branch metrics by output pattern (patterns(): 4 at K 19 rate
//     1/2), once a step in each CTA for each of its trellises, into shared
//     memory, computed for the next step after this step's ACS; where the
//     CTA's trellises' patterns do not fit its table, or past 256 patterns,
//     each transition's from its pattern's (or its own) output bits;
//   - the decisions as ballot words (even and odd states interleaved, as
//     the cluster route) in the scratch;
//   - the minimum: a warp's redux.sync where its pairs are one trellis's (a
//     lane's key otherwise), the CTA's a trellis by shared atomics, one
//     global atomicMin a CTA and trellis into one of three rotating key
//     arrays (the next one reset a step ahead), one grid.sync(), then the
//     CTA reads its trellises' minima back.
// The traceback: a warp a trellis, five steps a round from 31 candidate
// words, as the cluster route. Trellises past a batch (GRID_BATCH) go in
// turn inside the launch, reusing the scratch. Bit-identical to the twin:
// (pa - mn) + g with __fsub_rn and __fadd_rn, the tie-break c1 < c0, the
// first argmin of an unterminated span. What bounds it on an H100: the
// chain of a grid barrier a step (measured with an empty kernel that makes
// the same barriers: chip_smoke.py phase 7) and, at full width, the metric
// buffers' L2 traffic (16 MB a step at 16 K 19 trellises).

constexpr int kGridThreads = 512;
constexpr int kGridTableBytes = 32768;  // a CTA's pattern metrics of two steps, at most

// g = sum_m o_m * l_m, m left to right, o_m bit m of the output bits w.
__device__ __forceinline__ float branch_bits(const unsigned* __restrict__ w,
                                             const float* __restrict__ l, int n) {
  unsigned word = __ldg(w);
  float g = __fmul_rn((word & 1u) ? 1.0f : 0.0f, __ldg(l));
  for (int m = 1; m < n; ++m) {
    if ((m & 31) == 0) word = __ldg(w + (m >> 5));
    g = __fadd_rn(g, __fmul_rn(((word >> (m & 31)) & 1u) ? 1.0f : 0.0f, __ldg(l + m)));
  }
  return g;
}

// kTable: the patterns' metrics in shared memory. codes as the cluster
// route's (pattern bytes then the patterns' bits where npat <= 256, else the
// rows' bits). Scratch, for cap = min(n_trellis, batch) trellises: dec
// [cap][lw][max(1, S/32)] words, pm two buffers [cap][S], keys three [cap],
// first [cap].
template <bool kTable>
__global__ void __launch_bounds__(kGridThreads, 2)
viterbi_grid_kernel(const float* __restrict__ sym, unsigned char* __restrict__ bits,
                    long long n_trellis, long long batch, int lw, int n, int s_count,
                    int init_state0, int end_state0, const unsigned* __restrict__ codes,
                    int npat, int mw, int slots_max, unsigned* __restrict__ dec,
                    float* __restrict__ pm, unsigned* __restrict__ keys,
                    int* __restrict__ first) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smg[];
  float* const mn_s = smg;                                                 // [slots_max]
  unsigned* const kmin_s = reinterpret_cast<unsigned*>(smg + slots_max);  // [slots_max]
  float* const gm = smg + 2 * slots_max;  // kTable: [2][slots_max][npat]
  const int tid = threadIdx.x, lane = tid & 31, threads = blockDim.x;
  const long long G = gridDim.x, gtid = blockIdx.x * static_cast<long long>(threads) + tid;
  const int S = s_count, P = S / 2, K2 = __ffs(S) - 2;
  const int ws = S >= 32 ? S / 32 : 1, wshift = __ffs(ws) - 1;  // decision words a step
  const int U = P < 16 ? P : 16, ushift = __ffs(U) - 1;        // pairs a word
  const unsigned umask = (1u << U) - 1u;
  const bool pat = npat <= kMaxPatterns;
  const unsigned* const pbits = codes + (2 * S + 3) / 4;  // the patterns' bits after the bytes
  const unsigned* const ids = codes;                      // rows 4 i .. 4 i + 3: word i
  // the output bits of transition row r (2 s' + j)
  auto row_bits = [&](int r) -> const unsigned* {
    if (pat) {
      const int id = (__ldg(ids + (r >> 2)) >> (8 * (r & 3))) & 255;
      return pbits + id * mw;
    }
    return codes + static_cast<long long>(r) * mw;
  };
  const long long cap = min(batch, n_trellis);  // the scratch's trellises
  float* const buf0 = pm;
  float* const buf1 = pm + cap * S;
  const int lj = 31 - __clz(lane + 1), lb = lane + 1 - (1 << lj);

  for (long long b0 = 0; b0 < n_trellis; b0 += batch) {
    const long long nb = min(batch, n_trellis - b0);
    const long long units = nb * ws;
    const long long u0 = blockIdx.x * units / G, u1 = (blockIdx.x + 1) * units / G;
    const long long tr_lo = u0 >> wshift;
    const int slots = u1 > u0 ? static_cast<int>(((u1 - 1) >> wshift) - tr_lo + 1) : 0;
    const long long pairs = (u1 - u0) << ushift;
    // the pattern metrics of step t for the CTA's trellises, into gm[t & 1]
    auto metrics = [&](int t) {
      float* const g = gm + (t & 1) * slots_max * npat;
      for (int e = tid; e < slots * npat; e += threads) {
        const int slot = e / npat, p = e - slot * npat;
        const float* l = sym + ((b0 + tr_lo + slot) * lw + t) * static_cast<long long>(n);
        g[e] = branch_bits(pbits + p * mw, l, n);
      }
    };
    // a batch's start: the keys and first argmins reset, the CTA's minima
    // zero, step 0's pattern metrics
    for (long long x = gtid; x < nb; x += G * threads) {
      keys[x] = keys[cap + x] = keys[2 * cap + x] = 0xffffffffu;
      first[x] = S;
    }
    for (int s = tid; s < slots; s += threads) {
      mn_s[s] = 0.0f;
      kmin_s[s] = 0xffffffffu;
    }
    if constexpr (kTable) metrics(0);
    grid.sync();

    float ahead0 = 0.0f, ahead1 = 0.0f;  // the step's first pair's metrics, loaded ahead
    for (int t = 0; t < lw; ++t) {
      const float* const pa = (t & 1) ? buf1 : buf0;
      float* const pb = (t & 1) ? buf0 : buf1;
      const float* const gmt = gm + (t & 1) * slots_max * npat;
      for (long long base = 0; base < pairs; base += threads) {
        const long long j = base + tid;
        const bool act = j < pairs;  // whole warps past the range: none active
        const long long f = u0 + (j >> ushift);  // the word
        const long long trl = f >> wshift;       // the batch's trellis
        const int wd = static_cast<int>(f & (ws - 1));
        const int i = (wd << ushift) + static_cast<int>(j & (U - 1));  // states 2i, 2i + 1
        const int slot = static_cast<int>(trl - tr_lo);
        bool de = false, dodd = false;
        unsigned key = 0xffffffffu;
        if (act) {
          const float mn = mn_s[slot];
          float a0, a1;
          if (t == 0) {  // the initial metrics: 0 / 1e9 from state 0, or all zero
            a0 = init_state0 && i != 0 ? 1e9f : 0.0f;
            a1 = init_state0 ? 1e9f : 0.0f;
          } else if (base == 0) {
            a0 = ahead0;
            a1 = ahead1;
          } else {
            a0 = __ldcg(pa + trl * S + i);
            a1 = __ldcg(pa + trl * S + i + P);
          }
          a0 = __fsub_rn(a0, mn);
          a1 = __fsub_rn(a1, mn);
          float m0e, m1e, m0o, m1o;  // rows 4 i .. 4 i + 3
          if constexpr (kTable) {
            const unsigned id = __ldg(ids + i);
            const float* g = gmt + slot * npat;
            m0e = g[id & 255u];
            m1e = g[(id >> 8) & 255u];
            m0o = g[(id >> 16) & 255u];
            m1o = g[id >> 24];
          } else {
            const float* l = sym + ((b0 + trl) * lw + t) * static_cast<long long>(n);
            m0e = branch_bits(row_bits(4 * i), l, n);
            m1e = branch_bits(row_bits(4 * i + 1), l, n);
            m0o = branch_bits(row_bits(4 * i + 2), l, n);
            m1o = branch_bits(row_bits(4 * i + 3), l, n);
          }
          const float c0e = __fadd_rn(a0, m0e), c1e = __fadd_rn(a1, m1e);
          const float c0o = __fadd_rn(a0, m0o), c1o = __fadd_rn(a1, m1o);
          de = c1e < c0e;
          dodd = c1o < c0o;
          const float ne = de ? c1e : c0e, no = dodd ? c1o : c0o;
          reinterpret_cast<float2*>(pb + trl * S)[i] = make_float2(ne, no);
          key = min(fkey(ne), fkey(no));
        }
        const unsigned e = __ballot_sync(kFull, de), o = __ballot_sync(kFull, dodd);
        if (act && (lane & (U - 1)) == 0) {  // a word's first pair writes it
          dec[(trl * lw + t) * ws + wd] =
              spread16((e >> lane) & umask) | (spread16((o >> lane) & umask) << 1);
        }
        // the minimum: by redux.sync where the warp's pairs are one trellis's
        const long long t0 = __shfl_sync(kFull, trl, 0);
        if (__all_sync(kFull, !act || trl == t0)) {
          key = __reduce_min_sync(kFull, key);
          if (lane == 0 && act) atomicMin(kmin_s + slot, key);
        } else if (act) {
          atomicMin(kmin_s + slot, key);
        }
      }
      if constexpr (kTable) {
        if (t + 1 < lw) metrics(t + 1);
      }
      __syncthreads();
      unsigned* const kt = keys + (t % 3) * cap;
      for (int s = tid; s < slots; s += threads) {
        atomicMin(kt + tr_lo + s, kmin_s[s]);
        kmin_s[s] = 0xffffffffu;
      }
      unsigned* const kn = keys + ((t + 1) % 3) * cap;  // last read two steps ago
      for (long long x = gtid; x < nb; x += G * threads) kn[x] = 0xffffffffu;
      grid.sync();
      // the next step's first pair's metrics load beside the minima's
      if (t + 1 < lw && tid < pairs) {
        const long long f = u0 + (tid >> ushift), trl = f >> wshift;
        const int i = (static_cast<int>(f & (ws - 1)) << ushift) + (tid & (U - 1));
        ahead0 = __ldcg(pb + trl * S + i);
        ahead1 = __ldcg(pb + trl * S + i + P);
      }
      for (int s = tid; s < slots; s += threads) mn_s[s] = unkey(__ldcg(kt + tr_lo + s));
      __syncthreads();
    }

    // the traceback's start: state 0, or the first argmin of the final
    // metrics (the first s whose buffered metric equals their minimum)
    if (!end_state0) {
      const float* const fin = (lw & 1) ? buf1 : buf0;
      for (long long j = tid; j < pairs; j += threads) {
        const long long f = u0 + (j >> ushift), trl = f >> wshift;
        const int i = (static_cast<int>(f & (ws - 1)) << ushift) + static_cast<int>(j & (U - 1));
        const float mn = mn_s[trl - tr_lo];
        const float2 v = __ldcg(reinterpret_cast<const float2*>(fin + trl * S) + i);
        if (v.x == mn) {
          atomicMin(first + trl, 2 * i);
        } else if (v.y == mn) {
          atomicMin(first + trl, 2 * i + 1);
        }
      }
      grid.sync();
    }
    // a warp a trellis: lane l holds the candidate j = floor(log2(l + 1))
    // steps back whose decisions on the way are the bits of l + 1 - 2^j
    const long long warps = G * threads / 32;
    for (long long trl = gtid >> 5; trl < nb; trl += warps) {
      const unsigned* const dt = dec + trl * lw * ws;
      unsigned char* const ob = bits + (b0 + trl) * lw;
      int s = end_state0 ? 0 : __ldcg(first + trl);
      for (int t = lw - 1; t >= 0;) {
        const int steps = min(kTraceAhead, t + 1);
        unsigned wd = 0;
        if (lj < steps) {
          int st = s;
          for (int i = 0; i < lj; ++i) st = (st >> 1) | (((lb >> i) & 1) << K2);
          wd = __ldcg(dt + static_cast<long long>(t - lj) * ws + (st >> 5));
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
    if (b0 + batch < n_trellis) grid.sync();  // the tracebacks have read the scratch
  }
}

// The grid route's geometry for a call: the CTAs (co-resident at the
// occupancy, at most one a decision word of a batch), the trellis slots a
// CTA holds at most (sized at one CTA an SM, the fewest CTAs a card
// co-schedules), the pattern table's use and the dynamic shared memory;
// `syncs` the grid barriers the launch makes.
struct GridShape {
  int grid, slots, table, smem;
  long long syncs;
};

int grid_shape(long long n_trellis, long long batch, int lw, int s_count, int npat,
               int end_state0, GridShape* gs) {
  int dev = 0, sms = 0, optin = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop || sms < 1) return static_cast<int>(cudaErrorNotSupported);
  const long long ws = s_count >= 32 ? s_count / 32 : 1;
  const long long nb = n_trellis < batch ? n_trellis : batch;
  const long long units = nb * ws;
  auto slots_at = [&](long long g) {
    const long long per = (units + g - 1) / g;
    return (per + ws - 1) / ws + 1;
  };
  const long long s1 = slots_at(units < sms ? units : sms);
  const bool table = npat <= kMaxPatterns && 2 * s1 * npat * 4 <= kGridTableBytes;
  const long long smem = 8 * s1 + (table ? 2 * s1 * npat * 4 : 0);
  if (smem > optin) return static_cast<int>(cudaErrorInvalidValue);
  const void* kernel = table ? reinterpret_cast<const void*>(viterbi_grid_kernel<true>)
                             : reinterpret_cast<const void*>(viterbi_grid_kernel<false>);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int occ = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, kGridThreads,
                                                      static_cast<size_t>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (occ < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const long long most = static_cast<long long>(sms) * occ;
  gs->grid = static_cast<int>(units < most ? units : most);
  gs->slots = static_cast<int>(s1);
  gs->table = table;
  gs->smem = static_cast<int>(smem);
  const long long batches = (n_trellis + batch - 1) / batch;
  gs->syncs = batches * (1 + lw + (end_state0 ? 0 : 1)) + (batches - 1);
  return 0;
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

// Plain C entry point of the block instance's grid route, loaded with
// ctypes: one cooperative launch. Returns the cudaError_t of the launch (0 =
// success). The caller guarantees: sym float32 [n_trellis, lw, n] and bits
// uint8 [n_trellis, lw], contiguous; s_count a power of two >= 2; codes on
// the card as viterbi_cta_launch takes them (npat patterns, mw = ceil(n /
// 32) words a row); batch >= 1 trellises a pass; on the card, dec
// min(n_trellis, batch) * lw * max(1, s_count / 32) uint32 words, pm 2 *
// min(n_trellis, batch) * s_count floats (8-byte aligned), keys 3 *
// min(n_trellis, batch) uint32 and first min(n_trellis, batch) int32.
extern "C" int viterbi_grid_launch(const void* sym, void* bits, long long n_trellis,
                                   long long batch, int lw, int n, int s_count,
                                   int init_state0, int end_state0, const void* codes, int npat,
                                   int mw, void* dec, void* pm, void* keys, void* first,
                                   void* stream) {
  if (n < 1 || lw < 1 || s_count < 2 || (s_count & (s_count - 1)) || n_trellis < 1 ||
      batch < 1 || npat < 1 || mw < (n + 31) / 32 || !dec || !pm || !keys || !first)
    return static_cast<int>(cudaErrorInvalidValue);
  GridShape gs;
  int rc = grid_shape(n_trellis, batch, lw, s_count, npat, end_state0, &gs);
  if (rc) return rc;
  const float* a_sym = static_cast<const float*>(sym);
  unsigned char* a_bits = static_cast<unsigned char*>(bits);
  const unsigned* a_codes = static_cast<const unsigned*>(codes);
  unsigned* a_dec = static_cast<unsigned*>(dec);
  float* a_pm = static_cast<float*>(pm);
  unsigned* a_keys = static_cast<unsigned*>(keys);
  int* a_first = static_cast<int*>(first);
  void* args[] = {&a_sym, &a_bits, &n_trellis, &batch, &lw, &n, &s_count, &init_state0,
                  &end_state0, &a_codes, &npat, &mw, &gs.slots, &a_dec, &a_pm, &a_keys,
                  &a_first};
  const void* kernel = gs.table ? reinterpret_cast<const void*>(viterbi_grid_kernel<true>)
                                : reinterpret_cast<const void*>(viterbi_grid_kernel<false>);
  cudaError_t err = cudaLaunchCooperativeKernel(kernel, dim3(gs.grid), dim3(kGridThreads), args,
                                                static_cast<size_t>(gs.smem),
                                                static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The grid route's launch geometry for a call (what viterbi_grid_launch
// would launch, on the current card): out[0] the CTAs, out[1] their
// threads, out[2] the dynamic shared memory, out[3] the grid barriers the
// launch makes. For a kernel that times the barriers alone (chip_smoke.py).
extern "C" int viterbi_grid_geometry(long long n_trellis, long long batch, int lw, int s_count,
                                     int npat, int end_state0, long long* out) {
  if (lw < 1 || s_count < 2 || n_trellis < 1 || batch < 1 || npat < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  GridShape gs;
  const int rc = grid_shape(n_trellis, batch, lw, s_count, npat, end_state0, &gs);
  if (rc) return rc;
  out[0] = gs.grid;
  out[1] = kGridThreads;
  out[2] = gs.smem;
  out[3] = gs.syncs;
  return 0;
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
