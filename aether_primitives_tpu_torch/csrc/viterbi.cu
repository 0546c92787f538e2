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
// 0.1 G FP32 operations and the traffic 1.5 MB, both about a microsecond,
// but every one of the 638 ACS steps waits on the previous one through
// warp shuffles (4 to fetch predecessor metrics, 5 for the minimum), and the
// traceback is 638 dependent shared-memory reads, while 256 warps fill only
// a few warps per SM. What the design does about it: the path metrics stay
// in registers (2 of the 64 states per lane, S / 32 in general), the
// decisions of a step are packed by __ballot_sync into S / 32 words
// (8 bytes per step at S = 64, 5.1 KB per trellis) in shared memory, and the
// LLRs are read once, as warp-wide broadcast loads. Nothing but the bits
// goes back to device memory. Overlapping trellises to hide the chain
// latency (several trellises per warp) is left to a later change.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxN = 8;        // generators per code
constexpr int kMaxStates = 256; // 2^(K-1), K <= 9
constexpr unsigned kFull = 0xffffffffu;

// out_mask[2 * s' + j]: bit m is o_m of the transition into s' from
// predecessor j (the JAX package's _trellis outs table).
struct Masks {
  unsigned char m[2 * kMaxStates];
};

__device__ __forceinline__ float branch(unsigned mask, const float* l, int n) {
  float g = __fmul_rn((mask & 1u) ? 1.0f : 0.0f, l[0]);
#pragma unroll
  for (int m = 1; m < kMaxN; ++m) {
    if (m < n) g = __fadd_rn(g, __fmul_rn(((mask >> m) & 1u) ? 1.0f : 0.0f, l[m]));
  }
  return g;
}

template <int S>
__global__ void viterbi_kernel(const float* __restrict__ sym,
                               unsigned char* __restrict__ bits,
                               long long n_trellis, int lw, int n,
                               int init_state0, int end_state0, Masks masks) {
  constexpr int kSpl = S >= 32 ? S / 32 : 1;  // states (and words) per lane/step
  extern __shared__ unsigned int smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long tr = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (tr >= n_trellis) return;  // whole warps only: nothing below syncs the block
  unsigned int* dec = smem + static_cast<size_t>(warp) * lw * kSpl;
  const float* y = sym + tr * static_cast<long long>(lw) * n;

  int st[kSpl];
  unsigned om0[kSpl], om1[kSpl];
  float pm[kSpl];
#pragma unroll
  for (int j = 0; j < kSpl; ++j) {
    st[j] = S >= 32 ? lane + 32 * j : lane % S;
    om0[j] = masks.m[2 * st[j]];
    om1[j] = masks.m[2 * st[j] + 1];
    pm[j] = init_state0 ? (st[j] == 0 ? 0.0f : 1e9f) : 0.0f;
  }

  for (int t = 0; t < lw; ++t) {
    float l[kMaxN];
#pragma unroll
    for (int m = 0; m < kMaxN; ++m) l[m] = m < n ? __ldg(y + t * n + m) : 0.0f;
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
      const float c0 = __fadd_rn(a0, branch(om0[j], l, n));
      const float c1 = __fadd_rn(a1, branch(om1[j], l, n));
      const bool d = c1 < c0;
      nw[j] = d ? c1 : c0;
      const unsigned word = __ballot_sync(kFull, d);
      if (lane == j) dec[t * kSpl + j] = word;
    }
    float mn = nw[0];
#pragma unroll
    for (int j = 1; j < kSpl; ++j) mn = fminf(mn, nw[j]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mn = fminf(mn, __shfl_xor_sync(kFull, mn, off));
#pragma unroll
    for (int j = 0; j < kSpl; ++j) pm[j] = __fsub_rn(nw[j], mn);
  }

  int state = 0;
  if (!end_state0) {  // first argmin of the final metrics
    float mn = pm[0];
#pragma unroll
    for (int j = 1; j < kSpl; ++j) mn = fminf(mn, pm[j]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mn = fminf(mn, __shfl_xor_sync(kFull, mn, off));
    int best = S;
#pragma unroll
    for (int j = kSpl - 1; j >= 0; --j) {
      if (pm[j] == mn && st[j] < best) best = st[j];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) best = min(best, __shfl_xor_sync(kFull, best, off));
    state = best;
  }
  __syncwarp();
  if (lane == 0) {
    unsigned char* out = bits + tr * static_cast<long long>(lw);
    for (int t = lw - 1; t >= 0; --t) {
      out[t] = static_cast<unsigned char>(state & 1);
      const unsigned word = dec[t * kSpl + (S >= 32 ? (state >> 5) : 0)];
      const int d = (word >> (state & 31)) & 1;
      state = (state >> 1) | (d ? S / 2 : 0);
    }
  }
}

template <int S>
int launch(const void* sym, void* bits, long long n_trellis, int lw, int n,
           int init_state0, int end_state0, int warps, const Masks& masks,
           cudaStream_t stream) {
  constexpr int kSpl = S >= 32 ? S / 32 : 1;
  const size_t smem = static_cast<size_t>(warps) * lw * kSpl * sizeof(unsigned int);
  cudaError_t err = cudaFuncSetAttribute(
      viterbi_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (n_trellis + warps - 1) / warps;
  viterbi_kernel<S><<<static_cast<unsigned>(blocks), 32 * warps, smem, stream>>>(
      static_cast<const float*>(sym), static_cast<unsigned char*>(bits), n_trellis,
      lw, n, init_state0, end_state0, masks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, loaded with ctypes. Returns the cudaError_t of the
// launch (0 = success). The caller guarantees: sym float32 [n_trellis, lw, n]
// and bits uint8 [n_trellis, lw], contiguous; s_count a power of two in
// [4, 256]; 1 <= n <= 8; out_mask a host array of 2 * s_count bytes;
// warps * lw * max(1, s_count / 32) * 4 bytes of shared memory within the
// card's per-block limit.
extern "C" int viterbi_launch(const void* sym, void* bits, long long n_trellis,
                              int lw, int n, int s_count, int init_state0,
                              int end_state0, int warps,
                              const unsigned char* out_mask, void* stream) {
  if (n < 1 || n > kMaxN || s_count > kMaxStates || warps < 1 || warps > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  Masks masks = {};
  for (int i = 0; i < 2 * s_count; ++i) masks.m[i] = out_mask[i];
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (s_count) {
    case 4: return launch<4>(sym, bits, n_trellis, lw, n, init_state0, end_state0, warps, masks, s);
    case 8: return launch<8>(sym, bits, n_trellis, lw, n, init_state0, end_state0, warps, masks, s);
    case 16: return launch<16>(sym, bits, n_trellis, lw, n, init_state0, end_state0, warps, masks, s);
    case 32: return launch<32>(sym, bits, n_trellis, lw, n, init_state0, end_state0, warps, masks, s);
    case 64: return launch<64>(sym, bits, n_trellis, lw, n, init_state0, end_state0, warps, masks, s);
    case 128: return launch<128>(sym, bits, n_trellis, lw, n, init_state0, end_state0, warps, masks, s);
    case 256: return launch<256>(sym, bits, n_trellis, lw, n, init_state0, end_state0, warps, masks, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
