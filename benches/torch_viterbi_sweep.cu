// Two trellises a warp, for benches/torch_viterbi_sweep.py: the port's
// Viterbi kernel (csrc/viterbi.cu, one trellis a warp) with a second,
// independent trellis interleaved in the same instruction stream, to see
// whether two chains hide each other's latency. Only the burst path's code
// (64 states, rate 1/2) is compiled; the port does not ship this kernel.
//
// Build: nvcc <the port's flags> -I aether_primitives_tpu_torch/csrc
//        -o <lib>.so benches/torch_viterbi_sweep.cu

#include "viterbi.cu"

namespace {

constexpr int kS = 64;
constexpr int kSpl = kS / 32;
constexpr int kN = 2;
constexpr int kTpw = 2;

__global__ void viterbi_pair_kernel(const float* __restrict__ sym,
                                    unsigned char* __restrict__ bits,
                                    long long n_trellis, int lw, int init_state0,
                                    int end_state0, Masks masks) {
  extern __shared__ unsigned int smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long tr0 = (static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp) * kTpw;
  if (tr0 >= n_trellis) return;
  const int words = lw * kSpl;
  unsigned* dec = smem + static_cast<size_t>(warp) * kTpw * words;
  const float* y[kTpw];
  float cur[kTpw][kN], nxt[kTpw][kN];
#pragma unroll
  for (int tp = 0; tp < kTpw; ++tp) {
    // a missing second trellis decodes the first's LLRs again and is not stored
    const long long tr = tr0 + tp < n_trellis ? tr0 + tp : tr0;
    y[tp] = sym + tr * static_cast<long long>(lw) * kN;
    load_chunk<kN, kN>(y[tp], lw, kN, 0, lane, cur[tp]);
    load_chunk<kN, kN>(y[tp], lw, kN, 1, lane, nxt[tp]);
  }
  int st[kSpl];
  float o0[kSpl][kN], o1[kSpl][kN];
  float pm[kTpw][kSpl];
#pragma unroll
  for (int j = 0; j < kSpl; ++j) {
    st[j] = lane + 32 * j;
#pragma unroll
    for (int m = 0; m < kN; ++m) {
      o0[j][m] = (masks.m[2 * st[j]] >> m) & 1u ? 1.0f : 0.0f;
      o1[j][m] = (masks.m[2 * st[j] + 1] >> m) & 1u ? 1.0f : 0.0f;
    }
#pragma unroll
    for (int tp = 0; tp < kTpw; ++tp) pm[tp][j] = init_state0 ? (st[j] == 0 ? 0.0f : 1e9f) : 0.0f;
  }
  float g0[kTpw][kSpl], g1[kTpw][kSpl];
#pragma unroll
  for (int tp = 0; tp < kTpw; ++tp) branches<kSpl, kN, kN>(cur[tp], 0, kN, o0, o1, g0[tp], g1[tp]);

  for (int t = 0; t < lw; ++t) {
    const int tn = t + 1;
    if ((tn & 31) == 0) {
#pragma unroll
      for (int tp = 0; tp < kTpw; ++tp) {
#pragma unroll
        for (int m = 0; m < kN; ++m) cur[tp][m] = nxt[tp][m];
        load_chunk<kN, kN>(y[tp], lw, kN, (tn >> 5) + 1, lane, nxt[tp]);
      }
    }
    float h0[kTpw][kSpl], h1[kTpw][kSpl], nw[kTpw][kSpl];
#pragma unroll
    for (int tp = 0; tp < kTpw; ++tp) {
      branches<kSpl, kN, kN>(cur[tp], tn, kN, o0, o1, h0[tp], h1[tp]);
#pragma unroll
      for (int j = 0; j < kSpl; ++j) {
        const int src = (lane >> 1) + 16 * (j & 1);
        const float a0 = __shfl_sync(kFull, pm[tp][j >> 1], src);
        const float a1 = __shfl_sync(kFull, pm[tp][(j >> 1) + kSpl / 2], src);
        const float c0 = __fadd_rn(a0, g0[tp][j]);
        const float c1 = __fadd_rn(a1, g1[tp][j]);
        const bool d = c1 < c0;
        nw[tp][j] = d ? c1 : c0;
        const unsigned word = __ballot_sync(kFull, d);
        if (lane == j) dec[tp * words + t * kSpl + j] = word;
      }
    }
#pragma unroll
    for (int tp = 0; tp < kTpw; ++tp) {
      const float mn = unkey(__reduce_min_sync(kFull, fkey(fminf(nw[tp][0], nw[tp][1]))));
#pragma unroll
      for (int j = 0; j < kSpl; ++j) {
        pm[tp][j] = __fsub_rn(nw[tp][j], mn);
        g0[tp][j] = h0[tp][j];
        g1[tp][j] = h1[tp][j];
      }
    }
  }

  int start[kTpw];
#pragma unroll
  for (int tp = 0; tp < kTpw; ++tp) {
    start[tp] = 0;
    if (!end_state0) {
      const float mn = unkey(__reduce_min_sync(kFull, fkey(fminf(pm[tp][0], pm[tp][1]))));
      unsigned best = kS;
#pragma unroll
      for (int j = kSpl - 1; j >= 0; --j) {
        if (pm[tp][j] == mn && static_cast<unsigned>(st[j]) < best) best = st[j];
      }
      start[tp] = static_cast<int>(__reduce_min_sync(kFull, best));
    }
  }
  __syncwarp();
  if (lane < kTpw) {  // lane tp walks trellis tp
    int state = lane == 0 ? start[0] : start[1];
    const unsigned* d = dec + lane * words;
    unsigned char* out = reinterpret_cast<unsigned char*>(dec + lane * words);
    for (int t = lw - 1; t >= 0; --t) {
      const uint2 w = *reinterpret_cast<const uint2*>(d + t * kSpl);
      out[t * kSpl * 4] = static_cast<unsigned char>(state & 1);
      const unsigned word = (state >> 5) ? w.y : w.x;
      state = (state >> 1) | (((word >> (state & 31)) & 1u) ? kS / 2 : 0);
    }
  }
  __syncwarp();
#pragma unroll
  for (int tp = 0; tp < kTpw; ++tp) {
    if (tr0 + tp < n_trellis) {
      const unsigned char* src = reinterpret_cast<const unsigned char*>(dec + tp * words);
      unsigned char* dst = bits + (tr0 + tp) * static_cast<long long>(lw);
      for (int t = lane; t < lw; t += 32) dst[t] = src[t * kSpl * 4];
    }
  }
}

}  // namespace

// K = 7 (64 states), rate 1/2 only: sym float32 [n_trellis, lw, 2], bits
// uint8 [n_trellis, lw], out_mask 128 bytes; warps a block, two trellises
// a warp; warps * 2 * lw * 8 bytes of shared memory within the card's limit.
extern "C" int viterbi_pair_launch(const void* sym, void* bits, long long n_trellis, int lw,
                                   int init_state0, int end_state0, int warps,
                                   const unsigned char* out_mask, void* stream) {
  if (warps < 1 || warps > 32) return static_cast<int>(cudaErrorInvalidValue);
  Masks masks = {};
  for (int i = 0; i < 2 * kS; ++i) masks.m[i] = out_mask[i];
  const size_t smem = static_cast<size_t>(warps) * kTpw * lw * kSpl * sizeof(unsigned int);
  cudaError_t err = cudaFuncSetAttribute(
      viterbi_pair_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long per_block = static_cast<long long>(warps) * kTpw;
  const long long blocks = (n_trellis + per_block - 1) / per_block;
  viterbi_pair_kernel<<<static_cast<unsigned>(blocks), 32 * warps, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sym), static_cast<unsigned char*>(bits), n_trellis, lw,
      init_state0, end_state0, masks);
  return static_cast<int>(cudaGetLastError());
}
