// The previous design of aether_primitives_tpu_torch/csrc/pfb_fold.cu (each
// block loads its whole slab, then computes), kept unchanged below so that
// chip_smoke.py phase 13 can time the shipped kernel beside it in one run. The port does not call it. Its comment's
// "0.017 ms of FP32 issue" counts FMAs that it does not issue: its 1.09 G
// unfused multiplies and adds take 0.033 ms at the issue rate.
//
// Polyphase filterbank fold for Hopper (sm_90a): the weighted overlap-add
// of the oversampled PFB analysis and of the PFB synthesis spread.
//
// Replaces the TPU kernel aether_primitives_tpu/ops/pallas/pfb_fold.py:
// _fold_kernel (wrapper pfb_fold_os). For batch row b, oversampling class j
// (hop = M / os), class frame t and column r it computes
//   acc[t, r] = sum_{p=0}^{P-1} hb[p, r] * x[b, j*hop + (t + p)*M + r]
// on split float32 planes, the terms added in p order starting from the
// p = 0 product, and writes out[b, j, t, (r + a) mod M] = acc[t, r] with the
// class's reference roll a = (j*hop) mod M. Every multiply and add is
// __fmul_rn / __fadd_rn and the file is built without fast math, so no FMA
// contraction rounds differently from the plain PyTorch version, which adds
// the same P slice products in the same order: the two are bit-identical.
//
// What bounds it on an H100: bytes. At the channelizer's steady analysis
// step (os 2, M 2,048, P 33, 2,048 frames per class) it reads 34 MB of input
// and writes 67 MB of output for 1.1 G FP32 operations: 0.030 ms of HBM
// time against 0.017 ms of FP32 issue. The TPU kernel kept a whole
// (tile_t + P - 1) * M slab in VMEM (1.5 MB at M = 2,048), seven times what
// one block's shared memory holds. What the design does about it:
// - A block owns 64 input columns c by 64 frames, for every class. Output
//   column c of class j reads input column c too (the roll undoes the class
//   shift: j*hop + r = c, or c + M, which is the next frame row), so one
//   slab of (64 + P) x 64 samples of both planes in shared memory (50 KB at
//   P = 33) feeds all os classes and the input comes from device memory
//   about (64 + P) / 64 = 1.5 times in all, not once per class.
// - The slab is copied with cp.async, each warp a whole 256-byte row, all of
//   a block's copies in flight at once (serialized load->store pairs left
//   the load phase latency-bound).
// - Each thread owns 16 frames of one column: their accumulators and a
//   window of the 16 slab rows the current branch reads stay in registers,
//   and each branch loads one new row per plane from shared memory (row
//   t + p of frame t is row t + 1 of frame t - 1 at the branch before).
// - Each class's P x 64 weights are staged in shared memory (a global load
//   per branch left each branch waiting on a round trip).
// - The outputs go out as coalesced rows, and the ragged frame and column
//   edges are masked here, so no caller pads to whole tiles.
// A pipeline that overlaps the next slab's load with this one's arithmetic
// is left to a later change.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The tile shape; benches/torch_pfb_fold_sweep.py builds other values with
// -D to time them (4 x 16 measured fastest on the H100). The wrapper
// (ops/cuda/pfb_fold.py) assumes 64 frames per block.
#ifndef PFB_FOLD_ROWS
#define PFB_FOLD_ROWS 4
#endif
#ifndef PFB_FOLD_FRAMES
#define PFB_FOLD_FRAMES 16
#endif

constexpr int kStrip = 64;               // columns per block (threadIdx.x)
constexpr int kRows = PFB_FOLD_ROWS;     // thread rows per block (threadIdx.y)
constexpr int kFrames = PFB_FOLD_FRAMES; // frames per thread = register window
constexpr int kTile = kRows * kFrames;   // frames per block

// 4-byte asynchronous copy global -> shared (sm_80+), completed by
// cp_async_wait_all.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__global__ void __launch_bounds__(kStrip * kRows)
pfb_fold_kernel(const float* __restrict__ x_re, const float* __restrict__ x_im,
                long long n, const float* __restrict__ hb,
                float* __restrict__ out_re, float* __restrict__ out_im,
                int m, int p, int os, int hop, int t_cls) {
  extern __shared__ float smem[];
  const int slab_rows = kTile + p;  // + 1 row for classes that wrap a frame row
  float* sr = smem;                       // [slab_rows][kStrip]
  float* si = smem + slab_rows * kStrip;  // [slab_rows][kStrip]
  float* sw = si + slab_rows * kStrip;    // [p][kStrip], one class at a time

  const int t0 = blockIdx.x * kTile;          // first class frame of the tile
  const int c = blockIdx.y * kStrip + threadIdx.x;  // input and output column
  const long long b = blockIdx.z;
  const bool col_ok = c < m;

  const float* xr = x_re + b * n;
  const float* xi = x_im + b * n;
  for (int s = threadIdx.y; s < slab_rows; s += kRows) {
    const long long idx = static_cast<long long>(t0 + s) * m + c;
    float* dr = sr + s * kStrip + threadIdx.x;
    float* di = si + s * kStrip + threadIdx.x;
    if (col_ok && idx < n) {
      cp_async4(dr, xr + idx);
      cp_async4(di, xi + idx);
    } else {
      *dr = 0.0f;
      *di = 0.0f;
    }
  }

  const int tl = threadIdx.y * kFrames;  // first local frame of this thread
  for (int j = 0; j < os; ++j) {
    // class j's sample for output column c: x[j*hop + (t + q)*M + r] with
    // r = (c - j*hop) mod M, which is slab column c, one row down when
    // c < j*hop
    const int a = j * hop;
    const int r = c >= a ? c - a : c - a + m;
    const int down = c < a ? 1 : 0;
    if (j > 0) __syncthreads();  // every thread is done with the last weights
    for (int q = threadIdx.y; q < p; q += kRows) {
      float* dw = sw + q * kStrip + threadIdx.x;
      if (col_ok) {
        cp_async4(dw, hb + static_cast<long long>(q) * m + r);
      } else {
        *dw = 0.0f;
      }
    }
    cp_async_wait_all();
    __syncthreads();
    if (!col_ok) continue;  // the loop's only barriers are above

    // slab row tl + down + i of this column sits in window slot i % kFrames
    // once loaded; branch q reads rows i = q .. q + kFrames - 1, slot
    // (q + t) % kFrames for frame t, and then slot q % kFrames takes row
    // i = q + kFrames
    const float* cr = sr + (tl + down) * kStrip + threadIdx.x;
    const float* ci = si + (tl + down) * kStrip + threadIdx.x;
    const float* cw = sw + threadIdx.x;
    float xr_w[kFrames], xi_w[kFrames], ar[kFrames], ai[kFrames];
#pragma unroll
    for (int t = 0; t < kFrames; ++t) {
      xr_w[t] = cr[t * kStrip];
      xi_w[t] = ci[t * kStrip];
    }
    {
      const float w = cw[0];
#pragma unroll
      for (int t = 0; t < kFrames; ++t) {
        ar[t] = __fmul_rn(xr_w[t], w);
        ai[t] = __fmul_rn(xi_w[t], w);
      }
      if (p > 1) {
        xr_w[0] = cr[kFrames * kStrip];
        xi_w[0] = ci[kFrames * kStrip];
      }
    }
    for (int qb = 0; qb < p; qb += kFrames) {
#pragma unroll
      for (int k = 0; k < kFrames; ++k) {
        const int q = qb + k;
        if (q >= p) break;
        if (q == 0) continue;  // the p = 0 products above
        const float w = cw[q * kStrip];
#pragma unroll
        for (int t = 0; t < kFrames; ++t) {
          ar[t] = __fadd_rn(ar[t], __fmul_rn(xr_w[(k + t) % kFrames], w));
          ai[t] = __fadd_rn(ai[t], __fmul_rn(xi_w[(k + t) % kFrames], w));
        }
        if (q + 1 < p) {
          xr_w[k] = cr[(q + kFrames) * kStrip];
          xi_w[k] = ci[(q + kFrames) * kStrip];
        }
      }
    }

    const long long plane = (b * os + j) * static_cast<long long>(t_cls) * m + c;
#pragma unroll
    for (int t = 0; t < kFrames; ++t) {
      const int frame = t0 + tl + t;
      if (frame < t_cls) {
        out_re[plane + static_cast<long long>(frame) * m] = ar[t];
        out_im[plane + static_cast<long long>(frame) * m] = ai[t];
      }
    }
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. Returns the cudaError_t of the
// launch (0 = success). The caller guarantees: x_re and x_im float32
// [batch, n] contiguous with n >= (os - 1) * hop + (t_cls - 1 + p) * m;
// hb float32 [p, m] contiguous; out_re and out_im float32 [batch, os,
// t_cls, m] contiguous; hop * os == m; batch <= 65535, ceil(m / 64) <=
// 65535, and (2 * (64 + p) + p) * 64 * 4 bytes of shared memory within the
// card's per-block limit.
extern "C" int pfb_fold_launch(const void* x_re, const void* x_im, long long n,
                               const void* hb, void* out_re, void* out_im,
                               int batch, int m, int p, int os, int hop, int t_cls,
                               void* stream) {
  if (batch < 1 || m < 1 || p < 1 || os < 1 || t_cls < 1 || hop * os != m)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(2 * (kTile + p) + p) * kStrip * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      pfb_fold_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((t_cls + kTile - 1) / kTile, (m + kStrip - 1) / kStrip, batch);
  const dim3 block(kStrip, kRows);
  pfb_fold_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x_re), static_cast<const float*>(x_im), n,
      static_cast<const float*>(hb), static_cast<float*>(out_re),
      static_cast<float*>(out_im), m, p, os, hop, t_cls);
  return static_cast<int>(cudaGetLastError());
}
