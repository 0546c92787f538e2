// RX frame kernel for Hopper (sm_90a): causal FIR -> decimate -> frame DFT
// -> wrap correction -> hard demod, one CTA per frame.
//
// Replaces the TPU kernel aether_primitives_tpu/ops/pallas/rx_frame.py:_kernel
// and computes the JAX chain's staged frame op (ops/fir.py fir_decimate_fft
// with _staged_layout) plus the epilogue of models/modem.py RxChain._bits_fast.
// Per frame of span = n1 * n2 samples:
//   stage 1   A[k1, m2] = sum_n F1[n, k1] X[n, m2]           (DFT_{n1})
//   stage 2   Z[k1, d]  = sum_m2 A[k1, m2] G'[k1, m2, d]     (twiddle * taps *
//                                                            DFT_{n2} * fold)
//   wrap      Z[k1, d] -= sum_u delta[u] Cm[u, k1 + n1 d]    (delta = this
//             frame's last K-1 samples minus the previous frame's, or minus
//             the carried history for frame 0 of a block)
// and one of three epilogues, natural bin k = k1 + n1 d:
//   QPSK      4 symbols per byte, LSB-first, bits (re < 0) | (im < 0) << 1
//   BPSK      8 symbols per byte, LSB-first, bit  re + im < 0
//   SPECTRUM  complex64 bins times the Scale.SN factor (the EVM gate reads it)
// Comparisons are strict; a positive scale never flips a sign, so the bit
// epilogues skip it.
//
// What bounds it on an H100: FP32 issue. Per 4,194,304-sample block (512
// frames at n1 128, n2 64, r 16, K-1 64) the work is 0.67 G complex MACs
// (2.7 G FMAs, 80 us at the 67 TFLOP/s FP32 peak); the kernel takes about
// 0.22 ms, a third of that peak. Stage 2 and the wrap correction also stream
// G' (1 MB) and Cm (1 MB) from L2 once per frame (1.07 GB per block), but
// timing the stage splits n1 = 64, 128, 256 showed the time following the
// FP32 work, not the L2 bytes. DRAM traffic is only the 32 MB block in and
// 1 MB of bytes out.
// What the design does about it: the frame is read from DRAM once into shared
// memory (64 KB, deinterleaved into re/im planes) and stage 1's result
// overwrites it in place, so the spectra never touch DRAM and a CTA needs
// 64.5 KB, which lets two CTAs share an SM. Stage 1 keeps a 4 x 8 complex
// register tile per thread with F1 read as float4 through L1; stage 2 and the
// correction read G' and Cm as coalesced float4 rows ([d][m2][k1] and
// [d][u][k1] layouts, k1 minor). Everything is FP32 FMA: TF32 or bf16 would
// fail the -80 dB EVM gate. Raising the FP32 issue rate (a larger stage-1
// tile, fewer shared loads per FMA) is left to a later change.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileK = 4;  // stage-1 thread tile: 4 k1 ...
constexpr int kTileM = 8;  // ... by 8 m2

enum Epilogue { kQpsk = 0, kBpsk = 1, kSpectrum = 2 };

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

template <int EPI>
__global__ void __launch_bounds__(kThreads, 2)
rx_frame_kernel(const float2* __restrict__ x,     // [frames, span] complex64
                const float2* __restrict__ hist,  // [rows, ku] or null
                const float* __restrict__ f1r,    // [n1, n1]
                const float* __restrict__ f1i,
                const float* __restrict__ gr,     // [r, n2, n1]
                const float* __restrict__ gi,
                const float* __restrict__ cr,     // [r, ku, n1]
                const float* __restrict__ ci,
                void* __restrict__ out,
                int nsym, int n1, int n2, int r, int ku, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int span = n1 * n2;
  float* pr = smem;  // X [n1][n2], then A [n2][n1], re plane
  float* pi = smem + span;
  float* dr = smem + 2 * span;  // tail deltas [ku]
  float* di = dr + ku;

  const long long fi = blockIdx.x;  // frame index over all block rows
  const int f = static_cast<int>(fi % nsym);
  const float2* xf = x + fi * span;
  const int tid = threadIdx.x;

  for (int i = tid; i < span; i += kThreads) {
    const float2 v = xf[i];
    pr[i] = v.x;
    pi[i] = v.y;
  }
  for (int u = tid; u < ku; u += kThreads) {
    const float2 cur = xf[span - ku + u];
    float2 prev = make_float2(0.f, 0.f);
    if (f > 0) {
      prev = xf[u - ku];  // the previous frame's tail
    } else if (hist != nullptr) {
      prev = hist[(fi / nsym) * ku + u];
    }
    dr[u] = cur.x - prev.x;
    di[u] = cur.y - prev.y;
  }
  __syncthreads();

  // ---- stage 1: A[k1, m2] = sum_n F1[n, k1] X[n, m2] -------------------
  const int tiles_k = n1 / kTileK;
  const bool active = tid < tiles_k * (n2 / kTileM);
  const int k0 = (tid % tiles_k) * kTileK;
  const int m0 = (tid / tiles_k) * kTileM;
  float ar[kTileM][kTileK];
  float ai[kTileM][kTileK];
#pragma unroll
  for (int j = 0; j < kTileM; ++j) {
#pragma unroll
    for (int q = 0; q < kTileK; ++q) {
      ar[j][q] = 0.f;
      ai[j][q] = 0.f;
    }
  }
  if (active) {
    for (int n = 0; n < n1; ++n) {
      const float4 fr4 = ldg4(f1r + n * n1 + k0);
      const float4 fi4 = ldg4(f1i + n * n1 + k0);
      const float fr[kTileK] = {fr4.x, fr4.y, fr4.z, fr4.w};
      const float fm[kTileK] = {fi4.x, fi4.y, fi4.z, fi4.w};
      const float4 xa = ld4(pr + n * n2 + m0);
      const float4 xb = ld4(pr + n * n2 + m0 + 4);
      const float4 ya = ld4(pi + n * n2 + m0);
      const float4 yb = ld4(pi + n * n2 + m0 + 4);
      const float xr[kTileM] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
      const float xm[kTileM] = {ya.x, ya.y, ya.z, ya.w, yb.x, yb.y, yb.z, yb.w};
#pragma unroll
      for (int j = 0; j < kTileM; ++j) {
#pragma unroll
        for (int q = 0; q < kTileK; ++q) {
          ar[j][q] = fmaf(fr[q], xr[j], fmaf(-fm[q], xm[j], ar[j][q]));
          ai[j][q] = fmaf(fr[q], xm[j], fmaf(fm[q], xr[j], ai[j][q]));
        }
      }
    }
  }
  __syncthreads();  // every thread is done reading X: A overwrites it
  if (active) {
#pragma unroll
    for (int j = 0; j < kTileM; ++j) {
      const int o = (m0 + j) * n1 + k0;
      *reinterpret_cast<float4*>(pr + o) =
          make_float4(ar[j][0], ar[j][1], ar[j][2], ar[j][3]);
      *reinterpret_cast<float4*>(pi + o) =
          make_float4(ai[j][0], ai[j][1], ai[j][2], ai[j][3]);
    }
  }
  __syncthreads();

  // ---- stage 2 + wrap correction + epilogue, SPB symbols per thread ------
  constexpr int SPB = (EPI == kBpsk) ? 8 : 4;
  const int groups = n1 / SPB;
  for (int item = tid; item < r * groups; item += kThreads) {
    const int g = item % groups;
    const int d = item / groups;
    const int kb = g * SPB;
    float zr[SPB], zi[SPB], er[SPB], ei[SPB];
#pragma unroll
    for (int q = 0; q < SPB; ++q) {
      zr[q] = 0.f;
      zi[q] = 0.f;
      er[q] = 0.f;
      ei[q] = 0.f;
    }
    const float* gdr = gr + static_cast<size_t>(d) * n2 * n1 + kb;
    const float* gdi = gi + static_cast<size_t>(d) * n2 * n1 + kb;
    for (int m = 0; m < n2; ++m) {
#pragma unroll
      for (int h = 0; h < SPB; h += 4) {
        const float4 a4 = ld4(pr + m * n1 + kb + h);
        const float4 b4 = ld4(pi + m * n1 + kb + h);
        const float4 c4 = ldg4(gdr + m * n1 + h);
        const float4 s4 = ldg4(gdi + m * n1 + h);
        const float a[4] = {a4.x, a4.y, a4.z, a4.w};
        const float b[4] = {b4.x, b4.y, b4.z, b4.w};
        const float c[4] = {c4.x, c4.y, c4.z, c4.w};
        const float s[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          zr[h + q] = fmaf(a[q], c[q], fmaf(-b[q], s[q], zr[h + q]));
          zi[h + q] = fmaf(a[q], s[q], fmaf(b[q], c[q], zi[h + q]));
        }
      }
    }
    const float* cdr = cr + static_cast<size_t>(d) * ku * n1 + kb;
    const float* cdi = ci + static_cast<size_t>(d) * ku * n1 + kb;
    for (int u = 0; u < ku; ++u) {
      const float tr = dr[u];
      const float ti = di[u];
#pragma unroll
      for (int h = 0; h < SPB; h += 4) {
        const float4 c4 = ldg4(cdr + u * n1 + h);
        const float4 s4 = ldg4(cdi + u * n1 + h);
        const float c[4] = {c4.x, c4.y, c4.z, c4.w};
        const float s[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          er[h + q] = fmaf(tr, c[q], fmaf(-ti, s[q], er[h + q]));
          ei[h + q] = fmaf(tr, s[q], fmaf(ti, c[q], ei[h + q]));
        }
      }
    }
#pragma unroll
    for (int q = 0; q < SPB; ++q) {
      zr[q] -= er[q];
      zi[q] -= ei[q];
    }

    if constexpr (EPI == kSpectrum) {
      float2* o = static_cast<float2*>(out) + fi * (static_cast<long long>(r) * n1) +
                  static_cast<size_t>(d) * n1 + kb;
#pragma unroll
      for (int q = 0; q < SPB; ++q) o[q] = make_float2(zr[q] * scale, zi[q] * scale);
    } else {
      uint32_t byte = 0;
#pragma unroll
      for (int q = 0; q < SPB; ++q) {
        if constexpr (EPI == kQpsk) {
          byte |= (static_cast<uint32_t>(zr[q] < 0.f) |
                   (static_cast<uint32_t>(zi[q] < 0.f) << 1)) << (2 * q);
        } else {
          byte |= static_cast<uint32_t>(zr[q] + zi[q] < 0.f) << q;
        }
      }
      static_cast<uint8_t*>(out)[fi * (static_cast<long long>(r) * groups) + item] =
          static_cast<uint8_t>(byte);
    }
  }
}

template <int EPI>
int launch(const void* x, const void* hist, const void* f1r, const void* f1i,
           const void* gr, const void* gi, const void* cr, const void* ci,
           void* out, long long frames, int nsym, int n1, int n2, int r, int ku,
           float scale, cudaStream_t stream) {
  const size_t smem = (2 * static_cast<size_t>(n1) * n2 + 2 * static_cast<size_t>(ku)) *
                      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      rx_frame_kernel<EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  rx_frame_kernel<EPI><<<static_cast<unsigned>(frames), kThreads, smem, stream>>>(
      static_cast<const float2*>(x), static_cast<const float2*>(hist),
      static_cast<const float*>(f1r), static_cast<const float*>(f1i),
      static_cast<const float*>(gr), static_cast<const float*>(gi),
      static_cast<const float*>(cr), static_cast<const float*>(ci), out, nsym,
      n1, n2, r, ku, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, loaded with ctypes. epilogue: 0 QPSK bytes, 1 BPSK
// bytes, 2 spectrum. Returns the cudaError_t of the launch (0 = success).
// The caller guarantees: n1 % 8 == 0, n2 % 8 == 0, (n1 / 4) * (n2 / 8) <= 256
// threads, 0 <= ku <= n1 * n2, 16-byte aligned constants, contiguous tensors.
extern "C" int rx_frame_launch(int epilogue, const void* x, const void* hist,
                               const void* f1r, const void* f1i, const void* gr,
                               const void* gi, const void* cr, const void* ci,
                               void* out, long long frames, int nsym, int n1,
                               int n2, int r, int ku, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (epilogue) {
    case kQpsk:
      return launch<kQpsk>(x, hist, f1r, f1i, gr, gi, cr, ci, out, frames, nsym,
                           n1, n2, r, ku, scale, s);
    case kBpsk:
      return launch<kBpsk>(x, hist, f1r, f1i, gr, gi, cr, ci, out, frames, nsym,
                           n1, n2, r, ku, scale, s);
    case kSpectrum:
      return launch<kSpectrum>(x, hist, f1r, f1i, gr, gi, cr, ci, out, frames,
                               nsym, n1, n2, r, ku, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
