// RX frame kernel for Hopper (sm_90a): causal FIR -> decimate -> frame FFT
// -> hard demod (cli.py numpy_reference_spectra plus the sign demod).
//
// Replaces the TPU kernel aether_primitives_tpu/ops/pallas/rx_frame.py:_kernel
// and the epilogue of models/modem.py RxChain._bits_fast. The direct instance
// (the main path's; described after the tile instances) computes the FIR at
// the kept outputs and a hand-written FFT. The tile and generic instances
// compute the JAX chain's staged frame op (ops/fir.py fir_decimate_fft with
// _staged_layout), per frame of span = n1 * n2 samples:
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
// What bounds the staged form on an H100: FP32 issue. Per 4,194,304-sample
// block (512 frames at n1 128, n2 64, r 16, K-1 64) the work is 0.67 G complex MACs
// (2.7 G FMAs, 80 us at the 67 TFLOP/s FP32 peak); the kernel takes about
// 0.22 ms, a third of that peak. Stage 2 and the wrap correction also stream
// G' (1 MB) and Cm (1 MB) from L2 once per frame (1.07 GB per block), but
// timing the stage splits n1 = 64, 128, 256 showed the time following the
// FP32 work, not the L2 bytes. DRAM traffic is only the 33.55 MB block in and
// 262,144 QPSK bytes out.
// What the design does about it: the frame is read from DRAM once into shared
// memory (64 KB, deinterleaved into re/im planes) and stage 1's result
// overwrites it in place, so the spectra never touch DRAM and a CTA needs
// 64.5 KB, which lets two CTAs share an SM. Stage 1 keeps a 4 x 8 complex
// register tile per thread with F1 read as float4 through L1; stage 2 and the
// correction read G' and Cm as coalesced float4 rows ([d][m2][k1] and
// [d][u][k1] layouts, k1 minor). Everything is FP32 FMA: TF32 or bf16 would
// fail the -80 dB EVM gate. Raising the FP32 issue rate (a larger stage-1
// tile, fewer shared loads per FMA) is left to a later change.
//
// Four instances, picked by the wrapper (ops/cuda/rx_frame.py kernel_plan):
//   direct    power-of-two fft_len 64-4096 whose staged frames fit shared
//             memory and at most 256 taps (the main path, dec 4 / fft_len
//             2048, and dec 4 / fft_len 64 and 4096): see below;
//   tile256   n1 % 8 == 0, n2 % 8 == 0, span <= 8,192 (e.g. dec 4,
//             fft_len 192 or dec 8, fft_len 32): 256 threads, one 4 x 8
//             stage-1 tile each, two CTAs an SM;
//   tile512   the same code at 512 threads for spans of 8,193-16,384 (e.g.
//             dec 1, fft_len 16384): about 128.5 KB of opt-in dynamic shared
//             memory, one CTA an SM;
//   generic   any other split n1 x n2 (fft_len 30, spans under 64, n2 < 8):
//             scalar stage-1 points, each thread looping over (k1, m2), A in
//             its own pair of shared planes, and the spectrum epilogue only
//             (the wrapper demodulates and packs its spectrum in PyTorch).
//
// The direct instance computes the function itself rather than the MXU's
// factorisation: per frame, the decimating FIR at the kept outputs only,
//   y[m] = sum_k h[k] x[dec m - k],   m < fft_len,
// then an fft_len-point FFT written by hand in shared memory. What bounds
// it: the bytes. A 4M block is 33.55 MB in and 262,144 QPSK bytes out
// (0.0101 ms at 3.35 TB/s); the FIR is 1,048,576 outputs x 65 taps (273 M
// FP32 operations with real taps, 545 M with complex ones) and the FFTs
// about 58 M, 0.004-0.009 ms at the 67 TFLOP/s FP32 peak. Design:
//   - a CTA stages its frames once, by 8-byte cp.async, into a window of
//     K-1 + span samples each (the previous frame's tail, the carried
//     history row for frame 0 of a row, or zeros), one pad slot every 32
//     samples so that the FIR's strided reads miss no bank twice (68 KB at
//     the main path: three CTAs an SM);
//   - a thread computes 8 consecutive outputs, phase by phase of the
//     polyphase split k = dec q + p, in blocks of 8 taps: 15 samples in
//     registers serve 64 multiply-adds. The taps are a kernel parameter
//     (constant memory); a real-tap variant (every imaginary part exactly
//     0, as for the default lowpass) skips the products with zero;
//   - the FFT is a Stockham radix-8 (then radix-4 or 2) pass sequence in
//     place in shared memory, bins in natural order, twiddles from a
//     float32 table built on the host in float64; one pad slot every 8
//     points keeps the passes' strided stores off shared bank conflicts;
//   - the epilogues read the natural-order bins: strict comparisons, the
//     Scale.SN factor on the spectrum only.
// Frames of fewer than 2,048 points go 2048 / fft_len to a CTA (as far as
// shared memory allows), so that a CTA always has 2,048 outputs' work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGenericThreads = 256;
constexpr int kTileK = 4;  // stage-1 thread tile: 4 k1 ...
constexpr int kTileM = 8;  // ... by 8 m2

enum Epilogue { kQpsk = 0, kBpsk = 1, kSpectrum = 2 };

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

template <int EPI, int kThreads, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
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

// The generic instance: any n1 x n2 split, scalar stage-1 points, X and A in
// separate shared planes, the spectrum epilogue (natural bin k1 + n1 d).
__global__ void __launch_bounds__(kGenericThreads)
rx_frame_generic_kernel(const float2* __restrict__ x, const float2* __restrict__ hist,
                        const float* __restrict__ f1r, const float* __restrict__ f1i,
                        const float* __restrict__ gr, const float* __restrict__ gi,
                        const float* __restrict__ cr, const float* __restrict__ ci,
                        float2* __restrict__ out, int nsym, int n1, int n2, int r,
                        int ku, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int span = n1 * n2;
  float* xr = smem;  // X [n1][n2]
  float* xi = smem + span;
  float* ar = smem + 2 * span;  // A [n2][n1]
  float* ai = smem + 3 * span;
  float* dr = smem + 4 * span;  // tail deltas [ku]
  float* di = dr + ku;

  const long long fi = blockIdx.x;
  const int f = static_cast<int>(fi % nsym);
  const float2* xf = x + fi * span;
  const int tid = threadIdx.x;
  for (int i = tid; i < span; i += kGenericThreads) {
    const float2 v = xf[i];
    xr[i] = v.x;
    xi[i] = v.y;
  }
  for (int u = tid; u < ku; u += kGenericThreads) {
    const float2 cur = xf[span - ku + u];
    float2 prev = make_float2(0.f, 0.f);
    if (f > 0) {
      prev = xf[u - ku];
    } else if (hist != nullptr) {
      prev = hist[(fi / nsym) * ku + u];
    }
    dr[u] = cur.x - prev.x;
    di[u] = cur.y - prev.y;
  }
  __syncthreads();

  for (int p = tid; p < span; p += kGenericThreads) {  // A[k1, m2], p = m2 * n1 + k1
    const int k1 = p % n1;
    const int m2 = p / n1;
    float sr = 0.f, si = 0.f;
    for (int n = 0; n < n1; ++n) {
      const float fr = f1r[n * n1 + k1];
      const float fm = f1i[n * n1 + k1];
      const float a = xr[n * n2 + m2];
      const float b = xi[n * n2 + m2];
      sr = fmaf(fr, a, fmaf(-fm, b, sr));
      si = fmaf(fr, b, fmaf(fm, a, si));
    }
    ar[p] = sr;
    ai[p] = si;
  }
  __syncthreads();

  const int bins = r * n1;
  for (int p = tid; p < bins; p += kGenericThreads) {  // bin p = d * n1 + k1
    const int k1 = p % n1;
    const int d = p / n1;
    float zr = 0.f, zi = 0.f, er = 0.f, ei = 0.f;
    const float* gdr = gr + static_cast<size_t>(d) * n2 * n1 + k1;
    const float* gdi = gi + static_cast<size_t>(d) * n2 * n1 + k1;
    for (int m = 0; m < n2; ++m) {
      const float a = ar[m * n1 + k1];
      const float b = ai[m * n1 + k1];
      const float c = gdr[m * n1];
      const float s = gdi[m * n1];
      zr = fmaf(a, c, fmaf(-b, s, zr));
      zi = fmaf(a, s, fmaf(b, c, zi));
    }
    const float* cdr = cr + static_cast<size_t>(d) * ku * n1 + k1;
    const float* cdi = ci + static_cast<size_t>(d) * ku * n1 + k1;
    for (int u = 0; u < ku; ++u) {
      const float c = cdr[u * n1];
      const float s = cdi[u * n1];
      er = fmaf(dr[u], c, fmaf(-di[u], s, er));
      ei = fmaf(dr[u], s, fmaf(di[u], c, ei));
    }
    out[fi * bins + p] = make_float2((zr - er) * scale, (zi - ei) * scale);
  }
}

// ---- the direct instance ---------------------------------------------------

constexpr int kMaxTaps = 256;  // taps the direct instance takes (kernel parameter)
constexpr int kFirOut = 8;     // consecutive FIR outputs a thread
constexpr int kFirBlock = 8;   // taps of one register block

struct DirectTaps {
  float2 h[kMaxTaps];
};

// A staged window's slot of sample e' (one pad slot every 32 samples), and an
// FFT buffer's slot of point k (one pad slot every 8 points).
__device__ __forceinline__ int wslot(int e) { return e + (e >> 5); }
__device__ __forceinline__ int fslot(int k) { return k + (k >> 3); }

__device__ __forceinline__ void cp_async8(float2* dst, const float2* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <bool kReal>
__device__ __forceinline__ void fir_mac(float& ar, float& ai, float2 h, float2 v) {
  if constexpr (kReal) {
    ar = fmaf(h.x, v.x, ar);
    ai = fmaf(h.x, v.y, ai);
  } else {
    ar = fmaf(h.x, v.x, fmaf(-h.y, v.y, ar));
    ai = fmaf(h.x, v.y, fmaf(h.y, v.x, ai));
  }
}

__device__ __forceinline__ float2 c_add(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 c_sub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 c_mul(float2 a, float2 b) {
  return make_float2(fmaf(a.x, b.x, -a.y * b.y), fmaf(a.x, b.y, a.y * b.x));
}
__device__ __forceinline__ float2 c_negi(float2 a) {  // a * -i
  return make_float2(a.y, -a.x);
}

// In-register DFT_R, natural order in and out (forward, e^{-2 pi i / R}).
template <int R>
__device__ __forceinline__ void dft(float2* v) {
  if constexpr (R == 2) {
    const float2 a = v[0];
    v[0] = c_add(a, v[1]);
    v[1] = c_sub(a, v[1]);
  } else if constexpr (R == 4) {
    const float2 a0 = c_add(v[0], v[2]), a2 = c_sub(v[0], v[2]);
    const float2 a1 = c_add(v[1], v[3]), a3 = c_negi(c_sub(v[1], v[3]));
    v[0] = c_add(a0, a1);
    v[1] = c_add(a2, a3);
    v[2] = c_sub(a0, a1);
    v[3] = c_sub(a2, a3);
  } else {
    constexpr float kS = 0.70710678118654752f;
    const float2 a0 = c_add(v[0], v[4]), a1 = c_add(v[1], v[5]);
    const float2 a2 = c_add(v[2], v[6]), a3 = c_add(v[3], v[7]);
    const float2 a4 = c_sub(v[0], v[4]);
    const float2 d5 = c_sub(v[1], v[5]);
    const float2 a5 = make_float2((d5.x + d5.y) * kS, (d5.y - d5.x) * kS);  // * W8
    const float2 a6 = c_negi(c_sub(v[2], v[6]));                           // * W8^2
    const float2 d7 = c_sub(v[3], v[7]);
    const float2 a7 = make_float2((d7.y - d7.x) * kS, -(d7.x + d7.y) * kS);  // * W8^3
    const float2 b0 = c_add(a0, a2), b1 = c_add(a1, a3);
    const float2 b2 = c_sub(a0, a2), b3 = c_negi(c_sub(a1, a3));
    const float2 b4 = c_add(a4, a6), b5 = c_add(a5, a7);
    const float2 b6 = c_sub(a4, a6), b7 = c_negi(c_sub(a5, a7));
    v[0] = c_add(b0, b1);
    v[4] = c_sub(b0, b1);
    v[2] = c_add(b2, b3);
    v[6] = c_sub(b2, b3);
    v[1] = c_add(b4, b5);
    v[5] = c_sub(b4, b5);
    v[3] = c_add(b6, b7);
    v[7] = c_sub(b6, b7);
  }
}

// One Stockham pass of radix R over nf frames of n points in place (buffers
// of nb slots each): butterfly j of a frame reads points j + r n/R, twiddles
// point r by W_n^{(j mod ns) r n / (ns R)}, and writes point
// (j / ns) ns R + (j mod ns) + r ns. All reads land in registers before the
// first write (the CTA holds at most 8 n / R butterflies' points: nf n <= 8
// threads).
template <int R, int LOG2R, int kThreads>
__device__ __forceinline__ void fft_pass(float2* buf, int log2n, int nb, int nf, int ns,
                                         int log2ns, const float2* __restrict__ tw) {
  constexpr int kPer = 8 / R;
  const int log2b = log2n - LOG2R;  // butterflies a frame: 2^log2b
  const int total = nf << log2b;
  float2 v[kPer][R];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int bi = threadIdx.x + u * kThreads;
    if (bi < total) {
      const int j = bi & ((1 << log2b) - 1);
      const float2* src = buf + (bi >> log2b) * nb;
#pragma unroll
      for (int r = 0; r < R; ++r) v[u][r] = src[fslot(j + (r << log2b))];
    }
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int bi = threadIdx.x + u * kThreads;
    if (bi < total) {
      const int j = bi & ((1 << log2b) - 1);
      const int jm = j & (ns - 1);
      if (ns > 1) {
        const int e = jm << (log2n - log2ns - LOG2R);
#pragma unroll
        for (int r = 1; r < R; ++r) v[u][r] = c_mul(v[u][r], __ldg(tw + e * r));
      }
      dft<R>(v[u]);
      float2* dst = buf + (bi >> log2b) * nb;
      const int d = ((j >> log2ns) << (log2ns + LOG2R)) + jm;
#pragma unroll
      for (int r = 0; r < R; ++r) dst[fslot(d + (r << log2ns))] = v[u][r];
    }
  }
  __syncthreads();
}

// One CTA takes fpc consecutive frames (of any block rows): stage, FIR at the
// kept outputs, FFT, epilogue. Needs fpc * n <= 8 * kThreads and fpc to
// divide kThreads.
template <int EPI, int kThreads, int kMinBlocks, bool kReal>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
rx_frame_direct_kernel(const float2* __restrict__ x,     // [frames, span]
                       const float2* __restrict__ hist,  // [rows, ku] or null
                       const float2* __restrict__ tw,    // [n] W_n^e
                       void* __restrict__ out, long long frames, int nsym, int dec,
                       int log2n, int k, int fpc, int wp, int nb, float scale,
                       const __grid_constant__ DirectTaps taps) {
  extern __shared__ __align__(16) float2 sm[];
  const int tid = threadIdx.x;
  const int n = 1 << log2n;
  const int ku = k - 1;
  const int span = dec * n;
  const long long f0 = static_cast<long long>(blockIdx.x) * fpc;
  const int nf = static_cast<int>(min(static_cast<long long>(fpc), frames - f0));

  // ---- stage: window slot e' holds sample e' - ku of the frame ----------
  // each of the CTA's frames by kThreads / fpc threads (fpc divides kThreads)
  const int wlen = ku + span;
  const int tpf = fpc == 1 ? kThreads : kThreads / fpc;
  const int js = fpc == 1 ? 0 : tid / tpf;
  if (js < nf) {
    const long long fi = f0 + js;
    const float2* xf = x + fi * span;
    const bool first = fi % nsym == 0;  // frame 0 of a block row
    const float2* hrow = hist == nullptr ? nullptr : hist + (fi / nsym) * ku;
    float2* win = sm + js * wp;
    auto stage = [&](int e) {
      float2* dst = win + wslot(e);
      if (e >= ku || !first) {
        cp_async8(dst, xf + (e - ku));  // this frame, or the previous frame's tail
      } else if (hrow != nullptr) {
        cp_async8(dst, hrow + e);
      } else {
        *dst = make_float2(0.f, 0.f);
      }
    };
    if (fpc == 1) {
      for (int e = tid; e < wlen; e += kThreads) stage(e);  // a compile-time stride
    } else {
      for (int e = tid - js * tpf; e < wlen; e += tpf) stage(e);
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // ---- FIR at the kept outputs: y[m0 + r], r < 8 -------------------------
  const int groups = n / kFirOut;
  const bool active = tid < nf * groups;
  const int jf = tid / groups;
  const int m0 = (tid - jf * groups) * kFirOut;
  float ar[kFirOut], ai[kFirOut];
#pragma unroll
  for (int r = 0; r < kFirOut; ++r) {
    ar[r] = 0.f;
    ai[r] = 0.f;
  }
  if (active) {
    const float2* xw = sm + jf * wp;
    for (int p = 0; p < dec && p < k; ++p) {
      const int qp = (k - p + dec - 1) / dec;  // taps k = dec q + p < K
      int q = 0;
      for (; q + kFirBlock <= qp; q += kFirBlock) {
        // w[i] = x[dec (m0 - q - 7 + i) - p]: output r, tap q + b reads w[r - b + 7]
        float2 w[kFirOut + kFirBlock - 1];
        const int e0 = dec * (m0 - q - (kFirBlock - 1)) - p + ku;
#pragma unroll
        for (int i = 0; i < kFirOut + kFirBlock - 1; ++i) w[i] = xw[wslot(e0 + i * dec)];
#pragma unroll
        for (int b = 0; b < kFirBlock; ++b) {
          const float2 h = taps.h[dec * (q + b) + p];
#pragma unroll
          for (int r = 0; r < kFirOut; ++r) {
            fir_mac<kReal>(ar[r], ai[r], h, w[r - b + kFirBlock - 1]);
          }
        }
      }
      for (; q < qp; ++q) {
        const float2 h = taps.h[dec * q + p];
        const int e0 = dec * (m0 - q) - p + ku;
#pragma unroll
        for (int r = 0; r < kFirOut; ++r) fir_mac<kReal>(ar[r], ai[r], h, xw[wslot(e0 + r * dec)]);
      }
    }
  }
  __syncthreads();  // every window read: the FFT buffers overwrite them
  if (active) {
    float2* fb = sm + jf * nb;
#pragma unroll
    for (int r = 0; r < kFirOut; ++r) fb[fslot(m0 + r)] = make_float2(ar[r], ai[r]);
  }
  __syncthreads();

  // ---- FFT: radix-8 passes, then one radix-4 or radix-2 pass -------------
  int log2ns = 0;
  for (; log2ns + 3 <= log2n; log2ns += 3) {
    fft_pass<8, 3, kThreads>(sm, log2n, nb, nf, 1 << log2ns, log2ns, tw);
  }
  if (log2n - log2ns == 2) {
    fft_pass<4, 2, kThreads>(sm, log2n, nb, nf, 1 << log2ns, log2ns, tw);
  } else if (log2n - log2ns == 1) {
    fft_pass<2, 1, kThreads>(sm, log2n, nb, nf, 1 << log2ns, log2ns, tw);
  }

  // ---- epilogue, natural bin order -----------------------------------------
  if constexpr (EPI == kSpectrum) {
    float2* o = static_cast<float2*>(out) + f0 * n;
    for (int i = tid; i < nf * n; i += kThreads) {
      const float2 z = sm[(i >> log2n) * nb + fslot(i & (n - 1))];
      o[i] = make_float2(z.x * scale, z.y * scale);
    }
  } else {
    constexpr int SPB = (EPI == kBpsk) ? 8 : 4;  // symbols a byte
    const int per = n / SPB;
    uint8_t* o = static_cast<uint8_t*>(out) + f0 * per;
    for (int i = tid; i < nf * per; i += kThreads) {
      const int j = i / per;
      const float2* fb = sm + j * nb;
      const int kb = (i - j * per) * SPB;
      uint32_t byte = 0;
#pragma unroll
      for (int q = 0; q < SPB; ++q) {
        const float2 z = fb[fslot(kb + q)];
        if constexpr (EPI == kQpsk) {
          byte |= (static_cast<uint32_t>(z.x < 0.f) | (static_cast<uint32_t>(z.y < 0.f) << 1))
                  << (2 * q);
        } else {
          byte |= static_cast<uint32_t>(z.x + z.y < 0.f) << q;
        }
      }
      o[i] = static_cast<uint8_t>(byte);
    }
  }
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

template <int EPI, int kThreads, int kMinBlocks>
int launch(const void* x, const void* hist, const void* f1r, const void* f1i,
           const void* gr, const void* gi, const void* cr, const void* ci,
           void* out, long long frames, int nsym, int n1, int n2, int r, int ku,
           float scale, cudaStream_t stream) {
  const size_t smem = (2 * static_cast<size_t>(n1) * n2 + 2 * static_cast<size_t>(ku)) *
                      sizeof(float);
  const int err = set_smem(rx_frame_kernel<EPI, kThreads, kMinBlocks>, smem);
  if (err != 0) return err;
  rx_frame_kernel<EPI, kThreads, kMinBlocks>
      <<<static_cast<unsigned>(frames), kThreads, smem, stream>>>(
      static_cast<const float2*>(x), static_cast<const float2*>(hist),
      static_cast<const float*>(f1r), static_cast<const float*>(f1i),
      static_cast<const float*>(gr), static_cast<const float*>(gi),
      static_cast<const float*>(cr), static_cast<const float*>(ci), out, nsym,
      n1, n2, r, ku, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int kThreads, int kMinBlocks>
int launch_epilogue(int epilogue, const void* x, const void* hist, const void* f1r,
                    const void* f1i, const void* gr, const void* gi, const void* cr,
                    const void* ci, void* out, long long frames, int nsym, int n1,
                    int n2, int r, int ku, float scale, cudaStream_t s) {
  switch (epilogue) {
    case kQpsk:
      return launch<kQpsk, kThreads, kMinBlocks>(x, hist, f1r, f1i, gr, gi, cr, ci, out,
                                                 frames, nsym, n1, n2, r, ku, scale, s);
    case kBpsk:
      return launch<kBpsk, kThreads, kMinBlocks>(x, hist, f1r, f1i, gr, gi, cr, ci, out,
                                                 frames, nsym, n1, n2, r, ku, scale, s);
    case kSpectrum:
      return launch<kSpectrum, kThreads, kMinBlocks>(x, hist, f1r, f1i, gr, gi, cr, ci, out,
                                                     frames, nsym, n1, n2, r, ku, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int launch_instance(int instance, int epilogue, const void* x, const void* hist,
                    const void* f1r, const void* f1i, const void* gr, const void* gi,
                    const void* cr, const void* ci, void* out, long long frames, int nsym,
                    int n1, int n2, int r, int ku, float scale, cudaStream_t s) {
  switch (instance) {
    case 0:
      return launch_epilogue<256, 2>(epilogue, x, hist, f1r, f1i, gr, gi, cr, ci, out,
                                     frames, nsym, n1, n2, r, ku, scale, s);
    case 1:
      return launch_epilogue<512, 1>(epilogue, x, hist, f1r, f1i, gr, gi, cr, ci, out,
                                     frames, nsym, n1, n2, r, ku, scale, s);
    case 2: {
      if (epilogue != kSpectrum) return static_cast<int>(cudaErrorInvalidValue);
      const size_t smem = (4 * static_cast<size_t>(n1) * n2 + 2 * static_cast<size_t>(ku)) *
                          sizeof(float);
      const int err = set_smem(rx_frame_generic_kernel, smem);
      if (err != 0) return err;
      rx_frame_generic_kernel<<<static_cast<unsigned>(frames), kGenericThreads, smem, s>>>(
          static_cast<const float2*>(x), static_cast<const float2*>(hist),
          static_cast<const float*>(f1r), static_cast<const float*>(f1i),
          static_cast<const float*>(gr), static_cast<const float*>(gi),
          static_cast<const float*>(cr), static_cast<const float*>(ci),
          static_cast<float2*>(out), nsym, n1, n2, r, ku, scale);
      return static_cast<int>(cudaGetLastError());
    }
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}


template <int EPI, int kThreads, int kMinBlocks, bool kReal>
int launch_direct(const void* x, const void* hist, const void* tw, void* out,
                  long long frames, int nsym, int dec, int log2n, int k, int fpc, int wp,
                  int nb, float scale, const DirectTaps& taps, size_t smem,
                  cudaStream_t stream) {
  auto kernel = rx_frame_direct_kernel<EPI, kThreads, kMinBlocks, kReal>;
  const int err = set_smem(kernel, smem);
  if (err != 0) return err;
  const long long ctas = (frames + fpc - 1) / fpc;
  kernel<<<static_cast<unsigned>(ctas), kThreads, smem, stream>>>(
      static_cast<const float2*>(x), static_cast<const float2*>(hist),
      static_cast<const float2*>(tw), out, frames, nsym, dec, log2n, k, fpc, wp, nb, scale,
      taps);
  return static_cast<int>(cudaGetLastError());
}

template <int kThreads, int kMinBlocks, bool kReal>
int direct_epilogue(int epilogue, const void* x, const void* hist, const void* tw,
                    void* out, long long frames, int nsym, int dec, int log2n, int k,
                    int fpc, int wp, int nb, float scale, const DirectTaps& taps,
                    size_t smem, cudaStream_t s) {
  switch (epilogue) {
    case kQpsk:
      return launch_direct<kQpsk, kThreads, kMinBlocks, kReal>(
          x, hist, tw, out, frames, nsym, dec, log2n, k, fpc, wp, nb, scale, taps, smem, s);
    case kBpsk:
      return launch_direct<kBpsk, kThreads, kMinBlocks, kReal>(
          x, hist, tw, out, frames, nsym, dec, log2n, k, fpc, wp, nb, scale, taps, smem, s);
    case kSpectrum:
      return launch_direct<kSpectrum, kThreads, kMinBlocks, kReal>(
          x, hist, tw, out, frames, nsym, dec, log2n, k, fpc, wp, nb, scale, taps, smem, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int launch_direct_instance(int epilogue, const void* x, const void* hist, const void* tw,
                           const float* taps_ri, int k, int real_taps, void* out,
                           long long frames, int nsym, int dec, int log2n, int fpc, int wp,
                           int nb, float scale, cudaStream_t s) {
  const int n = 1 << log2n;
  if (k < 1 || k > kMaxTaps || log2n < 3 || fpc < 1 || fpc * n > 8 * 512 || 256 % fpc != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  DirectTaps taps = {};
  for (int i = 0; i < k; ++i) taps.h[i] = make_float2(taps_ri[2 * i], taps_ri[2 * i + 1]);
  const size_t smem = static_cast<size_t>(fpc) * (wp > nb ? wp : nb) * sizeof(float2);
  if (fpc * n > 8 * 256) {
    return real_taps ? direct_epilogue<512, 1, true>(epilogue, x, hist, tw, out, frames, nsym,
                                                     dec, log2n, k, fpc, wp, nb, scale, taps,
                                                     smem, s)
                     : direct_epilogue<512, 1, false>(epilogue, x, hist, tw, out, frames,
                                                      nsym, dec, log2n, k, fpc, wp, nb,
                                                      scale, taps, smem, s);
  }
  return real_taps ? direct_epilogue<256, 3, true>(epilogue, x, hist, tw, out, frames, nsym,
                                                   dec, log2n, k, fpc, wp, nb, scale, taps,
                                                   smem, s)
                   : direct_epilogue<256, 3, false>(epilogue, x, hist, tw, out, frames, nsym,
                                                    dec, log2n, k, fpc, wp, nb, scale, taps,
                                                    smem, s);
}

}  // namespace

// Plain C entry point, loaded with ctypes. instance: 0 tile256, 1 tile512,
// 2 generic. epilogue: 0 QPSK bytes, 1 BPSK bytes, 2 spectrum (the generic
// instance takes the spectrum only). Returns the cudaError_t of the launch
// (0 = success). The caller guarantees: for the tile instances n1 % 8 == 0,
// n2 % 8 == 0 and (n1 / 4) * (n2 / 8) <= the instance's threads, 16-byte
// aligned constants; for every instance 0 <= ku <= n1 * n2, contiguous
// tensors and a shared-memory size within the card's opt-in limit.
// Launches on `stream` of card `device`, which is made current for the
// launch where it is not (and the caller's put back).
extern "C" int rx_frame_launch(int instance, int epilogue, const void* x,
                               const void* hist, const void* f1r, const void* f1i,
                               const void* gr, const void* gi, const void* cr,
                               const void* ci, void* out, long long frames, int nsym,
                               int n1, int n2, int r, int ku, float scale, int device,
                               void* stream) {
  int prev = device;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  const int rc = launch_instance(instance, epilogue, x, hist, f1r, f1i, gr, gi, cr, ci, out,
                                 frames, nsym, n1, n2, r, ku, scale,
                                 static_cast<cudaStream_t>(stream));
  if (prev != device) cudaSetDevice(prev);
  return rc;
}

// Plain C entry point of the direct instance, loaded with ctypes. taps_ri:
// a host array of k complex taps as (re, im) float pairs, k <= 256;
// real_taps: every imaginary part is exactly 0 (the real-tap variant); tw:
// the float32 table W_n^e, e < n, of n = 2^log2n points on the card. A CTA
// takes fpc consecutive frames (a power of two, fpc * n <= 4,096; 512
// threads where fpc * n > 2,048, else 256); wp and nb: the float2 slots of a frame's staged window
// (wslot(K-2 + span) + 1) and FFT buffer (n + n / 8). Returns the
// cudaError_t of the launch (0 = success). The caller guarantees contiguous
// tensors and fpc * max(wp, nb) * 8 bytes within the opt-in shared memory.
extern "C" int rx_frame_direct_launch(int epilogue, const void* x, const void* hist,
                                      const void* tw, const float* taps_ri, int k,
                                      int real_taps, void* out, long long frames, int nsym,
                                      int dec, int log2n, int fpc, int wp, int nb,
                                      float scale, int device, void* stream) {
  int prev = device;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  const int rc = launch_direct_instance(epilogue, x, hist, tw, taps_ri, k, real_taps, out,
                                        frames, nsym, dec, log2n, fpc, wp, nb, scale,
                                        static_cast<cudaStream_t>(stream));
  if (prev != device) cudaSetDevice(prev);
  return rc;
}
