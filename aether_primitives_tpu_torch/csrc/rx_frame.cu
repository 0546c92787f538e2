// RX frame kernel for Hopper (sm_90a): causal FIR -> decimate -> frame FFT
// -> hard demod (cli.py numpy_reference_spectra plus the sign demod).
//
// Replaces the TPU kernel aether_primitives_tpu/ops/pallas/rx_frame.py:_kernel
// and the epilogue of models/modem.py RxChain._bits_fast. The TPU kernel
// factorises the frame op for its matrix unit (a DFT_{n1} contraction, a G'
// contraction folding taps, twiddles, DFT_{n2} and decimation, and a wrap
// correction). This kernel computes the function itself, per frame of
// span = dec * n samples:
//   y[m] = sum_k h[k] x[dec m - k],   m < n = fft_len
// (x before the frame: the previous frame's tail, or the carried history for
// frame 0 of a block row, or zeros), then an n-point FFT written by hand in
// shared memory, then one of three epilogues, natural bin k:
//   QPSK      4 symbols per byte, LSB-first, bits (re < 0) | (im < 0) << 1
//   BPSK      8 symbols per byte, LSB-first, bit  re + im < 0
//   SPECTRUM  complex64 bins times the Scale.SN factor (the EVM gate reads it)
// Comparisons are strict; a positive scale never flips a sign, so the bit
// epilogues skip it. Everything is FP32 FMA: TF32 or bf16 would fail the
// -80 dB EVM gate.
//
// What bounds it on an H100: the bytes. A 4M block is 33.55 MB in and
// 262,144 QPSK bytes out (0.0101 ms at 3.35 TB/s) at every decimation; with
// the chain's default 16 dec + 1 taps the FIR is about 16 real-tap
// multiply-adds per input sample (0.27-0.55 G FP32 operations a block) and
// the FFTs 5 n log2 n a frame, 0.004-0.009 ms at the 67 TFLOP/s FP32 peak.
//
// Three instances, picked by the wrapper (ops/cuda/rx_frame.py kernel_plan):
//   direct    fft_len 12-4096 (powers of two from 64), at most 256 taps, whole
//             frames staged within shared memory (the main path, dec 4 /
//             fft_len 2048; fft_len 30, 131, 192, 3072 through the mixed-radix
//             FFT, kMixed): below;
//   chunked   any other frame of at most 4,096 points whose span suits one
//             CTA (dec 16-64 with their 257-1,025 taps, fft_len 16 and 32, a
//             32,768-sample span at dec 8): the FIR's input staged in chunks,
//             taps through L1, the mixed-radix FFT (rx_frame_general_kernel);
//   cluster   larger frames or spans (fft_len 8,192-65,536, dec 64 at
//             fft_len >= 1024): 2-8 CTAs of a thread-block cluster share a
//             frame through distributed shared memory, with a four-step FFT;
//   global    every other frame (past 65,536 points, or past 4,096 with no
//             cluster split: 4,099, 8,198, 16,411): one cooperative launch,
//             frames of up to 16,384 FFT points whole in a CTA's shared
//             memory, larger ones a four-step split through one device
//             scratch buffer (rx_frame_global_kernel).
//
// The direct instance:
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
//
// The mixed-radix FFT (gen_fft) adds radix 3 and 5 passes and a pass by the
// definition of the p-point DFT for any other prime (O(p) a point) to the
// Stockham sequence, index arithmetic by a float-reciprocal divider (Div).
// The chunked and cluster instances keep the direct one's arithmetic and lift
// its limits: a CTA's shared memory holds its frames' FFT buffers and two
// windows of one chunk of outputs (any dec; a tap count past what a window
// holds is staged in ranges), the taps come through L1 (any count), and a
// frame beyond one CTA is split over a cluster. See rx_frame_general_kernel.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kMaxPasses = 20;
constexpr int kMaxLevels = 4;

// The global instance's plan (ops/cuda/rx_frame.py global_layout; the ctypes
// mirror's field order, GlobalPlan).
struct GlobalPlan {
  long long n;    // fft_len
  long long m;    // the FFT's points: n (a power of two), or Bluestein's power of two >= 2n - 1
  int dec;
  int k;          // taps
  int bluestein;  // 1: chirp, m-point FFT, the filter's spectrum, inverse FFT, chirp
  int levels;     // 1: whole frames in a CTA's tile; 2-4: the four-step levels of m
  int lp[kMaxLevels];  // log2 of level i's points P_i (level 0 the outermost)
  int lt[kMaxLevels];  // log2 of level i's sequences a tile T_i
  int tile;       // float2 slots of the tile buffer
  int split;      // FIR: threads that share a group's 8 outputs
  int chunk;      // FIR: outputs a chunk (8 threads / split)
  int kt;         // FIR: taps a staged range
  int win;        // FIR: float2 slots of one of the two windows (0: x read through L1)
  int log2q;      // log2 of the largest level's points Q (the twiddles W_Q)
  int h;          // log2 of the size of the low table of W_m (levels >= 2)
  int hq;         // log2 of the size of the low table of W_Q
  int twoff;      // float2 slot of the tables of W_Q in shared memory (after the
                  // tile and the windows; past one level, the windows and a chunk)
  int sub;        // Bluestein's sub-transforms of a frame in one CTA (m / 2^lp[0]), or 1
};

// The launch geometry of the chunked and cluster instances (ops/cuda/rx_frame.py
// general_layout builds it; the field order is the ctypes mirror's, GenPlan).
struct GenPlan {
  int n;      // fft_len
  int dec;    // decimation
  int k;      // taps
  int kt;     // taps a staged range (all of them where the window fits)
  int fpc;    // frames a CTA (1 in a cluster)
  int q;      // CTAs a frame: 1, or the cluster's size
  int lp;     // FIR outputs a CTA computes of a frame (a multiple of 8)
  int split;  // threads that share a group's 8 outputs (a power of two, <= 32)
  int chunk;  // outputs staged at once: 8 * threads / split
  int win;    // float2 slots of one of the two window buffers
  int fbuf;   // float2 slots of the FFT buffer
  int nb1;    // frame stride of the first FFT (a frame; a cluster's column of a)
  int nb2;    // a cluster: stride of a row of b points
  int a, b;   // a cluster's four-step split n = a * b (one CTA: n, 1)
  int np1, np2;
  int rad1[kMaxPasses];  // the first FFT's radices (2, 3, 4, 5, 8 or another prime)
  int rad2[kMaxPasses];  // a cluster's second FFT's
};

namespace {

namespace cg = cooperative_groups;

enum Epilogue { kQpsk = 0, kBpsk = 1, kSpectrum = 2 };

// ---- the direct instance ---------------------------------------------------

constexpr int kMaxTaps = 256;  // taps the direct instance takes (kernel parameter)
constexpr int kFirOut = 8;     // consecutive FIR outputs a thread
constexpr int kFirBlock = 8;   // taps of one register block

struct DirectTaps {
  float2 h[kMaxTaps];
  int n;                 // fft_len (the mixed-radix variant; else 2^log2n)
  int npass;             // its FFT passes and their radices
  int rad[kMaxPasses];
};

constexpr int kDirectPoints = 8;  // points a thread through a mixed-radix pass

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
  } else if constexpr (R == 3) {
    constexpr float kS = 0.86602540378443865f;  // sin(2 pi / 3)
    const float2 t = c_add(v[1], v[2]);
    const float2 d = c_sub(v[1], v[2]);
    const float2 m = make_float2(fmaf(-0.5f, t.x, v[0].x), fmaf(-0.5f, t.y, v[0].y));
    const float2 r = make_float2(kS * d.y, -kS * d.x);  // -i sin(2 pi / 3) (v1 - v2)
    v[0] = c_add(v[0], t);
    v[1] = c_add(m, r);
    v[2] = c_sub(m, r);
  } else if constexpr (R == 5) {
    constexpr float kC1 = 0.30901699437494742f;   // cos(2 pi / 5)
    constexpr float kC2 = -0.80901699437494742f;  // cos(4 pi / 5)
    constexpr float kS1 = 0.95105651629515357f;   // sin(2 pi / 5)
    constexpr float kS2 = 0.58778525229247313f;   // sin(4 pi / 5)
    const float2 t1 = c_add(v[1], v[4]), t2 = c_add(v[2], v[3]);
    const float2 t3 = c_sub(v[1], v[4]), t4 = c_sub(v[2], v[3]);
    const float2 a1 = make_float2(fmaf(kC1, t1.x, fmaf(kC2, t2.x, v[0].x)),
                                  fmaf(kC1, t1.y, fmaf(kC2, t2.y, v[0].y)));
    const float2 a2 = make_float2(fmaf(kC2, t1.x, fmaf(kC1, t2.x, v[0].x)),
                                  fmaf(kC2, t1.y, fmaf(kC1, t2.y, v[0].y)));
    const float2 b1 = make_float2(fmaf(kS1, t3.x, kS2 * t4.x), fmaf(kS1, t3.y, kS2 * t4.y));
    const float2 b2 = make_float2(fmaf(kS2, t3.x, -kS1 * t4.x), fmaf(kS2, t3.y, -kS1 * t4.y));
    v[0] = c_add(v[0], c_add(t1, t2));
    v[1] = c_add(a1, c_negi(b1));  // a - i b
    v[4] = c_sub(a1, c_negi(b1));
    v[2] = c_add(a2, c_negi(b2));
    v[3] = c_sub(a2, c_negi(b2));
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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x / d for 0 <= x < 2^22 by a float reciprocal and one correction (the
// product's error is under 1): the index arithmetic of the chunked and
// cluster instances divides by run-time sizes.
struct Div {
  int d;
  float r;
  __device__ __forceinline__ explicit Div(int d_) : d(d_), r(1.0f / static_cast<float>(d_)) {}
  __device__ __forceinline__ int operator()(int x) const {
    int q = __float2int_rz(__int2float_rn(x) * r);
    const int rem = x - q * d;
    return q + (rem >= d) - (rem < 0);
  }
};

// One Stockham pass of radix R (2, 3, 4, 5, 8) over nf frames of n points in
// place (frame stride nb): butterfly j of a frame reads points j + r n/R,
// twiddles point r by W_n^{(j mod ns) r n / (ns R)}, and writes point
// (j / ns) ns R + (j mod ns) + r ns. tw is a table of W_N^e with N = n tstride.
// Every read lands in registers before the first write (the plan keeps nf n
// within threads * kPoints points; a thread holds ceil(kPoints / R) butterflies).
template <int R, int kThreads, int kPoints>
__device__ __forceinline__ void gen_pass(float2* buf, int n, int nb, int nf, int ns,
                                         const float2* __restrict__ tw, int tstride) {
  constexpr int kPer = (kPoints + R - 1) / R;
  const int nbf = n / R;  // butterflies a frame
  const int total = nf * nbf;
  const Div by_nbf(nbf), by_ns(ns);
  float2 v[kPer][R];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int bi = threadIdx.x + u * kThreads;
    if (bi < total) {
      const int f = by_nbf(bi);
      const int j = bi - f * nbf;
      const float2* src = buf + f * nb;
#pragma unroll
      for (int r = 0; r < R; ++r) v[u][r] = src[fslot(j + r * nbf)];
    }
  }
  __syncthreads();
  const int step = n / (ns * R) * tstride;
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int bi = threadIdx.x + u * kThreads;
    if (bi < total) {
      const int f = by_nbf(bi);
      const int j = bi - f * nbf;
      const int jd = by_ns(j);
      const int jm = j - jd * ns;
      if (ns > 1) {
        const int e = jm * step;
#pragma unroll
        for (int r = 1; r < R; ++r) v[u][r] = c_mul(v[u][r], __ldg(tw + e * r));
      }
      dft<R>(v[u]);
      float2* dst = buf + f * nb;
      const int d = jd * ns * R + jm;
#pragma unroll
      for (int r = 0; r < R; ++r) dst[fslot(d + r * ns)] = v[u][r];
    }
  }
  __syncthreads();
}

// A pass of any other prime radix p, by the definition of the p-point DFT:
// output k of butterfly j is sum_r x[j + r n/p] W_n^{r (n / (ns p)) (j mod ns
// + k ns)}, one output point a thread at a time (kPoints of them held).
template <int kThreads, int kPoints>
__device__ __forceinline__ void prime_pass(float2* buf, int n, int nb, int nf, int ns, int p,
                                           const float2* __restrict__ tw, int tstride) {
  const int np = n / p;
  const int total = nf * n;
  const Div by_n(n), by_p(p), by_ns(ns);
  float2 acc[kPoints];
#pragma unroll
  for (int u = 0; u < kPoints; ++u) {
    const int pt = threadIdx.x + u * kThreads;
    if (pt < total) {
      const int f = by_n(pt);
      const int w = pt - f * n;
      const int j = by_p(w);
      const int k = w - j * p;
      const int jm = j - by_ns(j) * ns;
      const int step = np / ns * (jm + k * ns);  // < n
      const float2* src = buf + f * nb;
      float2 a = src[fslot(j)];
      int e = step;
      for (int r = 1; r < p; ++r) {
        const float2 t = __ldg(tw + e * tstride);
        const float2 y = src[fslot(j + r * np)];
        a.x = fmaf(y.x, t.x, fmaf(-y.y, t.y, a.x));
        a.y = fmaf(y.x, t.y, fmaf(y.y, t.x, a.y));
        e += step;
        if (e >= n) e -= n;
      }
      acc[u] = a;
    }
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kPoints; ++u) {
    const int pt = threadIdx.x + u * kThreads;
    if (pt < total) {
      const int f = by_n(pt);
      const int w = pt - f * n;
      const int j = by_p(w);
      const int k = w - j * p;
      const int jd = by_ns(j);
      const int jm = j - jd * ns;
      buf[f * nb + fslot(jd * ns * p + jm + k * ns)] = acc[u];
    }
  }
  __syncthreads();
}

// The mixed-radix Stockham FFT of nf frames of n points in place, bins in
// natural order, passes in the plan's order.
template <int kThreads, int kPoints>
__device__ __forceinline__ void gen_fft(float2* buf, int n, int nb, int nf, const int* rad,
                                        int npass, const float2* __restrict__ tw, int tstride) {
  int ns = 1;
  for (int i = 0; i < npass; ++i) {
    const int r = rad[i];
    switch (r) {
      case 8: gen_pass<8, kThreads, kPoints>(buf, n, nb, nf, ns, tw, tstride); break;
      case 4: gen_pass<4, kThreads, kPoints>(buf, n, nb, nf, ns, tw, tstride); break;
      case 2: gen_pass<2, kThreads, kPoints>(buf, n, nb, nf, ns, tw, tstride); break;
      case 3: gen_pass<3, kThreads, kPoints>(buf, n, nb, nf, ns, tw, tstride); break;
      case 5: gen_pass<5, kThreads, kPoints>(buf, n, nb, nf, ns, tw, tstride); break;
      default: prime_pass<kThreads, kPoints>(buf, n, nb, nf, ns, r, tw, tstride); break;
    }
    ns *= r;
  }
}

// One CTA takes fpc consecutive frames (of any block rows): stage, FIR at the
// kept outputs, FFT, epilogue. Needs fpc * n <= 8 * kThreads (n rounded up to
// a multiple of 8) and fpc to divide kThreads. kMixed: fft_len no power of
// two (taps.n; the FFT of the chunked instance, taps.rad), else 2^log2n.
template <int EPI, int kThreads, int kMinBlocks, bool kReal, bool kMixed>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
rx_frame_direct_kernel(const float2* __restrict__ x,     // [frames, span]
                       const float2* __restrict__ hist,  // [rows, ku] or null
                       const float2* __restrict__ tw,    // [n] W_n^e
                       void* __restrict__ out, long long frames, int nsym, int dec,
                       int log2n, int k, int fpc, int wp, int nb, float scale,
                       const __grid_constant__ DirectTaps taps) {
  extern __shared__ __align__(16) float2 sm[];
  const int tid = threadIdx.x;
  const int n = kMixed ? taps.n : 1 << log2n;
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
  // (the mixed-radix variant rounds a frame up to whole groups of 8; the
  // outputs past n read slots past the frame's samples and are dropped)
  const int groups = kMixed ? (n + kFirOut - 1) / kFirOut : n / kFirOut;
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
    for (int r = 0; r < kFirOut; ++r) {
      if (!kMixed || m0 + r < n) fb[fslot(m0 + r)] = make_float2(ar[r], ai[r]);
    }
  }
  __syncthreads();

  // ---- FFT: radix-8 passes, then one radix-4 or radix-2 pass -------------
  if constexpr (kMixed) {
    gen_fft<kThreads, kDirectPoints>(sm, n, nb, nf, taps.rad, taps.npass, tw, 1);
  } else {
    int log2ns = 0;
    for (; log2ns + 3 <= log2n; log2ns += 3) {
      fft_pass<8, 3, kThreads>(sm, log2n, nb, nf, 1 << log2ns, log2ns, tw);
    }
    if (log2n - log2ns == 2) {
      fft_pass<4, 2, kThreads>(sm, log2n, nb, nf, 1 << log2ns, log2ns, tw);
    } else if (log2n - log2ns == 1) {
      fft_pass<2, 1, kThreads>(sm, log2n, nb, nf, 1 << log2ns, log2ns, tw);
    }
  }

  // ---- epilogue, natural bin order -----------------------------------------
  if constexpr (EPI == kSpectrum) {
    float2* o = static_cast<float2*>(out) + f0 * n;
    for (int i = tid; i < nf * n; i += kThreads) {
      float2 z;
      if constexpr (kMixed) {
        const int j = Div(n)(i);
        z = sm[j * nb + fslot(i - j * n)];
      } else {
        z = sm[(i >> log2n) * nb + fslot(i & (n - 1))];
      }
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

// ---- the chunked and cluster instances -------------------------------------

// One group's (phase, block of 8 taps) items of the chunked and cluster
// instances (see rx_frame_general_kernel): outputs o + r, r < 8, of the taps
// [k0, k1) read window slots wslot(ob + dec r - kk); items s, s + S, ...
template <bool kReal>
__device__ __forceinline__ void fir_items(const float2* win, const float2* __restrict__ taps,
                                          int ob, int dec, int k0, int k1, int s, int S,
                                          const Div& by_dec, float* ar, float* ai) {
  const int nqb = (by_dec(k1 - k0 + dec - 1) + kFirBlock - 1) / kFirBlock;
  for (int item = s; item < dec * nqb; item += S) {
    const int b = by_dec(item);
    const int p = item - b * dec;
    const int qlo = k0 > p ? by_dec(k0 - p + dec - 1) : 0;  // taps dec q + p in [k0, k1)
    const int qhi = k1 > p ? by_dec(k1 - p + dec - 1) : 0;
    const int q0 = qlo + kFirBlock * b;
    if (q0 >= qhi) continue;
    if (q0 + kFirBlock <= qhi) {
      // w[i] = window at ob + dec (i - 7) - (dec q0 + p): output r, tap q0 + bb
      // reads w[r - bb + 7]
      float2 w[kFirOut + kFirBlock - 1];
      const int e0 = ob - dec * (q0 + kFirBlock - 1) - p;
#pragma unroll
      for (int i = 0; i < kFirOut + kFirBlock - 1; ++i) w[i] = win[wslot(e0 + i * dec)];
#pragma unroll
      for (int bb = 0; bb < kFirBlock; ++bb) {
        const float2 h = __ldg(taps + dec * (q0 + bb) + p);
#pragma unroll
        for (int r = 0; r < kFirOut; ++r) {
          fir_mac<kReal>(ar[r], ai[r], h, w[r - bb + kFirBlock - 1]);
        }
      }
    } else {
      for (int q = q0; q < qhi; ++q) {
        const float2 h = __ldg(taps + dec * q + p);
        const int e0 = ob - dec * q - p;
#pragma unroll
        for (int r = 0; r < kFirOut; ++r) {
          fir_mac<kReal>(ar[r], ai[r], h, win[wslot(e0 + r * dec)]);
        }
      }
    }
  }
}

// The bit epilogues' byte of 4 (QPSK) or 8 (BPSK) consecutive bins, bin q at(q).
template <typename At>
__device__ __forceinline__ uint8_t demod_byte(int epi, At at) {
  uint32_t byte = 0;
  if (epi == kQpsk) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 z = at(q);
      byte |= (static_cast<uint32_t>(z.x < 0.f) | (static_cast<uint32_t>(z.y < 0.f) << 1))
              << (2 * q);
    }
  } else {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const float2 z = at(q);
      byte |= static_cast<uint32_t>(z.x + z.y < 0.f) << q;
    }
  }
  return static_cast<uint8_t>(byte);
}

// The chunked (kCluster false) and cluster (kCluster true) instances. A CTA
// computes lp FIR outputs of each of its frames (fpc whole frames; in a
// cluster, the outputs [rank lp, (rank + 1) lp) of the cluster's frame):
//   - in chunks of `chunk` consecutive outputs (of consecutive frames), and
//     tap ranges of `kt` taps, each staged as one window per frame it touches
//     (the samples dec m - k the range's taps read for the chunk's outputs m,
//     the previous frame's tail, the carried history or zeros), by 8-byte
//     cp.async into two buffers: the next chunk loads while this one computes;
//   - `split` threads share a group of 8 consecutive outputs, taking the
//     (phase, block of 8 taps) items of the polyphase split k = dec q + p in
//     turn (15 samples in registers serve 64 multiply-adds, as in the direct
//     instance), then sum over the group's lanes by shuffles; taps come
//     through L1 (any count);
//   - one CTA: the outputs go to its frames' FFT buffers, then the mixed-radix
//     FFT and the epilogue;
//   - a cluster: output m = b m1 + m2 goes to the CTA that owns column m2
//     (b / q columns each, a points a column) through distributed shared
//     memory; each CTA FFTs its columns (a points), twiddles by W_n^{m2 k1}
//     as it gathers its a / q rows k1 of all b columns from the cluster, FFTs
//     the rows (b points), and writes bins k1 + a k2.
template <int kThreads, int kMinBlocks, int kPoints, bool kCluster>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
rx_frame_general_kernel(const float2* __restrict__ x,     // [frames, span]
                        const float2* __restrict__ hist,  // [rows, ku] or null
                        const float2* __restrict__ tw,    // [n] W_n^e
                        const float2* __restrict__ taps,  // [k]
                        void* __restrict__ out, long long frames, int nsym, float scale,
                        int epi, int real_taps, const __grid_constant__ GenPlan plan) {
  extern __shared__ __align__(16) float2 sm[];
  const int tid = threadIdx.x;
  const int n = plan.n, dec = plan.dec, k = plan.k;
  const int ku = k - 1;
  const int span = dec * n;
  const int lp = plan.lp;
  float2* fbuf = sm;

  long long f0;
  int nf, rank = 0;
  if constexpr (kCluster) {
    rank = static_cast<int>(cg::this_cluster().block_rank());
    f0 = blockIdx.x / plan.q;
    nf = 1;
    cg::this_cluster().sync();  // every CTA runs before one writes into another
  } else {
    f0 = static_cast<long long>(blockIdx.x) * plan.fpc;
    nf = static_cast<int>(min(static_cast<long long>(plan.fpc), frames - f0));
  }
  const int m_base = rank * lp;  // the CTA's first output of its frame(s)

  // ---- FIR at the kept outputs -----------------------------------------
  const int total_out = nf * lp;
  const int chunk = plan.chunk;
  const int nkr = (k + plan.kt - 1) / plan.kt;
  const int iters = (total_out + chunk - 1) / chunk * nkr;
  const int S = plan.split;
  const int g = tid / S;
  const int s = tid - g * S;

  // frame f0's block row and frame index in it: a sample before a frame's
  // start comes from the previous frame unless the frame opens its row
  const long long row0 = f0 / nsym;
  const int col0 = static_cast<int>(f0 - row0 * nsym);

  auto stage = [&](int it) {
    const int c = it / nkr;
    const int k0 = (it - c * nkr) * plan.kt;
    const int k1 = min(k, k0 + plan.kt);
    const int kr = k1 - k0;
    const int o0 = c * chunk;
    const int o1 = min(o0 + chunk, total_out);
    float2* win = sm + plan.fbuf + (it & 1) * plan.win;
    // one window a frame the chunk touches: the first from o0, the others
    // from a frame's first output; wl0 and wlf samples
    const int jf0 = o0 / lp;
    const int wl0 = dec * (min(o1, (jf0 + 1) * lp) - o0 - 1) + kr;
    const int wlf = dec * (lp - 1) + kr;
    const int pieces = (o1 - 1) / lp - jf0 + 1;
    const int total = dec * (o1 - o0 - pieces) + pieces * kr;
    const Div by_wlf(wlf);
    for (int idx = tid; idx < total; idx += kThreads) {
      int t = 0, e = idx;
      if (idx >= wl0) {
        t = 1 + by_wlf(idx - wl0);
        e = idx - wl0 - (t - 1) * wlf;
      }
      const int jf = jf0 + t;
      const int ps = t == 0 ? o0 : jf * lp;
      const int base = dec * (ps - o0) + t * (kr - dec);
      // sample i of frame f0 + jf, -ku <= i
      const int i = dec * (m_base + ps - jf * lp) - (k1 - 1) + e;
      float2* dst = win + wslot(base + e);
      const float2* xf = x + (f0 + jf) * span;
      if (i >= span) {
        *dst = make_float2(0.f, 0.f);  // past the frame: padded outputs only
      } else if (i >= 0) {
        cp_async8(dst, xf + i);
      } else {
        const int col = col0 + jf;
        const int rc = col / nsym;
        if (col - rc * nsym != 0) {
          cp_async8(dst, xf + i);  // the previous frame's tail
        } else if (hist != nullptr) {
          cp_async8(dst, hist + (row0 + rc) * ku + ku + i);  // the carried history
        } else {
          *dst = make_float2(0.f, 0.f);
        }
      }
    }
    cp_async_commit();
  };

  const Div by_dec(dec), by_lp(lp), by_b(plan.b), by_bq(plan.b / plan.q);
  float ar[kFirOut], ai[kFirOut];
  stage(0);
  for (int it = 0; it < iters; ++it) {
    if (it + 1 < iters) {
      stage(it + 1);
      cp_async_wait_group<1>();
    } else {
      cp_async_wait_group<0>();
    }
    __syncthreads();
    const int c = it / nkr;
    const int kr = it - c * nkr;
    const int k0 = kr * plan.kt;
    const int k1 = min(k, k0 + plan.kt);
    const int o0 = c * chunk;
    const int o1 = min(o0 + chunk, total_out);
    const int o = o0 + kFirOut * g;  // the group's first output
    if (kr == 0) {
#pragma unroll
      for (int r = 0; r < kFirOut; ++r) {
        ar[r] = 0.f;
        ai[r] = 0.f;
      }
    }
    if (o < o1) {
      const float2* win = sm + plan.fbuf + (it & 1) * plan.win;
      const int t = by_lp(o) - by_lp(o0);  // the group's window in the chunk
      // window slot of output o + r, tap kk: wslot(ob + dec r - kk)
      const int ob = dec * (o - o0) + t * (k1 - k0 - dec) + (k1 - 1);
      if (real_taps) {
        fir_items<true>(win, taps, ob, dec, k0, k1, s, S, by_dec, ar, ai);
      } else {
        fir_items<false>(win, taps, ob, dec, k0, k1, s, S, by_dec, ar, ai);
      }
    }
    if (kr == nkr - 1) {
      // the group's lanes are S consecutive lanes of one warp: sum them
      for (int off = S >> 1; off > 0; off >>= 1) {
#pragma unroll
        for (int r = 0; r < kFirOut; ++r) {
          ar[r] += __shfl_xor_sync(0xffffffffu, ar[r], off);
          ai[r] += __shfl_xor_sync(0xffffffffu, ai[r], off);
        }
      }
      if (o < o1) {
        const int jf = by_lp(o);
        const int m = o - jf * lp + m_base;  // output index in the frame
#pragma unroll
        for (int r = 0; r < kFirOut; ++r) {
          if (S <= kFirOut ? (r & (S - 1)) == s : r == s) {
            const float2 y = make_float2(ar[r], ai[r]);
            if constexpr (kCluster) {
              const int mm = m + r;
              const int m1 = by_b(mm);
              const int m2 = mm - m1 * plan.b;
              const int dst = by_bq(m2);
              float2* rb = cg::this_cluster().map_shared_rank(fbuf, dst);
              rb[(m2 - dst * by_bq.d) * plan.nb1 + fslot(m1)] = y;
            } else {
              if (m + r < n) fbuf[jf * plan.nb1 + fslot(m + r)] = y;
            }
          }
        }
      }
    }
    __syncthreads();  // the window is read: the load two iterations on may overwrite it
  }

  // ---- FFT ------------------------------------------------------------------
  if constexpr (kCluster) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every output is in its column's CTA
    const int a = plan.a, b = plan.b, q = plan.q;
    const int aq = a / q, bq = b / q;
    gen_fft<kThreads, kPoints>(fbuf, a, plan.nb1, bq, plan.rad1, plan.np1, tw, b);  // columns
    cluster.sync();  // every CTA's columns are transformed
    // gather rows k1 of this CTA from every column, twiddled by W_n^{m2 k1}
    const int pts = aq * b;
    const Div by_b(b), by_bq(bq);
    float2 v[kPoints];
#pragma unroll
    for (int u = 0; u < kPoints; ++u) {
      const int pt = tid + u * kThreads;
      if (pt < pts) {
        const int k1l = by_b(pt);
        const int m2 = pt - k1l * b;
        const int src = by_bq(m2);
        const int k1 = rank * aq + k1l;
        const float2* rb = cluster.map_shared_rank(fbuf, src);
        v[u] = c_mul(rb[(m2 - src * bq) * plan.nb1 + fslot(k1)], __ldg(tw + k1 * m2));
      }
    }
    cluster.sync();  // every CTA has read what it needs: buffers may be overwritten
#pragma unroll
    for (int u = 0; u < kPoints; ++u) {
      const int pt = tid + u * kThreads;
      if (pt < pts) {
        const int k1l = by_b(pt);
        fbuf[k1l * plan.nb2 + fslot(pt - k1l * b)] = v[u];
      }
    }
    __syncthreads();
    gen_fft<kThreads, kPoints>(fbuf, b, plan.nb2, aq, plan.rad2, plan.np2, tw, a);  // rows
    // ---- epilogue: bin k1 + a k2 -------------------------------------------
    if (epi == kSpectrum) {
      float2* o = static_cast<float2*>(out) + f0 * n + rank * aq;
      const Div by_aq(aq);
      for (int i = tid; i < pts; i += kThreads) {
        const int k2 = by_aq(i);
        const int k1l = i - k2 * aq;
        const float2 z = fbuf[k1l * plan.nb2 + fslot(k2)];
        o[k1l + a * k2] = make_float2(z.x * scale, z.y * scale);
      }
    } else {
      const int spb = epi == kBpsk ? 8 : 4;  // symbols a byte
      const int per = aq / spb;
      uint8_t* o = static_cast<uint8_t*>(out) + f0 * (n / spb) + rank * per;
      const Div by_per(per);
      for (int i = tid; i < per * b; i += kThreads) {
        const int k2 = by_per(i);
        const int kb = (i - k2 * per) * spb;
        o[kb / spb + (a / spb) * k2] =
            demod_byte(epi, [&](int q) { return fbuf[(kb + q) * plan.nb2 + fslot(k2)]; });
      }
    }
  } else {
    gen_fft<kThreads, kPoints>(fbuf, n, plan.nb1, nf, plan.rad1, plan.np1, tw, 1);
    // ---- epilogue, natural bin order ---------------------------------------
    if (epi == kSpectrum) {
      float2* o = static_cast<float2*>(out) + f0 * n;
      const Div by_n(n);
      for (int i = tid; i < nf * n; i += kThreads) {
        const int j = by_n(i);
        const float2 z = fbuf[j * plan.nb1 + fslot(i - j * n)];
        o[i] = make_float2(z.x * scale, z.y * scale);
      }
    } else {
      const int spb = epi == kBpsk ? 8 : 4;
      const int per = n / spb;
      uint8_t* o = static_cast<uint8_t*>(out) + f0 * per;
      const Div by_per(per);
      for (int i = tid; i < nf * per; i += kThreads) {
        const int j = by_per(i);
        const float2* fb = fbuf + j * plan.nb1;
        const int kb = (i - j * per) * spb;
        o[i] = demod_byte(epi, [&](int q) { return fb[fslot(kb + q)]; });
      }
    }
  }
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

template <int EPI, int kThreads, int kMinBlocks, bool kReal, bool kMixed>
int launch_direct(const void* x, const void* hist, const void* tw, void* out,
                  long long frames, int nsym, int dec, int log2n, int k, int fpc, int wp,
                  int nb, float scale, const DirectTaps& taps, size_t smem,
                  cudaStream_t stream) {
  auto kernel = rx_frame_direct_kernel<EPI, kThreads, kMinBlocks, kReal, kMixed>;
  const int err = set_smem(kernel, smem);
  if (err != 0) return err;
  const long long ctas = (frames + fpc - 1) / fpc;
  kernel<<<static_cast<unsigned>(ctas), kThreads, smem, stream>>>(
      static_cast<const float2*>(x), static_cast<const float2*>(hist),
      static_cast<const float2*>(tw), out, frames, nsym, dec, log2n, k, fpc, wp, nb, scale,
      taps);
  return static_cast<int>(cudaGetLastError());
}

template <int kThreads, int kMinBlocks, bool kReal, bool kMixed>
int direct_epilogue(int epilogue, const void* x, const void* hist, const void* tw,
                    void* out, long long frames, int nsym, int dec, int log2n, int k,
                    int fpc, int wp, int nb, float scale, const DirectTaps& taps,
                    size_t smem, cudaStream_t s) {
  switch (epilogue) {
    case kQpsk:
      return launch_direct<kQpsk, kThreads, kMinBlocks, kReal, kMixed>(
          x, hist, tw, out, frames, nsym, dec, log2n, k, fpc, wp, nb, scale, taps, smem, s);
    case kBpsk:
      return launch_direct<kBpsk, kThreads, kMinBlocks, kReal, kMixed>(
          x, hist, tw, out, frames, nsym, dec, log2n, k, fpc, wp, nb, scale, taps, smem, s);
    case kSpectrum:
      return launch_direct<kSpectrum, kThreads, kMinBlocks, kReal, kMixed>(
          x, hist, tw, out, frames, nsym, dec, log2n, k, fpc, wp, nb, scale, taps, smem, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// 512 threads where a CTA's frames pass 2,048 points, else 256 (three CTAs
// an SM for the power-of-two FFT, two for the mixed-radix one).
template <bool kMixed>
int direct_width(int epilogue, int real_taps, const void* x, const void* hist, const void* tw,
                 void* out, long long frames, int nsym, int dec, int log2n, int k, int fpc,
                 int wp, int nb, float scale, const DirectTaps& taps, size_t smem,
                 cudaStream_t s) {
  constexpr int kMin256 = kMixed ? 2 : 3;
  if (fpc * ((taps.n + kFirOut - 1) / kFirOut * kFirOut) > 8 * 256) {
    return real_taps ? direct_epilogue<512, 1, true, kMixed>(epilogue, x, hist, tw, out, frames,
                                                             nsym, dec, log2n, k, fpc, wp, nb,
                                                             scale, taps, smem, s)
                     : direct_epilogue<512, 1, false, kMixed>(epilogue, x, hist, tw, out,
                                                              frames, nsym, dec, log2n, k, fpc,
                                                              wp, nb, scale, taps, smem, s);
  }
  return real_taps ? direct_epilogue<256, kMin256, true, kMixed>(epilogue, x, hist, tw, out,
                                                                 frames, nsym, dec, log2n, k,
                                                                 fpc, wp, nb, scale, taps, smem,
                                                                 s)
                   : direct_epilogue<256, kMin256, false, kMixed>(epilogue, x, hist, tw, out,
                                                                  frames, nsym, dec, log2n, k,
                                                                  fpc, wp, nb, scale, taps,
                                                                  smem, s);
}

int launch_direct_instance(int epilogue, const void* x, const void* hist, const void* tw,
                           const float* taps_ri, int k, int real_taps, void* out,
                           long long frames, int nsym, int dec, int log2n, int fpc, int wp,
                           int nb, int n_mixed, const int* rad, int npass, float scale,
                           cudaStream_t s) {
  const bool mixed = npass > 0;
  const int n = mixed ? n_mixed : 1 << log2n;
  const int lp = (n + kFirOut - 1) / kFirOut * kFirOut;
  if (k < 1 || k > kMaxTaps || n < 8 || (!mixed && n % 8 != 0) || fpc < 1 ||
      fpc * lp > 8 * 512 || 256 % fpc != 0 || npass > kMaxPasses)
    return static_cast<int>(cudaErrorInvalidValue);
  DirectTaps taps = {};
  for (int i = 0; i < k; ++i) taps.h[i] = make_float2(taps_ri[2 * i], taps_ri[2 * i + 1]);
  taps.n = n;
  taps.npass = npass;
  for (int i = 0; i < npass; ++i) taps.rad[i] = rad[i];
  const size_t smem = static_cast<size_t>(fpc) * (wp > nb ? wp : nb) * sizeof(float2);
  return mixed ? direct_width<true>(epilogue, real_taps, x, hist, tw, out, frames, nsym, dec,
                                    log2n, k, fpc, wp, nb, scale, taps, smem, s)
               : direct_width<false>(epilogue, real_taps, x, hist, tw, out, frames, nsym, dec,
                                     log2n, k, fpc, wp, nb, scale, taps, smem, s);
}


// Points a thread holds in registers through an FFT pass: 8 on one CTA (no
// spills at 128 registers), 16 in a cluster (a CTA holds 8,192 points of a
// 65,536-point frame at 512 threads). ops/cuda/rx_frame.py GEN_POINTS,
// CLUSTER_POINTS_A_THREAD mirror them.
constexpr int kSinglePoints = 8;
constexpr int kClusterPoints = 16;

template <int kThreads, int kMinBlocks, int kPoints, bool kCluster>
int launch_general(int epilogue, int real_taps, const void* x, const void* hist, const void* tw,
                   const void* taps, void* out, long long frames, int nsym, float scale,
                   const GenPlan& plan, size_t smem, cudaStream_t stream) {
  auto kernel = rx_frame_general_kernel<kThreads, kMinBlocks, kPoints, kCluster>;
  const int err = set_smem(kernel, smem);
  if (err != 0) return err;
  const long long ctas = kCluster ? frames * plan.q : (frames + plan.fpc - 1) / plan.fpc;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(ctas));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster ? plan.q : 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = kCluster ? 1 : 0;
  const cudaError_t rc = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const float2*>(x), static_cast<const float2*>(hist),
      static_cast<const float2*>(tw), static_cast<const float2*>(taps), out, frames, nsym,
      scale, epilogue, real_taps, plan);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}

// The instances: one CTA at 256 or 512 threads, a cluster's CTAs at 512.
int general_instance(int epilogue, int real_taps, int threads, const void* x, const void* hist,
                     const void* tw, const void* taps, void* out, long long frames, int nsym,
                     float scale, const GenPlan& plan, size_t smem, cudaStream_t s) {
  if (epilogue < kQpsk || epilogue > kSpectrum) return static_cast<int>(cudaErrorInvalidValue);
  if (plan.q > 1) {
    if (threads != 512) return static_cast<int>(cudaErrorInvalidValue);
    return launch_general<512, 1, kClusterPoints, true>(epilogue, real_taps, x, hist, tw, taps,
                                                        out, frames, nsym, scale, plan, smem, s);
  }
  if (threads == 256) {
    return launch_general<256, 2, kSinglePoints, false>(epilogue, real_taps, x, hist, tw, taps,
                                                        out, frames, nsym, scale, plan, smem, s);
  }
  return launch_general<512, 1, kSinglePoints, false>(epilogue, real_taps, x, hist, tw, taps,
                                                      out, frames, nsym, scale, plan, smem, s);
}

// ---- the global instance ---------------------------------------------------
//
// Every frame the other instances do not take (past 65,536 points, or past
// 4,096 with no cluster split). The FFT has m points: fft_len where it is a
// power of two, else Bluestein's power of two m >= 2n - 1 (the chirp
// w[j] = exp(-i pi (j^2 mod 2n) / n), the square reduced in integers, and the
// chirp filter's spectrum over m, both built on the host in float64). It runs
// a tile at a time in shared memory: a CTA's tile holds T sequences of P
// points (point r of sequence c at slot fslot(r T + c), at most kTilePoints),
// and a sequence's FFT is an in-place radix-8 (then 4 or 2) DIF in the tile,
// natural order in and digit-reversed out (difpos), or the DIT that takes the
// DIF's order back; a thread holds all its butterflies of a stage in
// registers, and the twiddles W_Q^e are the product of two float32 tables
// built on the host in float64 and kept in shared memory. One cooperative
// launch of co-resident CTAs, each phase a loop over tiles, a grid.sync()
// between phases:
//   - m <= kTilePoints (plan.levels 1): a tile holds whole frames. The FIR
//     at the kept outputs (times the chirp), the FFT, Bluestein's product
//     with the filter's spectrum and the inverse FFT (the DIT of the
//     conjugate), and the epilogue all run on it: nothing of a frame goes to
//     device memory.
//   - Bluestein over m = 2 tiles with 100 frames or more (plan.sub 2): a
//     frame a CTA, its two tile-sized sub-transforms (the even and the odd
//     bins) one after the other; only x and a sum of n points a frame go
//     through device memory (global_sub).
//   - larger frames: m = P_0 P_1 ... (levels 2-4, each P_i <= 2,048), a
//     frame in one device scratch buffer of m points, transformed in place a
//     level at a time (the four-step split, m = a b for two levels). First
//     the FIR writes every frame's outputs to the scratch. Level i's tiles
//     hold T_i adjacent columns (points at stride s_i = P_{i+1} ...): the
//     FFT along the column, then the twiddle W_m^{k c L_i} (L_i = P_0 ...
//     P_{i-1}) from two float32 tables, W_m^e for e < 2^h and W_m^{e 2^h}.
//     The last level's tiles hold 8 contiguous rows of consecutive k_0, so
//     bin k_0 + P_0 k_1 + ... of 8 consecutive bins is whole bytes: the
//     epilogue is fused into its store. Bluestein: the last level multiplies
//     by the filter's spectrum and runs the inverse FFT on the same tile, the
//     levels below run again in reverse (each the twiddle, then the DIT),
//     and the epilogue is fused into level 0's store, conj(z_t) w[t].
// Scratch written in the launch is read with ld.global.cg, never through
// the read-only path, kBatch loads in flight a thread. What bounds it on an
// H100: the bytes (x once, the output once); past the chip the scratch adds
// 16 m bytes a frame for a power of two and 24 m with Bluestein (40 n on the
// sub route), much of it through L2. What holds it back (PERF.md §6): one
// CTA of 16 warps an SM (a tile takes 147 KB), so every phase waits on
// latency, and a tile's load, FFT and store do not overlap.

constexpr int kGlobalThreads = 512;
constexpr int kTilePoints = 16384;
constexpr int kBatch = 4;  // global loads a thread keeps in flight

struct GlobalArgs {
  const float2* x;      // [rows, nsym * span]
  const float2* hist;   // [rows, k - 1] or null
  const float2* taps;   // [k]
  const float2* twq;    // [2^hq] W_Q^e, then [Q / 2^hq] W_Q^{e 2^hq}
  const float2* twlo;   // [2^h] W_m^e (levels >= 2)
  const float2* twhi;   // [m / 2^h] W_m^{e 2^h} (levels >= 2)
  const float2* chirp;  // [n] w (Bluestein) or null
  const float2* filt;   // [m] the chirp filter's spectrum over m, divided by m (Bluestein) or null
  float2* buf;          // [frames, m] (levels >= 2) or null
  void* out;
  long long frames;
  int nsym;
  int epi;
  int real_taps;
  float scale;
  GlobalPlan plan;
};

// The slot of bin k after the DIF of a 2^lp-point sequence: the stages'
// mixed-radix digits of k reversed.
__device__ __forceinline__ int difpos(int k, int lp) {
  int pos = 0;
  for (int b = lp; b > 0; b -= 3) {
    const int lr = min(3, b);
    pos += (k & ((1 << lr) - 1)) << (b - lr);
    k >>= lr;
  }
  return pos;
}

// e = tid, tid + kGlobalThreads, ... < total, kBatch at a time: every load(e)
// of a batch is issued before the first use(e, value).
template <typename Load, typename Use>
__device__ __forceinline__ void batched(int total, Load load, Use use) {
  for (int e0 = threadIdx.x; e0 < total; e0 += kGlobalThreads * kBatch) {
    float2 v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * kGlobalThreads;
      if (e < total) v[u] = load(e);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * kGlobalThreads;
      if (e < total) use(e, v[u]);
    }
  }
}

// W_Q^e from the tables in shared memory: tq[e mod 2^hq] tq[2^hq + e / 2^hq].
__device__ __forceinline__ float2 twiddle_q(const float2* tq, int hq, int e) {
  return c_mul(tq[e & ((1 << hq) - 1)], tq[(1 << hq) + (e >> hq)]);
}

// One radix-R stage on the sub-FFTs of 2^b points of each of a tile's 2^lt
// sequences of 2^lp points, in place: butterfly j of a sub-FFT takes points
// j + q 2^b / R. DIF: the DFT, then output u times W_{2^b}^{j u}; DIT: input
// q times W_{2^b}^{j q}, then the DFT. A thread loads 8 points (8 / R of
// its butterflies) before it computes and stores them (no other thread
// touches them; more points a thread spill registers).
template <int R, int LOG2R, bool kDit>
__device__ __forceinline__ void tile_stage(float2* t, int lp, int lt, int b, const float2* tq,
                                           int hq, int log2q) {
  constexpr int kGroup = 8 / R;
  const int lq = b - LOG2R;  // log2 of a sub-FFT's butterflies
  const int total = 1 << (lp + lt - LOG2R);
  const int cmask = (1 << lt) - 1;
  for (int b0 = threadIdx.x; b0 < total; b0 += kGroup * kGlobalThreads) {
    float2 v[kGroup][R];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int bi = b0 + u * kGlobalThreads;
      if (bi < total) {
        const int rest = bi >> lt;
        const int r0 = ((rest >> lq) << b) + (rest & ((1 << lq) - 1));
#pragma unroll
        for (int q = 0; q < R; ++q) v[u][q] = t[fslot(((r0 + (q << lq)) << lt) + (bi & cmask))];
      }
    }
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int bi = b0 + u * kGlobalThreads;
      if (bi < total) {
        const int rest = bi >> lt;
        const int j = rest & ((1 << lq) - 1);
        const int r0 = ((rest >> lq) << b) + j;
        const int e = j << (log2q - b);
        if constexpr (kDit) {
#pragma unroll
          for (int q = 1; q < R; ++q) v[u][q] = c_mul(v[u][q], twiddle_q(tq, hq, e * q));
          dft<R>(v[u]);
        } else {
          dft<R>(v[u]);
#pragma unroll
          for (int q = 1; q < R; ++q) v[u][q] = c_mul(v[u][q], twiddle_q(tq, hq, e * q));
        }
#pragma unroll
        for (int q = 0; q < R; ++q) t[fslot(((r0 + (q << lq)) << lt) + (bi & cmask))] = v[u][q];
      }
    }
  }
  __syncthreads();
}

// The FFT of every sequence of a tile: the DIF's stages on sub-FFTs of 2^lp,
// 2^(lp-3), ... points, or the DIT's in the reverse order.
template <bool kDit>
__device__ __forceinline__ void tile_fft(float2* t, int lp, int lt, const float2* tq, int hq, int log2q) {
  const int stages = (lp + 2) / 3;
  for (int i = 0; i < stages; ++i) {
    const int b = lp - 3 * (kDit ? stages - 1 - i : i);
    if (b >= 3) {
      tile_stage<8, 3, kDit>(t, lp, lt, b, tq, hq, log2q);
    } else if (b == 2) {
      tile_stage<4, 2, kDit>(t, lp, lt, b, tq, hq, log2q);
    } else {
      tile_stage<2, 1, kDit>(t, lp, lt, b, tq, hq, log2q);
    }
  }
}

// W_m^e, e < m, from the two tables of W_m.
__device__ __forceinline__ float2 twiddle_m(const GlobalArgs& a, long long e) {
  return c_mul(__ldg(a.twlo + (e & ((1LL << a.plan.h) - 1))), __ldg(a.twhi + (e >> a.plan.h)));
}

// A frame's samples -ku <= i < span for the FIR: its own, the previous
// frame's tail, the carried history for frame 0 of a block row, or zeros
// (null).
struct FrameSrc {
  const float2* x;     // the frame's sample 0
  const float2* hist;  // its row's history at sample 0 (frame 0 of a row), or null
  bool first;          // frame 0 of its block row
  __device__ __forceinline__ const float2* at(long long i) const {
    return i >= 0 || !first ? x + i : (hist != nullptr ? hist + i : nullptr);
  }
};

// The FIR at the kept outputs of a CTA's chunks: item i is frame f's outputs
// [o0, o0 + cnt), cnt <= plan.chunk; each output (times the chirp for
// Bluestein) goes to put(f, o, y), through ostage (shared memory, chunk
// slots) where it is given, so that a chunk leaves in order. A chunk's input
// for a range of taps is staged by cp.async into one of two windows (the
// next while this one computes) and split threads share a group of 8
// outputs (fir_items), as in the chunked instance; where no window fits
// (plan.win 0) each output reads x through L1. Ends in a barrier.
template <typename Item, typename Put>
__device__ __forceinline__ void global_fir(const GlobalArgs& a, float2* win0, float2* ostage, long long nitems,
                           Item item, Put put) {
  const GlobalPlan& p = a.plan;
  const int dec = p.dec, k = p.k, ku = k - 1;
  const long long span = static_cast<long long>(dec) * p.n;
  const int tid = threadIdx.x;
  auto source = [&](long long f) {
    const long long row = f / a.nsym;
    FrameSrc s;
    s.x = a.x + f * span;
    s.first = f == row * a.nsym;
    s.hist = s.first && a.hist != nullptr ? a.hist + row * ku + ku : nullptr;
    return s;
  };
  auto emit = [&](long long o, float ar, float ai) {
    float2 y = make_float2(ar, ai);
    if (p.bluestein) y = c_mul(y, __ldg(a.chirp + o));
    return y;
  };
  if (p.win == 0) {
    for (long long it = 0; it < nitems; ++it) {
      long long f, o0;
      int cnt;
      item(it, f, o0, cnt);
      const FrameSrc sx = source(f);
      for (int u = tid; u < cnt; u += kGlobalThreads) {
        const long long o = o0 + u;
        float ar = 0.0f, ai = 0.0f;
        for (int t = 0; t < k; ++t) {
          const float2* s = sx.at(dec * o - t);
          if (s != nullptr) fir_mac<false>(ar, ai, __ldg(a.taps + t), __ldg(s));
        }
        put(f, o, emit(o, ar, ai));
      }
    }
    __syncthreads();
    return;
  }
  const int S = p.split;
  const int nkr = (k + p.kt - 1) / p.kt;
  const long long iters = nitems * nkr;
  const int g = tid / S, s = tid - g * S;
  const Div by_dec(dec);
  auto stage = [&](long long it) {
    const long long ii = it / nkr;
    const int kr = static_cast<int>(it - ii * nkr);
    long long f, o0;
    int cnt;
    item(ii, f, o0, cnt);
    const FrameSrc sx = source(f);
    const int k0 = kr * p.kt, k1 = min(k, k0 + p.kt);
    const int wl = dec * (cnt - 1) + (k1 - k0);
    float2* w = win0 + (it & 1) * p.win;
    const long long i0 = dec * o0 - (k1 - 1);
    for (int e = tid; e < wl; e += kGlobalThreads) {
      const float2* sp = sx.at(i0 + e);
      if (sp != nullptr) {
        cp_async8(w + wslot(e), sp);
      } else {
        w[wslot(e)] = make_float2(0.f, 0.f);
      }
    }
    cp_async_commit();
  };
  float ar[kFirOut], ai[kFirOut];
  if (iters > 0) stage(0);
  for (long long it = 0; it < iters; ++it) {
    if (it + 1 < iters) {
      stage(it + 1);
      cp_async_wait_group<1>();
    } else {
      cp_async_wait_group<0>();
    }
    __syncthreads();
    const long long ii = it / nkr;
    const int kr = static_cast<int>(it - ii * nkr);
    long long f, o0;
    int cnt;
    item(ii, f, o0, cnt);
    const int k0 = kr * p.kt, k1 = min(k, k0 + p.kt);
    if (kr == 0) {
#pragma unroll
      for (int r = 0; r < kFirOut; ++r) {
        ar[r] = 0.f;
        ai[r] = 0.f;
      }
    }
    if (kFirOut * g < cnt) {
      // window slot of output o0 + 8 g + r, tap kk: wslot(ob + dec r - kk)
      const float2* w = win0 + (it & 1) * p.win;
      const int ob = dec * kFirOut * g + (k1 - 1);
      if (a.real_taps) {
        fir_items<true>(w, a.taps, ob, dec, k0, k1, s, S, by_dec, ar, ai);
      } else {
        fir_items<false>(w, a.taps, ob, dec, k0, k1, s, S, by_dec, ar, ai);
      }
    }
    if (kr == nkr - 1) {
      for (int off = S >> 1; off > 0; off >>= 1) {
#pragma unroll
        for (int r = 0; r < kFirOut; ++r) {
          ar[r] += __shfl_xor_sync(0xffffffffu, ar[r], off);
          ai[r] += __shfl_xor_sync(0xffffffffu, ai[r], off);
        }
      }
#pragma unroll
      for (int r = 0; r < kFirOut; ++r) {
        const int u = kFirOut * g + r;
        if ((S <= kFirOut ? (r & (S - 1)) == s : r == s) && u < cnt) {
          const float2 y = emit(o0 + u, ar[r], ai[r]);
          if (ostage != nullptr) {
            ostage[u] = y;
          } else {
            put(f, o0 + u, y);
          }
        }
      }
      if (ostage != nullptr) {
        __syncthreads();
        for (int u = tid; u < cnt; u += kGlobalThreads) put(f, o0 + u, ostage[u]);
      }
    }
    __syncthreads();  // the window is read: the load two iterations on may overwrite it
  }
}

// The epilogue of bins: spectrum element value(0) times the scale at
// out[o0]; bytes of spb bins (value(i), i < spb) at out[o0 / spb]. Strict
// comparisons, as elsewhere.
template <typename Value>
__device__ __forceinline__ void put_bins(const GlobalArgs& a, long long o0, Value value) {
  if (a.epi == kSpectrum) {
    const float2 z = value(0);
    static_cast<float2*>(a.out)[o0] = make_float2(z.x * a.scale, z.y * a.scale);
  } else {
    const int spb = a.epi == kQpsk ? 4 : 8;
    static_cast<uint8_t*>(a.out)[o0 / spb] = demod_byte(a.epi, value);
  }
}

// levels 1: whole frames in a tile, T = 2^lt of them, m = 2^lp points each.
__device__ __forceinline__ void global_on_chip(const GlobalArgs& a, float2* tile, float2* win, const float2* tq) {
  const GlobalPlan& p = a.plan;
  const int tid = threadIdx.x;
  const int lp = p.lp[0], lt = p.lt[0];
  const int P = 1 << lp, T = 1 << lt;
  const int n = static_cast<int>(p.n);
  const int nc = (n + p.chunk - 1) / p.chunk;  // FIR chunks a frame
  const int spb = a.epi == kSpectrum ? 1 : (a.epi == kQpsk ? 4 : 8);
  const long long tiles = (a.frames + T - 1) >> lt;
  for (long long tl = blockIdx.x; tl < tiles; tl += gridDim.x) {
    const long long f0 = tl << lt;
    const int nf = static_cast<int>(min(static_cast<long long>(T), a.frames - f0));
    for (int e = tid; e < (P - n) * nf; e += kGlobalThreads) {  // Bluestein's zeros
      tile[fslot(((n + e / nf) << lt) + e % nf)] = make_float2(0.f, 0.f);
    }
    global_fir(
        a, win, nullptr, static_cast<long long>(nf) * nc,
        [&](long long i, long long& f, long long& o0, int& cnt) {
          const int c = static_cast<int>(i / nc);
          f = f0 + c;
          o0 = (i - static_cast<long long>(c) * nc) * p.chunk;
          cnt = static_cast<int>(min(static_cast<long long>(p.chunk), n - o0));
        },
        [&](long long f, long long o, float2 y) {
          tile[fslot((static_cast<int>(o) << lt) + static_cast<int>(f - f0))] = y;
        });
    tile_fft<false>(tile, lp, lt, tq, p.hq, p.log2q);
    if (p.bluestein) {
      batched(P * nf, [&](int e) { return __ldg(a.filt + e / nf); },
              [&](int e, float2 h) {  // bin k of frame c
                const int slot = fslot((difpos(e / nf, lp) << lt) + e % nf);
                const float2 z = c_mul(tile[slot], h);
                tile[slot] = make_float2(z.x, -z.y);
              });
      __syncthreads();
      tile_fft<true>(tile, lp, lt, tq, p.hq, p.log2q);  // natural order: conj(z_t)
    }
    const int per = n / spb;
    for (int e = tid; e < per * nf; e += kGlobalThreads) {
      const int c = e / per, q0 = (e - c * per) * spb;
      put_bins(a, (f0 + c) * n + q0, [&](int q) {
        const int t = q0 + q;
        if (!p.bluestein) return tile[fslot((difpos(t, lp) << lt) + c)];
        const float2 z = tile[fslot((t << lt) + c)];
        return c_mul(make_float2(z.x, -z.y), __ldg(a.chirp + t));
      });
    }
    __syncthreads();  // the tile is read: the next tile's FIR may overwrite it
  }
}

// Bluestein with m = q P, q = plan.sub (P = 2^lp points, a tile): a frame a
// CTA, its q sub-transforms one after the other. Its FIR outputs x (times the
// chirp) go to buf [f][0, n), then for u < q: the tile holds a_u[t'] =
// sum_j x[t' + P j] W_m^{u (t' + P j)}, whose DIF is X[q k + u]; times the
// filter's spectrum there, conjugated, the DIT gives z_u, and conj(y_t) =
// sum_u W_m^{u t} z_u[t mod P] accumulates in buf [f][n, 2 n) for t < n; the
// last sub-transform's pass is the epilogue, conj of the sum times w[t].
__device__ __forceinline__ void global_sub(const GlobalArgs& a, float2* tile, float2* win,
                                           const float2* tq) {
  const GlobalPlan& p = a.plan;
  const int tid = threadIdx.x;
  const int lp = p.lp[0], P = 1 << lp, q = p.sub;
  const int n = static_cast<int>(p.n);
  const long long nc = (n + p.chunk - 1) / p.chunk;
  const int spb = a.epi == kSpectrum ? 1 : (a.epi == kQpsk ? 4 : 8);
  for (long long f = blockIdx.x; f < a.frames; f += gridDim.x) {
    float2* xs = a.buf + f * 2 * n;
    float2* acc = xs + n;
    global_fir(
        a, win, tile, nc,
        [&](long long i, long long& ff, long long& o0, int& cnt) {
          ff = f;
          o0 = i * p.chunk;
          cnt = static_cast<int>(min(static_cast<long long>(p.chunk), n - o0));
        },
        [&](long long, long long o, float2 y) { xs[o] = y; });
    for (int u = 0; u < q; ++u) {
      batched(
          P,
          [&](int e) {
            float2 v = make_float2(0.f, 0.f);
            for (int t = e; t < n; t += P) {
              const float2 x = __ldcg(xs + t);
              v = c_add(v, u == 0 ? x : c_mul(x, twiddle_m(a, (static_cast<long long>(u) * t) &
                                                                   (p.m - 1))));
            }
            return v;
          },
          [&](int e, float2 v) { tile[fslot(e)] = v; });
      __syncthreads();
      tile_fft<false>(tile, lp, 0, tq, p.hq, p.log2q);
      batched(P, [&](int e) { return __ldg(a.filt + static_cast<long long>(q) * e + u); },
              [&](int e, float2 h) {  // bin q e + u
                const int slot = fslot(difpos(e, lp));
                const float2 z = c_mul(tile[slot], h);
                tile[slot] = make_float2(z.x, -z.y);
              });
      __syncthreads();
      tile_fft<true>(tile, lp, 0, tq, p.hq, p.log2q);  // z_u, natural order
      auto term = [&](int t) {
        const float2 z = tile[fslot(t & (P - 1))];
        return u == 0 ? z : c_mul(z, twiddle_m(a, (static_cast<long long>(u) * t) & (p.m - 1)));
      };
      if (u + 1 < q) {
        for (int t = tid; t < n; t += kGlobalThreads) {
          acc[t] = u == 0 ? term(t) : c_add(__ldcg(acc + t), term(t));
        }
      } else {
        for (int e = tid; e < n / spb; e += kGlobalThreads) {
          const int t0 = e * spb;
          put_bins(a, f * n + t0, [&](int j) {
            const float2 z = c_add(__ldcg(acc + t0 + j), term(t0 + j));
            return c_mul(make_float2(z.x, -z.y), __ldg(a.chirp + t0 + j));
          });
        }
      }
      __syncthreads();  // the tile is read: the next sub-transform's load may overwrite it
    }
  }
}

// Level i's tile tl (levels >= 2): point (r, c) at base + r rstride + c
// cstride of the scratch. Levels below the last: T columns c0 + c of a
// block of P rows at stride s; the last: T rows (blocks) of consecutive k_0,
// row c's bin k at binbase + c + k L.
struct TileAt {
  long long f, base, rstride, cstride, c0, binbase;
  int ls, ll;  // log2 of s and of L
};

__device__ __forceinline__ TileAt tile_at(const GlobalArgs& a, int i, long long tl) {
  const GlobalPlan& p = a.plan;
  const int last = p.levels - 1;
  TileAt t;
  t.ls = 0;
  t.ll = 0;
  for (int l = 0; l < p.levels; ++l) {
    if (l > i) t.ls += p.lp[l];
    if (l < i) t.ll += p.lp[l];
  }
  const int lp = p.lp[i], lt = p.lt[i];
  const long long tpf = p.m >> (lp + lt);  // tiles a frame
  t.f = tl / tpf;
  const long long rem = tl - t.f * tpf;
  if (i < last) {
    t.c0 = (rem & ((1LL << (t.ls - lt)) - 1)) << lt;
    t.base = t.f * p.m + ((rem >> (t.ls - lt)) << (lp + t.ls)) + t.c0;
    t.rstride = 1LL << t.ls;
    t.cstride = 1;
    t.binbase = 0;
  } else {
    // blocks k_0 P_1 ... P_{last-1} + rest; bin k_0 + P_0 dr(rest) + L k
    const int lbs = t.ll - p.lp[0];
    const long long g = rem >> lbs, rest = rem & ((1LL << lbs) - 1);
    long long dr = 0, tmp = rest;
    int sh = lbs;
    for (int l = last - 1; l >= 1; --l) {
      sh -= p.lp[l];
      dr |= (tmp & ((1LL << p.lp[l]) - 1)) << sh;
      tmp >>= p.lp[l];
    }
    t.base = t.f * p.m + ((((g << lt) << lbs) + rest) << lp);
    t.rstride = 1;
    t.cstride = 1LL << (lbs + lp);
    t.c0 = 0;
    t.binbase = (g << lt) + (dr << p.lp[0]);
  }
  return t;
}

__global__ void __launch_bounds__(kGlobalThreads, 1)
rx_frame_global_kernel(const __grid_constant__ GlobalArgs a) {
  extern __shared__ __align__(16) float2 sm[];
  const GlobalPlan& p = a.plan;
  const int tid = threadIdx.x;
  float2* tile = sm;
  float2* win = sm + (p.levels == 1 ? p.tile : 0);  // past one level the FIR runs first
  float2* tq = sm + p.twoff;  // the tables of W_Q
  const int nq = (1 << p.hq) + ((1 << p.log2q) >> p.hq);
  for (int e = tid; e < nq; e += kGlobalThreads) tq[e] = __ldg(a.twq + e);
  __syncthreads();
  if (p.levels == 1) {
    if (p.sub > 1) {
      global_sub(a, tile, win, tq);
    } else {
      global_on_chip(a, tile, win, tq);
    }
    return;
  }
  cg::grid_group grid = cg::this_grid();
  const long long n = p.n, m = p.m;
  const int last = p.levels - 1;
  const int spb = a.epi == kSpectrum ? 1 : (a.epi == kQpsk ? 4 : 8);

  // the FIR of every frame into the scratch, each chunk in order
  const long long nc = (n + p.chunk - 1) / p.chunk;
  const long long items = a.frames * nc;
  const long long mine = items > blockIdx.x ? (items - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  global_fir(
      a, win, win + 2 * p.win, mine,
      [&](long long i, long long& f, long long& o0, int& cnt) {
        const long long it = blockIdx.x + i * gridDim.x;
        f = it / nc;
        o0 = (it - f * nc) * p.chunk;
        cnt = static_cast<int>(min(static_cast<long long>(p.chunk), n - o0));
      },
      [&](long long f, long long o, float2 y) { a.buf[f * m + o] = y; });
  grid.sync();

  // the forward levels; Bluestein's last one also multiplies by the filter
  // and runs the inverse FFT of its rows
  for (int i = 0; i <= last; ++i) {
    const int lp = p.lp[i], lt = p.lt[i];
    const int P = 1 << lp, T = 1 << lt;
    const long long tiles = (a.frames * m) >> (lp + lt);
    for (long long tl = blockIdx.x; tl < tiles; tl += gridDim.x) {
      const TileAt t = tile_at(a, i, tl);
      // point (r, c): columns c fastest below the last level, rows r in it
      auto rc = [&](int e, int& r, int& c) {
        r = i < last ? e >> lt : e & (P - 1);
        c = i < last ? e & (T - 1) : e >> lp;
      };
      batched(
          P * T,
          [&](int e) {
            int r, c;
            rc(e, r, c);
            const long long pos = t.base + r * t.rstride + c * t.cstride;
            return i == 0 && pos - t.f * m >= n ? make_float2(0.f, 0.f) : __ldcg(a.buf + pos);
          },
          [&](int e, float2 z) {
            int r, c;
            rc(e, r, c);
            tile[fslot((r << lt) + c)] = z;
          });
      __syncthreads();
      tile_fft<false>(tile, lp, lt, tq, p.hq, p.log2q);
      if (i < last) {  // natural rows k, times W_m^{k c L}
        batched(
            P * T, [&](int e) { return twiddle_m(a, ((e >> lt) * (t.c0 + (e & (T - 1)))) << t.ll); },
            [&](int e, float2 w) {
              const int kb = e >> lt, c = e & (T - 1);
              a.buf[t.base + kb * t.rstride + c] =
                  c_mul(tile[fslot((difpos(kb, lp) << lt) + c)], w);
            });
      } else if (!p.bluestein) {  // the epilogue at bin binbase + c + k L
        for (int e = tid; e < P * (T / spb); e += kGlobalThreads) {
          const int kb = e / (T / spb), c0 = (e - kb * (T / spb)) * spb;
          const int row = difpos(kb, lp) << lt;
          put_bins(a, t.f * n + t.binbase + c0 + (static_cast<long long>(kb) << t.ll),
                   [&](int q) { return tile[fslot(row + c0 + q)]; });
        }
      } else {
        batched(
            P * T,
            [&](int e) {
              return __ldg(a.filt + t.binbase + (e & (T - 1)) +
                           (static_cast<long long>(e >> lt) << t.ll));
            },
            [&](int e, float2 h) {
              const int slot = fslot((difpos(e >> lt, lp) << lt) + (e & (T - 1)));
              const float2 z = c_mul(tile[slot], h);
              tile[slot] = make_float2(z.x, -z.y);
            });
        __syncthreads();
        tile_fft<true>(tile, lp, lt, tq, p.hq, p.log2q);
        for (int e = tid; e < P * T; e += kGlobalThreads) {
          const int r = e & (P - 1), c = e >> lp;
          a.buf[t.base + r + c * t.cstride] = tile[fslot((r << lt) + c)];
        }
      }
      __syncthreads();  // the tile is read: the next tile's load may overwrite it
    }
    if (i < last || p.bluestein) grid.sync();
  }
  if (!p.bluestein) return;

  // Bluestein: the levels below the last in reverse, the twiddle then the
  // DIT; level 0 ends in the epilogue at t = r s + c, conj(z_t) w[t]
  for (int i = last - 1; i >= 0; --i) {
    const int lp = p.lp[i], lt = p.lt[i];
    const int P = 1 << lp, T = 1 << lt;
    const long long tiles = (a.frames * m) >> (lp + lt);
    for (long long tl = blockIdx.x; tl < tiles; tl += gridDim.x) {
      const TileAt t = tile_at(a, i, tl);
      batched(
          P * T, [&](int e) { return __ldcg(a.buf + t.base + (e >> lt) * t.rstride + (e & (T - 1))); },
          [&](int e, float2 z) {
            const int kb = e >> lt, c = e & (T - 1);
            tile[fslot((difpos(kb, lp) << lt) + c)] =
                c_mul(z, twiddle_m(a, (kb * (t.c0 + c)) << t.ll));
          });
      __syncthreads();
      tile_fft<true>(tile, lp, lt, tq, p.hq, p.log2q);
      if (i > 0) {
        for (int e = tid; e < P * T; e += kGlobalThreads) {
          a.buf[t.base + (e >> lt) * t.rstride + (e & (T - 1))] = tile[fslot(e)];
        }
      } else {
        for (int e = tid; e < P * (T / spb); e += kGlobalThreads) {
          const int r = e / (T / spb), c0 = (e - r * (T / spb)) * spb;
          const long long q0 = (static_cast<long long>(r) << t.ls) + t.c0 + c0;
          if (q0 >= n) continue;
          put_bins(a, t.f * n + q0, [&](int q) {
            const float2 z = tile[fslot((r << lt) + c0 + q)];
            return c_mul(make_float2(z.x, -z.y), __ldg(a.chirp + q0 + q));
          });
        }
      }
      __syncthreads();
    }
    if (i > 0) grid.sync();
  }
}

int launch_global(const GlobalArgs& a, int device, cudaStream_t stream) {
  int coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem =
      (static_cast<size_t>(a.plan.twoff) + (1 << a.plan.hq) + ((1 << a.plan.log2q) >> a.plan.hq)) *
      sizeof(float2);
  const int rc = set_smem(rx_frame_global_kernel, smem);
  if (rc != 0) return rc;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rx_frame_global_kernel,
                                                      kGlobalThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  // the most work of a phase: tiles of a level, or FIR chunks
  long long need = 1;
  if (a.plan.levels == 1) {
    need = a.plan.sub > 1 ? a.frames : (a.frames + (1LL << a.plan.lt[0]) - 1) >> a.plan.lt[0];
  } else {
    need = a.frames * ((a.plan.n + a.plan.chunk - 1) / a.plan.chunk);
    for (int i = 0; i < a.plan.levels; ++i) {
      const long long tiles = (a.frames * a.plan.m) >> (a.plan.lp[i] + a.plan.lt[i]);
      if (tiles > need) need = tiles;
    }
  }
  const long long most = static_cast<long long>(per_sm) * sms;
  const unsigned blocks = static_cast<unsigned>(need < most ? need : most);
  void* args[] = {const_cast<GlobalArgs*>(&a)};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(rx_frame_global_kernel),
                                    dim3(blocks), dim3(kGlobalThreads), args, smem, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point of the direct instance, loaded with ctypes. taps_ri:
// a host array of k complex taps as (re, im) float pairs, k <= 256;
// real_taps: every imaginary part is exactly 0 (the real-tap variant); tw:
// the float32 table W_n^e, e < n, on the card; n = 2^log2n, or, where npass >
// 0, n = n_mixed with the FFT passes rad[npass] (the mixed-radix variant). A
// CTA takes fpc consecutive frames (a power of two, fpc * lp <= 4,096 with lp
// n rounded up to a multiple of 8; 512 threads where fpc * lp > 2,048, else
// 256); wp and nb: the float2 slots of a frame's staged window (wslot(K-2 +
// span + dec (lp - n)) + 1: the dropped outputs' reads stay in the window's
// slots) and FFT buffer (n + n / 8). Returns the cudaError_t of the launch (0 = success). The
// caller guarantees contiguous tensors and fpc * max(wp, nb) * 8 bytes within
// the opt-in shared memory.
extern "C" int rx_frame_direct_launch(int epilogue, const void* x, const void* hist,
                                      const void* tw, const float* taps_ri, int k,
                                      int real_taps, void* out, long long frames, int nsym,
                                      int dec, int log2n, int fpc, int wp, int nb, int n_mixed,
                                      const int* rad, int npass, float scale, int device,
                                      void* stream) {
  int prev = device;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  const int rc = launch_direct_instance(epilogue, x, hist, tw, taps_ri, k, real_taps, out,
                                        frames, nsym, dec, log2n, fpc, wp, nb, n_mixed, rad,
                                        npass, scale, static_cast<cudaStream_t>(stream));
  if (prev != device) cudaSetDevice(prev);
  return rc;
}

// Plain C entry point of the chunked and cluster instances, loaded with
// ctypes. plan: a host GenPlan (ops/cuda/rx_frame.py general_layout); threads:
// 256 or 512 a CTA (512 in a cluster); taps: the k complex taps on the card; real_taps: every
// imaginary part exactly 0; tw: the float32 table W_n^e, e < n, on the card.
// A cluster launch (plan->q > 1) puts q CTAs on each frame. Returns the
// cudaError_t of the launch (0 = success). The caller guarantees contiguous
// tensors, 8 | lp, 8 q | a, q | b, lp = n / q in a cluster, and (fbuf + 2 win)
// float2 slots within the opt-in shared memory.
extern "C" int rx_frame_general_launch(int epilogue, const void* x, const void* hist,
                                       const void* tw, const void* taps, int real_taps,
                                       void* out, long long frames, int nsym, int threads,
                                       const GenPlan* plan, float scale, int device,
                                       void* stream) {
  if (plan->np1 > kMaxPasses || plan->np2 > kMaxPasses || plan->split < 1 ||
      plan->split > 32 || plan->q < 1 || plan->q > 8 || (threads != 256 && threads != 512))
    return static_cast<int>(cudaErrorInvalidValue);
  int prev = device;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  const size_t smem = (static_cast<size_t>(plan->fbuf) + 2 * static_cast<size_t>(plan->win)) *
                      sizeof(float2);
  const int rc = general_instance(epilogue, real_taps, threads, x, hist, tw, taps, out, frames,
                                  nsym, scale, *plan, smem, static_cast<cudaStream_t>(stream));
  if (prev != device) cudaSetDevice(prev);
  return rc;
}

// Plain C entry point of the global instance, loaded with ctypes. plan: a
// host GlobalPlan (ops/cuda/rx_frame.py global_layout); taps: the k complex
// taps on the card (real_taps: every imaginary part exactly 0); twq: W_Q^e,
// e < 2^hq, then W_Q^{e 2^hq}, e < Q / 2^hq (Q = 2^plan->log2q), float32
// built in float64; twlo, twhi: W_m^e, e < 2^h,
// and W_m^{e 2^h}, e < m / 2^h (levels >= 2 or sub > 1, else null); chirp
// ([n]) and filt ([m]) where plan->bluestein, else null; buf: a scratch of
// frames x m complex64 (levels >= 2), of frames x 2 n (sub > 1), else null;
// all on the card; out: as the other
// instances'. One cooperative launch; returns its cudaError_t (0 =
// success). The caller guarantees contiguous tensors and twoff + 2^hq +
// Q / 2^hq float2 slots within the opt-in shared memory.
extern "C" int rx_frame_global_launch(int epilogue, const void* x, const void* hist,
                                      const void* taps, const void* twq, const void* twlo,
                                      const void* twhi, const void* chirp, const void* filt,
                                      void* buf, void* out, long long frames, int nsym,
                                      int real_taps, const GlobalPlan* plan, float scale,
                                      int device, void* stream) {
  if (epilogue < kQpsk || epilogue > kSpectrum || plan->levels < 1 ||
      plan->levels > kMaxLevels || plan->k < 1 || frames < 1 ||
      (plan->bluestein && (chirp == nullptr || filt == nullptr)) ||
      ((plan->levels > 1 || plan->sub > 1) &&
       (buf == nullptr || twlo == nullptr || twhi == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  int prev = device;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  GlobalArgs a;
  a.x = static_cast<const float2*>(x);
  a.hist = static_cast<const float2*>(hist);
  a.taps = static_cast<const float2*>(taps);
  a.twq = static_cast<const float2*>(twq);
  a.twlo = static_cast<const float2*>(twlo);
  a.twhi = static_cast<const float2*>(twhi);
  a.chirp = static_cast<const float2*>(chirp);
  a.filt = static_cast<const float2*>(filt);
  a.buf = static_cast<float2*>(buf);
  a.out = out;
  a.frames = frames;
  a.nsym = nsym;
  a.epi = epilogue;
  a.real_taps = real_taps;
  a.scale = scale;
  a.plan = *plan;
  const int rc = launch_global(a, device, static_cast<cudaStream_t>(stream));
  if (prev != device) cudaSetDevice(prev);
  return rc;
}
