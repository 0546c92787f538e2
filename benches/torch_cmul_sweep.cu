// Launch shapes of the fused complex multiply out = (a * b[conj]) * scale,
// for benches/torch_cmul_sweep.py: the port's kernel
// (aether_primitives_tpu_torch/csrc/cmul.cu, one float4 a stream per thread,
// default caching, one group a thread) beside the shapes it was chosen over.
// Same arithmetic as the port's, every op __fmul_rn / __fadd_rn / __fsub_rn
// and no fast math, so every shape is bit-identical to the plain version.
// - kUnroll: a thread loads kUnroll float4 of every input stream before any
//   arithmetic (1, 2 or 4).
// - kHint: 0 the default, 1 streaming loads and stores (ld.global.cs /
//   st.global.cs), 2 non-coherent loads that skip L1
//   (ld.global.nc.L1::no_allocate) with streaming stores.
// - The grid: one group of kUnroll float4 a thread (ctas_per_sm 0), or SMs x
//   ctas_per_sm CTAs walking the planes grid-stride.
//
// Build: nvcc <the port's flags> -o <lib>.so benches/torch_cmul_sweep.cu

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 20;

__device__ __forceinline__ void cmul1(float ar, float ai, float br, float bi, float s,
                                      int conj_b, float& out_re, float& out_im) {
  if (conj_b) bi = -bi;
  out_re = __fmul_rn(__fsub_rn(__fmul_rn(ar, br), __fmul_rn(ai, bi)), s);
  out_im = __fmul_rn(__fadd_rn(__fmul_rn(ar, bi), __fmul_rn(ai, br)), s);
}

template <int kHint>
__device__ __forceinline__ float4 load4(const float4* p) {
  if constexpr (kHint == 1) {
    return __ldcs(p);
  } else if constexpr (kHint == 2) {
    float4 v;
    asm("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];"
                 : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p));
    return v;
  } else {
    return *p;
  }
}

template <int kHint>
__device__ __forceinline__ void store4(float4* p, float4 v) {
  if constexpr (kHint == 0) {
    *p = v;
  } else {
    __stcs(p, v);
  }
}

// Split planes: four inputs and two outputs of n float32 each. kVec: every
// pointer 16-byte aligned; then n / 4 float4 in groups of kUnroll per
// thread, and the scalar tail.
template <bool kVec, int kUnroll, int kHint>
__global__ void __launch_bounds__(kThreads)
cmul_planes_kernel(const float* __restrict__ ar, const float* __restrict__ ai,
                   const float* __restrict__ br, const float* __restrict__ bi,
                   float* __restrict__ out_re, float* __restrict__ out_im,
                   long long n, float s, int conj_b) {
  const long long threads = static_cast<long long>(gridDim.x) * kThreads;
  long long done = 0;
  if constexpr (kVec) {
    const long long n4 = n / 4;
    const float4* a_r = reinterpret_cast<const float4*>(ar);
    const float4* a_i = reinterpret_cast<const float4*>(ai);
    const float4* b_r = reinterpret_cast<const float4*>(br);
    const float4* b_i = reinterpret_cast<const float4*>(bi);
    float4* o_r = reinterpret_cast<float4*>(out_re);
    float4* o_i = reinterpret_cast<float4*>(out_im);
    // a CTA's group: kUnroll x kThreads consecutive float4, thread t at
    // t, t + kThreads, ...: every load instruction of a warp is 512 bytes
    const long long step = threads * kUnroll;
    for (long long g = static_cast<long long>(blockIdx.x) * kThreads * kUnroll + threadIdx.x;
         g < n4; g += step) {
      float4 va_r[kUnroll], va_i[kUnroll], vb_r[kUnroll], vb_i[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long i = g + u * kThreads;
        if (i < n4) {
          va_r[u] = load4<kHint>(a_r + i);
          va_i[u] = load4<kHint>(a_i + i);
          vb_r[u] = load4<kHint>(b_r + i);
          vb_i[u] = load4<kHint>(b_i + i);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long i = g + u * kThreads;
        if (i < n4) {
          float4 r, m;
          cmul1(va_r[u].x, va_i[u].x, vb_r[u].x, vb_i[u].x, s, conj_b, r.x, m.x);
          cmul1(va_r[u].y, va_i[u].y, vb_r[u].y, vb_i[u].y, s, conj_b, r.y, m.y);
          cmul1(va_r[u].z, va_i[u].z, vb_r[u].z, vb_i[u].z, s, conj_b, r.z, m.z);
          cmul1(va_r[u].w, va_i[u].w, vb_r[u].w, vb_i[u].w, s, conj_b, r.w, m.w);
          store4<kHint>(o_r + i, r);
          store4<kHint>(o_i + i, m);
        }
      }
    }
    done = n4 * 4;
  }
  for (long long i = done + static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += threads) {
    cmul1(ar[i], ai[i], br[i], bi[i], s, conj_b, out_re[i], out_im[i]);
  }
}

// Interleaved complex64: a, b and out hold n (re, im) pairs each; a float4
// is two of them.
template <bool kVec, int kUnroll, int kHint>
__global__ void __launch_bounds__(kThreads)
cmul_c64_kernel(const float2* __restrict__ a, const float2* __restrict__ b,
                float2* __restrict__ out, long long n, float s, int conj_b) {
  const long long threads = static_cast<long long>(gridDim.x) * kThreads;
  long long done = 0;
  if constexpr (kVec) {
    const long long n2 = n / 2;
    const float4* va = reinterpret_cast<const float4*>(a);
    const float4* vb = reinterpret_cast<const float4*>(b);
    float4* vo = reinterpret_cast<float4*>(out);
    const long long step = threads * kUnroll;
    for (long long g = static_cast<long long>(blockIdx.x) * kThreads * kUnroll + threadIdx.x;
         g < n2; g += step) {
      float4 x[kUnroll], y[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long i = g + u * kThreads;
        if (i < n2) {
          x[u] = load4<kHint>(va + i);
          y[u] = load4<kHint>(vb + i);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long i = g + u * kThreads;
        if (i < n2) {
          float4 o;
          cmul1(x[u].x, x[u].y, y[u].x, y[u].y, s, conj_b, o.x, o.y);
          cmul1(x[u].z, x[u].w, y[u].z, y[u].w, s, conj_b, o.z, o.w);
          store4<kHint>(vo + i, o);
        }
      }
    }
    done = n2 * 2;
  }
  for (long long i = done + static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += threads) {
    const float2 va = a[i], vb = b[i];
    float2 o;
    cmul1(va.x, va.y, vb.x, vb.y, s, conj_b, o.x, o.y);
    out[i] = o;
  }
}

// The grid: one group of kUnroll float4 a thread (ctas_per_sm 0), or at most
// SMs x ctas_per_sm CTAs.
int grid_for(long long groups, int ctas_per_sm, int device, unsigned* grid) {
  long long blocks = (groups + kThreads - 1) / kThreads;
  if (ctas_per_sm > 0) {
    static int sms[64] = {};
    if (device < 0 || device >= 64) return static_cast<int>(cudaErrorInvalidValue);
    if (sms[device] == 0) {
      const cudaError_t err =
          cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount, device);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    const long long cap = static_cast<long long>(sms[device]) * ctas_per_sm;
    if (blocks > cap) blocks = cap;
  }
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  *grid = static_cast<unsigned>(blocks);
  return 0;
}

struct PlanesArgs {
  const float *ar, *ai, *br, *bi;
  float *out_re, *out_im;
  long long n;
  float s;
  int conj_b;
};

struct C64Args {
  const float2 *a, *b;
  float2* out;
  long long n;
  float s;
  int conj_b;
};

template <bool kVec, int kUnroll, int kHint>
void go(const PlanesArgs& p, unsigned grid, cudaStream_t st) {
  cmul_planes_kernel<kVec, kUnroll, kHint><<<grid, kThreads, 0, st>>>(
      p.ar, p.ai, p.br, p.bi, p.out_re, p.out_im, p.n, p.s, p.conj_b);
}

template <bool kVec, int kUnroll, int kHint>
void go(const C64Args& p, unsigned grid, cudaStream_t st) {
  cmul_c64_kernel<kVec, kUnroll, kHint><<<grid, kThreads, 0, st>>>(
      p.a, p.b, p.out, p.n, p.s, p.conj_b);
}

template <int kUnroll, class Args>
int go_hint(const Args& p, int hint, unsigned grid, cudaStream_t st) {
  switch (hint) {
    case 0: go<true, kUnroll, 0>(p, grid, st); break;
    case 1: go<true, kUnroll, 1>(p, grid, st); break;
    case 2: go<true, kUnroll, 2>(p, grid, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// One launch at the shape (vec, unroll, hint, ctas_per_sm) on card `device`,
// made current for the launch where it is not (and the caller's put back).
// elems_per_vec: elements of a float4 (4 for a plane, 2 for complex64).
template <class Args>
int launch(const Args& p, int elems_per_vec, int vec, int unroll, int hint, int ctas_per_sm,
           int device, cudaStream_t st) {
  int prev = device;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  unsigned grid = 0;
  int rc = 0;
  const long long nv = p.n / elems_per_vec;
  if (!vec) {
    rc = grid_for(p.n, ctas_per_sm, device, &grid);
    if (!rc) {
      go<false, 1, 0>(p, grid, st);
      rc = static_cast<int>(cudaGetLastError());
    }
  } else if (unroll == 1 || unroll == 2 || unroll == 4) {
    rc = grid_for((nv + unroll - 1) / unroll, ctas_per_sm, device, &grid);
    if (!rc) {
      rc = unroll == 1 ? go_hint<1>(p, hint, grid, st)
           : unroll == 2 ? go_hint<2>(p, hint, grid, st)
                         : go_hint<4>(p, hint, grid, st);
    }
  } else {
    rc = static_cast<int>(cudaErrorInvalidValue);
  }
  if (prev != device) cudaSetDevice(prev);
  return rc;
}

}  // namespace

// Plain C entry points, loaded with ctypes; each returns the cudaError_t of
// the launch (0 = success) and launches on `stream` of card `device`, made
// current for the launch where it is not. vec != 0: every pointer is
// 16-byte aligned (checked by the wrapper); then unroll (1, 2 or 4 float4
// per stream a thread), hint (0-2) and ctas_per_sm (0: one group a thread)
// pick the launch shape. vec == 0: the scalar loop, whatever unroll and
// hint say.
extern "C" int cmul_sweep_planes_launch(const void* ar, const void* ai, const void* br,
                                        const void* bi, void* out_re, void* out_im,
                                        long long n, float scale, int conj_b, int vec,
                                        int unroll, int hint, int ctas_per_sm, int device,
                                        void* stream) {
  if (n <= 0) return 0;
  const PlanesArgs p{static_cast<const float*>(ar), static_cast<const float*>(ai),
                     static_cast<const float*>(br), static_cast<const float*>(bi),
                     static_cast<float*>(out_re), static_cast<float*>(out_im),
                     n, scale, conj_b};
  return launch(p, 4, vec, unroll, hint, ctas_per_sm, device,
                static_cast<cudaStream_t>(stream));
}

extern "C" int cmul_sweep_c64_launch(const void* a, const void* b, void* out, long long n,
                                     float scale, int conj_b, int vec, int unroll, int hint,
                                     int ctas_per_sm, int device, void* stream) {
  if (n <= 0) return 0;
  const C64Args p{static_cast<const float2*>(a), static_cast<const float2*>(b),
                  static_cast<float2*>(out), n, scale, conj_b};
  return launch(p, 2, vec, unroll, hint, ctas_per_sm, device,
                static_cast<cudaStream_t>(stream));
}
