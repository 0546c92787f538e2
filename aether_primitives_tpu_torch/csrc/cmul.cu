// Fused complex multiply for Hopper (sm_90a): out = (a * b[conj]) * scale.
//
// Replaces the TPU kernel aether_primitives_tpu/ops/pallas/cmul.py:
// _cmul_kernel (wrappers cmul and cmul_c64). For every element
//   out_re = (ar*br - ai*bi) * s,   out_im = (ar*bi + ai*br) * s
// with bi negated first when conj_b is set. Every multiply, add and subtract
// is __fmul_rn / __fadd_rn / __fsub_rn in that order and the file is built
// without fast math, so nvcc cannot contract a product into an FMA that
// rounds differently: the kernel is bit-identical to the plain PyTorch
// version (ops/cuda/cmul.py cmul_reference), which rounds every op too.
//
// What bounds it on an H100: bytes. Six float32 planes of 4,194,304
// elements (four in, two out) are 100.7 MB, 0.030 ms at 3.35 TB/s, against
// 33.6 M FP32 operations (0.0005 ms). What the design does about it:
// - One pass, each element read and written once, with 16-byte vector loads
//   and stores where all pointers are 16-byte aligned (the wrapper checks)
//   and a scalar tail; a grid-stride loop takes any element count.
// - cmul_c64 reads the interleaved complex64 storage itself (two complex
//   values per float4), so the complex signature moves the same bytes as
//   the split one; the TPU wrapper split and merged its planes through
//   copies, which on a card would nearly double the traffic.
// The TPU kernel's row tiling and its VMEM budget (cmul.py:37-58) are a TPU
// workaround and have no counterpart here.

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

// Split planes: four inputs and two outputs of n float32 each.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
cmul_planes_kernel(const float* __restrict__ ar, const float* __restrict__ ai,
                   const float* __restrict__ br, const float* __restrict__ bi,
                   float* __restrict__ out_re, float* __restrict__ out_im,
                   long long n, float s, int conj_b) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long done = 0;
  if constexpr (kVec) {
    const long long n4 = n / 4;
    for (long long i = first; i < n4; i += stride) {
      const float4 a_r = reinterpret_cast<const float4*>(ar)[i];
      const float4 a_i = reinterpret_cast<const float4*>(ai)[i];
      const float4 b_r = reinterpret_cast<const float4*>(br)[i];
      const float4 b_i = reinterpret_cast<const float4*>(bi)[i];
      float4 o_r, o_i;
      cmul1(a_r.x, a_i.x, b_r.x, b_i.x, s, conj_b, o_r.x, o_i.x);
      cmul1(a_r.y, a_i.y, b_r.y, b_i.y, s, conj_b, o_r.y, o_i.y);
      cmul1(a_r.z, a_i.z, b_r.z, b_i.z, s, conj_b, o_r.z, o_i.z);
      cmul1(a_r.w, a_i.w, b_r.w, b_i.w, s, conj_b, o_r.w, o_i.w);
      reinterpret_cast<float4*>(out_re)[i] = o_r;
      reinterpret_cast<float4*>(out_im)[i] = o_i;
    }
    done = n4 * 4;
  }
  for (long long i = done + first; i < n; i += stride) {
    cmul1(ar[i], ai[i], br[i], bi[i], s, conj_b, out_re[i], out_im[i]);
  }
}

// Interleaved complex64: a, b and out hold n (re, im) pairs each.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
cmul_c64_kernel(const float2* __restrict__ a, const float2* __restrict__ b,
                float2* __restrict__ out, long long n, float s, int conj_b) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long done = 0;
  if constexpr (kVec) {
    const long long n2 = n / 2;  // float4 = two complex values
    for (long long i = first; i < n2; i += stride) {
      const float4 va = reinterpret_cast<const float4*>(a)[i];
      const float4 vb = reinterpret_cast<const float4*>(b)[i];
      float4 o;
      cmul1(va.x, va.y, vb.x, vb.y, s, conj_b, o.x, o.y);
      cmul1(va.z, va.w, vb.z, vb.w, s, conj_b, o.z, o.w);
      reinterpret_cast<float4*>(out)[i] = o;
    }
    done = n2 * 2;
  }
  for (long long i = done + first; i < n; i += stride) {
    const float2 va = a[i], vb = b[i];
    float2 o;
    cmul1(va.x, va.y, vb.x, vb.y, s, conj_b, o.x, o.y);
    out[i] = o;
  }
}

unsigned grid_for(long long work) {
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return static_cast<unsigned>(blocks);
}

}  // namespace

// vec != 0: every pointer is 16-byte aligned (checked by the wrapper).
extern "C" int cmul_planes_launch(const void* ar, const void* ai, const void* br,
                                  const void* bi, void* out_re, void* out_im,
                                  long long n, float scale, int conj_b, int vec,
                                  void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* a_r = static_cast<const float*>(ar);
  const float* a_i = static_cast<const float*>(ai);
  const float* b_r = static_cast<const float*>(br);
  const float* b_i = static_cast<const float*>(bi);
  float* o_r = static_cast<float*>(out_re);
  float* o_i = static_cast<float*>(out_im);
  if (vec) {
    cmul_planes_kernel<true><<<grid_for(n / 4 > 0 ? n / 4 : 1), kThreads, 0, st>>>(
        a_r, a_i, b_r, b_i, o_r, o_i, n, scale, conj_b);
  } else {
    cmul_planes_kernel<false><<<grid_for(n), kThreads, 0, st>>>(
        a_r, a_i, b_r, b_i, o_r, o_i, n, scale, conj_b);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cmul_c64_launch(const void* a, const void* b, void* out, long long n,
                               float scale, int conj_b, int vec, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float2* va = static_cast<const float2*>(a);
  const float2* vb = static_cast<const float2*>(b);
  float2* vo = static_cast<float2*>(out);
  if (vec) {
    cmul_c64_kernel<true><<<grid_for(n / 2 > 0 ? n / 2 : 1), kThreads, 0, st>>>(
        va, vb, vo, n, scale, conj_b);
  } else {
    cmul_c64_kernel<false><<<grid_for(n), kThreads, 0, st>>>(va, vb, vo, n, scale, conj_b);
  }
  return static_cast<int>(cudaGetLastError());
}
