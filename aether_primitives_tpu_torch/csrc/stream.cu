// Streamed chunk-broadcast complex multiply for Hopper (sm_90a):
// out = x * tile(r), x streamed through a multi-stage ring in shared memory.
//
// Replaces the TPU kernel aether_primitives_tpu/ops/pallas/stream.py:
// _stream_kernel (wrapper streamed_cmul). x and out are [rows, lanes] split
// float32 planes, r is [chunk_rows, lanes] and multiplies every chunk of
// chunk_rows rows of x:
//   out_re = xr*rr - xi*ri,   out_im = xr*ri + xi*rr
// each product and sum rounded on its own (__fmul_rn, __fsub_rn, __fadd_rn,
// no fast math), so the kernel is bit-identical to the plain PyTorch version
// (ops/cuda/stream.py streamed_cmul_reference).
//
// What bounds it on an H100: bytes. At x [2048, 2048] with chunk_rows 128 it
// moves 69.2 MB (x and out, both planes, and r once): 0.021 ms at 3.35 TB/s.
// Little's law at that rate and about a microsecond of latency asks for some
// 25 KB of loads in flight on every SM. The Pallas kernel kept r resident in
// VMEM and streamed x chunk by chunk through a two-slot VMEM ring. The Hopper
// form:
// - A chunk is chunk_rows * lanes consecutive elements of the flattened x,
//   so position j of every chunk meets the same r[j]. A CTA owns a tile of
//   kThreads * kVec * kUnroll consecutive positions and keeps their r values
//   in registers (r is 2 MB at the path's shape and stays in L2, so each
//   chunk group re-reading it costs no DRAM time).
// - The grid is (position tile) x (chunk group): a CTA walks only its own
//   group of consecutive chunks, so the wrapper can put several CTAs on
//   every SM whatever the chunk count.
// - x comes through a kStages-deep cp.async ring in shared memory: the copies
//   of kStages - 1 chunks are in flight while one is computed (kUnroll 16-byte
//   copies per plane a thread a stage; 8 KB a stage for each unroll step of a
//   256-thread CTA). Each thread copies and reads only its own bytes, so the
//   ring needs no barrier between threads.
// - Stores go straight from registers to device memory with the streaming
//   hint (st.global.cs), 16 bytes a thread: out is not read again.
// The scalar instance (kVec 1) takes chunks that are not a multiple of 4 and
// planes that are not 16-byte aligned. The TPU wrapper's VMEM-size refusal
// (stream.py:109-114) has no counterpart; the divisibility check stays in
// the wrapper.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kScalarUnroll = 4;  // the scalar instance's copies per plane a stage

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>  // wait until at most kPending groups are in flight
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// kVec elements of each plane per copy (4: 16 bytes, 1: 4 bytes), kUnroll
// copies per plane a thread a stage, a ring kStages deep.
template <int kVec, int kUnroll, int kStages>
__global__ void __launch_bounds__(kThreads)
stream_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
              const float* __restrict__ rr, const float* __restrict__ ri,
              float* __restrict__ out_re, float* __restrict__ out_im,
              long long chunk, int n_chunks, int chunks_per_cta) {
  constexpr int kStep = kThreads * kVec;       // positions of one unroll step
  constexpr int kTile = kStep * kUnroll;       // positions of a CTA
  extern __shared__ __align__(16) float ring[];  // [kStages][2 planes][kTile]
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  const int t = threadIdx.x * kVec;
  const int c_begin = blockIdx.y * chunks_per_cta;
  const int c_end = min(n_chunks, c_begin + chunks_per_cta);

  // kVec 4 implies chunk % 4 == 0: j + 3 < chunk whenever j < chunk
  float r_re[kUnroll][kVec], r_im[kUnroll][kVec];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long j = base + u * kStep + t;
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      r_re[u][e] = j < chunk ? rr[j + e] : 0.f;
      r_im[u][e] = j < chunk ? ri[j + e] : 0.f;
    }
  }

  auto start_copy = [&](int c, int slot) {
    if (c < c_end) {
      float* s_re = ring + static_cast<size_t>(slot) * 2 * kTile;
      float* s_im = s_re + kTile;
      const long long g0 = static_cast<long long>(c) * chunk;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long j = base + u * kStep + t;
        if (j < chunk) {
          if constexpr (kVec == 4) {
            cp_async16(s_re + u * kStep + t, xr + g0 + j);
            cp_async16(s_im + u * kStep + t, xi + g0 + j);
          } else {
            cp_async4(s_re + u * kStep + t, xr + g0 + j);
            cp_async4(s_im + u * kStep + t, xi + g0 + j);
          }
        }
      }
    }
    cp_async_commit();  // empty groups past the end keep the wait count uniform
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) start_copy(c_begin + s, s);
  for (int c = c_begin; c < c_end; ++c) {
    const int i = c - c_begin;
    start_copy(c + kStages - 1, (i + kStages - 1) % kStages);  // the slot read last
    cp_async_wait<kStages - 1>();  // chunk c has landed in its slot
    const float* s_re = ring + static_cast<size_t>(i % kStages) * 2 * kTile;
    const float* s_im = s_re + kTile;
    const long long g0 = static_cast<long long>(c) * chunk;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = base + u * kStep + t;
      if (j < chunk) {
        float o_re[kVec], o_im[kVec];
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const float a = s_re[u * kStep + t + e];
          const float b = s_im[u * kStep + t + e];
          o_re[e] = __fsub_rn(__fmul_rn(a, r_re[u][e]), __fmul_rn(b, r_im[u][e]));
          o_im[e] = __fadd_rn(__fmul_rn(a, r_im[u][e]), __fmul_rn(b, r_re[u][e]));
        }
        if constexpr (kVec == 4) {
          __stcs(reinterpret_cast<float4*>(out_re + g0 + j),
                 make_float4(o_re[0], o_re[1], o_re[2], o_re[3]));
          __stcs(reinterpret_cast<float4*>(out_im + g0 + j),
                 make_float4(o_im[0], o_im[1], o_im[2], o_im[3]));
        } else {
          __stcs(out_re + g0 + j, o_re[0]);
          __stcs(out_im + g0 + j, o_im[0]);
        }
      }
    }
  }
}

template <int kVec, int kUnroll, int kStages>
int launch(const float* xr, const float* xi, const float* rr, const float* ri,
           float* out_re, float* out_im, long long chunk, int n_chunks,
           int chunks_per_cta, cudaStream_t st) {
  constexpr long long kTile = static_cast<long long>(kThreads) * kVec * kUnroll;
  const long long tiles = (chunk + kTile - 1) / kTile;
  const long long groups = (n_chunks + chunks_per_cta - 1) / chunks_per_cta;
  if (tiles > 0x7fffffffLL || groups > 65535) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = static_cast<int>(kStages * 2 * kTile * sizeof(float));
  // the opt-in above 48 KB, once per instance and card (the attribute is
  // per device; a launch is host-bound enough without a call per launch)
  static bool opted[64] = {};
  int dev = 0;
  if (smem > 48 * 1024 && (cudaGetDevice(&dev) != cudaSuccess || dev >= 64 || !opted[dev])) {
    const cudaError_t err = cudaFuncSetAttribute(
        stream_kernel<kVec, kUnroll, kStages>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= 0 && dev < 64) opted[dev] = true;
  }
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(groups));
  stream_kernel<kVec, kUnroll, kStages><<<grid, kThreads, smem, st>>>(
      xr, xi, rr, ri, out_re, out_im, chunk, n_chunks, chunks_per_cta);
  return static_cast<int>(cudaGetLastError());
}

template <int kVec, int kUnroll>
int launch_stages(int stages, const float* xr, const float* xi, const float* rr,
                  const float* ri, float* out_re, float* out_im, long long chunk,
                  int n_chunks, int chunks_per_cta, cudaStream_t st) {
  switch (stages) {
    case 2: return launch<kVec, kUnroll, 2>(xr, xi, rr, ri, out_re, out_im, chunk, n_chunks, chunks_per_cta, st);
    case 3: return launch<kVec, kUnroll, 3>(xr, xi, rr, ri, out_re, out_im, chunk, n_chunks, chunks_per_cta, st);
    case 4: return launch<kVec, kUnroll, 4>(xr, xi, rr, ri, out_re, out_im, chunk, n_chunks, chunks_per_cta, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int launch_vec(const void* xr, const void* xi, const void* rr, const void* ri,
               void* out_re, void* out_im, long long chunk, int n_chunks,
               int chunks_per_cta, int vec, int unroll, int stages, cudaStream_t st) {
  const float* x_r = static_cast<const float*>(xr);
  const float* x_i = static_cast<const float*>(xi);
  const float* r_r = static_cast<const float*>(rr);
  const float* r_i = static_cast<const float*>(ri);
  float* o_r = static_cast<float*>(out_re);
  float* o_i = static_cast<float*>(out_im);
#define STREAM_ARGS x_r, x_i, r_r, r_i, o_r, o_i, chunk, n_chunks, chunks_per_cta, st
  if (vec) {
    switch (unroll) {
      case 1: return launch_stages<4, 1>(stages, STREAM_ARGS);
      case 2: return launch_stages<4, 2>(stages, STREAM_ARGS);
      case 4: return launch_stages<4, 4>(stages, STREAM_ARGS);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  // the scalar ring: four 4-byte copies per plane a thread a stage, 4 deep
  return launch<1, kScalarUnroll, 4>(STREAM_ARGS);
#undef STREAM_ARGS
}

}  // namespace

// chunk = chunk_rows * lanes elements, n_chunks = rows / chunk_rows; the grid
// is ceil(chunk / tile) x ceil(n_chunks / chunks_per_cta) CTAs. vec != 0:
// chunk % 4 == 0 and every pointer is 16-byte aligned (checked by the
// wrapper); then unroll 1, 2 or 4 16-byte copies per plane a thread a stage
// and stages 2-4 pick the instance. vec == 0: the scalar instance, whatever
// unroll and stages say.
// Launches on `stream` of card `device`, which is made current for the
// launch where it is not (and the caller's put back).
extern "C" int stream_launch(const void* xr, const void* xi, const void* rr,
                             const void* ri, void* out_re, void* out_im,
                             long long chunk, int n_chunks, int chunks_per_cta,
                             int vec, int unroll, int stages, int device, void* stream) {
  if (chunk <= 0 || n_chunks <= 0) return 0;
  if (chunks_per_cta <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int prev = device;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  const int rc = launch_vec(xr, xi, rr, ri, out_re, out_im, chunk, n_chunks, chunks_per_cta,
                            vec, unroll, stages, static_cast<cudaStream_t>(stream));
  if (prev != device) cudaSetDevice(prev);
  return rc;
}
