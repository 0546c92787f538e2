// Streamed chunk-broadcast complex multiply for Hopper (sm_90a):
// out = x * tile(r), x streamed through a two-stage ring in shared memory.
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
// The Pallas kernel kept r resident in VMEM and streamed x chunk by chunk
// through a two-slot VMEM ring with DMA semaphores. The Hopper form:
// - A chunk is chunk_rows * lanes consecutive elements of the flattened x,
//   so position j of every chunk meets the same r[j]. A block owns 256 * 4
//   consecutive positions (256 when the planes are not 16-byte aligned or
//   the chunk is not a multiple of 4) and keeps their r values in
//   registers: r is read from device memory once in all.
// - The block then walks every chunk. Its x tiles come through a two-stage
//   cp.async ring in shared memory: start the copy of chunk c + 1 into one
//   slot, wait for chunk c in the other, compute, store. Each thread copies
//   and reads only its own 16 bytes of each plane, so the ring needs no
//   barrier between threads.
// - Stores go straight from registers to device memory, 16 bytes a thread.
// The TPU wrapper's VMEM-size refusal (stream.py:109-114) has no
// counterpart; the divisibility check stays in the wrapper.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_prior() {  // all but the newest group
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// kVec elements of each plane per thread (4: float4, 1: scalar).
template <int kVec>
__global__ void __launch_bounds__(kThreads)
stream_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
              const float* __restrict__ rr, const float* __restrict__ ri,
              float* __restrict__ out_re, float* __restrict__ out_im,
              long long chunk, int n_chunks) {
  __shared__ __align__(16) float ring[2][2][kThreads * kVec];  // [slot][plane][elem]
  const int t = threadIdx.x * kVec;
  const long long j = static_cast<long long>(blockIdx.x) * (kThreads * kVec) + t;
  const bool live = j < chunk;  // kVec 4 implies chunk % 4 == 0: j + 3 < chunk too

  float r_re[kVec], r_im[kVec];
  if (live) {
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      r_re[e] = rr[j + e];
      r_im[e] = ri[j + e];
    }
  }

  auto start_copy = [&](int c, int slot) {
    if (live) {
      const long long g = static_cast<long long>(c) * chunk + j;
      if constexpr (kVec == 4) {
        cp_async16(&ring[slot][0][t], xr + g);
        cp_async16(&ring[slot][1][t], xi + g);
      } else {
        cp_async4(&ring[slot][0][t], xr + g);
        cp_async4(&ring[slot][1][t], xi + g);
      }
    }
    cp_async_commit();
  };

  start_copy(0, 0);
  for (int c = 0; c < n_chunks; ++c) {
    const int slot = c & 1;
    if (c + 1 < n_chunks) {
      start_copy(c + 1, slot ^ 1);
    } else {
      cp_async_commit();  // an empty group keeps the wait count uniform
    }
    cp_async_wait_prior();  // chunk c has landed in its slot
    if (live) {
      const long long g = static_cast<long long>(c) * chunk + j;
      float o_re[kVec], o_im[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float a = ring[slot][0][t + e];
        const float b = ring[slot][1][t + e];
        o_re[e] = __fsub_rn(__fmul_rn(a, r_re[e]), __fmul_rn(b, r_im[e]));
        o_im[e] = __fadd_rn(__fmul_rn(a, r_im[e]), __fmul_rn(b, r_re[e]));
      }
      if constexpr (kVec == 4) {
        *reinterpret_cast<float4*>(out_re + g) = make_float4(o_re[0], o_re[1], o_re[2], o_re[3]);
        *reinterpret_cast<float4*>(out_im + g) = make_float4(o_im[0], o_im[1], o_im[2], o_im[3]);
      } else {
        out_re[g] = o_re[0];
        out_im[g] = o_im[0];
      }
    }
  }
}

}  // namespace

// chunk = chunk_rows * lanes elements, n_chunks = rows / chunk_rows.
// vec != 0: chunk % 4 == 0 and every pointer is 16-byte aligned (checked by
// the wrapper).
extern "C" int stream_launch(const void* xr, const void* xi, const void* rr,
                             const void* ri, void* out_re, void* out_im,
                             long long chunk, int n_chunks, int vec, void* stream) {
  if (chunk <= 0 || n_chunks <= 0) return 0;
  const long long per_block = static_cast<long long>(kThreads) * (vec ? 4 : 1);
  const long long blocks = (chunk + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* x_r = static_cast<const float*>(xr);
  const float* x_i = static_cast<const float*>(xi);
  const float* r_r = static_cast<const float*>(rr);
  const float* r_i = static_cast<const float*>(ri);
  float* o_r = static_cast<float*>(out_re);
  float* o_i = static_cast<float*>(out_im);
  if (vec) {
    stream_kernel<4><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        x_r, x_i, r_r, r_i, o_r, o_i, chunk, n_chunks);
  } else {
    stream_kernel<1><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        x_r, x_i, r_r, r_i, o_r, o_i, chunk, n_chunks);
  }
  return static_cast<int>(cudaGetLastError());
}
