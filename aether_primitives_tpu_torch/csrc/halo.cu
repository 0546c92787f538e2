// Left-halo push between shards for Hopper (sm_90a).
//
// Replaces the TPU kernel aether_primitives_tpu/ops/pallas/halo_rdma.py:
// _halo_kernel (wrapper halo_left_rdma). Along one mesh axis every shard
// pushes the trailing `overlap` elements of each row of its block straight
// into the receive buffer of its right neighbour; the first shard's buffer
// ends as zeros (the causal start). The buffer may lie on another card:
// under unified addressing a store through a pointer into a peer card's
// memory travels over NVLink, once peer access is enabled for the pair, so
// this kernel is the remote copy itself, not a call into a copy library.
// With sender and receiver on one card the same kernel runs with local
// pointers.
//
// One launch per sending shard, on the sender's device and stream. The
// wrapper (ops/cuda/halo.py) orders it against the receiver's stream with
// two events, the counterparts of the TPU kernel's send and receive
// semaphores.
//
// What the TPU kernel does differently, and why this one does not: it sends
// around the whole ring and lets the first shard overwrite the wrapped tail
// with zeros afterwards, because divergent sends deadlock there. On CUDA
// that order would be two writers racing for one buffer from two cards.
// Here the last shard pushes zeros into the first shard's buffer instead of
// its tail: the same result, one writer per buffer, still one uniform push
// per shard.
//
// What bounds it on an H100: bytes. A push reads rows * overlap elements
// and writes as many: 2 * rows * overlap * itemsize bytes, over 3.35 TB/s
// on one card or 450 GB/s one way across NVLink. At the RX chain's shape
// (64 complex64 a row, 512 bytes) that is nanoseconds, and the launch
// itself is the floor. What the design does about the bytes: it moves them
// as bytes whatever the dtype, gathers the strided tail itself (no
// contiguous copy of the tail is made first), and copies 16 bytes a thread,
// neighbouring threads on neighbouring addresses, where the source rows, the
// destination and the row length are 16-byte aligned; otherwise one element
// a thread (complex64 at an odd offset, float32 rows of odd length).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 16;

template <typename T> __device__ __forceinline__ T zero_unit() { return T(0); }
template <> __device__ __forceinline__ uint4 zero_unit<uint4>() {
  return make_uint4(0u, 0u, 0u, 0u);
}

// dst[r, c] = src[r * src_stride + c] (or zero), r < rows, c < row_units,
// all counts in units of T. src points at the first row's tail.
template <typename T>
__global__ void __launch_bounds__(kThreads)
halo_push_kernel(const T* __restrict__ src, T* __restrict__ dst, long long rows,
                 long long row_units, long long src_stride, int zeros) {
  const long long total = rows * row_units;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    if (zeros) {
      dst[i] = zero_unit<T>();
    } else {
      const long long r = i / row_units;
      dst[i] = src[r * src_stride + (i - r * row_units)];
    }
  }
}

template <typename T>
int launch(const void* src, void* dst, long long rows, long long row_bytes,
           long long src_stride_bytes, int zeros, cudaStream_t st) {
  const long long unit = static_cast<long long>(sizeof(T));
  const long long row_units = row_bytes / unit;
  const long long total = rows * row_units;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  halo_push_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      static_cast<const T*>(src), static_cast<T*>(dst), rows, row_units,
      src_stride_bytes / unit, zeros);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Push `rows` tails of `row_bytes` bytes each, `src_stride_bytes` apart at
// `src`, into the contiguous buffer `dst` (which may lie on a peer card), or
// zeros when `zeros` is set. `unit` is the copy granule in bytes (16, 8, 4,
// 2 or 1): the wrapper picks 16 where every address and length allows it,
// else the element size. Launches on `stream` of card `device`, the sender's,
// which is made current for the launch where it is not (and the caller's put
// back): cheaper than the wrapper switching devices from Python per push.
extern "C" int halo_push_launch(const void* src, void* dst, long long rows,
                                long long row_bytes, long long src_stride_bytes,
                                int unit, int zeros, int device, void* stream) {
  if (rows <= 0 || row_bytes <= 0) return 0;
  int prev = device;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  switch (unit) {
    case 16: rc = launch<uint4>(src, dst, rows, row_bytes, src_stride_bytes, zeros, st); break;
    case 8: rc = launch<uint64_t>(src, dst, rows, row_bytes, src_stride_bytes, zeros, st); break;
    case 4: rc = launch<uint32_t>(src, dst, rows, row_bytes, src_stride_bytes, zeros, st); break;
    case 2: rc = launch<uint16_t>(src, dst, rows, row_bytes, src_stride_bytes, zeros, st); break;
    case 1: rc = launch<uint8_t>(src, dst, rows, row_bytes, src_stride_bytes, zeros, st); break;
    default: rc = static_cast<int>(cudaErrorInvalidValue);
  }
  if (prev != device) cudaSetDevice(prev);
  return rc;
}

// Let kernels on card `sender` write memory of card `receiver` (access is
// per pair and per direction). Returns 0 when access is (already) enabled,
// -1 when the pair has no peer access, else the CUDA error.
extern "C" int halo_enable_peer(int sender, int receiver) {
  if (sender == receiver) return 0;
  int can = 0;
  cudaError_t err = cudaDeviceCanAccessPeer(&can, sender, receiver);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!can) return -1;
  int prev = 0;
  err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaSetDevice(sender);  // enabling applies to the current device
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceEnablePeerAccess(receiver, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();  // enabled earlier (by PyTorch or by us): clear it
    err = cudaSuccess;
  }
  cudaSetDevice(prev);
  return static_cast<int>(err);
}
