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
// One launch per sending card, on that card's stream: a table of pushes
// {src, dst} (src null: push zeros) travels by value as a kernel parameter
// and blockIdx.y selects the push, so a card's shards cost one launch
// however many there are. The wrapper (ops/cuda/halo.py) orders the launch
// against the receiving cards' streams with one event per ordered pair of
// cards, the counterparts of the TPU kernel's send and receive semaphores.
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
// itself is the floor: hence one launch per card, not per shard. What the
// design does about the bytes: it moves them as bytes whatever the dtype,
// gathers the strided tail itself (no contiguous copy of the tail is made
// first), and copies 16 bytes a thread, neighbouring threads on neighbouring
// addresses, where every push's source rows, destination and row length are
// 16-byte aligned; otherwise one element a thread (complex64 at an odd
// offset, float32 rows of odd length).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 16;
// 128 pushes of two pointers: 2 KB of the 4 KB of kernel parameters.
constexpr int kMaxPushes = 128;

struct PushTable {
  const void* src[kMaxPushes];  // the first row's tail, or null for zeros
  void* dst[kMaxPushes];        // the receive buffer, contiguous
};

template <typename T> __device__ __forceinline__ T zero_unit() { return T(0); }
template <> __device__ __forceinline__ uint4 zero_unit<uint4>() {
  return make_uint4(0u, 0u, 0u, 0u);
}

// Push blockIdx.y: dst[r, c] = src[r * src_stride + c] (or zero), r < rows,
// c < row_units, all counts in units of T.
template <typename T>
__global__ void __launch_bounds__(kThreads)
halo_push_kernel(const __grid_constant__ PushTable table, long long rows,
                 long long row_units, long long src_stride) {
  const T* __restrict__ src = static_cast<const T*>(table.src[blockIdx.y]);
  T* __restrict__ dst = static_cast<T*>(table.dst[blockIdx.y]);
  const long long total = rows * row_units;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    if (src == nullptr) {
      dst[i] = zero_unit<T>();
    } else {
      const long long r = i / row_units;
      dst[i] = src[r * src_stride + (i - r * row_units)];
    }
  }
}

template <typename T>
int launch(const PushTable& table, int n_push, long long rows, long long row_bytes,
           long long src_stride_bytes, cudaStream_t st) {
  const long long unit = static_cast<long long>(sizeof(T));
  const long long row_units = row_bytes / unit;
  const long long total = rows * row_units;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(n_push));
  halo_push_kernel<T><<<grid, kThreads, 0, st>>>(table, rows, row_units,
                                                src_stride_bytes / unit);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The most pushes one launch takes (the table's size).
extern "C" int halo_max_pushes() { return kMaxPushes; }

// Push `n_push` blocks of `rows` tails of `row_bytes` bytes each,
// `src_stride_bytes` apart at `srcs[p]`, into the contiguous buffers
// `dsts[p]` (which may lie on peer cards), or zeros where `srcs[p]` is null.
// `unit` is the copy granule in bytes (16, 8, 4, 2 or 1): the wrapper picks
// 16 where every push's addresses and lengths allow it, else the element
// size. Launches on `stream` of card `device`, the sender's, which is made
// current for the launch where it is not (and the caller's put back):
// cheaper than the wrapper switching devices from Python.
extern "C" int halo_push_launch(const void* const* srcs, void* const* dsts, int n_push,
                                long long rows, long long row_bytes,
                                long long src_stride_bytes, int unit, int device,
                                void* stream) {
  if (n_push <= 0 || rows <= 0 || row_bytes <= 0) return 0;
  if (n_push > kMaxPushes) return static_cast<int>(cudaErrorInvalidValue);
  PushTable table = {};
  for (int p = 0; p < n_push; ++p) {
    table.src[p] = srcs[p];
    table.dst[p] = dsts[p];
  }
  int prev = device;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  switch (unit) {
    case 16: rc = launch<uint4>(table, n_push, rows, row_bytes, src_stride_bytes, st); break;
    case 8: rc = launch<uint64_t>(table, n_push, rows, row_bytes, src_stride_bytes, st); break;
    case 4: rc = launch<uint32_t>(table, n_push, rows, row_bytes, src_stride_bytes, st); break;
    case 2: rc = launch<uint16_t>(table, n_push, rows, row_bytes, src_stride_bytes, st); break;
    case 1: rc = launch<uint8_t>(table, n_push, rows, row_bytes, src_stride_bytes, st); break;
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
