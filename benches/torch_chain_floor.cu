// Empty kernels that make a decoder kernel's barriers and nothing else: the
// chain floor of its steps, measured. chip_smoke.py phase 7 launches them at
// the geometry of the launch it times:
//   - grid_floor_kernel: the grid's CTAs (cooperative launch, the same count
//     and threads as the Viterbi kernel's grid route, from its
//     viterbi_grid_geometry), `syncs` grid.sync()s;
//   - cluster_floor_kernel: the same CTAs, cluster size and threads as the
//     BCJR kernel's cluster route in its registers placement, each
//     direction's W warps making its Lw steps of exchange and nothing else:
//     a step waits on the direction's mbarrier, then each warp pushes one
//     partial key to every other CTA by st.async and arrives with the bytes
//     it expects; a cluster barrier before, at the meet and after, as the
//     kernel makes them;
//   - block_floor_kernel: the same CTAs and threads as the BCJR kernel's
//     shared route (one CTA a column, W warps a direction), each
//     direction's warps making the named barriers of its Lw steps and of
//     each half's start and end, and one CTA barrier at the meet, as the
//     kernel makes them.
// Built with ops/cuda/build.py load_source (plain C entries, ctypes).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

__global__ void grid_floor_kernel(long long syncs) {
  cg::grid_group grid = cg::this_grid();
  for (long long i = 0; i < syncs; ++i) grid.sync();
}

__device__ __forceinline__ unsigned cluster_map(const void* p, int rank) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(a), "r"(rank));
  return r;
}

__global__ void cluster_floor_kernel(int lw, int warps) {
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ int keys[2][2][32];
  __shared__ __align__(8) unsigned long long bars[2][2];
  const int q = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int d = warp < warps ? 0 : 1, w = warp < warps ? warp : warp - warps;
  const unsigned bar_s = static_cast<unsigned>(__cvta_generic_to_shared(&bars[0][0]));
  if (threadIdx.x == 0) {
    for (int i = 0; i < 4; ++i) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar_s + 8 * i), "r"(warps)
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster.sync();
  int j = 0;
  unsigned ph = 0u;
  auto wait = [&](int p) {
    unsigned done;
    do {
      asm volatile(
          "{\n .reg .pred p;\n"
          " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done) : "r"(bar_s + 8 * (2 * d + p)), "r"((ph >> p) & 1u) : "memory");
    } while (!done);
    ph ^= 1u << p;
  };
  auto steps = [&](int count) {
    for (int i = 0; i < count; ++i) {
      const int p = j & 1, pn = p ^ 1;
      if (j > 0) wait(p);
      if (lane == rank) {
        keys[d][pn][rank * warps + w] = j;
      } else if (lane < q) {
        asm volatile(
            "st.async.shared::cluster.mbarrier::complete_tx::bytes.s32 [%0], %1, [%2];\n"
            ::"r"(cluster_map(&keys[d][pn][rank * warps + w], lane)), "r"(j),
            "r"(cluster_map(&bars[d][pn], lane)) : "memory");
      }
      __syncwarp();
      if (lane == 0) {
        asm volatile("mbarrier.arrive.expect_tx.release.cta.shared::cta.b64 _, [%0], %1;\n"
                     ::"r"(bar_s + 8 * (2 * d + pn)), "r"(4 * (q - 1)) : "memory");
      }
      ++j;
    }
  };
  const int mid = lw >> 1;
  steps(d == 0 ? mid : lw - mid);
  cluster.sync();  // the meet
  steps(d == 0 ? lw - mid : mid);
  wait(j & 1);
  cluster.sync();
}

__global__ void block_floor_kernel(int lw, int warps) {
  const bool forward = static_cast<int>(threadIdx.x >> 5) < warps;
  auto bar = [&] {
    asm volatile("bar.sync %0, %1;\n" ::"r"(forward ? 1 : 2), "r"(32 * warps) : "memory");
  };
  const int mid = lw >> 1;
  const int first = forward ? mid : lw - mid;
  for (int i = 0; i <= first; ++i) bar();  // the half's start and its steps
  __syncthreads();  // the meet
  for (int i = 0; i <= lw - first + 1; ++i) bar();  // start, steps, the last LLR's
}

}  // namespace

// One launch of `ctas` CTAs of 64 `warps` threads, each direction's
// `warps` warps making the named barriers of `lw` steps. Returns the
// cudaError_t of the launch.
extern "C" int block_floor_launch(long long ctas, int warps, int lw, void* stream) {
  if (warps < 1 || warps > 8 || lw < 1 || ctas < 1) return static_cast<int>(cudaErrorInvalidValue);
  block_floor_kernel<<<static_cast<unsigned>(ctas), 64 * warps, 0,
                       static_cast<cudaStream_t>(stream)>>>(lw, warps);
  return static_cast<int>(cudaGetLastError());
}

// One cooperative launch of `grid` CTAs of `threads` threads making `syncs`
// grid barriers. Returns the cudaError_t of the launch (0 = success).
extern "C" int grid_floor_launch(int grid, int threads, long long syncs, void* stream) {
  void* args[] = {&syncs};
  cudaError_t err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(grid_floor_kernel),
                                                dim3(grid), dim3(threads), args, 0,
                                                static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// One launch of `ctas` CTAs of 64 `warps` threads in clusters of `q`, each
// direction's `warps` warps making `lw` steps of exchange. Returns the
// cudaError_t of the launch.
extern "C" int cluster_floor_launch(long long ctas, int q, int warps, int lw, void* stream) {
  if (q < 2 || q > 8 || q * warps > 32 || lw < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(ctas));
  cfg.blockDim = dim3(64 * warps);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = q;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, cluster_floor_kernel, lw, warps);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
