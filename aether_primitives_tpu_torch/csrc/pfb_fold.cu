// Polyphase filterbank fold for Hopper (sm_90a): the weighted overlap-add
// of the oversampled PFB analysis and of the PFB synthesis, on interleaved
// complex64 samples as the channelizer holds them.
//
// Replaces the TPU kernel aether_primitives_tpu/ops/pallas/pfb_fold.py:
// _fold_kernel (wrapper pfb_fold_os). Three layouts of one kernel:
// - analysis (pfb_channelize_os, PfbChannelizerOs, sharded_pfb_os): the
//   samples are two sources, a head and a body (the carried tail and the
//   new block, or a shard and its right halo; sample s is head[s] for
//   s < n_head, else body[s - n_head], zero past the end). For class j
//   (hop = M / os), class frame i and column c it writes frame t = i*os + j
//   of out[t, c] = sum_{p=0}^{P-1} hb[p, r] * x[j*hop + (i + p)*M + r],
//   r = (c - j*hop) mod M (the class's reference roll), frames t >= t_out
//   masked;
// - synthesis (pfb_synthesize_os, PfbSynthesizerOs, and pfb_synthesize when
//   asked for): frames v [T, M] in, the raw overlap-add out: class j's
//   frames v[i*os + j] spread with the reversed branches g[q] = hb[P-1-q],
//   out[U*M + c] = sum over classes j, in j order, of
//   sum_q g[q, r] * v[(U - d + q - (P-1))*os + j, c] with d = (c < j*hop),
//   r = (c - j*hop) mod M, zero frames outside [0, T), and a literal +0.0
//   for a class whose spread does not reach U*M + c;
// - planes (pfb_fold_os, the TPU wrapper's counterpart): split float32
//   planes in, [os, t_cls, M] planes out, the analysis sum.
// Branches are real (float) or complex (float2: acc.re += xr*hr - xi*hi,
// acc.im += xr*hi + xi*hr). Every product, difference and sum is
// __fmul_rn / __fsub_rn / __fadd_rn in p order from the p = 0 term, the
// file is built without fast math, so no FMA contraction rounds differently
// from the plain PyTorch twins: the two are bit-identical.
//
// What bounds it on an H100: both floors, close together. At the
// channelizer's steady analysis step (os 2, M 2,048, P 33, 2,048 frames a
// class) it reads 34 MB and writes 67 MB (0.030 ms at 3.35 TB/s) and issues
// 1.09 G FP32 instructions: a multiply and an add a term, never an FMA
// (0.033 ms at 132 SMs x 128 lanes x 1.98 GHz; the synthesis step the
// same). Only a kernel that loads while it computes gets near either.
// What the design does about it:
// - A block owns a strip of 64 columns (input column c feeds output column
//   c in every class: the roll only moves a class's rows down by one where
//   c < j*hop) and walks a run of tiles of it: 128 class frames (analysis:
//   8 thread rows x 16 frames, one 512-thread block an SM) or 44 output
//   rows (synthesis: 4 x 11, two 256-thread blocks an SM). The grid is the
//   strips times as many runs as fill the SMs once; where the tiles are too
//   few to (few frames a class, a large os), an analysis tile's classes are
//   split over several blocks, each re-reading the tile's slab.
// - Its slabs, (tile + P) rows of 64 complex64 samples (82 KB analysis, 39
//   KB synthesis at P = 33), go through a ring of 2 stages (1 where two do
//   not fit) filled by cp.async: the next slab loads while this one's
//   branch loop runs. An analysis slab feeds all os classes; synthesis
//   stages one slab per class, and a tile's classes are added in registers.
// - A slab whose rows are whole strips inside one source, 16-byte aligned
//   (every tile of the path but the one at the head/body seam), is copied
//   with one check and plain 16-byte copies; any other row pair by pair, 8
//   bytes a sample where it straddles the seam, lies at an odd offset or in
//   the ragged strip, zeros past the end.
// - Each thread owns 16 frames (11 synthesis rows) of one column: their
//   accumulators and a window of the slab rows the current branch reads
//   stay in registers, and each branch loads one new row (one 8-byte shared
//   load for both planes) and one weight.
// - The block's weights, os x P x 64 of them (the strip's columns r of each
//   class), are loaded once into shared memory where they fit beside one
//   slab. Past that (a large os x P) an instance stages one class's weights
//   a chunk of 4 x 16 (synthesis 4 x 11) branches at a time between two
//   block barriers, so the kernel takes any P whose slab fits beside a
//   chunk, at every os: P <= 294 real / 262 complex (analysis, planes),
//   388 / 366 (synthesis).
// - Frames go out interleaved, in frame order, as coalesced rows; the
//   ragged edges are masked here, so no caller pads, concatenates,
//   de-interleaves or splits planes. The synthesis stage's tail add and
//   periodic division (its epilogue) run on the way out.
// On the H100 (benches/torch_pfb_fold_sweep.py) the analysis layout takes
// ~0.063 ms and the synthesis ~0.084 ms. The branch loop bounds it: with
// neither the slab copies nor the frame stores running, the analysis still
// takes ~0.055 ms, ~60% of the issue rate, though a branch is FP32 work
// beside two shared loads (a block's warps reach each branch together).
// A ring of rows (each tile loading only its new rows, two blocks an SM)
// was slower: the wrap test in the window loads cost more than the
// re-reads it saved.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

// Tile shapes (benches/torch_pfb_fold_sweep.py times others in edited
// copies of this file).
constexpr int kRowsAnalysis = 8;     // analysis (and planes): thread rows of 64 columns
constexpr int kFramesAnalysis = 16;  // analysis (and planes): class frames a thread
constexpr int kRowsSynthesis = 4;    // synthesis: thread rows of 64 columns
constexpr int kFramesSynthesis = 11; // synthesis: output rows a thread

constexpr int kStrip = 64;

enum Mode : int { kAnalysis = 0, kSynthesis = 1, kPlanes = 2 };

struct Params {
  const float2* src0;  // analysis: head; synthesis: frames [T, M]
  const float2* src1;  // analysis: body (may be null when n1 == 0)
  const float* x_re;   // planes
  const float* x_im;
  long long n0, n1;            // samples a row of each source
  long long stride0, stride1;  // elements between batch rows
  const void* w;               // [P, M] float or float2
  float2* out;                 // analysis [batch, t_out, M]; synthesis [batch, emit]
  float* out_re;               // planes [batch, os, t_cls, M]
  float* out_im;
  long long out_len;  // synthesis: samples a row of the overlap-add
  // synthesis epilogue: tail [batch, tail_len] added to the first samples,
  // samples below emit divided by div[u mod hop] (div may be null) into
  // out, the rest into rest [batch, out_len - emit]
  const float2* tail;
  long long tail_len;
  const float* div;
  long long emit;
  float2* rest;
  int m, p, os, hop;
  int t_out;  // analysis: frames; planes: class frames
  int t_cls;  // analysis, planes: class frames; synthesis: slabs a class (T_cls + P - 1)
  int n_tiles, tiles_per_block, stages;
  // analysis, planes: runs of classes a tile is split into (blockIdx.z is
  // row * groups + run; 1 unless the tiles alone leave SMs idle)
  int groups;
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most `pending` (0 or 1) of this thread's groups are in flight
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending == 1) {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  } else {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  }
}

__device__ __forceinline__ float2 zero2() { return make_float2(0.0f, 0.0f); }

// the twins' term and sum, rounded one operation at a time
__device__ __forceinline__ float2 term(float2 x, float w) {
  return make_float2(__fmul_rn(x.x, w), __fmul_rn(x.y, w));
}
__device__ __forceinline__ float2 term(float2 x, float2 w) {
  return make_float2(__fsub_rn(__fmul_rn(x.x, w.x), __fmul_rn(x.y, w.y)),
                     __fadd_rn(__fmul_rn(x.x, w.y), __fmul_rn(x.y, w.x)));
}
__device__ __forceinline__ float2 add2(float2 a, float2 b) {
  return make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
}

// sample s of batch row b of the two-source stream
__device__ __forceinline__ const float2* stream_at(const Params& a, long long b, long long s) {
  return s < a.n0 ? a.src0 + b * a.stride0 + s : a.src1 + b * a.stride1 + (s - a.n0);
}

// stream samples s, s + 1 into dst[0..1] (shared, 16-byte aligned); a
// sample whose column lies outside the strip (ok0 / ok1 false) or past the
// stream's end is a zero
__device__ __forceinline__ void load_pair(float2* dst, const Params& a, long long b,
                                          long long s, bool ok0, bool ok1) {
  const long long n = a.n0 + a.n1;
  ok0 = ok0 && s < n;
  ok1 = ok1 && s + 1 < n;
  if (ok0 && ok1 && (s + 1 < a.n0 || s >= a.n0)) {
    const float2* src = stream_at(a, b, s);
    if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      cp_async16(dst, src);
      return;
    }
  }
  if (ok0) {
    cp_async8(dst, stream_at(a, b, s));
  } else {
    dst[0] = zero2();
  }
  if (ok1) {
    cp_async8(dst + 1, stream_at(a, b, s + 1));
  } else {
    dst[1] = zero2();
  }
}

// One class's sum for the F frames of a thread: acc[t] = sum_q term(row t +
// q of col, w[q]). Slab row t + q of this column sits in window slot
// (t + q) % F once loaded; branch q reads rows q .. q + F - 1, and then slot
// q % F takes row q + F. Branch q's weight is wcol[q * 64] (WS: every
// branch staged) or, without WS, wcol[(q % KQ) * 64] of the chunk of KQ
// branches (a multiple of F) that stage(q0) puts in shared memory at q0 =
// 0, KQ, 2 KQ, ...: then every thread of the block makes the call.
template <int F, int KQ, bool WS, typename Tw, typename Stage>
__device__ __forceinline__ void fold_class(const float2* __restrict__ col,
                                           const Tw* __restrict__ wcol, int p,
                                           float2 (&acc)[F], Stage&& stage) {
  float2 xw[F];
#pragma unroll
  for (int t = 0; t < F; ++t) xw[t] = col[t * kStrip];
  if (!WS) stage(0);
  {
    const Tw w = wcol[0];
#pragma unroll
    for (int t = 0; t < F; ++t) acc[t] = term(xw[t], w);
    if (p > 1) xw[0] = col[F * kStrip];
  }
  for (int qb = 0; qb < p; qb += F) {
    const int qc = WS ? qb : qb % KQ;  // wcol row of branch qb
    if (!WS && qb > 0 && qc == 0) stage(qb);
#pragma unroll
    for (int k = 0; k < F; ++k) {
      const int q = qb + k;
      if (q >= p) break;
      if (q == 0) continue;  // the p = 0 terms above
      const Tw w = wcol[(qc + k) * kStrip];
#pragma unroll
      for (int t = 0; t < F; ++t) acc[t] = add2(acc[t], term(xw[(k + t) % F], w));
      if (q + 1 < p) xw[k] = col[(q + F) * kStrip];
    }
  }
}

template <int M_, bool CT>
struct Inst {
  static constexpr int kRows = M_ == kSynthesis ? kRowsSynthesis : kRowsAnalysis;
  static constexpr int kFrames = M_ == kSynthesis ? kFramesSynthesis : kFramesAnalysis;
  static constexpr int kThreads = kStrip * kRows;
  static constexpr int kMinBlocks = kThreads >= 512 ? 1 : 512 / kThreads;  // <= 128 registers
  static constexpr int kTile = kRows * kFrames;
  static constexpr int kChunk = 4 * kFrames;  // branches a weight chunk (without WS)
  using Tw = typename std::conditional<CT, float2, float>::type;
};

// WS: the strip's weights of every class staged in shared memory once (where
// they fit beside one slab), else one class's chunk of kChunk branches at a
// time
template <int M_, bool CT, bool WS>
__global__ void __launch_bounds__(Inst<M_, CT>::kThreads, Inst<M_, CT>::kMinBlocks)
    pfb_fold_kernel(const Params a) {
  using I = Inst<M_, CT>;
  using Tw = typename I::Tw;
  constexpr int F = I::kFrames;
  constexpr int kTile = I::kTile;
  constexpr int kThreads = I::kThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int p = a.p;
  const int slab_rows = kTile + p;
  float2* ring = reinterpret_cast<float2*>(smem_raw);  // [stages][slab_rows][64]
  // WS: [os][p][64]; else [kChunk][64]
  Tw* sw = reinterpret_cast<Tw*>(ring + a.stages * slab_rows * kStrip);

  const int tid = threadIdx.x;
  const int tx = tid & (kStrip - 1);
  const int tl = (tid / kStrip) * F;  // first local frame (row) of this thread
  const int c0 = blockIdx.y * kStrip;
  const int c = c0 + tx;
  const bool col_ok = c < a.m;
  const long long b = blockIdx.z / a.groups;
  const int g = blockIdx.z - static_cast<int>(b) * a.groups;  // this block's classes
  const int j_lo = g * a.os / a.groups, j_hi = (g + 1) * a.os / a.groups;
  const int tile0 = blockIdx.x * a.tiles_per_block;
  const int n_my = min(a.tiles_per_block, a.n_tiles - tile0);
  const int upt = M_ == kSynthesis ? a.os : 1;  // pipeline steps a tile
  const int n_steps = n_my * upt;

  // the strip's weights of every class, once: column r = (c - j*hop) mod M
  // (in the first commit group)
  for (int e = tid; WS && e < a.os * p * kStrip; e += kThreads) {
    const int cc = c0 + (e & (kStrip - 1));
    const int jq = e / kStrip;
    const int j = jq / p;
    const int q = jq - j * p;
    if (cc < a.m) {
      int r = cc - j * a.hop;
      if (r < 0) r += a.m;
      const Tw* src = static_cast<const Tw*>(a.w) + static_cast<long long>(q) * a.m + r;
      if (CT) {
        cp_async8(sw + e, src);
      } else {
        cp_async4(sw + e, src);
      }
    } else {
      sw[e] = Tw{};
    }
  }

  // slab of pipeline step u into ring stage `stage`
  auto load_unit = [&](int u, int stage) {
    const int tile = tile0 + u / upt;
    const int j = u % upt;
    float2* slab = ring + stage * slab_rows * kStrip;
    if (M_ == kPlanes) {
      const long long row0 = static_cast<long long>(tile) * kTile;
      for (int e = tid; e < slab_rows * kStrip; e += kThreads) {
        const int cc = c0 + (e & (kStrip - 1));
        const long long s = (row0 + e / kStrip) * a.m + cc;
        float2* d = slab + e;
        if (cc < a.m && s < a.n0) {
          cp_async4(&d->x, a.x_re + b * a.n0 + s);
          cp_async4(&d->y, a.x_im + b * a.n0 + s);
        } else {
          *d = zero2();
        }
      }
      return;
    }
    // slab row rho is stream row first + rho * step (synthesis: class j's
    // frame i*os + j for class frame i = U0 - P + rho)
    const long long first = M_ == kAnalysis
                                ? static_cast<long long>(tile) * kTile
                                : (static_cast<long long>(tile) * kTile - p) * a.os + j;
    const long long step = M_ == kAnalysis ? 1 : a.os;
    // the common case: every row a whole strip inside one source, 16-byte
    // aligned; one check a unit, then plain 16-byte copies
    const long long s_lo = first * a.m + c0;
    const long long s_hi = (first + (slab_rows - 1) * step) * a.m + c0 + kStrip;
    const bool in_head = s_hi <= a.n0;
    if (first >= 0 && c0 + kStrip <= a.m && (a.m & 1) == 0 &&
        (in_head || (s_lo >= a.n0 && s_hi <= a.n0 + a.n1))) {
      const float2* src = stream_at(a, b, s_lo);
      if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
        const long long row_step = step * a.m;
        for (int e = tid; e < slab_rows * (kStrip / 2); e += kThreads) {
          const int rho = e / (kStrip / 2);
          const int k2 = 2 * (e & (kStrip / 2 - 1));
          cp_async16(slab + rho * kStrip + k2, src + rho * row_step + k2);
        }
        return;
      }
    }
    for (int e = tid; e < slab_rows * (kStrip / 2); e += kThreads) {
      const int rho = e / (kStrip / 2);
      const int k2 = 2 * (e & (kStrip / 2 - 1));
      const int cc = c0 + k2;
      float2* d = slab + rho * kStrip + k2;
      const long long row = first + rho * step;
      if (row < 0) {  // synthesis: a class frame before the first
        d[0] = zero2();
        d[1] = zero2();
        continue;
      }
      load_pair(d, a, b, row * a.m + cc, cc < a.m, cc + 1 < a.m);
    }
  };

  // class j's weights of this thread's column
  auto wcol = [&](int j) -> const Tw* { return sw + (WS ? j * p * kStrip : 0) + tx; };
  // without WS: branches q0 .. q0 + kChunk - 1 of class j's weights for the
  // strip into sw (zeros past P and M), between two barriers
  auto stage_chunk = [&](int j, int q0) {
    __syncthreads();  // every thread is done with the last chunk
#pragma unroll
    for (int e = tid; e < I::kChunk * kStrip; e += kThreads) {
      const int cc = c0 + (e & (kStrip - 1));
      const int q = q0 + e / kStrip;
      Tw v{};
      if (cc < a.m && q < p) {
        int r = cc - j * a.hop;
        if (r < 0) r += a.m;
        v = static_cast<const Tw*>(a.w)[static_cast<long long>(q) * a.m + r];
      }
      sw[e] = v;
    }
    __syncthreads();
  };

  float2 o[F];  // synthesis: the tile's sum over the classes so far
#pragma unroll
  for (int t = 0; t < F; ++t) o[t] = zero2();

  for (int s = 0; s < a.stages - 1; ++s) {  // always stages - 1 groups
    if (s < n_steps) load_unit(s, s);
    cp_async_commit();
  }
  for (int u = 0; u < n_steps; ++u) {
    const int nu = u + a.stages - 1;
    if (nu < n_steps) load_unit(nu, nu % a.stages);
    cp_async_commit();
    cp_async_wait(a.stages - 1);  // unit u's group (and the weights) landed
    __syncthreads();
    const float2* slab = ring + (u % a.stages) * slab_rows * kStrip;
    const int tile = tile0 + u / upt;
    if (M_ == kSynthesis) {
      const int j = u % upt;
      const int aj = j * a.hop;
      const int d = c < aj ? 1 : 0;  // this column reads class row U - d
      if (!WS || col_ok) {  // without WS every thread stages the chunks
        float2 acc[F];
        fold_class<F, I::kChunk, WS, Tw>(slab + (tl + 1 - d) * kStrip + tx, wcol(j), p, acc,
                                         [&](int q0) { stage_chunk(j, q0); });
        if (col_ok) {
          const int u0 = tile * kTile + tl;
#pragma unroll
          for (int t = 0; t < F; ++t) {
            const int srow = u0 + t - d;
            const float2 v = (srow >= 0 && srow < a.t_cls) ? acc[t] : zero2();
            o[t] = j == 0 ? v : add2(o[t], v);
          }
          if (j == a.os - 1) {
            const float d = a.div ? a.div[c % a.hop] : 1.0f;  // (U*M + c) mod hop
#pragma unroll
            for (int t = 0; t < F; ++t) {
              const long long idx = static_cast<long long>(u0 + t) * a.m + c;
              if (idx >= a.out_len) continue;
              float2 v = o[t];
              if (idx < a.tail_len) v = add2(v, a.tail[b * a.tail_len + idx]);
              if (idx < a.emit) {
                if (a.div) v = make_float2(__fdiv_rn(v.x, d), __fdiv_rn(v.y, d));
                a.out[b * a.emit + idx] = v;
              } else {
                a.rest[b * (a.out_len - a.emit) + idx - a.emit] = v;
              }
            }
          }
        }
      }
    } else if (!WS || col_ok) {
      const int i0 = tile * kTile + tl;
      auto fold_store = [&](int j) {
        const int down = c < j * a.hop ? 1 : 0;  // r = c - j*hop + M: next row
        float2 acc[F];
        fold_class<F, I::kChunk, WS, Tw>(slab + (tl + down) * kStrip + tx, wcol(j), p, acc,
                                         [&](int q0) { stage_chunk(j, q0); });
        if (!col_ok) return;
        if (M_ == kAnalysis) {
          float2* out = a.out + b * static_cast<long long>(a.t_out) * a.m + c;
#pragma unroll
          for (int t = 0; t < F; ++t) {
            const long long frame = static_cast<long long>(i0 + t) * a.os + j;
            if (frame < a.t_out) out[frame * a.m] = acc[t];
          }
        } else {
          const long long plane = (b * a.os + j) * static_cast<long long>(a.t_cls) * a.m + c;
#pragma unroll
          for (int t = 0; t < F; ++t) {
            if (i0 + t < a.t_cls) {
              a.out_re[plane + static_cast<long long>(i0 + t) * a.m] = acc[t].x;
              a.out_im[plane + static_cast<long long>(i0 + t) * a.m] = acc[t].y;
            }
          }
        }
      };
      for (int j = j_lo; j < j_hi; ++j) fold_store(j);
    }
    __syncthreads();  // the stage is free for the load issued next
  }
}

constexpr int kInstances = 10;  // 5 layout x tap-type pairs, weights staged or not
constexpr int kMaxDevices = 64;

// per instance and device: the dynamic shared memory set so far, and the
// last occupancy query (shared memory -> blocks an SM)
struct LaunchCache {
  size_t smem_set[kInstances][kMaxDevices];
  size_t occ_smem[kInstances][kMaxDevices];
  int occ_blocks[kInstances][kMaxDevices];
  int sms[kMaxDevices];
};
LaunchCache g_cache;

template <int M_, bool CT, bool WS>
int launch_inst(int inst, int dev, size_t optin, Params a, int batch, cudaStream_t stream) {
  using I = Inst<M_, CT>;
  auto kern = pfb_fold_kernel<M_, CT, WS>;
  const size_t wbytes = static_cast<size_t>(WS ? a.os * a.p : I::kChunk) * kStrip *
                        sizeof(typename I::Tw);
  const size_t stage_bytes = static_cast<size_t>(I::kTile + a.p) * kStrip * sizeof(float2);
  // a ring of two slabs, or one (no overlap) where two do not fit
  a.stages = 2 * stage_bytes + wbytes <= optin ? 2 : 1;
  const size_t smem = a.stages * stage_bytes + wbytes;
  if (smem > optin) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (g_cache.smem_set[inst][dev] < smem) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    g_cache.smem_set[inst][dev] = smem;
  }
  if (g_cache.sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&g_cache.sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (g_cache.occ_smem[inst][dev] != smem) {
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, I::kThreads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (blocks < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    g_cache.occ_blocks[inst][dev] = blocks;
    g_cache.occ_smem[inst][dev] = smem;
  }
  const long long rows = M_ == kSynthesis ? (a.out_len + a.m - 1) / a.m : a.t_cls;
  const long long n_tiles = (rows + I::kTile - 1) / I::kTile;
  const long long strips = (a.m + kStrip - 1) / kStrip;
  const long long slots = static_cast<long long>(g_cache.sms[dev]) * g_cache.occ_blocks[inst][dev];
  if (n_tiles > 0x7fffffffLL || strips > 65535 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  // where the tiles leave SMs idle (few frames a class, a large os), each
  // tile's classes are split over up to slots / tiles blocks (analysis,
  // planes: they re-read the tile's slab)
  long long groups = 1;
  if (M_ != kSynthesis) {
    groups = slots / (n_tiles * strips * batch);
    if (groups > a.os) groups = a.os;
    if (groups > 65535 / batch) groups = 65535 / batch;
    if (groups < 1) groups = 1;
  }
  // runs of tiles a strip and class run: as many as fill the SMs once
  long long splits = slots / (strips * batch * groups);
  splits = splits < 1 ? 1 : (splits > n_tiles ? n_tiles : splits);
  const long long per = (n_tiles + splits - 1) / splits;
  splits = (n_tiles + per - 1) / per;
  a.n_tiles = static_cast<int>(n_tiles);
  a.tiles_per_block = static_cast<int>(per);
  a.groups = static_cast<int>(groups);
  const dim3 grid(static_cast<unsigned>(splits), static_cast<unsigned>(strips),
                  static_cast<unsigned>(batch * groups));
  kern<<<grid, I::kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// layout `layout` (0-4): every class's weights staged where they fit beside
// one slab, else a chunk at a time
template <int M_, bool CT>
int launch_layout(int layout, Params a, int batch, cudaStream_t stream) {
  using I = Inst<M_, CT>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t wbytes = static_cast<size_t>(a.os) * a.p * kStrip * sizeof(typename I::Tw);
  const size_t stage_bytes = static_cast<size_t>(I::kTile + a.p) * kStrip * sizeof(float2);
  const bool ws = stage_bytes + wbytes <= static_cast<size_t>(optin);
  return ws ? launch_inst<M_, CT, true>(2 * layout, dev, optin, a, batch, stream)
            : launch_inst<M_, CT, false>(2 * layout + 1, dev, optin, a, batch, stream);
}

}  // namespace

// Plain C entry point, loaded with ctypes. Returns the cudaError_t of the
// launch (0 = success). mode 0 analysis, 1 synthesis, 2 planes;
// complex_taps 1 for float2 branches (not with planes).
// - analysis: src0/src1 the head and body (complex64 rows of n0 / n1
//   samples, stride0 / stride1 elements apart; src1 may be null with
//   n1 = 0), t_out frames of [batch, t_out, m] complex64 into out0;
// - synthesis: src0 the frames [batch, t_in, m] complex64 (n0 = t_in * m,
//   stride0 = n0), the overlap-add of out_len = (ceil(t_in / os) + p - 1) *
//   m + (os - 1) * hop samples a row, with tail [batch, tail_len] complex64
//   (may be null with tail_len 0) added to its first samples: samples below
//   emit, divided by div[u mod hop] (float32 [hop], may be null), into out0
//   [batch, emit], the rest into out1 [batch, out_len - emit];
// - planes: src0/src1 the float32 planes [batch, n0], t_out class frames of
//   [batch, os, t_out, m] planes into out0 / out1.
// w: [p, m] float32 (complex_taps 0) or complex64, contiguous (synthesis:
// the branches reversed in p). The kernel takes any p whose slab, (tile +
// p) x 64 complex64 samples, fits the card's shared memory beside a chunk
// of the weights (pfb_fold.launch_plan).
extern "C" int pfb_fold_launch(int mode, int complex_taps, const void* src0,
                               const void* src1, long long n0, long long n1,
                               long long stride0, long long stride1, const void* w,
                               void* out0, void* out1, long long out_len, int batch,
                               int m, int p, int os, int t_in, int t_out,
                               const void* tail, long long tail_len, const void* div,
                               long long emit, void* stream) {
  if (batch < 1 || m < 1 || p < 1 || os < 1 || m % os || n0 < 0 || n1 < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params a{};
  a.n0 = n0;
  a.n1 = n1;
  a.stride0 = stride0;
  a.stride1 = stride1;
  a.w = w;
  a.m = m;
  a.p = p;
  a.os = os;
  a.hop = m / os;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == kAnalysis) {
    if (t_out < 1) return static_cast<int>(cudaErrorInvalidValue);
    a.src0 = static_cast<const float2*>(src0);
    a.src1 = static_cast<const float2*>(src1);
    a.out = static_cast<float2*>(out0);
    a.t_out = t_out;
    a.t_cls = (t_out + os - 1) / os;
    return complex_taps ? launch_layout<kAnalysis, true>(1, a, batch, st)
                        : launch_layout<kAnalysis, false>(0, a, batch, st);
  }
  if (mode == kSynthesis) {
    if (t_in < 1) return static_cast<int>(cudaErrorInvalidValue);
    a.src0 = static_cast<const float2*>(src0);
    a.n0 = static_cast<long long>(t_in) * m;
    a.n1 = 0;
    a.out = static_cast<float2*>(out0);
    a.t_cls = (t_in + os - 1) / os + p - 1;
    a.out_len = static_cast<long long>(a.t_cls) * m + static_cast<long long>(os - 1) * a.hop;
    if (out_len != a.out_len || emit < 0 || emit > out_len || tail_len < 0 ||
        tail_len > out_len || (tail_len > 0 && !tail) || (emit < out_len && !out1))
      return static_cast<int>(cudaErrorInvalidValue);
    a.tail = static_cast<const float2*>(tail);
    a.tail_len = tail_len;
    a.div = static_cast<const float*>(div);
    a.emit = emit;
    a.rest = static_cast<float2*>(out1);
    return complex_taps ? launch_layout<kSynthesis, true>(3, a, batch, st)
                        : launch_layout<kSynthesis, false>(2, a, batch, st);
  }
  if (mode == kPlanes && !complex_taps) {
    if (t_out < 1) return static_cast<int>(cudaErrorInvalidValue);
    a.x_re = static_cast<const float*>(src0);
    a.x_im = static_cast<const float*>(src1);
    a.out_re = static_cast<float*>(out0);
    a.out_im = static_cast<float*>(out1);
    a.t_out = t_out;
    a.t_cls = t_out;
    return launch_layout<kPlanes, false>(4, a, batch, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
