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
//   block barriers, so this kernel takes any P whose slab fits beside a
//   chunk, at every os: P <= 294 real / 262 complex (analysis, planes),
//   388 / 366 (synthesis).
// - Past that P, the ranged instance (pfb_fold_ranged_kernel) stages a
//   tile's slab in ranges of Pc branches, the way the RX frame kernel stages
//   its window: branches [q0, q0 + Pc) of a tile read the slab rows [q0, q0 +
//   tile + Pc), which go through the same two-stage cp.async ring, each with
//   its class's Pc x 64 weights beside it. Every layout takes one tile shape
//   there, 8 x 16 (one 512-thread block, 16 warps an SM), and Pc 64 real /
//   48 complex (two stages within 227 KB). A pipeline step is (tile, class,
//   range); a thread's accumulators stay in registers across the ranges, so
//   the sum over p runs in the same order. The synthesis runs only the
//   ranges, and in them a thread only the branches, that reach a real class
//   frame (its spread's all-zero edge is as wide as P), and adds its classes
//   through the output.
// - Past 65,535 strips of 64 columns or 65,535 rows (times the class runs),
//   grid.y and grid.z stop at 65,535 and the excess folds into grid.x.
// - Frames go out interleaved, in frame order, as coalesced rows; the
//   ragged edges are masked here, so no caller pads, concatenates,
//   de-interleaves or splits planes. The synthesis stage's tail add and
//   periodic division (its epilogue) run on the way out.
// On the H100 (chip_smoke.py phase 13) the analysis layout takes ~0.063 ms
// and the synthesis ~0.09 ms. The branch loop bounds it: with neither the
// slab copies nor the frame stores running, the analysis still took ~0.055
// ms, ~60% of the issue rate, though a branch is FP32 work beside two
// shared loads (a block's warps reach each branch together). A ring of
// rows (each tile loading only its new rows, two blocks an SM) was slower:
// the wrap test in the window loads cost more than the re-reads it saved.
// The ranged instance (benches/torch_pfb_fold_sweep.py) at M 2,048, os 2,
// P 512, 1,024 frames: synthesis ~0.24 ms, analysis ~0.19 (1.9x and 1.45x
// the operation floor); without its copies and outputs the synthesis
// still takes ~0.18 ms. A 64-row tile at two blocks an SM, and the classes'
// sum in registers, were no faster.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

// Tile shapes of the staged and chunked instances.
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
  // analysis, planes: runs of classes a tile is split into (the block's z
  // coordinate is row * groups + run; 1 unless the tiles alone leave SMs idle)
  int groups;
  // the grid: splits runs of tiles along x, strips along y and batch *
  // groups along z; past 65,535 along y or z the excess folds into x as
  // blockIdx.x = split + splits * (yhi + ny * zhi)
  int splits, ny, strips, zs;
  // the ranged instance: branches a range (0 in the other instance), and
  // the synthesis's frames in
  int pc, t_in;
};

// This block's (tile run, strip, row * groups + run) coordinates; false
// for a block of the folded grid past the last strip or row.
__device__ __forceinline__ bool block_coords(const Params& a, int& bx, int& by, int& bz) {
  const int hi = blockIdx.x / a.splits;
  bx = blockIdx.x - hi * a.splits;
  by = blockIdx.y + (hi % a.ny) * gridDim.y;
  bz = blockIdx.z + (hi / a.ny) * gridDim.z;
  return by < a.strips && bz < a.zs;
}

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

// Analysis and planes: class j's frames i0 .. i0 + F - 1 of column c (batch
// row b) out, the ragged frame edge masked.
template <int M_, int F>
__device__ __forceinline__ void store_frames(const Params& a, long long b, int c, int i0, int j,
                                             const float2 (&acc)[F]) {
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
}

// Synthesis: class j's sum acc of output rows u0 .. u0 + F - 1 of column c
// (which reads class row U - d) added into o in j order; after the last
// class the stage's epilogue (the tail added, samples below emit divided
// by div[u mod hop] into out, the rest into rest).
template <int F>
__device__ __forceinline__ void synthesis_add(const Params& a, long long b, int c, int u0, int d,
                                              int j, const float2 (&acc)[F], float2 (&o)[F]) {
#pragma unroll
  for (int t = 0; t < F; ++t) {
    const int srow = u0 + t - d;
    const float2 v = (srow >= 0 && srow < a.t_cls) ? acc[t] : zero2();
    o[t] = j == 0 ? v : add2(o[t], v);
  }
  if (j != a.os - 1) return;
  const float dv = a.div ? a.div[c % a.hop] : 1.0f;  // (U*M + c) mod hop
#pragma unroll
  for (int t = 0; t < F; ++t) {
    const long long idx = static_cast<long long>(u0 + t) * a.m + c;
    if (idx >= a.out_len) continue;
    float2 v = o[t];
    if (idx < a.tail_len) v = add2(v, a.tail[b * a.tail_len + idx]);
    if (idx < a.emit) {
      if (a.div) v = make_float2(__fdiv_rn(v.x, dv), __fdiv_rn(v.y, dv));
      a.out[b * a.emit + idx] = v;
    } else {
      a.rest[b * (a.out_len - a.emit) + idx - a.emit] = v;
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

  int bx, by, bz;
  if (!block_coords(a, bx, by, bz)) return;
  const int tid = threadIdx.x;
  const int tx = tid & (kStrip - 1);
  const int tl = (tid / kStrip) * F;  // first local frame (row) of this thread
  const int c0 = by * kStrip;
  const int c = c0 + tx;
  const bool col_ok = c < a.m;
  const long long b = bz / a.groups;
  const int g = bz - static_cast<int>(b) * a.groups;  // this block's classes
  const int j_lo = g * a.os / a.groups, j_hi = (g + 1) * a.os / a.groups;
  const int tile0 = bx * a.tiles_per_block;
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
        if (col_ok) synthesis_add<F>(a, b, c, tile * kTile + tl, d, j, acc, o);
      }
    } else if (!WS || col_ok) {
      const int i0 = tile * kTile + tl;
      auto fold_store = [&](int j) {
        const int down = c < j * a.hop ? 1 : 0;  // r = c - j*hop + M: next row
        float2 acc[F];
        fold_class<F, I::kChunk, WS, Tw>(slab + (tl + down) * kStrip + tx, wcol(j), p, acc,
                                         [&](int q0) { stage_chunk(j, q0); });
        if (col_ok) store_frames<M_, F>(a, b, c, i0, j, acc);
      };
      for (int j = j_lo; j < j_hi; ++j) fold_store(j);
    }
    __syncthreads();  // the stage is free for the load issued next
  }
}

// The ranged instance's tile in every layout: 8 thread rows of 64 columns,
// 16 class frames (synthesis: output rows) a thread, one 512-thread block
// an SM (benches/torch_pfb_fold_sweep.py times edited copies).
constexpr int kRowsRanged = 8;
constexpr int kFramesRanged = 16;

template <bool CT>
struct RangedInst {
  static constexpr int kRows = kRowsRanged;
  static constexpr int kFrames = kFramesRanged;
  static constexpr int kThreads = kStrip * kRows;
  static constexpr int kMinBlocks = 1;
  static constexpr int kTile = kRows * kFrames;
  using Tw = typename std::conditional<CT, float2, float>::type;
};

// n branches' sum for the F frames of a thread: slab row t + q of col in
// window slot (t + q) % F (as in fold_class), weight q at wcol[q * 64];
// where `first` the first term initialises acc, else every term adds to the
// sum that earlier ranges left there.
template <int F, typename Tw>
__device__ __forceinline__ void fold_range(const float2* __restrict__ col,
                                           const Tw* __restrict__ wcol, int n, bool first,
                                           float2 (&acc)[F]) {
  float2 xw[F];
#pragma unroll
  for (int t = 0; t < F; ++t) xw[t] = col[t * kStrip];
  int q = 0;
  if (first) {
    const Tw w = wcol[0];
#pragma unroll
    for (int t = 0; t < F; ++t) acc[t] = term(xw[t], w);
    if (n > 1) xw[0] = col[F * kStrip];
    q = 1;
  }
  for (int qb = 0; qb < n; qb += F) {
#pragma unroll
    for (int k = 0; k < F; ++k) {
      const int qk = qb + k;
      if (qk >= n) break;
      if (qk < q) continue;  // the peeled first term
      const Tw w = wcol[qk * kStrip];
#pragma unroll
      for (int t = 0; t < F; ++t) acc[t] = add2(acc[t], term(xw[(k + t) % F], w));
      if (qk + 1 < n) xw[k] = col[(qk + F) * kStrip];
    }
  }
}

// A pipeline step of the ranged instance: range r of class jj (its k-th
// tile) in the ranges [r_lo, r_hi) that hold its live branches [ql, qh); a
// class with none runs one empty step (r_hi = r_lo + 1, ql = qh), which
// loads and adds nothing but still finishes the class.
struct RStep {
  int k, jj, r, r_lo, r_hi, ql, qh;
};

// The ranged instance: layouts as pfb_fold_kernel, for a P whose slab does
// not fit beside a chunk of the weights. A block walks its tiles (tile
// bx, bx + splits, ...: the spread's edge tiles, which have less work, fall
// to every block alike), per tile its classes in j order, per class the
// ranges of pc branches that hold a live branch; a ring stage holds the slab
// rows a range's live branches read and their weights.
// - Analysis and planes: every branch is live (ql, qh = 0, P).
// - Synthesis: output row U of column c reads class frame U - d + q - (P-1)
//   (d = c < j*hop), a real frame for q in [P-1-U+d, P-1-U+d+T_j) (T_j the
//   class's frames; the rest are the spread's zero frames, whose products
//   are +-0 and leave every sum's value as it is: x + (+-0) = x). A tile's
//   live branches are the union over its rows and its strip's d: ranges
//   outside them are not loaded or run, and a thread runs only the union
//   over its own 16 rows, so the dead terms left are the triangles of
//   16-row thread slabs at the spread's two edges, at most 15 x 16 a thread
//   and class: 2.9% more terms than real ones at M 2,048, os 2, P 512 and
//   1,024 frames, 0.7% at 4,096 (pfb_fold.ranged_terms counts them). A
//   thread's sum starts from its first live term; the classes are added in
//   j order through the output itself (class j < os - 1 writes its partial
//   sum where the sample goes; the next class reads it back), the last with
//   the stage's epilogue; a row no class reaches is a literal +0.0.
template <int M_, bool CT>
__global__ void __launch_bounds__(RangedInst<CT>::kThreads, RangedInst<CT>::kMinBlocks)
    pfb_fold_ranged_kernel(const Params a) {
  using I = RangedInst<CT>;
  using Tw = typename I::Tw;
  constexpr int F = I::kFrames;
  constexpr int kTile = I::kTile;
  constexpr int kThreads = I::kThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int bx, by, bz;
  if (!block_coords(a, bx, by, bz)) return;
  const int p = a.p;
  const int pcmax = a.pc;
  const int slab_rows = kTile + pcmax;
  const int stage_elems = slab_rows * kStrip + pcmax * kStrip * static_cast<int>(sizeof(Tw)) / 8;
  float2* ring = reinterpret_cast<float2*>(smem_raw);  // [2][slab, weights]

  const int tid = threadIdx.x;
  const int tx = tid & (kStrip - 1);
  const int tl = (tid / kStrip) * F;
  const int c0 = by * kStrip;
  const int c = c0 + tx;
  const bool col_ok = c < a.m;
  const int c_last = min(c0 + kStrip, a.m) - 1;
  const long long b = bz / a.groups;
  const int g = bz - static_cast<int>(b) * a.groups;
  const int j_lo = M_ == kSynthesis ? 0 : g * a.os / a.groups;
  const int j_hi = M_ == kSynthesis ? a.os : (g + 1) * a.os / a.groups;
  const int classes = j_hi - j_lo;
  const int n_my = (a.n_tiles - bx + a.splits - 1) / a.splits;  // tiles bx + k * splits

  // class jj's live branches in its k-th tile, and their ranges
  auto begin = [&](int k, int jj) {
    RStep s{k, jj, 0, 0, 0, 0, p};
    if (M_ == kSynthesis && k < n_my) {
      const int j = j_lo + jj;
      const int u0 = (bx + k * a.splits) * kTile;
      const int tj = (a.t_in - j + a.os - 1) / a.os;
      const int dmin = c_last < j * a.hop ? 1 : 0;
      const int dmax = c0 < j * a.hop ? 1 : 0;
      s.ql = max(0, p - 1 - (u0 + kTile - 1) + dmin);
      s.qh = min(p, p - 1 - u0 + dmax + tj);
    }
    if (s.ql < s.qh) {
      s.r_lo = s.ql / pcmax;
      s.r_hi = (s.qh + pcmax - 1) / pcmax;
    } else {
      s.r_lo = 0;
      s.r_hi = 1;
      s.qh = s.ql;
    }
    s.r = s.r_lo;
    return s;
  };
  auto advance = [&](const RStep& s) {
    if (s.r + 1 < s.r_hi) {
      RStep t = s;
      ++t.r;
      return t;
    }
    return s.jj + 1 < classes ? begin(s.k, s.jj + 1) : begin(s.k + 1, 0);
  };

  auto load_unit = [&](const RStep& s, int stage) {
    const int tile = bx + s.k * a.splits;
    const int j = j_lo + s.jj;
    const int q0 = s.r * pcmax;
    // the range's live branches [la, lb) (local) and the slab rows they read
    const int la = max(s.ql, q0) - q0;
    const int lb = min(s.qh, q0 + pcmax) - q0;
    if (la >= lb) return;
    float2* slab = ring + stage * stage_elems;
    Tw* sw = reinterpret_cast<Tw*>(slab + slab_rows * kStrip);
    {
      int r0 = c0 - j * a.hop;
      if (r0 < 0) r0 += a.m;
      const Tw* wsrc = static_cast<const Tw*>(a.w) + static_cast<long long>(q0) * a.m;
      constexpr int kPer = 16 / static_cast<int>(sizeof(Tw));  // weights a 16-byte copy
      if (c0 + kStrip <= a.m && r0 + kStrip <= a.m &&
          ((reinterpret_cast<uintptr_t>(wsrc + r0) | (a.m * sizeof(Tw))) & 15) == 0) {
        for (int e = la * (kStrip / kPer) + tid; e < lb * (kStrip / kPer); e += kThreads) {
          const int q = e / (kStrip / kPer);
          const int k4 = (e - q * (kStrip / kPer)) * kPer;
          cp_async16(sw + q * kStrip + k4, wsrc + static_cast<long long>(q) * a.m + r0 + k4);
        }
      } else {
        for (int e = la * kStrip + tid; e < lb * kStrip; e += kThreads) {
          const int cc = c0 + (e & (kStrip - 1));
          const int q = e / kStrip;
          if (cc < a.m) {
            int r = cc - j * a.hop;
            if (r < 0) r += a.m;
            const Tw* src = wsrc + static_cast<long long>(q) * a.m + r;
            if (CT) {
              cp_async8(sw + e, src);
            } else {
              cp_async4(sw + e, src);
            }
          } else {
            sw[e] = Tw{};
          }
        }
      }
    }
    // slab rows [rho_lo, rho_hi): synthesis reads rows tl + 1 - d + q + t
    // (d in [dmin, dmax]), analysis and planes tl + down + q + t
    int rho_lo = 0, rho_hi = kTile + pcmax;
    if (M_ == kSynthesis) {
      const int dmin = c_last < j * a.hop ? 1 : 0;
      const int dmax = c0 < j * a.hop ? 1 : 0;
      rho_lo = la + 1 - dmax;
      rho_hi = lb + kTile - dmin;
    }
    if (M_ == kPlanes) {
      const long long row0 = static_cast<long long>(tile) * kTile + q0;
      for (int e = rho_lo * kStrip + tid; e < rho_hi * kStrip; e += kThreads) {
        const int cc = c0 + (e & (kStrip - 1));
        const long long sidx = (row0 + e / kStrip) * a.m + cc;
        float2* d = slab + e;
        if (cc < a.m && sidx < a.n0) {
          cp_async4(&d->x, a.x_re + b * a.n0 + sidx);
          cp_async4(&d->y, a.x_im + b * a.n0 + sidx);
        } else {
          *d = zero2();
        }
      }
      return;
    }
    // slab row rho is stream row first + rho * step (synthesis: class j's
    // frame i*os + j for class frame i = tile * kTile - P + q0 + rho)
    const long long first = M_ == kAnalysis
                                ? static_cast<long long>(tile) * kTile + q0
                                : (static_cast<long long>(tile) * kTile - p + q0) * a.os + j;
    const long long step = M_ == kAnalysis ? 1 : a.os;
    // every row a whole strip inside one source, 16-byte aligned: one check
    // a step, then plain 16-byte copies
    const long long s_lo = (first + rho_lo * step) * a.m + c0;
    const long long s_hi = (first + (rho_hi - 1) * step) * a.m + c0 + kStrip;
    if (first + rho_lo * step >= 0 && c0 + kStrip <= a.m && (a.m & 1) == 0 &&
        (s_hi <= a.n0 || (s_lo >= a.n0 && s_hi <= a.n0 + a.n1))) {
      const float2* src = stream_at(a, b, s_lo);
      if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
        const long long row_step = step * a.m;
        float2* dst = slab + rho_lo * kStrip;
        for (int e = tid; e < (rho_hi - rho_lo) * (kStrip / 2); e += kThreads) {
          const int rho = e / (kStrip / 2);
          const int k2 = 2 * (e & (kStrip / 2 - 1));
          cp_async16(dst + rho * kStrip + k2, src + rho * row_step + k2);
        }
        return;
      }
    }
    for (int e = rho_lo * (kStrip / 2) + tid; e < rho_hi * (kStrip / 2); e += kThreads) {
      const int rho = e / (kStrip / 2);
      const int k2 = 2 * (e & (kStrip / 2 - 1));
      const int cc = c0 + k2;
      float2* d = slab + rho * kStrip + k2;
      const long long row = first + rho * step;
      if (row < 0) {
        d[0] = zero2();
        d[1] = zero2();
        continue;
      }
      load_pair(d, a, b, row * a.m + cc, cc < a.m, cc + 1 < a.m);
    }
  };

  // synthesis: class j's sum of this thread's rows added to the classes
  // before it (their partial sum where the sample goes), the last class
  // with the stage's epilogue (as synthesis_add)
  auto synthesis_out = [&](int u0, int d, int j, const float2 (&acc)[F]) {
    const float dv = a.div ? a.div[c % a.hop] : 1.0f;  // (U*M + c) mod hop
#pragma unroll
    for (int t = 0; t < F; ++t) {
      const long long idx = static_cast<long long>(u0 + t) * a.m + c;
      if (idx >= a.out_len) continue;
      const int srow = u0 + t - d;
      float2 v = (srow >= 0 && srow < a.t_cls) ? acc[t] : zero2();
      float2* dst = idx < a.emit ? a.out + b * a.emit + idx
                                 : a.rest + b * (a.out_len - a.emit) + idx - a.emit;
      if (j > 0) v = add2(*dst, v);
      if (j == a.os - 1) {
        if (idx < a.tail_len) v = add2(v, a.tail[b * a.tail_len + idx]);
        if (idx < a.emit && a.div) v = make_float2(__fdiv_rn(v.x, dv), __fdiv_rn(v.y, dv));
      }
      *dst = v;
    }
  };

  float2 acc[F];
  RStep cur = begin(0, 0);
  if (cur.k < n_my) load_unit(cur, 0);
  cp_async_commit();
  for (int u = 0; cur.k < n_my; ++u) {
    const RStep nxt = advance(cur);
    if (nxt.k < n_my) load_unit(nxt, (u + 1) & 1);
    cp_async_commit();
    cp_async_wait(1);  // step u's group landed
    __syncthreads();
    const float2* slab = ring + (u & 1) * stage_elems;
    const Tw* sw = reinterpret_cast<const Tw*>(slab + slab_rows * kStrip);
    const int tile = bx + cur.k * a.splits;
    const int j = j_lo + cur.jj;
    const int q0 = cur.r * pcmax;
    if (col_ok) {
      const int d = c < j * a.hop ? 1 : 0;  // synthesis: class row U - d; else the next row
      const int u0 = tile * kTile + tl;
      if (cur.r == cur.r_lo) {
#pragma unroll
        for (int t = 0; t < F; ++t) acc[t] = zero2();
      }
      if (M_ == kSynthesis) {
        // this thread's live branches, and those in this range
        const int tj = (a.t_in - j + a.os - 1) / a.os;
        const int qf = max(0, p - 1 - (u0 + F - 1) + d);
        const int qs = max(q0, qf);
        const int qe = min(min(q0 + pcmax, p), min(cur.qh, p - 1 - u0 + d + tj));
        if (qs < qe)
          fold_range<F, Tw>(slab + (tl + 1 - d + qs - q0) * kStrip + tx,
                            sw + (qs - q0) * kStrip + tx, qe - qs, qs == qf, acc);
        if (cur.r == cur.r_hi - 1) synthesis_out(u0, d, j, acc);
      } else {
        fold_range<F, Tw>(slab + (tl + d) * kStrip + tx, sw + tx, min(pcmax, p - q0),
                          cur.r == 0, acc);
        if (cur.r == cur.r_hi - 1) store_frames<M_, F>(a, b, c, u0, j, acc);
      }
    }
    __syncthreads();  // the stage is free for the load issued next
    cur = nxt;
  }
}

constexpr int kInstances = 15;  // 5 layout x tap-type pairs: weights staged, chunked, ranged
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

// KIND 0: every class's weights staged (pfb_fold_kernel<.., true>); 1: a
// chunk at a time (pfb_fold_kernel<.., false>); 2: the ranged instance, a
// ring of two stages of a range's slab and weights (a.pc branches)
template <int M_, bool CT, int KIND>
int launch_inst(int inst, int dev, size_t optin, Params a, int batch, cudaStream_t stream) {
  using I = typename std::conditional<KIND == 2, RangedInst<CT>, Inst<M_, CT>>::type;
  auto kern = KIND == 2 ? pfb_fold_ranged_kernel<M_, CT> : pfb_fold_kernel<M_, CT, KIND == 0>;
  size_t smem;
  if constexpr (KIND == 2) {
    a.stages = 2;
    smem = 2 * (static_cast<size_t>(I::kTile + a.pc) * kStrip * sizeof(float2) +
                static_cast<size_t>(a.pc) * kStrip * sizeof(typename I::Tw));
  } else {
    a.pc = 0;
    const size_t wbytes = static_cast<size_t>(KIND == 0 ? a.os * a.p : I::kChunk) * kStrip *
                          sizeof(typename I::Tw);
    const size_t stage_bytes = static_cast<size_t>(I::kTile + a.p) * kStrip * sizeof(float2);
    // a ring of two slabs, or one (no overlap) where two do not fit
    a.stages = 2 * stage_bytes + wbytes <= optin ? 2 : 1;
    smem = a.stages * stage_bytes + wbytes;
  }
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
  if (n_tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
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
  // strips along y and rows x class runs along z, up to 65,535 each; the
  // excess folds into x
  const long long zs = batch * groups;
  const long long gy = strips < 65535 ? strips : 65535;
  const long long gz = zs < 65535 ? zs : 65535;
  const long long ny = (strips + gy - 1) / gy;
  const long long nz = (zs + gz - 1) / gz;
  if (splits * ny * nz > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  a.splits = static_cast<int>(splits);
  a.ny = static_cast<int>(ny);
  a.strips = static_cast<int>(strips);
  a.zs = static_cast<int>(zs);
  const dim3 grid(static_cast<unsigned>(splits * ny * nz), static_cast<unsigned>(gy),
                  static_cast<unsigned>(gz));
  kern<<<grid, I::kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// layout `layout` (0-4): every class's weights staged where they fit beside
// one slab, else a chunk at a time where a chunk fits beside one slab, else
// the ranged instance
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
  const size_t chunk = static_cast<size_t>(I::kChunk) * kStrip * sizeof(typename I::Tw);
  const bool ws = stage_bytes + wbytes <= static_cast<size_t>(optin);
  if (ws) return launch_inst<M_, CT, 0>(3 * layout, dev, optin, a, batch, stream);
  if (stage_bytes + chunk <= static_cast<size_t>(optin))
    return launch_inst<M_, CT, 1>(3 * layout + 1, dev, optin, a, batch, stream);
  // the ranged instance: the most branches a range (a multiple of the frames
  // a thread) whose slab and weights fit two ring stages
  using R = RangedInst<CT>;
  const long long per_branch = kStrip * (sizeof(float2) + sizeof(typename I::Tw));
  long long pc = (optin / 2 - static_cast<long long>(R::kTile) * kStrip * sizeof(float2)) /
                 per_branch;
  pc -= pc % R::kFrames;
  if (pc < 1) return static_cast<int>(cudaErrorInvalidValue);
  a.pc = static_cast<int>(pc);
  return launch_inst<M_, CT, 2>(3 * layout + 2, dev, optin, a, batch, stream);
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
// the branches reversed in p). Any p, any batch and any m: where the slab,
// (tile + p) x 64 complex64 samples, does not fit the card's shared memory
// beside a chunk of the weights, the ranged instance stages it in ranges of
// branches (pfb_fold.launch_plan, branch_range).
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
    a.t_in = t_in;
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
