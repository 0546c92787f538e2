"""The RX frame op: FIR -> decimate -> frame DFT -> wrap correction -> demod.

Port of the TPU kernel ``aether_primitives_tpu/ops/pallas/rx_frame.py``
(``_kernel``), extended to what the RX chain's fast path emits
(``models/modem.py`` ``RxChain._bits_fast``): packed LSB-first QPSK or BPSK
bytes, or the ``Scale.SN`` spectrum that the EVM gate reads.

- :func:`rx_frame` is the wrapper. For a CUDA tensor it launches the
  hand-written kernel ``csrc/rx_frame.cu`` (built at first use, see
  :mod:`.build`) or raises; for a CPU tensor it runs :func:`rx_frame_reference`.
- :func:`rx_frame_reference` is the plain PyTorch version: the staged
  two-einsum :func:`~aether_primitives_tpu_torch.ops.fir.fir_decimate_fft`
  in complex64 where a stage split exists, else its span-point FFT route
  (the JAX package's), plus the same epilogue.
- :data:`launches` counts the kernel's launches (one per call).
- :func:`kernel_plan` / :func:`kernel_supports` name the kernel's instance
  for a geometry. Every instance computes the function itself, the
  decimating FIR at the kept outputs and an FFT written by hand, with no
  stage split: ``direct`` (fft_len 12-4096, powers of two from 64, at most
  :data:`DIRECT_MAX_TAPS` taps, whole frames staged within the opt-in
  shared memory: the main path's dec 4, fft_len 2048; a mixed-radix FFT
  where fft_len is no power of two); ``chunked`` (every
  other frame of at most 4,096 points whose input span suits one CTA: the
  FIR's input staged in chunks, taps read through L1, a mixed-radix FFT);
  ``cluster`` (larger frames or spans: a thread-block cluster of 2-8 CTAs
  shares a frame through distributed shared memory and a four-step FFT);
  ``global`` (every other frame: past 65,536 points, or past 4,096 with no
  cluster split, a prime fft_len such as 4,099 or 16,411: one cooperative
  launch; an FFT of a power of two, Bluestein's chirp transform for any
  other length, whole frames in a CTA's shared memory up to
  :data:`GLOBAL_TILE` FFT points, a four-step split through one scratch
  buffer past it).
  :func:`general_layout` and :func:`global_layout` give their launch
  geometry. The only geometry that raises is one whose scratch exceeds the
  card's memory.

Output per frame, natural bin ``k``: ``"qpsk"`` writes ``fft_len / 4``
bytes (byte ``k/4`` holds symbols ``k..k+3``, two bits each, LSB-first); ``"bpsk"`` writes ``fft_len / 8`` bytes, one
bit ``re + im < 0`` per symbol; ``"spectrum"`` writes ``fft_len`` complex64
bins times ``Scale.SN``. Bytes come back flat per block row,
``[..., nsym * fft_len * bits / 8]``; spectra as ``[..., nsym, fft_len]``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from .. import fir as _fir
from ..fft import Scale
from . import CARD_BYTES, build

#: Launches of the CUDA kernel in this process (the plain version and
#: calls that raise do not count).
launches = 0

EPILOGUES = {"qpsk": 0, "bpsk": 1, "spectrum": 2}
#: The direct instance: the most taps (a kernel parameter), the fft_len
#: range (powers of two; any other fft_len from the range's second value
#: through the mixed-radix FFT), and the FIR outputs a CTA works on at once.
DIRECT_MAX_TAPS = 256
DIRECT_FFT_LEN = (64, 12, 4096)
DIRECT_OUTPUTS = 2048
#: Opt-in shared memory of one CTA on sm_90 (227 KB).
SMEM_LIMIT = 232_448
#: The chunked and cluster instances: CTA widths (threads; a cluster's CTAs
#: take 512), the points a thread holds in registers through an FFT pass on
#: one CTA and in a cluster, the outputs and input samples a CTA aims at,
#: the cluster sizes, and the passes a frame's FFT may have
#: (``csrc/rx_frame.cu`` ``kSinglePoints``, ``kClusterPoints``, ``GenPlan``).
GEN_THREADS = (256, 512)
GEN_POINTS = 8
CLUSTER_THREADS = 512
CLUSTER_POINTS_A_THREAD = 16
GEN_OUTPUTS = 2048
GEN_SPAN = 32768
CLUSTER_SIZES = (2, 4, 8)
CLUSTER_POINTS = 8192
MAX_PASSES = 20
SMALL_RADICES = (2, 3, 4, 5, 8)
#: The global instance: its CTA width, the points of a CTA's tile in shared
#: memory, the most points of a level past one tile, and the most levels
#: (``csrc/rx_frame.cu`` ``kGlobalThreads``, ``kMaxLevels``).
GLOBAL_THREADS = 512
GLOBAL_TILE = 16384
GLOBAL_LEVEL = 2048
GLOBAL_MAX_LEVELS = 4
#: Bluestein over m = 2 x GLOBAL_TILE takes its two sub-transforms in one
#: CTA (``global_layout``'s ``alt``) where a call has at least this many
#: frames; fewer take the levels (at 2 / 8,198 and at 1 / 15,000 on an H100
#: the levels were faster at 66 frames and the sub-transforms at 132:
#: ``benches/torch_rx_frame_routes.py``, PERF.md §6).
GLOBAL_SUB_FRAMES = 100


def direct_layout(dec: int, fft_len: int, n_taps: int = 1) -> Optional[tuple]:
    """``(fpc, wp, nb)`` of the direct instance, or None where it does not
    take the geometry: frames a CTA (the largest power of two up to
    ``DIRECT_OUTPUTS / fft_len``, halved until they fit :data:`SMEM_LIMIT`),
    float2 slots of a frame's staged window (``K-1 + span`` samples, one pad
    slot every 32) and of its FFT buffer (``fft_len`` points, one pad slot
    every 8). fft_len in :data:`DIRECT_FFT_LEN`: a power of two takes the
    radix-8/4/2 FFT, any other the mixed-radix one, its frames' outputs
    rounded up to whole groups of 8 (the window keeps the slots the
    dropped outputs read)."""
    lo_pow2, lo, hi = DIRECT_FFT_LEN
    pow2 = fft_len & (fft_len - 1) == 0
    if (not (lo_pow2 if pow2 else lo) <= fft_len <= hi or not 1 <= n_taps <= DIRECT_MAX_TAPS
            or len(radices(fft_len)) > MAX_PASSES):
        return None
    lp = -(-fft_len // 8) * 8
    wlen = n_taps - 1 + dec * fft_len + dec * (lp - fft_len)
    wp = wlen + ((wlen - 1) >> 5)
    nb = fft_len + fft_len // 8
    fpc = 1 << (max(1, DIRECT_OUTPUTS // fft_len).bit_length() - 1)
    if fpc > 1 and fpc * lp > DIRECT_OUTPUTS:  # padded outputs past 256 threads' 2,048
        fpc //= 2
    while fpc > 1 and fpc * max(wp, nb) * 8 > SMEM_LIMIT:
        fpc //= 2
    if fpc * max(wp, nb) * 8 > SMEM_LIMIT:
        return None
    return fpc, wp, nb


def radices(n: int) -> list:
    """The FFT passes of an ``n``-point frame in the kernel's order: radix 8
    while it divides, then one radix 4 or 2, then 3s, 5s and every other
    prime factor ascending (each a pass of its own)."""
    out, m = [], n
    while m % 8 == 0:
        out.append(8)
        m //= 8
    for r in (4, 2):
        if m % r == 0:
            out.append(r)
            m //= r
    p = 3
    while m > 1:
        while m % p == 0:
            out.append(p)
            m //= p
        p += 2
    return out


def _capacity(threads: int, rads, per: int) -> int:
    """The most points a CTA of ``threads`` holds through the passes
    ``rads`` at ``per`` points a thread: a radix-R pass keeps ``ceil(per /
    R)`` butterflies a thread in registers, any other prime ``per`` output
    points."""
    return threads * min([r * -(-per // r) if r in SMALL_RADICES else per for r in rads]
                         or [per])


def _fslot(k: int) -> int:
    return k + (k >> 3)


def _wslot(e: int) -> int:
    return e + (e >> 5)


def _fir_items(dec: int, k: int) -> int:
    """The FIR's non-empty (phase, block of 8 taps) items for one output
    group: ``sum_p ceil(ceil((K - p) / dec) / 8)``."""
    return sum(-(-(-(-(k - p) // dec)) // 8) for p in range(min(dec, k)))


def _fir_fit(dec: int, k: int, threads: int, lp: int, pieces_cap: int, fbuf: int):
    """``(split, chunk, kt, win)`` of the FIR's staging for a CTA whose FFT
    buffer takes ``fbuf`` slots, or None: threads a group (a power of two
    up to 32, from the FIR's items), outputs a chunk, taps a staged range
    (all of them where they fit) and the float2 slots of one of the two
    window buffers."""
    s0 = 1
    while s0 < 32 and 2 * s0 <= _fir_items(dec, k) // 2:
        s0 *= 2
    split = s0
    while split <= 32:
        chunk = 8 * threads // split
        pieces = max(1, min(pieces_cap, chunk // lp + 2))
        room = (SMEM_LIMIT // 8 - fbuf) // 2  # window slots that fit
        # total samples t of a window take _wslot(t - 1) + 1 <= t + t / 32 + 1 slots
        samples = (room - 1) * 32 // 33
        kt = min(k, (samples - dec * chunk) // pieces)
        if kt == k or (split == 32 and kt >= 1):
            total = pieces * kt + dec * chunk
            return split, chunk, kt, _wslot(total - 1) + 1
        split *= 2
    return None


def _single_layout(dec: int, n: int, k: int) -> Optional[dict]:
    rads = radices(n)
    # the narrowest CTA that holds a frame, as many frames as it holds
    threads = next((t for t in GEN_THREADS if n <= _capacity(t, rads, GEN_POINTS)), None)
    if len(rads) > MAX_PASSES or threads is None:
        return None
    span = dec * n
    fpc0 = max(1, min(GEN_OUTPUTS // n, GEN_SPAN // span,
                      _capacity(threads, rads, GEN_POINTS) // n))
    lp = -(-n // 8) * 8
    nb = _fslot(n - 1) + 1
    fpc = fpc0
    while fpc >= 1:
        fit = _fir_fit(dec, k, threads, lp, fpc, fpc * nb)
        if fit is not None:
            split, chunk, kt, win = fit
            return dict(instance="chunked", threads=threads, n=n, dec=dec, k=k, kt=kt,
                        fpc=fpc, q=1, lp=lp, split=split, chunk=chunk, win=win,
                        fbuf=fpc * nb, nb1=nb, nb2=0, a=n, b=1, rad1=rads, rad2=[])
        fpc //= 2
    return None


def _cluster_layout(dec: int, n: int, k: int) -> Optional[dict]:
    span = dec * n
    found = []
    for q in CLUSTER_SIZES:
        if n % (8 * q * q) or n // q > CLUSTER_THREADS * CLUSTER_POINTS_A_THREAD:
            continue  # no split, or more points a CTA than its threads hold
        # n = a * b, q | b, a / q a multiple of 8, a and b near sqrt(n)
        best = None
        for a in range(8 * q, n + 1, 8 * q):
            if n % a or (n // a) % q:
                continue
            b = n // a
            score = abs(np.log(a / b))
            if best is None or score < best[0]:
                best = (score, a, b)
        if best is None:
            continue
        _, a, b = best
        ra, rb = radices(a), radices(b)
        if max(len(ra), len(rb)) > MAX_PASSES:
            continue
        pts = n // q
        threads = CLUSTER_THREADS
        if pts > min(_capacity(threads, r, CLUSTER_POINTS_A_THREAD) for r in (ra, rb)):
            continue
        nb1 = (_fslot(a - 1) + 1) | 1  # odd strides: strided reads miss no bank twice
        nb2 = (_fslot(b - 1) + 1) | 1
        fbuf = max((b // q) * nb1, (a // q) * nb2)
        fit = _fir_fit(dec, k, threads, pts, 1, fbuf)
        if fit is None:
            continue
        split, chunk, kt, win = fit
        found.append(dict(instance="cluster", threads=threads, n=n, dec=dec, k=k, kt=kt,
                          fpc=1, q=q, lp=pts, split=split, chunk=chunk, win=win, fbuf=fbuf,
                          nb1=nb1, nb2=nb2, a=a, b=b, rad1=ra, rad2=rb))
    for lay in found:
        if lay["lp"] <= CLUSTER_POINTS and span // lay["q"] <= GEN_SPAN:
            return lay
    return found[-1] if found else None


@functools.lru_cache(maxsize=None)
def general_layout(dec: int, fft_len: int, n_taps: int = 1) -> Optional[dict]:
    """The launch geometry of the chunked or cluster instance, or None
    where neither takes the geometry. Keys: ``instance``, ``threads``,
    ``n`` (fft_len), ``dec``, ``k`` (taps), ``kt`` (taps a staged range),
    ``fpc`` (frames a CTA), ``q`` (CTAs a frame: 1, or a cluster's size),
    ``lp`` (FIR outputs a CTA computes of a frame, a multiple of 8),
    ``split`` (threads that share a group's 8 outputs), ``chunk`` (outputs
    staged at once), ``win`` (float2 slots of a window buffer), ``fbuf``
    (of the FFT buffer), ``nb1``/``nb2`` (frame strides of the FFT's
    stages), ``a``/``b`` (the cluster's four-step split ``n = a b``; ``n``,
    1 on one CTA) and ``rad1``/``rad2`` (the stages' radices).

    One CTA (256 threads where they hold the frame, else 512) takes frames
    of up to 4,096 points (8 a thread through the FFT's passes) whose span
    is at most :data:`GEN_SPAN` samples, ``GEN_OUTPUTS / fft_len`` of them
    together. Past either, a cluster of 512-thread CTAs (16 points a
    thread): the smallest of :data:`CLUSTER_SIZES` whose CTAs hold at most
    :data:`CLUSTER_POINTS` points and :data:`GEN_SPAN` samples of the frame
    each (else the largest whose CTAs hold their share), where ``fft_len``
    splits as ``a b`` with ``8 q | a`` and ``q | b``: up to 65,536 points. A
    frame that fits one CTA and has no such split stays on one CTA.
    """
    if fft_len < 1 or dec < 1 or not 1 <= n_taps <= dec * fft_len + 1:
        return None
    single = _single_layout(dec, fft_len, n_taps)
    if single is not None and dec * fft_len <= GEN_SPAN:
        return single
    return _cluster_layout(dec, fft_len, n_taps) or single


def global_levels(m: int, tile: int = GLOBAL_TILE, level: int = GLOBAL_LEVEL) -> tuple:
    """``(lp, lt)``: log2 of each level's points ``P_i`` and of a tile's
    sequences ``T_i`` for an m-point FFT (m a power of two), level 0 the
    outermost. Up to ``tile`` points: one level, ``tile / m`` whole frames a
    tile. Past it: ``level`` points in the last level (tiles of ``tile /
    level`` rows, whole bytes of bins), the rest of m in levels of up to
    ``level`` points from level 0 on, each tile ``tile / P_i`` adjacent
    columns (at most the level's stride)."""
    lm, lt_all, ll = m.bit_length() - 1, tile.bit_length() - 1, level.bit_length() - 1
    if m <= tile:
        return [lm], [lt_all - lm]
    lps, rest = [], lm - ll
    while rest > 0:
        lps.append(min(rest, ll))
        rest -= lps[-1]
    lps.append(ll)
    lts = [min(lt_all - lp, sum(lps[i + 1:])) for i, lp in enumerate(lps[:-1])]
    return lps, lts + [lt_all - ll]


def global_layout(dec: int, fft_len: int, n_taps: int = 1) -> Optional[dict]:
    """The global instance's geometry, or None where one frame's scratch and
    tables exceed the card's memory (:data:`CARD_BYTES`). Keys: ``n``
    (fft_len), ``m`` (the FFT's points: ``n`` for a power of two, else
    Bluestein's power of two ``>= 2n - 1``), ``bluestein``, ``dec``, ``k``,
    ``lp`` / ``lt`` (:func:`global_levels`: one level where m fits a tile of
    :data:`GLOBAL_TILE` points, which then holds whole frames and no scratch
    is needed; else the four-step levels through a scratch of m points a
    frame), ``tile`` (float2 slots of the tile buffer), the FIR's staging
    ``split``, ``chunk``, ``kt``, ``win`` (:func:`_fir_fit`: two windows
    beside the tile for one level, in its place past it; ``win`` 0 where no
    window fits: x read through L1), ``log2q`` (the largest level's points
    Q), ``h`` and ``hq`` (the splits of the tables of ``W_m`` and ``W_Q``:
    :func:`split_twiddles`) and ``twoff`` (the slot of the tables of ``W_Q``
    in shared memory, after the tile and the windows), ``sub`` (1) and
    ``alt``: for Bluestein over m = 2 x :data:`GLOBAL_TILE`, the layout
    whose ``sub`` 2 sub-transforms of a frame run one after the other in one
    CTA (a scratch of 2 n points a frame: x and the sum), else None."""
    if fft_len < 1 or dec < 1 or not 1 <= n_taps <= dec * fft_len + 1:
        return None
    pow2 = fft_len & (fft_len - 1) == 0
    m = fft_len if pow2 else 1 << (2 * fft_len - 2).bit_length()
    if m < 2:
        return None
    lps, lts = global_levels(m)
    if len(lps) > GLOBAL_MAX_LEVELS:
        return None
    lay = _global_fit(dict(n=fft_len, m=m, bluestein=not pow2, dec=dec, k=n_taps, lp=lps,
                           lt=lts, h=m.bit_length() // 2, sub=1, alt=None))
    if not pow2 and m == 2 * GLOBAL_TILE:  # Bluestein's two sub-transforms in one CTA
        lay["alt"] = _global_fit(dict(lay, lp=[GLOBAL_TILE.bit_length() - 1], lt=[0], sub=2))
    if global_bytes(lay, 1) > CARD_BYTES:
        return None
    return lay


def _global_fit(lay: dict) -> dict:
    """``lay`` with its tile, the FIR's staging and the tables of ``W_Q``."""
    lps = lay["lp"]
    tile = _fslot(GLOBAL_TILE - 1) + 1
    log2q = max(lps)
    hq = (log2q + 1) // 2
    tables = (1 << hq) + ((1 << log2q) >> hq)
    # one level: the windows beside the tile; more: the FIR runs before the
    # first level's tiles, its windows and a chunk of outputs in the tile's place
    chunk_max = 8 * GLOBAL_THREADS
    fit = _fir_fit(lay["dec"], lay["k"], GLOBAL_THREADS, 8, 1,
                   (tile if len(lps) == 1 else chunk_max) + tables)
    split, chunk, kt, win = fit if fit is not None else (1, GLOBAL_THREADS, lay["k"], 0)
    twoff = tile + 2 * win if len(lps) == 1 else max(tile, 2 * win + chunk)
    return dict(lay, tile=tile, split=split, chunk=chunk, kt=kt, win=win, log2q=log2q, hq=hq,
                twoff=twoff)


def global_bytes(lay: dict, frames: int) -> int:
    """Device bytes of a global-instance call on ``frames`` frames: its
    scratch of ``m`` points a frame where the FFT has more than one level
    (``2 n`` for the ``sub`` route), and its tables (the two of ``W_Q``, the two of ``W_m``, and Bluestein's
    chirp and filter spectrum)."""
    m, n = lay["m"], lay["n"]
    levels = len(lay["lp"]) > 1
    scratch = frames * m if levels else (frames * 2 * n if lay["sub"] > 1 else 0)
    tables = ((1 << lay["hq"]) + ((1 << lay["log2q"]) >> lay["hq"])
              + (((1 << lay["h"]) + (m >> lay["h"])) if levels or lay["sub"] > 1 else 0))
    return 8 * (scratch + tables + (n + m if lay["bluestein"] else 0))


@functools.lru_cache(maxsize=None)
def kernel_plan(dec: int, fft_len: int, stage_n1: Optional[int] = None,
                n_taps: int = 1) -> Optional[tuple]:
    """``(instance, n1)``: the kernel's instance for a geometry (``"direct"``
    wherever :func:`direct_layout` takes it, else ``"chunked"`` or
    ``"cluster"`` of :func:`general_layout`, else ``"global"`` of
    :func:`global_layout`), or None where a frame's scratch exceeds the
    card's memory. The kernel has no stage split: ``n1`` is the split the
    plain twin computes, ``stage_n1`` or the heuristic's
    (``_fused_stage_n1``, the JAX package's), None where there is none (the
    twin's FFT route)."""
    n1 = _fir._fused_stage_n1(dec, fft_len, stage_n1)
    if direct_layout(dec, fft_len, n_taps) is not None:
        return "direct", n1
    layout = general_layout(dec, fft_len, n_taps)
    if layout is not None:
        return layout["instance"], n1
    return None if global_layout(dec, fft_len, n_taps) is None else ("global", n1)


def kernel_supports(dec: int, fft_len: int, stage_n1: Optional[int] = None,
                    n_taps: int = 1) -> Optional[str]:
    """The instance of the CUDA kernel that takes this geometry
    (``"direct"``, ``"chunked"``, ``"cluster"`` or ``"global"``, see
    :func:`kernel_plan`), or None where none does (a frame whose scratch
    exceeds the card's memory). Every output mode shares the condition."""
    plan = kernel_plan(dec, fft_len, stage_n1, n_taps)
    return None if plan is None else plan[0]


def _check_args(x: torch.Tensor, taps, dec: int, fft_len: int, epilogue: str):
    if epilogue not in EPILOGUES:
        raise ValueError(
            f"unknown epilogue {epilogue!r} (expected one of {sorted(EPILOGUES)})"
        )
    if x.dtype != torch.complex64:
        raise TypeError(f"rx_frame takes complex64 samples, got {x.dtype}")
    taps = np.asarray(taps, dtype=np.complex64).ravel()
    span = dec * fft_len
    if x.shape[-1] % span:
        raise ValueError(
            f"length {x.shape[-1]} not divisible by dec*fft_len = {span}"
        )
    if taps.shape[-1] - 1 > span:
        raise ValueError(f"taps ({taps.shape[-1]}) longer than a frame ({span}) + 1")
    bits = {"qpsk": 2, "bpsk": 1}.get(epilogue)
    if bits and fft_len * bits % 8:
        raise ValueError(
            f"the {epilogue} epilogue writes whole bytes per frame; "
            f"fft_len {fft_len} x {bits} bits is not a multiple of 8"
        )
    return taps


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Flat per-bit ``[..., n]`` (``n % 8 == 0``) -> packed uint8 bytes
    ``[..., n / 8]``, LSB-first."""
    n = bits.shape[-1]
    w = bits.reshape(bits.shape[:-1] + (n // 8, 8)).to(torch.int32)
    byte = w[..., 0]
    for m in range(1, 8):
        byte = byte | (w[..., m] << m)
    return byte.to(torch.uint8)


def unpack_bits(packed: torch.Tensor) -> torch.Tensor:
    """Packed bytes ``[..., m]`` -> flat per-bit uint8 ``[..., 8 m]``,
    LSB-first (the inverse of :func:`pack_bits`)."""
    shifts = torch.arange(8, device=packed.device, dtype=torch.int32)
    bits = (packed.to(torch.int32)[..., None] >> shifts) & 1
    return bits.to(torch.uint8).reshape(packed.shape[:-1] + (-1,))


def rx_frame_reference(x, taps, dec: int, fft_len: int, history=None,
                       epilogue: str = "qpsk",
                       stage_n1: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`rx_frame` (same signature, same
    output), on any device: the staged two-einsum frame op where a stage
    split exists (``stage_n1``, else the heuristic's), else the span-point
    FFT route of the JAX package's ``fir_decimate_fft`` (the FFT times the
    taps' spectrum, the spectral fold, the wrap correction)."""
    taps = _check_args(x, taps, dec, fft_len, epilogue)
    batch = tuple(x.shape[:-1])
    if _fir._fused_stage_n1(dec, fft_len, stage_n1) is None:
        spec = _fir.fir_decimate_fft(x, taps, dec, fft_len, Scale.NONE, history=history)
    else:
        z = _fir.fir_decimate_fft(
            x, taps, dec, fft_len, Scale.NONE, history=history,
            stage_n1=stage_n1, _staged_layout=True,
        )  # [n1, ..., nsym, r], k1 leading
        spec = z.movedim(0, -1).reshape(batch + (-1, fft_len))  # natural bin order
    if epilogue == "spectrum":
        return Scale.SN.apply(spec)
    return pack_bits(sign_bits(spec, epilogue))


@functools.lru_cache(maxsize=None)
def _direct_entry():
    fn = build.load("rx_frame").rx_frame_direct_launch
    fn.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        + [ctypes.c_longlong] + [ctypes.c_int] * 7 + [ctypes.c_void_p, ctypes.c_int]
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def direct_radices(fft_len: int):
    """The direct instance's ``(n_mixed, rad, npass)`` C arguments: ``(0,
    None, 0)`` for a power of two (its own radix-8/4/2 passes), else the
    mixed-radix passes of :func:`radices` as an int32 array."""
    if fft_len & (fft_len - 1) == 0:
        return 0, None, 0
    rads = np.asarray(radices(fft_len), dtype=np.int32)
    return fft_len, rads, len(rads)


class GenPlan(ctypes.Structure):
    """ctypes mirror of ``csrc/rx_frame.cu`` ``GenPlan`` (same field order)."""

    _fields_ = ([(name, ctypes.c_int) for name in (
        "n", "dec", "k", "kt", "fpc", "q", "lp", "split", "chunk", "win", "fbuf", "nb1",
        "nb2", "a", "b", "np1", "np2")]
        + [("rad1", ctypes.c_int * MAX_PASSES), ("rad2", ctypes.c_int * MAX_PASSES)])


@functools.lru_cache(maxsize=None)
def gen_plan(dec: int, fft_len: int, n_taps: int) -> GenPlan:
    """The :class:`GenPlan` of :func:`general_layout` (which must take the
    geometry), built once per geometry."""
    lay = general_layout(dec, fft_len, n_taps)
    fields = {key: lay[key] for key, _ in GenPlan._fields_[:15]}
    plan = GenPlan(**fields, np1=len(lay["rad1"]), np2=len(lay["rad2"]))
    plan.rad1[:len(lay["rad1"])] = lay["rad1"]
    plan.rad2[:len(lay["rad2"])] = lay["rad2"]
    return plan


@functools.lru_cache(maxsize=None)
def _general_entry():
    fn = build.load("rx_frame").rx_frame_general_launch
    fn.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p,
                                                  ctypes.c_longlong, ctypes.c_int,
                                                  ctypes.c_int, ctypes.POINTER(GenPlan),
                                                  ctypes.c_float, ctypes.c_int,
                                                  ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def twiddles(fft_len: int, device: str) -> torch.Tensor:
    """The FFT twiddles ``W[e] = exp(-2 pi i e / fft_len)``, ``e <
    fft_len``: computed in float64, stored as complex64, uploaded once per
    ``(fft_len, device)``."""
    e = np.arange(fft_len, dtype=np.float64)
    return torch.from_numpy(np.exp(-2j * np.pi * e / fft_len).astype(np.complex64)).to(device)


@functools.lru_cache(maxsize=None)
def _direct_taps(taps_bytes: bytes):
    """The taps as ``(re, im)`` float32 pairs for the C entry, and whether
    every imaginary part is exactly 0 (the real-tap variant)."""
    taps = np.frombuffer(taps_bytes, dtype=np.complex64)
    return np.ascontiguousarray(taps.view(np.float32)), bool(np.all(taps.imag == 0))


@functools.lru_cache(maxsize=None)
def device_taps(taps_bytes: bytes, device: str) -> torch.Tensor:
    """The taps as complex64 on ``device``, uploaded once (the chunked and
    cluster instances read them through L1)."""
    return torch.from_numpy(np.frombuffer(taps_bytes, dtype=np.complex64).copy()).to(device)


def sign_bits(spec: torch.Tensor, epilogue: str) -> torch.Tensor:
    """The bit epilogues' hard decisions of ``[..., nsym, fft_len]`` spectra,
    one uint8 per bit in natural bin order: QPSK ``(re < 0, im < 0)``, BPSK
    ``re + im < 0``, flat per block row ``[..., nsym * fft_len * bits]``."""
    if epilogue == "qpsk":
        bits = torch.stack([spec.real < 0, spec.imag < 0], dim=-1)
    else:
        bits = spec.real + spec.imag < 0
    return bits.to(torch.uint8).reshape(spec.shape[:-2] + (-1,))


def rx_frame(x, taps, dec: int, fft_len: int, history=None,
             epilogue: str = "qpsk",
             stage_n1: Optional[int] = None) -> torch.Tensor:
    """Block ``[..., n]`` complex64 -> packed demod bytes or SN spectra.

    ``history``: optional ``[..., K-1]`` samples preceding each block row
    (zeros = causal start). On a CUDA tensor this launches the kernel of
    ``csrc/rx_frame.cu`` on the current stream, once, in the instance of
    :func:`kernel_plan` (``stage_n1`` changes no route: the kernel has no
    stage split); it raises on a geometry no instance takes, a dtype other
    than complex64, a non-contiguous block, a missing ``nvcc``, a failed
    build or a failed launch. On a CPU tensor it is
    :func:`rx_frame_reference`.
    """
    if not isinstance(x, torch.Tensor):
        raise TypeError("rx_frame takes a torch.Tensor block")
    if x.device.type == "cpu":
        return rx_frame_reference(x, taps, dec, fft_len, history, epilogue,
                                  stage_n1)
    if x.device.type != "cuda":
        raise ValueError(f"rx_frame runs on cpu or cuda, not {x.device.type}")
    taps = _check_args(x, taps, dec, fft_len, epilogue)
    if not x.is_contiguous():
        raise ValueError("rx_frame takes a contiguous block")
    k = taps.shape[-1]
    ku = k - 1
    span = dec * fft_len
    plan = kernel_plan(dec, fft_len, stage_n1, k)
    batch = tuple(x.shape[:-1])
    nsym = x.shape[-1] // span
    rows = int(np.prod(batch, dtype=np.int64))
    frames = rows * nsym
    if plan is None or plan[0] == "global":
        total = torch.cuda.get_device_properties(x.device).total_memory
        if plan is None or global_bytes(global_layout(dec, fft_len, k), frames) > total:
            raise ValueError(
                f"the CUDA rx_frame kernel does not take dec {dec}, fft_len {fft_len}, "
                f"{k} taps over {frames} frames: the global instance's scratch exceeds the "
                f"card's memory ({total} bytes; see global_layout)"
            )
    q = gen_plan(dec, fft_len, k).q if plan[0] in ("chunked", "cluster") else 1
    if plan[0] != "global" and frames * q >= 1 << 31:
        raise ValueError(f"{frames} frames exceed one launch's grid")
    hist = None
    if ku > 0 and history is not None:
        hist = torch.as_tensor(history, dtype=torch.complex64, device=x.device)
        if hist.shape[-1] != ku:
            raise ValueError(f"history must have K-1 = {ku} samples")
        hist = hist.expand(batch + (ku,)).contiguous()
    if epilogue == "spectrum":
        out = torch.empty(batch + (nsym, fft_len), dtype=torch.complex64, device=x.device)
    else:
        bits = 2 if epilogue == "qpsk" else 1
        out = torch.empty(batch + (nsym * fft_len * bits // 8,), dtype=torch.uint8,
                          device=x.device)
    if frames == 0:
        return out
    if plan[0] == "direct":
        _launch_direct(x, hist, taps, dec, fft_len, epilogue, out, frames)
    elif plan[0] == "global":
        _launch_global(x, hist, taps, dec, fft_len, epilogue, out, frames)
    else:
        _launch_general(x, hist, taps, dec, fft_len, epilogue, out, frames)
    return out


def _launch_direct(x, hist, taps, dec, fft_len, epilogue, out, frames):
    """One launch of the direct instance into ``out`` (see :func:`rx_frame`)."""
    global launches
    fpc, wp, nb = direct_layout(dec, fft_len, taps.shape[-1])
    taps_ri, real = _direct_taps(taps.tobytes())
    n_mixed, rads, npass = direct_radices(fft_len)
    index = x.get_device()
    rc = _direct_entry()(
        EPILOGUES[epilogue], x.data_ptr(), None if hist is None else hist.data_ptr(),
        twiddles(fft_len, str(x.device)).data_ptr(), taps_ri.ctypes.data,
        taps.shape[-1], int(real), out.data_ptr(), frames, x.shape[-1] // (dec * fft_len), dec,
        fft_len.bit_length() - 1, fpc, wp, nb, n_mixed,
        None if rads is None else rads.ctypes.data, npass, Scale.SN.factor_for(fft_len),
        index, torch._C._cuda_getCurrentRawStream(index),
    )
    if rc != 0:
        raise RuntimeError(f"rx_frame kernel launch failed: CUDA error {rc}")
    launches += 1


def _launch_general(x, hist, taps, dec, fft_len, epilogue, out, frames):
    """One launch of the chunked or cluster instance into ``out`` (see
    :func:`rx_frame`)."""
    global launches
    k = taps.shape[-1]
    plan = gen_plan(dec, fft_len, k)
    threads = general_layout(dec, fft_len, k)["threads"]
    dev = str(x.device)
    index = x.get_device()
    rc = _general_entry()(
        EPILOGUES[epilogue], x.data_ptr(), None if hist is None else hist.data_ptr(),
        twiddles(fft_len, dev).data_ptr(), device_taps(taps.tobytes(), dev).data_ptr(),
        int(_direct_taps(taps.tobytes())[1]), out.data_ptr(), frames,
        x.shape[-1] // (dec * fft_len), threads, ctypes.byref(plan),
        Scale.SN.factor_for(fft_len), index, torch._C._cuda_getCurrentRawStream(index),
    )
    if rc != 0:
        raise RuntimeError(f"rx_frame kernel launch failed: CUDA error {rc}")
    launches += 1


class GlobalPlan(ctypes.Structure):
    """ctypes mirror of ``csrc/rx_frame.cu`` ``GlobalPlan`` (same field order)."""

    _fields_ = ([("n", ctypes.c_longlong), ("m", ctypes.c_longlong)]
                + [(name, ctypes.c_int) for name in ("dec", "k", "bluestein", "levels")]
                + [("lp", ctypes.c_int * GLOBAL_MAX_LEVELS),
                   ("lt", ctypes.c_int * GLOBAL_MAX_LEVELS)]
                + [(name, ctypes.c_int) for name in ("tile", "split", "chunk", "kt", "win",
                                                     "log2q", "h", "hq", "twoff", "sub")])


def global_route(lay: dict, frames: int) -> dict:
    """The layout a call of ``frames`` frames takes: ``lay["alt"]`` (one CTA
    a frame) where there is one and the call has :data:`GLOBAL_SUB_FRAMES`
    frames or more, else ``lay``."""
    return lay["alt"] if lay["alt"] is not None and frames >= GLOBAL_SUB_FRAMES else lay


@functools.lru_cache(maxsize=None)
def global_plan(dec: int, fft_len: int, n_taps: int, alt: bool = False) -> GlobalPlan:
    """The :class:`GlobalPlan` of :func:`global_layout` (which must take the
    geometry), or of its ``alt`` route, built once per geometry."""
    lay = global_layout(dec, fft_len, n_taps)
    lay = lay["alt"] if alt else lay
    plan = GlobalPlan(n=lay["n"], m=lay["m"], dec=dec, k=n_taps,
                      bluestein=int(lay["bluestein"]), levels=len(lay["lp"]),
                      **{key: lay[key] for key in ("tile", "split", "chunk", "kt", "win",
                                                   "log2q", "h", "hq", "twoff", "sub")})
    plan.lp[:len(lay["lp"])] = lay["lp"]
    plan.lt[:len(lay["lt"])] = lay["lt"]
    return plan


def bluestein_chirp(n: int) -> np.ndarray:
    """Bluestein's chirp ``w[j] = exp(-i pi j^2 / n)``, ``j < n``, complex128:
    ``j^2`` reduced mod ``2n`` in integers first (a float ``j^2`` loses the
    phase past a few thousand points)."""
    j = np.arange(n, dtype=np.int64)
    return np.exp(-1j * np.pi * ((j * j) % (2 * n)).astype(np.float64) / n)


def bluestein_filter(n: int, m: int) -> np.ndarray:
    """The chirp filter's spectrum over ``m``, complex128 ``[m]``: the FFT of
    ``conj(w[t])`` at ``t`` and ``m - t`` (``0 <= t < n``), zeros between,
    divided by ``m`` (the inverse FFT's factor)."""
    b = np.zeros(m, np.complex128)
    wc = np.conj(bluestein_chirp(n))
    b[:n] = wc
    b[m - n + 1:] = wc[1:][::-1]
    return np.fft.fft(b) / m


@functools.lru_cache(maxsize=None)
def bluestein_tables(n: int, m: int, device: str):
    """The chirp ``[n]`` and the filter's spectrum ``[m]`` as complex64 on
    ``device``: built in float64 on the host, uploaded once per geometry."""
    return (torch.from_numpy(bluestein_chirp(n).astype(np.complex64)).to(device),
            torch.from_numpy(bluestein_filter(n, m).astype(np.complex64)).to(device))


def split_twiddles(m: int, h: int) -> tuple:
    """``W_m^e`` as two complex64 tables built in float64: ``e < 2^h``, and
    ``e 2^h`` for ``e < m / 2^h`` (their product is ``W_m^e`` for any
    ``e < m``)."""
    lo = np.exp(-2j * np.pi * np.arange(1 << h, dtype=np.float64) / m)
    hi = np.exp(-2j * np.pi * (np.arange(m >> h, dtype=np.float64) * (1 << h)) / m)
    return lo.astype(np.complex64), hi.astype(np.complex64)


@functools.lru_cache(maxsize=None)
def _split_twiddles_on(m: int, h: int, device: str) -> torch.Tensor:
    """:func:`split_twiddles` on ``device``, the two tables end to end."""
    return torch.from_numpy(np.concatenate(split_twiddles(m, h))).to(device)


@functools.lru_cache(maxsize=None)
def _global_entry():
    fn = build.load("rx_frame").rx_frame_global_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 10
                   + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.POINTER(GlobalPlan),
                      ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch_global(x, hist, taps, dec, fft_len, epilogue, out, frames):
    """One launch of the global instance into ``out`` (see :func:`rx_frame`)
    in the route of :func:`global_route`, its scratch allocated here."""
    global launches
    k = taps.shape[-1]
    lay = global_layout(dec, fft_len, k)
    plan = global_plan(dec, fft_len, k, global_route(lay, frames) is not lay)
    dev = str(x.device)
    index = x.get_device()
    buf = twlo = twhi = chirp = filt = None
    if plan.levels > 1 or plan.sub > 1:
        buf = torch.empty((frames, plan.m if plan.levels > 1 else 2 * fft_len),
                          dtype=torch.complex64, device=x.device)
        twlo = _split_twiddles_on(plan.m, plan.h, dev)
        twhi = twlo[1 << plan.h:]
    if plan.bluestein:
        chirp, filt = bluestein_tables(fft_len, plan.m, dev)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    rc = _global_entry()(
        EPILOGUES[epilogue], x.data_ptr(), ptr(hist),
        device_taps(taps.tobytes(), dev).data_ptr(),
        _split_twiddles_on(1 << plan.log2q, plan.hq, dev).data_ptr(),
        ptr(twlo), ptr(twhi), ptr(chirp), ptr(filt), ptr(buf), out.data_ptr(), frames,
        x.shape[-1] // (dec * fft_len), int(_direct_taps(taps.tobytes())[1]),
        ctypes.byref(plan), Scale.SN.factor_for(fft_len), index,
        torch._C._cuda_getCurrentRawStream(index),
    )
    if rc != 0:
        raise RuntimeError(f"rx_frame kernel launch failed: CUDA error {rc}")
    launches += 1
