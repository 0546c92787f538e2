"""Batched hard-decision Viterbi over LLR spans: the trellis pass of
:func:`~aether_primitives_tpu_torch.ops.fec.viterbi_decode`.

Port of the TPU kernel ``aether_primitives_tpu/ops/pallas/viterbi.py``
(``_viterbi_kernel``, wrapper ``viterbi_lanes``). The layout is the GPU's,
one trellis per row: ``sym [N, Lw, n]`` float32 LLRs (the TPU's ``[Lw, n,
N]`` transposed) -> uint8 bits ``[N, Lw]``.

- :func:`viterbi_lanes` is the wrapper. For a CUDA tensor it launches the
  hand-written kernel ``csrc/viterbi.cu`` (built at first use, see
  :mod:`.build`) or raises; for a CPU tensor it runs
  :func:`viterbi_lanes_reference`.
- :func:`viterbi_lanes_reference` is the plain PyTorch version, a loop over
  the steps with the JAX scans' arithmetic, on any device.
- :data:`launches` counts the kernel's launches.

The kernel has two instances (:func:`instance`). ``"warp"``: ``2^(K-1)``
from 2 to 256 states and 1 to 8 generators, at any span length. A decision
history of ``Lw * max(1, S/32) * 4`` bytes per trellis is kept in one
block's shared memory where it fits (58,112 steps up to 32 states, 29,056
at 64, with one trellis per block; the LLRs do not take shared memory); a
longer full block keeps it in a device scratch that the wrapper allocates
(:func:`scratch_words`), with the same ACS, tie-break and traceback. A
warp decodes one trellis; the trellises a block (:data:`WARPS`, the first
that fits) were chosen by ``benches/torch_viterbi_sweep.py``.
``"block"``: every other code (more than 256 states, more than 8
generators), in one of two routes (:func:`block_plan`): up to
:data:`CLUSTER_MAX_STATES` states a CTA or a cluster of 2-8 CTAs a
trellis, the path metrics in shared memory split by state range, a thread
a pair of states, the branch metrics once a step per distinct output
pattern (:func:`patterns`; per transition past :data:`MAX_PATTERNS`) from
LLRs staged 32 steps ahead, the decisions in shared memory where a
trellis's history fits (else the device scratch), a warp's traceback five
steps a round; past it, or where a CTA's LLRs of many generators do not
fit its shared memory, the grid route: one cooperative launch of the
co-resident CTAs, every trellis's states spread by range over all of them,
the metrics and the decisions in the device scratch, one grid barrier a
step (:func:`scratch_words`; batches of :data:`GRID_BATCH` trellises in
turn). :func:`kernel_supports` is then limited by the card's memory
alone.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import CARD_BYTES, build

#: Launches of the CUDA kernel in this process (the plain version and
#: calls that raise do not count).
launches = 0

MAX_SMEM = 232_448  # bytes of shared memory one block may use on an H100
#: The warp instance's codes: 2-256 states, 1-8 generators.
WARP_MAX_STATES = 256
WARP_MAX_GENERATORS = 8
#: The block instance's cluster route: up to this many states (K <= 18), a
#: CTA of at most CTA_THREADS threads, clusters of up to CLUSTER_MAX CTAs,
#: sized against the H100's SMS SMs, each CTA's shared memory within
#: CTA_SMEM bytes (``csrc/viterbi.cu`` ``viterbi_cta_launch``). Past it the
#: grid route keeps the path metrics in the device scratch.
CLUSTER_MAX_STATES = 131_072
CTA_THREADS = 512
CLUSTER_MAX = 8
SMS = 132
CTA_SMEM = MAX_SMEM - 1_024
#: The cluster route's branch metrics: one a distinct output pattern up to
#: this many patterns (each transition's own past it); the steps of LLRs
#: staged at once (``kMaxPatterns``, ``kLlrChunk``).
MAX_PATTERNS = 256
LLR_CHUNK = 32
#: Trellises (warps) a block in order of preference; the kernel takes the
#: first whose histories fit a block.
WARPS = (4, 2, 1)
#: The grid route's trellises a pass: more go in batches inside the launch,
#: reusing the scratch (``csrc/viterbi.cu`` ``viterbi_grid_launch``).
GRID_BATCH = 65_536


def _tables(polys, k: int):
    from ..fec import _trellis  # the trellis tables live with the decoder

    return _trellis(tuple(int(p) for p in polys), int(k))


def warps_per_block(lw: int, k: int, choices=WARPS):
    """The first of ``choices`` (warps a block, one trellis a warp) whose
    decision histories fit one block's shared memory, or None."""
    per_trellis = lw * max(1, (1 << (k - 1)) // 32) * 4
    for warps in choices:
        if warps * per_trellis <= MAX_SMEM:
            return warps
    return None


def instance(n: int, constraint: int) -> str:
    """The kernel instance that decodes a code of ``n`` generators and
    constraint length ``constraint``: ``"warp"`` (2-256 states, 1-8
    generators) or ``"block"`` (any other code)."""
    s_count = 1 << (int(constraint) - 1)
    return ("warp" if 2 <= s_count <= WARP_MAX_STATES and n <= WARP_MAX_GENERATORS
            else "block")


def _mask_words(n: int) -> int:
    return -(-int(n) // 32)


def _cta_smem(s_count: int, n: int, q: int, threads: int, lw: int, dec_smem: bool) -> int:
    """Shared memory bytes of a CTA of the cluster route: two metric
    buffers of its ``S / q`` states, the decisions where they are kept
    there, the patterns' metrics, two chunks of LLRs and the warps'
    minima."""
    sc = s_count // q
    return 4 * (2 * sc + (lw * max(1, sc // 32) if dec_smem else 0) + 2 * MAX_PATTERNS
                + 2 * LLR_CHUNK * n + 2 * q * (threads // 32))


@functools.lru_cache(maxsize=None)
def patterns(polys, k: int) -> tuple:
    """``(npat, codes)``: the code's distinct output patterns and the
    cluster route's table of them, uint32 words: where ``npat <=``
    :data:`MAX_PATTERNS`, each transition row's pattern byte (row ``2 s' +
    j``, :func:`block_mask_words`' order; padded to whole words), then each
    pattern's output bits (``[npat, ceil(n / 32)]``); past it the rows'
    output bits themselves."""
    rows = block_mask_words(polys, k)
    pats, inverse = np.unique(rows, axis=0, return_inverse=True)
    if len(pats) > MAX_PATTERNS:
        return len(pats), rows
    ids = np.zeros(-(-rows.shape[0] // 4) * 4, np.uint8)
    ids[:rows.shape[0]] = inverse.reshape(-1)
    return len(pats), np.concatenate([ids.view(np.uint32), pats.reshape(-1)])


def block_plan(lw: int, n: int, k: int, n_trellis: int, npat=None):
    """The block instance's cluster route for ``n_trellis`` spans, or None
    (the grid route: past :data:`CLUSTER_MAX_STATES` states, or where a
    CTA's shared memory does not fit at the largest cluster, or a cluster's
    CTA would keep fewer than 64 states): ``q`` CTAs a trellis (doubled from
    1 while the metrics do not fit a CTA, or while the trellises' CTAs fill
    fewer than half the SMs and a CTA keeps 2,048 states), ``threads`` a CTA
    (a thread a pair of states, and one a pattern's metric, 32-512; ``npat``
    the code's patterns, at most ``min(2^n, 2 S)`` where it is not given),
    and ``dec_smem`` (the decisions in shared memory where they fit)."""
    s_count = 1 << (int(k) - 1)
    if s_count > CLUSTER_MAX_STATES:
        return None
    q = 1
    while q < CLUSTER_MAX and (_cta_smem(s_count, n, q, CTA_THREADS, lw, False) > CTA_SMEM
                               or (2 * n_trellis * q <= SMS and s_count // q >= 2048)):
        q *= 2
    if (_cta_smem(s_count, n, q, CTA_THREADS, lw, False) > CTA_SMEM
            or (q > 1 and s_count // q < 64)):
        return None  # the LLRs of many generators: viterbi_cta_launch would refuse it
    if npat is None:
        npat = min(1 << min(int(n), 20), 2 * s_count)
    threads = max(32, min(CTA_THREADS, s_count // q // 2))
    if npat > threads and threads < CTA_THREADS:  # a thread a pattern where it pays
        threads = min(CTA_THREADS, -(-min(npat, MAX_PATTERNS) // 32) * 32)
    # at the widest CTA: the scratch's size does not depend on npat
    return dict(q=q, threads=threads,
                dec_smem=_cta_smem(s_count, n, q, CTA_THREADS, lw, True) <= CTA_SMEM)


def _block_scratch(lw: int, n: int, k: int, n_trellis: int) -> tuple:
    """``(decision words, metric floats, key words)`` of the block
    instance's scratch: on the grid route, for a batch of ``min(n_trellis,
    GRID_BATCH)`` trellises, their decisions, two metric buffers a trellis,
    and three key arrays and the first argmins."""
    s_count = 1 << (int(k) - 1)
    plan = block_plan(lw, n, k, n_trellis)
    if plan is not None:
        return (0 if plan["dec_smem"] else n_trellis * lw * max(1, s_count // 32)), 0, 0
    nb = min(n_trellis, GRID_BATCH)
    return nb * lw * max(1, s_count // 32), nb * 2 * s_count, 4 * nb


def scratch_words(lw: int, k: int, n_trellis: int, n: int = 2) -> int:
    """uint32 words of the device scratch of ``n_trellis`` spans of ``lw``
    steps of a code of ``n`` generators: for the warp instance, the decision
    histories, or 0 where one trellis's history fits a block's shared memory
    (the shared route); for the block instance, the decision histories
    where they do not fit the cluster route's shared memory, and, on the
    grid route (:func:`block_plan` None), those of a batch of at most
    :data:`GRID_BATCH` trellises, two metric buffers a trellis, three key
    arrays and the first argmins."""
    if instance(n, k) == "block":
        return sum(_block_scratch(lw, n, k, n_trellis))
    if warps_per_block(lw, k) is not None:
        return 0
    return n_trellis * lw * max(1, (1 << (k - 1)) // 32)


def _card_bytes(lw: int, n: int, k: int, n_trellis: int) -> int:
    """Device bytes a call takes: its scratch and, for the block instance,
    the encoder-output table (at most ``ceil(n / 32)`` words a transition
    row, the most :func:`patterns` takes)."""
    table = 0
    if instance(n, k) == "block":
        table = (2 << (int(k) - 1)) * _mask_words(n) * 4
    return 4 * scratch_words(lw, k, n_trellis, n) + table


def kernel_supports(lw: int, n: int, constraint: int) -> bool:
    """True when the CUDA kernel takes spans of ``lw`` steps for a code of
    ``n`` generators and constraint length ``constraint``: any ``K >= 2``,
    ``n >= 1`` and ``lw >= 1`` whose one trellis's scratch and tables fit
    the card's memory (:data:`CARD_BYTES`)."""
    return (int(constraint) >= 2 and int(n) >= 1 and int(lw) >= 1
            and _card_bytes(lw, n, constraint, 1) <= CARD_BYTES)


def _check_args(sym: torch.Tensor, lw: int, n: int, polys, constraint: int):
    if sym.dtype != torch.float32:
        raise TypeError(f"viterbi_lanes takes float32 LLRs, got {sym.dtype}")
    if sym.ndim != 3 or sym.shape[1] != lw or sym.shape[2] != n:
        raise ValueError(f"bad span shape {tuple(sym.shape)} for Lw={lw}, n={n}")
    if len(polys) != n:
        raise ValueError(f"{len(polys)} generators for n = {n} LLR streams")


def viterbi_lanes_reference(sym, lw: int, n: int, polys, constraint: int,
                            init_state0: bool, end_state0: bool) -> torch.Tensor:
    """Plain PyTorch version of :func:`viterbi_lanes` (same signature, same
    output), on any device.

    ACS per step: ``c_j = pm[pred_j] + sum_m o_m llr_m`` (left to right),
    decision ``c1 < c0``, ``pm' = min(c0, c1) - min_s``; metrics start at 0
    for state 0 and 1e9 elsewhere (``init_state0``) or all zero. The
    traceback starts from state 0 (``end_state0``) or the first argmin.
    """
    _check_args(sym, lw, n, polys, constraint)
    pred, outs = _tables(polys, constraint)
    dev = sym.device
    k = int(constraint)
    s_count = pred.shape[0]
    p0 = torch.from_numpy(pred[:, 0].astype(np.int64)).to(dev)
    p1 = torch.from_numpy(pred[:, 1].astype(np.int64)).to(dev)
    o = torch.from_numpy(outs).to(dev)  # [S, 2, n] of {0, 1}
    n_tr = sym.shape[0]
    pm = torch.zeros((n_tr, s_count), dtype=torch.float32, device=dev)
    if init_state0:
        pm[:, 1:] = 1e9
    decisions = torch.empty((lw, n_tr, s_count), dtype=torch.bool, device=dev)
    for t in range(lw):
        lt = sym[:, t, :]
        g = []
        for j in (0, 1):
            acc = o[:, j, 0] * lt[:, 0:1]
            for m in range(1, n):
                acc = acc + o[:, j, m] * lt[:, m:m + 1]
            g.append(acc)
        c0 = pm[:, p0] + g[0]
        c1 = pm[:, p1] + g[1]
        decisions[t] = c1 < c0
        new = torch.minimum(c0, c1)
        pm = new - new.amin(dim=1, keepdim=True)
    if end_state0:
        state = torch.zeros(n_tr, dtype=torch.int64, device=dev)
    else:
        state = torch.argmin(pm, dim=1)
    bits = torch.empty((n_tr, lw), dtype=torch.uint8, device=dev)
    for t in range(lw - 1, -1, -1):
        bits[:, t] = (state & 1).to(torch.uint8)
        which = decisions[t].gather(1, state[:, None])[:, 0].to(torch.int64)
        state = (state >> 1) | (which << (k - 2))
    return bits


@functools.lru_cache(maxsize=None)
def block_mask_words(polys, k: int) -> np.ndarray:
    """The encoder outputs: uint32 ``[2 S, ceil(n / 32)]``, bit ``m % 32``
    of word ``m // 32`` of row ``2 s' + j`` the output ``o_m`` of the
    transition into ``s'`` from predecessor ``j`` (the block instance reads
    them on the card)."""
    _, outs = _tables(polys, k)
    n = outs.shape[-1]
    flat = outs.reshape(-1, n).astype(np.uint64)
    words = np.zeros((flat.shape[0], _mask_words(n)), np.uint64)
    for m in range(n):
        words[:, m // 32] |= flat[:, m] << np.uint64(m % 32)
    return words.astype(np.uint32)


@functools.lru_cache(maxsize=None)
def _out_masks(polys, k: int) -> np.ndarray:
    """The warp instance's uint8 ``[2 S]`` (its codes have at most 8
    generators): :func:`block_mask_words`' one word a row."""
    return np.ascontiguousarray(block_mask_words(polys, k)[:, 0].astype(np.uint8))


@functools.lru_cache(maxsize=None)
def _patterns_on(polys, k: int, index: int) -> torch.Tensor:
    """:func:`patterns`' table on card ``index`` (as int32), copied once."""
    return torch.from_numpy(patterns(polys, k)[1].view(np.int32)).to(
        torch.device("cuda", index))


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.load("viterbi").viterbi_launch
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong]
                   + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _cta_entry():
    fn = build.load("viterbi").viterbi_cta_launch
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong]
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p] + [ctypes.c_int] * 5
                   + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _grid_entry():
    fn = build.load("viterbi").viterbi_grid_launch
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong]
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p] + [ctypes.c_int] * 2
                   + [ctypes.c_void_p] * 5)
    fn.restype = ctypes.c_int
    return fn


def viterbi_lanes(sym, lw: int, n: int, polys, constraint: int,
                  init_state0: bool, end_state0: bool) -> torch.Tensor:
    """Decode ``sym [N, Lw, n]`` float32 LLR spans, one independent trellis
    per row, to uint8 bits ``[N, Lw]`` (bit t = the survivor state's input
    bit at step t).

    On a CUDA tensor this launches the kernel of ``csrc/viterbi.cu`` on the
    current stream, once, in the instance :func:`instance` names (a scratch
    allocated here, :func:`scratch_words`, where it needs one); it raises on
    a code past the card's memory (:func:`kernel_supports`, and the call's
    scratch against its card's ``total_memory``), a dtype other than
    float32, a non-contiguous tensor, a missing ``nvcc``, a failed build or
    a failed launch. On a CPU tensor it is :func:`viterbi_lanes_reference`.
    """
    global launches
    if not isinstance(sym, torch.Tensor):
        raise TypeError("viterbi_lanes takes a torch.Tensor of LLR spans")
    if sym.device.type == "cpu":
        return viterbi_lanes_reference(sym, lw, n, polys, constraint,
                                       init_state0, end_state0)
    if sym.device.type != "cuda":
        raise ValueError(f"viterbi_lanes runs on cpu or cuda, not {sym.device.type}")
    _check_args(sym, lw, n, polys, constraint)
    if not sym.is_contiguous():
        raise ValueError("viterbi_lanes takes contiguous spans")
    k = int(constraint)
    polys = tuple(int(p) for p in polys)
    n_tr = sym.shape[0]
    need = _card_bytes(lw, n, k, max(n_tr, 1))
    total = torch.cuda.get_device_properties(sym.device).total_memory if need else 0
    if not kernel_supports(lw, n, k) or need > total or n_tr >= 1 << 31:
        raise ValueError(
            f"the CUDA Viterbi kernel does not take a K={k} code with {n} "
            f"generators over {n_tr} spans of {lw} steps: its scratch and tables "
            f"({need} bytes) exceed the card's memory ({total} bytes; see "
            "kernel_supports)"
        )
    bits = torch.empty((n_tr, lw), dtype=torch.uint8, device=sym.device)
    if n_tr == 0:
        return bits
    if instance(n, k) == "block":
        launch_block(sym, bits, lw, n, polys, k, init_state0, end_state0)
        launches += 1
        return bits
    words = scratch_words(lw, k, n_tr, n)
    scratch = (torch.empty(words, dtype=torch.int32, device=sym.device)
               if words else None)
    launch(sym, bits, lw, n, polys, k, init_state0, end_state0,
           warps_per_block(lw, k) or WARPS[0], scratch)
    launches += 1
    return bits


def launch_block(sym, bits, lw: int, n: int, polys, k: int, init_state0: bool,
                 end_state0: bool) -> None:
    """One launch of the block instance into ``bits`` (checked arguments; no
    count) in the route of :func:`block_plan`, its scratch allocated here."""
    n_tr = sym.shape[0]
    s_count = 1 << (k - 1)
    words, floats, keys = _block_scratch(lw, n, k, n_tr)
    scratch = torch.empty(words + floats + keys, dtype=torch.int32, device=sym.device) if (
        words + floats + keys) else None
    npat, _ = patterns(tuple(polys), k)
    plan = block_plan(lw, n, k, n_tr, npat)
    codes = _patterns_on(tuple(polys), k, sym.get_device()).data_ptr()
    with torch.cuda.device(sym.device):
        stream = torch.cuda.current_stream(sym.device).cuda_stream
        if plan is not None:
            rc = _cta_entry()(
                sym.data_ptr(), bits.data_ptr(), n_tr, lw, n, s_count, int(bool(init_state0)),
                int(bool(end_state0)), codes, npat, _mask_words(n), plan["q"], plan["threads"],
                int(plan["dec_smem"]), None if scratch is None else scratch.data_ptr(), stream,
            )
        else:  # the metrics first (8-byte aligned), then the decisions and the keys
            pm = scratch.data_ptr()
            dec = pm + 4 * floats
            key = dec + 4 * words
            rc = _grid_entry()(
                sym.data_ptr(), bits.data_ptr(), n_tr, GRID_BATCH, lw, n, s_count,
                int(bool(init_state0)), int(bool(end_state0)), codes, npat, _mask_words(n),
                dec, pm, key, key + 4 * 3 * (keys // 4), stream,
            )
    if rc != 0:
        raise RuntimeError(f"viterbi kernel launch failed: CUDA error {rc}")


def launch(sym, bits, lw: int, n: int, polys, k: int, init_state0: bool,
           end_state0: bool, warps: int, scratch=None) -> None:
    """One launch of the kernel at ``warps`` trellises a block into ``bits``
    (checked arguments; no count), the histories in shared memory, or in
    ``scratch`` (an int32 tensor of at least ``N * lw * max(1, S/32)``
    words on the card) where it is given: :func:`viterbi_lanes`, and the
    tests and the sweep at each block width."""
    with torch.cuda.device(sym.device):
        stream = torch.cuda.current_stream(sym.device).cuda_stream
        rc = _entry()(
            sym.data_ptr(), bits.data_ptr(), sym.shape[0], lw, n, 1 << (k - 1),
            int(bool(init_state0)), int(bool(end_state0)), warps,
            _out_masks(tuple(polys), k).ctypes.data,
            None if scratch is None else scratch.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"viterbi kernel launch failed: CUDA error {rc}")
