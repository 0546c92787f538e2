"""Windowed max-log BCJR over LLR spans: the recursion of the turbo decoder's
windowed constituent decoder.

Port of the TPU kernel ``aether_primitives_tpu/ops/pallas/bcjr.py``
(``_bcjr_kernel``, wrapper ``bcjr_windowed_llr``), same layout: the two LLR
streams' spans ``ls, lp [Lw, N]`` float32, one window per column, ->
a-posteriori LLRs ``[Lw, N]`` float32, from uniform metrics at both ends.
The trellis comes as the generic tables ``(nxt, prev_s, fw0, fw1, bw0,
bw1)``, each ``[S][2]`` (None = the turbo RSC-8 trellis).

- :func:`bcjr_windowed_llr` is the wrapper. For a CUDA tensor it launches
  the hand-written kernel ``csrc/bcjr.cu`` (built at first use, see
  :mod:`.build`) or raises; for a CPU tensor it runs
  :func:`bcjr_windowed_llr_reference`.
- :func:`bcjr_windowed_llr_reference` is the plain PyTorch version, a loop
  over the steps with the JAX scan's expression tree, on any device.
- :data:`launches` counts the kernel's launches.

The kernel has three instances; :func:`kernel_plan` says which one a call
takes. ``"rsc8"``: the trellis's ``nxt`` and ``prev_s`` equal the turbo
RSC-8 trellis's (``ops/turbo.py _trellis``), of which ``csrc/bcjr.cu``
holds a compile-time copy, and the coefficients factor through its four
branch-metric classes, as the turbo tables' do (decided once per table
set, with the tables' host arrays): a column's metrics live in registers,
a forward and a backward warp meet in the middle of the span, and a step
computes four branch metrics. ``"lanes"``: any other table set of 4 to 64
states (:data:`KERNEL_STATES`; the K=7 conv code), and RSC-8 spans too long
for the meet instance: the same meeting warps with a column's states spread
over lanes and its half-histories in shared memory, up to
:func:`lanes_span_limit` steps; a step's metrics are gathered by shuffles
where the tables are the shift-register pattern (:func:`shift_register`),
else through shared memory by the tables. ``"block"``: every other call
(state counts outside 4-64, spans past the lanes limit): the same meeting
schedule in the route :func:`block_layout` names: ``"thin"`` at 2 and 3
states (a column a lane; spans and half-histories in shared memory up to
:func:`thin_resident_span`), ``"block"`` to :data:`BLOCK_STATES` (a
column's states over the lanes of 1-4 warps a direction, their tables in
registers), ``"shared"`` past that to :data:`SHARED_STATES` over columns
that fill the card (one CTA a column of 8 warps a direction, the tables in
shared memory), ``"cluster"`` for every other call past
:data:`BLOCK_STATES`
(the same design across a cluster of 2-8 CTAs a column,
:func:`cluster_layout`); past shared memory the half-histories go to a
device scratch and come back ahead of need through a ``cp.async`` ring.
All take any ``N``, ragged or not, and any ``Lw >= 1``; the limit is the
card's memory.

A call decides what it needs of a table set once (:func:`_tables_of`: the
host tables, their kind, their copies on each card), finding it
by the tables object's identity or, for a new object, by one hash of the
tables; the instance comes from the state count, kind and span
(:func:`_kernel_plan`).
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

#: The state counts of the rsc8 and lanes instances' compiled tables; the
#: block instance takes any count.
KERNEL_STATES = (4, 8, 16, 32, 64)
#: The most states the block instance's ``block`` route takes (4 warps a
#: direction of 8 states a lane, their tables in registers); past it the
#: ``cluster`` route.
BLOCK_STATES = 1024
#: The ``cluster`` route (``csrc/bcjr.cu bcjr_kernel_cluster``): clusters of
#: 2 to CLUSTER_MAX CTAs a column, sized against the H100's SMS SMs. To
#: CLUSTER_REG_STATES states the tables in registers and the metrics pushed
#: to every CTA's copy of the column (placement ``"registers"``, a ring of
#: copies CLUSTER_RING steps ahead); past it the tables read a step through
#: L1 and each CTA's own states' exchange in the device scratch, read by the
#: others (``"global"``).
CLUSTER_MAX = 8
CLUSTER_REG_STATES = CLUSTER_MAX * BLOCK_STATES
SMS = 132
#: The ``"shared"`` route (``csrc/bcjr.cu bcjr_kernel_block``'s kShared):
#: past :data:`BLOCK_STATES` to SHARED_STATES states, one CTA a column of
#: SHARED_GEOMETRY = (R states a lane, W warps a direction), the tables'
#: coefficients in shared memory; its place in a geometry ``(q, R, W,
#: place, rl)`` is ``"shared"``, the third of PLACES.
SHARED_STATES = 2048
SHARED_GEOMETRY = (8, 8)
PLACES = ("registers", "global", "shared")
CLUSTER_RING = 4
#: Columns a CTA of the meet instance takes (one lane of a forward and of a
#: backward warp each), chosen by ``benches/torch_bcjr_sweep.py`` on an H100
#: at Lw 96, N 2,560 (``PERF.md``); spans too long for it at 16 take 8.
MEET_COLS = (16, 8)
_MEET_SMEM = 232448  # opt-in shared memory of a CTA on sm_90 (kMaxSmem)
_MEET_STATES = 8


@functools.lru_cache(maxsize=None)
def rsc8_tables():
    """The turbo RSC-8 trellis in the generic ``(nxt, prev_s, fw0, fw1,
    bw0, bw1)`` form (the JAX package's ``_rsc8_tables``)."""
    from ..turbo import _step_coeffs  # the trellis lives with the decoder

    nxt, prev_s, cu, cp, du, dp = _step_coeffs()
    s_count = nxt.shape[0]
    bw0 = np.broadcast_to(np.asarray(du)[None, :], (s_count, 2))
    return (
        tuple(map(tuple, nxt.tolist())),
        tuple(map(tuple, prev_s.tolist())),
        tuple(map(tuple, cu.tolist())),
        tuple(map(tuple, cp.tolist())),
        tuple(map(tuple, bw0.tolist())),
        tuple(map(tuple, np.asarray(dp).tolist())),
    )


@functools.lru_cache(maxsize=None)
def _rsc8_index():
    """int32 ``[nxt; prev_s]`` of the turbo RSC-8 trellis, the pattern the
    meet instance has compiled in, and the branch-metric class ``2 u +
    parity[s][u]`` of each transition ``(s, u)`` (its compiled-in
    ``kClass``)."""
    from ..turbo import _trellis

    nxt, par, _, prev_s, _ = _trellis()
    return np.stack([nxt, prev_s]).astype(np.int32), 2 * np.arange(2)[None, :] + par


@functools.lru_cache(maxsize=None)
def _host_tables(tables):
    """int32 ``[nxt; prev_s]`` ``[2, S, 2]`` and float32 ``[fw0; fw1; bw0;
    bw1]`` ``[4, S, 2]`` host arrays of hashable tables; the instance that
    takes them: ``"rsc8"`` when ``nxt`` and ``prev_s`` are the RSC-8
    trellis's and every transition's coefficients are its class's (backward
    ``bw[s][u]``, and forward ``fw[s'][j]`` for the transition
    ``prev_s[s'][j] -> s'``), as for the turbo tables, else ``"generic"``;
    and, for ``"rsc8"``, the classes' coefficient pairs ``[c0; c1]``
    (float32 ``[2, 4]``), else None."""
    nxt, prev_s, fw0, fw1, bw0, bw1 = tables
    idx = np.ascontiguousarray(np.stack([np.asarray(nxt), np.asarray(prev_s)]),
                               dtype=np.int32)
    coef = np.ascontiguousarray(np.stack([np.asarray(a, dtype=np.float64)
                                          for a in (fw0, fw1, bw0, bw1)]),
                                dtype=np.float32)
    s_count = idx.shape[1]
    if idx.shape != (2, s_count, 2) or coef.shape != (4, s_count, 2):
        raise ValueError("trellis tables must each be [S][2]")
    if idx.min() < 0 or idx.max() >= s_count:
        raise ValueError("trellis state indices out of range")
    pattern, klass = _rsc8_index()
    if not np.array_equal(idx, pattern):
        return idx, coef, "generic", None
    cls = np.full((2, 4), np.nan, np.float32)
    pairs = [(klass[s, u], coef[2, s, u], coef[3, s, u]) for s in range(8) for u in (0, 1)]
    for sp in range(8):
        for j in (0, 1):
            p = prev_s[sp][j]
            u = 0 if nxt[p][0] == sp else 1
            pairs.append((klass[p, u], coef[0, sp, j], coef[1, sp, j]))
    for k, c0, c1 in pairs:
        if np.isnan(cls[0, k]):
            cls[:, k] = c0, c1
        elif not (cls[0, k] == c0 and cls[1, k] == c1):
            return idx, coef, "generic", None
    return idx, coef, "rsc8", cls


def lanes_smem(s_count: int, lw: int) -> int:
    """Shared memory of a lanes-instance CTA in bytes: its spans,
    half-histories and exchange buffers, ``Lw x G x (S + 2) + 4 G S``
    floats (``G = 32 / min(S, 32)`` columns)."""
    g = 32 // min(s_count, 32)
    return 4 * (lw * g * (s_count + 2) + 4 * g * s_count)


def lanes_span_limit(s_count: int) -> int:
    """The longest span the lanes instance takes at ``s_count`` states:
    the largest ``Lw`` whose :func:`lanes_smem` fits a CTA's shared
    memory."""
    g = 32 // min(s_count, 32)
    return (_MEET_SMEM // 4 - 4 * g * s_count) // (g * (s_count + 2))


def cluster_layout(s_count: int, n: int = 1):
    """The geometry past :data:`BLOCK_STATES` at ``s_count`` states over
    ``n`` columns, ``(q, R, W, place, rl)``: ``q`` CTAs a column, ``W``
    warps a direction in each, ``rl`` states a lane (``R`` its compile-time
    count, 1 in the global placement), in the placement ``place`` of
    :data:`PLACES`. The ``cluster`` route: to :data:`CLUSTER_REG_STATES`
    ``q`` the least power of two with ``q`` x 1,024 >= S, doubled while the
    columns' CTAs fill at most half the SMs (to 8), ``R`` the least of 2,
    4, 8 with 128 R >= S / q, ``W = ceil(S / q / 32 R)`` (3 or 4); past it
    the global placement, ``q`` 8, ``W`` 4, ``rl = ceil(S / 1,024)``. To
    :data:`SHARED_STATES`, where that cluster is 2 CTAs (the columns fill
    the SMs: 34 columns and more), the ``"shared"`` route instead, ``q`` 1,
    ``(R, W)`` :data:`SHARED_GEOMETRY` (on an H100 at the K 12 code, Lw 224:
    0.277 ms against the cluster's 0.374 at 64 columns, 0.268 against 0.228
    at 7; ``benches/torch_bcjr_sweep.py``, PERF.md)."""
    if s_count <= CLUSTER_REG_STATES:
        q = max(2, 1 << (-(-s_count // BLOCK_STATES) - 1).bit_length())
        while q < CLUSTER_MAX and 2 * q * n <= SMS:
            q *= 2
        if s_count <= SHARED_STATES and q == 2:
            r, w = SHARED_GEOMETRY
            return 1, r, w, "shared", r
        sc = -(-s_count // q)
        r = next(r for r in (2, 4, 8) if 128 * r >= sc)
        return q, r, -(-sc // (32 * r)), "registers", r
    q, w = CLUSTER_MAX, 4
    return q, 1, w, "global", -(-s_count // (q * 32 * w))


def cluster_smem(r: int, w: int, place: str, sc: int, q: int) -> int:
    """Shared memory of a ``cluster`` CTA of ``sc`` states in a cluster of
    ``q``, in bytes (``csrc/bcjr.cu cluster_smem_floats``): in the registers
    placement the whole column's metrics (``4 q sc`` floats), the keys, four
    mbarriers and the ring of copies; in the global placement the keys."""
    if place == "registers":
        return 4 * (4 * q * sc + 12 * 32 + 8 + CLUSTER_RING * (2 + 2 * r) * 64 * w)
    return 4 * 12 * 32


def block_layout(s_count: int, n: int = 1):
    """The block instance's route at ``s_count`` states over ``n`` columns,
    ``(route, R, L, W, G, P, q)`` (``csrc/bcjr.cu launch_block_route``):
    ``R`` states a lane, ``L`` lanes and ``W`` warps a column and direction
    in a CTA, ``G`` columns a CTA, ``P`` the padded states a column, ``q``
    CTAs a column. ``"thin"`` at 2 and 3 states (a column a lane, ``R =
    S``); ``"block"`` to :data:`BLOCK_STATES`: 4-32 states a state a lane
    (``L`` the power of two >= S, ``32 / L`` columns a warp), 33-256 one
    warp (``R`` the power of two >= S / 32), past 256 ``W = ceil(S / 256)``
    warps of 8 states a lane; past that ``"shared"`` or ``"cluster"``
    (:func:`cluster_layout`: ``q`` CTAs a column, ``P = 32 q W R``)."""
    if s_count <= 3:
        return "thin", s_count, 1, 1, 32, s_count, 1
    if s_count <= 32:
        lanes = max(4, 1 << (s_count - 1).bit_length())
        return "block", 1, lanes, 1, 32 // lanes, lanes, 1
    if s_count <= 256:
        r = 1 << (-(-s_count // 32) - 1).bit_length()
        return "block", r, 32, 1, 1, 32 * r, 1
    if s_count <= BLOCK_STATES:
        w = -(-s_count // 256)
        return "block", 8, 32, w, 1, 256 * w, 1
    q, _, w, place, rl = cluster_layout(s_count, n)
    return ("shared" if place == "shared" else "cluster"), rl, 32, w, 1, 32 * q * w * rl, q


def thin_resident_span(s_count: int) -> int:
    """The longest span whose spans and half-histories the thin route (2 or
    3 states) keeps in a CTA's shared memory, ``Lw x (S + 2) x 32`` floats
    (``csrc/bcjr.cu thin_smem``): 454 steps at S 2, 363 at S 3; longer
    spans go through the scratch."""
    return _MEET_SMEM // (4 * (s_count + 2) * 32)


def kernel_plan(tables, lw: int):
    """The instance a call on the card takes: ``("rsc8", c)``, the meet
    instance at the first columns a CTA ``c`` of :data:`MEET_COLS` whose
    spans and history (``Lw`` x ``c`` x 40 bytes) fit a CTA's shared
    memory; else ``("lanes", g)``, ``g`` columns a CTA, up to
    :func:`lanes_span_limit`; else, and at any state count outside
    :data:`KERNEL_STATES`, ``("block", g)``, ``g`` columns a CTA of
    :func:`block_layout`. Raises ValueError where one column's device
    scratch does not fit the card's memory (:data:`CARD_BYTES`)."""
    return _tables_of(tables).plan(lw)


@functools.lru_cache(maxsize=None)
def _kernel_plan(s_count: int, kind: str, lw: int):
    if scratch_bytes(s_count, lw, 1) > CARD_BYTES:
        raise ValueError(
            f"the CUDA BCJR kernel does not take {s_count} states over {lw} steps: a "
            f"column's scratch exceeds the card's memory ({CARD_BYTES} bytes)"
        )
    if s_count in KERNEL_STATES:
        if kind == "rsc8":
            for c in MEET_COLS:
                if lw * c * (_MEET_STATES + 2) * 4 <= _MEET_SMEM:
                    return "rsc8", c
        if lw <= lanes_span_limit(s_count):
            return "lanes", 32 // min(s_count, 32)
    return "block", block_layout(s_count)[4]


def _cluster_floats(layout, lw: int, n: int) -> tuple:
    """``(history, exchange)`` floats of the ``cluster`` route's scratch at
    ``layout = (q, R, W, place, rl)`` over ``n`` columns: ``Lw x P`` a
    column, and in the global placement its four exchange buffers, ``4 P``."""
    q, _, w, place, rl = layout
    p = 32 * q * w * rl
    return lw * p * n, (4 * p * n if place == "global" else 0)


def scratch_bytes(s_count: int, lw: int, n: int) -> int:
    """Device scratch bytes of a block-instance call on ``n`` columns: the
    half-histories, ``Lw`` x ``P`` floats a column (``P`` the padded states
    of :func:`block_layout`, whole CTAs of ``G`` columns; none where the
    thin route keeps them in shared memory, to :func:`thin_resident_span`),
    and the ``cluster`` route's exchange in its global placement (``4 P``
    floats a column)."""
    route, _, _, _, g, p, _ = block_layout(s_count, n)
    if route == "thin" and lw <= thin_resident_span(s_count):
        return 0
    if route == "cluster":
        return 4 * sum(_cluster_floats(cluster_layout(s_count, n), lw, n))
    return 4 * lw * p * g * (-(-n // g))


def _check_args(ls, lp, lw: int):
    for name, a in (("ls", ls), ("lp", lp)):
        if not isinstance(a, torch.Tensor):
            raise TypeError(f"bcjr_windowed_llr takes torch.Tensor spans ({name})")
        if a.dtype != torch.float32:
            raise TypeError(f"bcjr_windowed_llr takes float32 spans, got {a.dtype}")
    if ls.shape != lp.shape or ls.ndim != 2 or ls.shape[0] != lw:
        raise ValueError(f"bad spans {tuple(ls.shape)} {tuple(lp.shape)} for Lw={lw}")
    if ls.device != lp.device:
        raise ValueError("ls and lp must be on one device")


def bcjr_windowed_llr_reference(ls, lp, lw: int, tables=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`bcjr_windowed_llr` (same signature,
    same output), on any device. States lead (``[S, N]`` metrics), and
    every state's update has the scan's expression tree."""
    _check_args(ls, lp, lw)
    idx, coef, _, _ = _host_tables(tables if tables is not None else rsc8_tables())
    dev = ls.device
    s_count = idx.shape[1]
    nxt = [torch.from_numpy(idx[0, :, u].astype(np.int64)).to(dev) for u in (0, 1)]
    prev = [torch.from_numpy(idx[1, :, u].astype(np.int64)).to(dev) for u in (0, 1)]
    c = torch.from_numpy(coef).to(dev)[..., None]  # [4, S, 2, 1]
    fw0, fw1, bw0, bw1 = c[0], c[1], c[2], c[3]
    n = ls.shape[1]

    def g(c0, c1, u, ls_t, lp_t):  # [S, N]
        return c0[:, u] * ls_t + c1[:, u] * lp_t

    betas = torch.empty((lw, s_count, n), dtype=torch.float32, device=dev)
    beta = torch.zeros((s_count, n), dtype=torch.float32, device=dev)
    for t in range(lw - 1, -1, -1):
        betas[t] = beta
        ls_t, lp_t = ls[t][None], lp[t][None]
        b = torch.maximum(beta[nxt[0]] + g(bw0, bw1, 0, ls_t, lp_t),
                          beta[nxt[1]] + g(bw0, bw1, 1, ls_t, lp_t))
        beta = b - b.amax(dim=0, keepdim=True)
    out = torch.empty((lw, n), dtype=torch.float32, device=dev)
    alpha = torch.zeros((s_count, n), dtype=torch.float32, device=dev)
    for t in range(lw):
        ls_t, lp_t = ls[t][None], lp[t][None]
        beta_t = betas[t]
        m0 = ((alpha + g(bw0, bw1, 0, ls_t, lp_t)) + beta_t[nxt[0]]).amax(dim=0)
        m1 = ((alpha + g(bw0, bw1, 1, ls_t, lp_t)) + beta_t[nxt[1]]).amax(dim=0)
        out[t] = m0 - m1
        a = torch.maximum(alpha[prev[0]] + g(fw0, fw1, 0, ls_t, lp_t),
                          alpha[prev[1]] + g(fw0, fw1, 1, ls_t, lp_t))
        alpha = a - a.amax(dim=0, keepdim=True)
    return out


@functools.lru_cache(maxsize=None)
def _entries():
    lib = build.load("bcjr")
    meet = lib.bcjr_rsc8_launch
    meet.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_longlong]
                     + [ctypes.c_int] * 2 + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    meet.restype = ctypes.c_int
    lanes = lib.bcjr_lanes_launch
    lanes.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_longlong]
                      + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
                      + [ctypes.c_int, ctypes.c_void_p])
    lanes.restype = ctypes.c_int
    block = lib.bcjr_block_launch
    block.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_longlong]
                      + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 4
                      + [ctypes.c_int, ctypes.c_void_p])
    block.restype = ctypes.c_int
    return meet, lanes, block


class _TableSet:
    """What a call needs of one table set, decided once: the host tables
    (:func:`_host_tables`) and their kind, the shuffle form
    (:func:`shift_register`), the state count, and the tables on each card,
    copied at first use (:meth:`card`)."""

    __slots__ = ("idx", "coef", "kind", "cls", "shift", "s_count", "cards")

    def __init__(self, tables):
        self.idx, self.coef, self.kind, self.cls = _host_tables(
            tables if tables is not None else rsc8_tables())
        self.s_count = self.idx.shape[1]
        self.shift = _shift_pattern(self.idx)
        self.cards = {}

    def plan(self, lw: int):
        """The instance at span ``lw`` (:func:`kernel_plan`)."""
        return _kernel_plan(self.s_count, self.kind, lw)

    def card(self, index: int) -> tuple:
        """int32 ``[nxt; prev_s]`` and float32 ``[fw0; fw1; bw0; bw1]`` on
        card ``index``."""
        got = self.cards.get(index)
        if got is None:
            dev = torch.device("cuda", index)
            got = self.cards[index] = (torch.from_numpy(self.idx).to(dev),
                                       torch.from_numpy(self.coef).to(dev))
        return got


@functools.lru_cache(maxsize=None)
def _table_set(tables) -> _TableSet:
    """The :class:`_TableSet` of ``tables``, cached on their hash."""
    return _TableSet(tables)


_RECENT = {}


def _tables_of(tables) -> _TableSet:
    """:func:`_table_set`, found first by the tables object's identity (the
    decoders pass the same tuples every call; a hash of S = 2,048 tables
    costs about as much as the kernel), so that a call hashes its tables at
    most once, where it passes a new object."""
    hit = _RECENT.get(id(tables))
    if hit is not None and hit[0] is tables:
        return hit[1]
    ts = _table_set(tables)
    if len(_RECENT) >= 64:
        _RECENT.clear()
    _RECENT[id(tables)] = (tables, ts)  # holds the tables, so their id stays theirs
    return ts


def _shift_pattern(idx) -> bool:
    s = np.arange(idx.shape[1])
    nxt = (2 * s[:, None] + np.arange(2)) % idx.shape[1]
    prev = (s[:, None] >> 1) + np.arange(2) * (idx.shape[1] // 2)
    return bool(np.array_equal(idx[0], nxt) and np.array_equal(idx[1], prev))


@functools.lru_cache(maxsize=None)
def shift_register(tables) -> bool:
    """Whether the tables' ``nxt`` and ``prev_s`` are the shift-register
    pattern of ``ops/fec.py _conv_soft_coeffs`` (``nxt[s][u] = (2 s + u)
    mod S``, ``prev_s[s'][j] = (s' >> 1) + j S / 2``): the lanes instance
    then gathers a step's metrics by shuffles instead of through shared
    memory."""
    return _shift_pattern(_host_tables(tables if tables is not None else rsc8_tables())[0])


def bcjr_windowed_llr(ls, lp, lw: int, tables=None) -> torch.Tensor:
    """Per-position max-log a-posteriori LLRs of ``[Lw, N]`` spans of the
    two LLR streams (``N`` = windows x batch, any count), uniform initial
    metrics at both ends. ``tables``: the trellis as hashable ``(nxt,
    prev_s, fw0, fw1, bw0, bw1)`` tuples, None for the turbo RSC-8 trellis.

    On a CUDA tensor this launches the kernel of ``csrc/bcjr.cu`` on the
    current stream, in the instance :func:`kernel_plan` names (the block
    one with a float32 scratch of :func:`scratch_bytes` for the
    half-histories); it raises where the scratch exceeds the card's memory,
    a dtype other than float32, non-contiguous spans, a missing ``nvcc``, a
    failed build or a failed launch. On a CPU tensor it is :func:`bcjr_windowed_llr_reference`.
    NaN input is outside the contract: the kernel's ``fmaxf`` and the plain
    version's ``torch.maximum`` treat it differently.
    """
    _check_args(ls, lp, lw)
    if ls.get_device() < 0:
        if ls.device.type == "cpu":
            return bcjr_windowed_llr_reference(ls, lp, lw, tables)
        raise ValueError(f"bcjr_windowed_llr runs on cpu or cuda, not {ls.device.type}")
    if not (ls.is_contiguous() and lp.is_contiguous()):
        raise ValueError("bcjr_windowed_llr takes contiguous spans")
    ts = _tables_of(tables)
    instance, cols = ts.plan(lw)
    n = ls.shape[1]
    need = scratch_bytes(ts.s_count, lw, n) if instance == "block" else 0
    total = torch.cuda.get_device_properties(ls.device).total_memory if need else 0
    if need > total or n >= 1 << 31:
        raise ValueError(
            f"the CUDA BCJR kernel does not take {n} columns of {lw} steps at "
            f"{ts.s_count} states: its scratch ({need} bytes) exceeds the card's "
            f"memory ({total} bytes)"
        )
    out = torch.empty((lw, n), dtype=torch.float32, device=ls.device)
    if n == 0 or lw == 0:
        return out
    if instance == "rsc8":
        _launch_meet(ls, lp, out, lw, cols, ts.cls)
    elif instance == "lanes":
        _launch_lanes(ls, lp, out, lw, tables, ts.shift, ts)
    else:
        _launch_block(ls, lp, out, lw, tables, ts)
    return out


def _launch_lanes(ls, lp, out, lw: int, tables, shift: bool, ts=None) -> None:
    """One launch of the lanes instance with ``tables`` (None: RSC-8),
    counted in :data:`launches`: in its shuffle form where ``shift`` (only
    for tables that :func:`shift_register` holds for), else its table form.
    ``ts``: the call's :func:`_tables_of`, found here where not given. The
    C entry makes the spans' card current for the launch itself."""
    global launches
    index = ls.get_device()
    idx_t, coef_t = (ts or _tables_of(tables)).card(index)
    rc = _entries()[1](ls.data_ptr(), lp.data_ptr(), out.data_ptr(), lw, ls.shape[1],
                       idx_t.shape[1], int(shift), idx_t.data_ptr(), coef_t.data_ptr(),
                       index, torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        raise RuntimeError(f"bcjr kernel launch failed: CUDA error {rc}")
    launches += 1


def _launch_meet(ls, lp, out, lw: int, cols: int, cls) -> None:
    """One launch of the meet instance at ``cols`` columns a CTA (one of
    :data:`MEET_COLS`), counted in :data:`launches`. ``cls`` is the table
    set's classes' coefficients from :func:`_host_tables`. The C entry makes
    the spans' card current for the launch itself."""
    global launches
    n = ls.shape[1]
    a, b = ls.data_ptr(), lp.data_ptr()
    vec = int(n % 4 == 0 and cols % 4 == 0 and a % 16 == 0 and b % 16 == 0)
    index = ls.get_device()
    rc = _entries()[0](a, b, out.data_ptr(), lw, n, cols, vec, cls.ctypes.data, index,
                       torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        raise RuntimeError(f"bcjr kernel launch failed: CUDA error {rc}")
    launches += 1


def _launch_block(ls, lp, out, lw: int, tables, ts=None, cluster=None) -> None:
    """One launch of the block instance with ``tables``, at any state count
    and span (the route of :func:`block_layout`), counted in
    :data:`launches`: its half-histories (and the ``cluster`` route's
    exchange in its global placement) in a scratch allocated here.
    ``ts``: the call's :func:`_tables_of`, found here where not given;
    ``cluster``: a geometry ``(q, R, W, place, rl)`` past
    :data:`BLOCK_STATES` in place of :func:`cluster_layout`'s (a bench's). A
    private entry:
    the wrapper takes it where :func:`kernel_plan` names the block instance,
    a bench or a check may call it at any state count to time the design
    against another instance."""
    global launches
    ts = ts or _tables_of(tables)
    index = ls.get_device()
    idx_t, coef_t = ts.card(index)
    s_count, n = ts.s_count, ls.shape[1]
    geo, xg = (1, 0, 0, 0, 0), None
    if s_count > BLOCK_STATES:
        geo = cluster or cluster_layout(s_count, n)
        hist_f, xg_f = _cluster_floats(geo, lw, n)
        hist = torch.empty(hist_f + xg_f, dtype=torch.float32, device=ls.device)
        xg = hist[hist_f:] if xg_f else None
        geo = (geo[0], geo[1], geo[2], PLACES.index(geo[3]), geo[4])
    else:
        hist = torch.empty(scratch_bytes(s_count, lw, n) // 4, dtype=torch.float32,
                           device=ls.device)
    rc = _entries()[2](ls.data_ptr(), lp.data_ptr(), out.data_ptr(), hist.data_ptr(),
                       None if xg is None else xg.data_ptr(), lw, n, s_count, *geo,
                       idx_t.data_ptr(), coef_t.data_ptr(), ts.idx.ctypes.data,
                       ts.coef.ctypes.data, index, torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        raise RuntimeError(f"bcjr kernel launch failed: CUDA error {rc}")
    launches += 1
