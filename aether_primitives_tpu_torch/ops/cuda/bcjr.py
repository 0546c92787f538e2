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

The kernel has two instances; :func:`kernel_plan` says which one a call
takes. ``"rsc8"``: the trellis's ``nxt`` and ``prev_s`` equal the turbo
RSC-8 trellis's (``ops/turbo.py _trellis``), of which ``csrc/bcjr.cu``
holds a compile-time copy, and the coefficients factor through its four
branch-metric classes, as the turbo tables' do (decided once per table
set, with the tables' host arrays): a column's metrics live in registers,
a forward and a backward warp meet in the middle of the span, and a step
computes four branch metrics. ``"generic"``: any other table set of 4 to
64 states (:data:`KERNEL_STATES`), and RSC-8 spans too long for the meet
instance's shared memory; one thread per column. Both take any ``N``,
ragged or not, and any ``Lw >= 1``.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import build

#: Launches of the CUDA kernel in this process (the plain version and
#: calls that raise do not count).
launches = 0

KERNEL_STATES = (4, 8, 16, 32, 64)
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


def kernel_plan(tables, lw: int):
    """The instance a call on the card takes: ``("rsc8", c)``, the meet
    instance at the first columns a CTA ``c`` of :data:`MEET_COLS` whose
    spans and history (``Lw`` x ``c`` x 40 bytes) fit a CTA's shared
    memory, or ``("generic", 0)``."""
    _, _, instance, _ = _host_tables(tables if tables is not None else rsc8_tables())
    if instance == "rsc8":
        for c in MEET_COLS:
            if lw * c * (_MEET_STATES + 2) * 4 <= _MEET_SMEM:
                return "rsc8", c
    return "generic", 0


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
    generic = lib.bcjr_launch
    generic.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int]
                        + [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p])
    generic.restype = ctypes.c_int
    meet = lib.bcjr_rsc8_launch
    meet.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_longlong]
                     + [ctypes.c_int] * 2 + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    meet.restype = ctypes.c_int
    return generic, meet


@functools.lru_cache(maxsize=None)
def _plan(tables, lw: int):
    """``(idx, coef, cls, instance, cols)`` of a call: :func:`_host_tables`
    and :func:`kernel_plan` at once, cached on the call's own arguments (no
    table hashing a call when ``tables`` is None)."""
    idx, coef, _, cls = _host_tables(tables if tables is not None else rsc8_tables())
    s_count = idx.shape[1]
    if s_count not in KERNEL_STATES:
        raise ValueError(
            f"the CUDA BCJR kernel takes {KERNEL_STATES} states, not {s_count}"
        )
    return (idx, coef, cls, *kernel_plan(tables, lw))


def bcjr_windowed_llr(ls, lp, lw: int, tables=None) -> torch.Tensor:
    """Per-position max-log a-posteriori LLRs of ``[Lw, N]`` spans of the
    two LLR streams (``N`` = windows x batch, any count), uniform initial
    metrics at both ends. ``tables``: the trellis as hashable ``(nxt,
    prev_s, fw0, fw1, bw0, bw1)`` tuples, None for the turbo RSC-8 trellis.

    On a CUDA tensor this launches the kernel of ``csrc/bcjr.cu`` on the
    current stream, in the instance :func:`kernel_plan` names (the generic
    one with an ``[Lw, S, N]`` float32 scratch for the beta history); it
    raises on a state count the kernel does not take, a dtype other than
    float32, non-contiguous spans, a missing ``nvcc``, a failed build or a
    failed launch. On a CPU tensor it is :func:`bcjr_windowed_llr_reference`.
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
    idx, coef, cls, instance, cols = _plan(tables, lw)
    n = ls.shape[1]
    out = torch.empty((lw, n), dtype=torch.float32, device=ls.device)
    if n == 0 or lw == 0:
        return out
    if instance == "rsc8":
        _launch_meet(ls, lp, out, lw, cols, cls)
        return out
    scratch = torch.empty((lw, idx.shape[1], n), dtype=torch.float32, device=ls.device)
    _launch(ls, lp, out, lw, idx, coef, scratch)
    return out


def _launch(ls, lp, out, lw: int, idx, coef, scratch) -> None:
    """One launch of the generic instance, counted in :data:`launches`."""
    global launches
    index = ls.get_device()
    rc = _entries()[0](
        ls.data_ptr(), lp.data_ptr(), out.data_ptr(), scratch.data_ptr(),
        lw, ls.shape[1], idx.shape[1], idx.ctypes.data, coef.ctypes.data,
        index, torch._C._cuda_getCurrentRawStream(index),
    )
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
    rc = _entries()[1](a, b, out.data_ptr(), lw, n, cols, vec, cls.ctypes.data, index,
                       torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        raise RuntimeError(f"bcjr kernel launch failed: CUDA error {rc}")
    launches += 1
