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

The kernel takes 4 to 64 states (:data:`KERNEL_STATES`) and any ``N``,
ragged or not: each column is one thread, masked at the edge.
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
def _host_tables(tables):
    """int32 ``[nxt; prev_s]`` ``[2, S, 2]`` and float32 ``[fw0; fw1; bw0;
    bw1]`` ``[4, S, 2]`` host arrays of hashable tables."""
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
    return idx, coef


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
    idx, coef = _host_tables(tables if tables is not None else rsc8_tables())
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
def _entry():
    fn = build.load("bcjr").bcjr_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int]
                   + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    return fn


def bcjr_windowed_llr(ls, lp, lw: int, tables=None) -> torch.Tensor:
    """Per-position max-log a-posteriori LLRs of ``[Lw, N]`` spans of the
    two LLR streams (``N`` = windows x batch, any count), uniform initial
    metrics at both ends. ``tables``: the trellis as hashable ``(nxt,
    prev_s, fw0, fw1, bw0, bw1)`` tuples, None for the turbo RSC-8 trellis.

    On a CUDA tensor this launches the kernel of ``csrc/bcjr.cu`` on the
    current stream, with an ``[Lw, S, N]`` float32 scratch for the beta
    history; it raises on a state count the kernel does not take, a dtype
    other than float32, non-contiguous spans, a missing ``nvcc``, a failed
    build or a failed launch. On a CPU tensor it is
    :func:`bcjr_windowed_llr_reference`.
    """
    global launches
    _check_args(ls, lp, lw)
    if ls.device.type == "cpu":
        return bcjr_windowed_llr_reference(ls, lp, lw, tables)
    if ls.device.type != "cuda":
        raise ValueError(f"bcjr_windowed_llr runs on cpu or cuda, not {ls.device.type}")
    if not (ls.is_contiguous() and lp.is_contiguous()):
        raise ValueError("bcjr_windowed_llr takes contiguous spans")
    idx, coef = _host_tables(tables if tables is not None else rsc8_tables())
    s_count = idx.shape[1]
    if s_count not in KERNEL_STATES:
        raise ValueError(
            f"the CUDA BCJR kernel takes {KERNEL_STATES} states, not {s_count}"
        )
    n = ls.shape[1]
    out = torch.empty((lw, n), dtype=torch.float32, device=ls.device)
    if n == 0 or lw == 0:
        return out
    scratch = torch.empty((lw, s_count, n), dtype=torch.float32, device=ls.device)
    with torch.cuda.device(ls.device):
        stream = torch.cuda.current_stream(ls.device).cuda_stream
        rc = _entry()(
            ls.data_ptr(), lp.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            lw, n, s_count, idx.ctypes.data, coef.ctypes.data, stream,
        )
    if rc != 0:
        raise RuntimeError(f"bcjr kernel launch failed: CUDA error {rc}")
    launches += 1
    return out
