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

The kernel's limits (:func:`kernel_supports`): ``2^(K-1)`` from 4 to 256
states, 1 to 8 generators, and a decision history of ``Lw * max(1, S/32) *
4`` bytes per trellis within one block's shared memory (7,264 steps at 64
states with 4 trellises per block, 29,058 steps with one). A longer block
is the windowed decoder's work (``viterbi_decode(..., window=...)``).
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

MAX_SMEM = 232_448  # bytes of shared memory one block may use on an H100
MAX_STATES = 256
MAX_GENERATORS = 8
_WARPS = (4, 2, 1)  # trellises per block, the first that fits


def _tables(polys, k: int):
    from ..fec import _trellis  # the trellis tables live with the decoder

    return _trellis(tuple(int(p) for p in polys), int(k))


def _warps_per_block(lw: int, k: int):
    words = max(1, (1 << (k - 1)) // 32)
    for w in _WARPS:
        if w * lw * words * 4 <= MAX_SMEM:
            return w
    return None


def kernel_supports(lw: int, n: int, constraint: int) -> bool:
    """True when the CUDA kernel takes spans of ``lw`` steps for a code of
    ``n`` generators and constraint length ``constraint``."""
    s_count = 1 << (int(constraint) - 1)
    return (4 <= s_count <= MAX_STATES and 1 <= n <= MAX_GENERATORS and lw >= 1
            and _warps_per_block(lw, int(constraint)) is not None)


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
def _out_masks(polys, k: int) -> np.ndarray:
    """uint8 ``[2 S]``: bit m of entry ``2 s' + j`` is the encoder output
    ``o_m`` of the transition into ``s'`` from predecessor ``j``."""
    _, outs = _tables(polys, k)
    weights = (1 << np.arange(outs.shape[-1])).astype(np.int64)
    return np.ascontiguousarray((outs.astype(np.int64) * weights).sum(-1)
                                .reshape(-1).astype(np.uint8))


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.load("viterbi").viterbi_launch
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong]
                   + [ctypes.c_int] * 6 + [ctypes.c_void_p, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def viterbi_lanes(sym, lw: int, n: int, polys, constraint: int,
                  init_state0: bool, end_state0: bool) -> torch.Tensor:
    """Decode ``sym [N, Lw, n]`` float32 LLR spans, one independent trellis
    per row, to uint8 bits ``[N, Lw]`` (bit t = the survivor state's input
    bit at step t).

    On a CUDA tensor this launches the kernel of ``csrc/viterbi.cu`` on the
    current stream; it raises on spans the kernel does not take
    (:func:`kernel_supports`: too long a block names the windowed decoder),
    a dtype other than float32, a non-contiguous tensor, a missing
    ``nvcc``, a failed build or a failed launch. On a CPU tensor it is
    :func:`viterbi_lanes_reference`.
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
    if not kernel_supports(lw, n, k):
        raise ValueError(
            f"the CUDA Viterbi kernel does not take {lw}-step spans of a K={k} "
            f"code with {n} generators (see kernel_supports); decode long "
            "blocks with the windowed decoder, viterbi_decode(..., window=64)"
        )
    n_tr = sym.shape[0]
    bits = torch.empty((n_tr, lw), dtype=torch.uint8, device=sym.device)
    if n_tr == 0:
        return bits
    masks = _out_masks(polys, k)
    with torch.cuda.device(sym.device):
        stream = torch.cuda.current_stream(sym.device).cuda_stream
        rc = _entry()(
            sym.data_ptr(), bits.data_ptr(), n_tr, lw, n, 1 << (k - 1),
            int(bool(init_state0)), int(bool(end_state0)), _warps_per_block(lw, k),
            masks.ctypes.data, stream,
        )
    if rc != 0:
        raise RuntimeError(f"viterbi kernel launch failed: CUDA error {rc}")
    launches += 1
    return bits
