"""The polyphase filterbank fold: the weighted overlap-add of the
oversampled PFB analysis (:func:`~aether_primitives_tpu_torch.models.
channelizer.pfb_channelize_os`) and of the synthesis spreads
(``pfb_synthesize_os``, and ``pfb_synthesize`` when asked for).

Port of the TPU kernel ``aether_primitives_tpu/ops/pallas/pfb_fold.py``
(``_fold_kernel``, wrapper ``pfb_fold_os``), on split float32 planes with a
real prototype ``hb [P, M]``. For each class ``j`` of ``os`` (``hop = M /
os``), frame ``t < t_cls`` and column ``r``::

    acc[t, r] = sum_p hb[p, r] * x[..., j*hop + (t + p)*M + r]   (p in order)
    out[..., j, t, c] = acc[t, (c - (j*hop) % M) % M]            (the roll)

- :func:`pfb_fold_os` is the wrapper. For a CUDA tensor it launches the
  hand-written kernel ``csrc/pfb_fold.cu`` (built at first use, see
  :mod:`.build`) or raises; for a CPU tensor it runs
  :func:`pfb_fold_os_reference`.
- :func:`pfb_fold_os_reference` is the plain PyTorch version: P slice
  products added in ``p`` order on the real planes, on any device. (A
  complex-by-real product in torch multiplies by ``w + 0i``, which the
  kernel does not, so the twin stays on planes.)
- :data:`launches` counts the kernel's launches.

Unlike the TPU wrapper, the input need not be padded to whole frame
tiles: it must hold ``(os - 1)*hop + (t_cls - 1 + P)*M`` samples, and the
kernel masks the ragged frame and column edges itself. A leading batch
axis is taken natively (one launch for all rows).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

#: Launches of the CUDA kernel in this process (the plain version and
#: calls that raise do not count).
launches = 0

MAX_SMEM = 232_448  # bytes of shared memory one block may use on an H100
TILE_FRAMES, STRIP = 64, 64  # frames x columns per block (csrc/pfb_fold.cu)
MAX_GRID_YZ = 65_535


def _smem_bytes(p: int) -> int:
    return (2 * (TILE_FRAMES + p) + p) * STRIP * 4


def kernel_supports(m: int, p: int, os: int, batch: int = 1) -> bool:
    """True when the CUDA kernel takes ``batch`` rows of an ``os``-class
    fold with ``M = m`` columns and ``P = p`` branches: the input slab of
    one block (``(64 + P) x 64`` samples of both planes and ``P x 64``
    weights) fits in shared memory (P <= 260), and the grid fits its
    limits (at most 65,535 rows and 65,535 strips of 64 columns)."""
    return (p >= 1 and m >= 1 and os >= 1 and _smem_bytes(p) <= MAX_SMEM
            and -(-m // STRIP) <= MAX_GRID_YZ and batch <= MAX_GRID_YZ)


def _check_args(x_re, x_im, hb, os: int, t_cls: int):
    """Validate shapes and types; returns ``(p, m, hop)``."""
    for name, t in (("x_re", x_re), ("x_im", x_im), ("hb", hb)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"pfb_fold_os takes torch tensors ({name})")
        if t.dtype != torch.float32:
            raise TypeError(f"pfb_fold_os takes float32 planes, got {name} {t.dtype}")
    if x_re.shape != x_im.shape or x_re.ndim < 1:
        raise ValueError(f"x_re {tuple(x_re.shape)} and x_im {tuple(x_im.shape)} "
                         "must be equal shapes [..., n]")
    if hb.ndim != 2:
        raise ValueError(f"hb must be [P, M], got {tuple(hb.shape)}")
    p, m = hb.shape
    os = int(os)
    if os < 1 or m % os:
        raise ValueError(f"os must divide M ({m} % {os})")
    if int(t_cls) < 1:
        raise ValueError(f"t_cls must be >= 1, got {t_cls}")
    hop = m // os
    need = (os - 1) * hop + (int(t_cls) - 1 + p) * m
    if x_re.shape[-1] < need:
        raise ValueError(f"input too short: {x_re.shape[-1]} < {need} samples "
                         f"((os-1)*hop + (t_cls-1+P)*M)")
    return p, m, hop


def pfb_fold_os_reference(x_re, x_im, hb, os: int, t_cls: int):
    """Plain PyTorch version of :func:`pfb_fold_os` (same arguments, same
    output), on any device: per class, ``P`` slice products of the
    ``[t_cls - 1 + P, M]`` frame view added in ``p`` order, then the roll."""
    p, m, hop = _check_args(x_re, x_im, hb, os, t_cls)
    t_cls = int(t_cls)
    batch = tuple(x_re.shape[:-1])
    span = (t_cls - 1 + p) * m
    outs = []
    for plane in (x_re, x_im):
        classes = []
        for j in range(int(os)):
            fr = plane[..., j * hop:j * hop + span].reshape(batch + (t_cls - 1 + p, m))
            acc = fr[..., 0:t_cls, :] * hb[0]
            for q in range(1, p):
                acc = acc + fr[..., q:q + t_cls, :] * hb[q]
            a = (j * hop) % m
            classes.append(torch.roll(acc, a, dims=-1) if a else acc)
        outs.append(torch.stack(classes, dim=-3))
    return outs[0], outs[1]


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.load("pfb_fold").pfb_fold_launch
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def pfb_fold_os(x_re, x_im, hb, os: int, t_cls: int):
    """Fold split planes ``x_re, x_im [..., n]`` with the real prototype
    branches ``hb [P, M]`` into ``(out_re, out_im)``, each ``[..., os,
    t_cls, M]``: class ``j`` holds frames ``t = i*os + j`` of the
    oversampled bank with its reference roll applied (the module docstring
    gives the formula).

    On a CUDA tensor this launches the kernel of ``csrc/pfb_fold.cu`` on the
    current stream; it raises for an input too short (fewer than
    ``(os-1)*hop + (t_cls-1+P)*M`` samples), a dtype other than float32,
    planes that are not contiguous, tensors on different devices, a shape
    the kernel does not take (:func:`kernel_supports`), a missing ``nvcc``,
    a failed build or a failed launch. On a CPU tensor it is
    :func:`pfb_fold_os_reference`.
    """
    global launches
    p, m, hop = _check_args(x_re, x_im, hb, os, t_cls)
    dev = x_re.device
    if dev.type == "cpu":
        return pfb_fold_os_reference(x_re, x_im, hb, os, t_cls)
    if dev.type != "cuda":
        raise ValueError(f"pfb_fold_os runs on cpu or cuda, not {dev.type}")
    if x_im.device != dev or hb.device != dev:
        raise ValueError("pfb_fold_os takes x_re, x_im and hb on one device")
    if not (x_re.is_contiguous() and x_im.is_contiguous() and hb.is_contiguous()):
        raise ValueError("pfb_fold_os takes contiguous planes and branches")
    os, t_cls = int(os), int(t_cls)
    batch = tuple(x_re.shape[:-1])
    rows = 1
    for d in batch:
        rows *= int(d)
    if not kernel_supports(m, p, os, rows):
        raise ValueError(
            f"the CUDA PFB fold kernel does not take M={m}, P={p}, os={os} over "
            f"{rows} rows (see kernel_supports: P <= 260, rows <= 65535)"
        )
    out_re = torch.empty(batch + (os, t_cls, m), dtype=torch.float32, device=dev)
    out_im = torch.empty_like(out_re)
    if rows == 0:
        return out_re, out_im
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _entry()(
            x_re.data_ptr(), x_im.data_ptr(), x_re.shape[-1], hb.data_ptr(),
            out_re.data_ptr(), out_im.data_ptr(), rows, m, p, os, hop, t_cls, stream,
        )
    if rc != 0:
        raise RuntimeError(f"pfb_fold kernel launch failed: CUDA error {rc}")
    launches += 1
    return out_re, out_im
