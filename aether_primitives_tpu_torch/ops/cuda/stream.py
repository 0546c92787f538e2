"""Streamed chunk-broadcast complex multiply ``x * tile(r)``.

Port of the TPU kernel ``aether_primitives_tpu/ops/pallas/stream.py``
(``_stream_kernel``, wrapper ``streamed_cmul``): a long block stays in
device memory and streams chunk by chunk past a small resident operand,
the template of a streaming stage whose block is too big for fast memory.

- :func:`streamed_cmul` takes ``x`` as split float32 planes ``[rows,
  lanes]`` and ``r`` as ``[chunk_rows, lanes]`` planes, with ``rows`` a
  multiple of ``chunk_rows``, and returns ``x * tile(r)`` as split planes.
  For CUDA tensors it launches the hand-written kernel of
  ``csrc/stream.cu`` (r kept in registers, x through a two-stage
  ``cp.async`` ring in shared memory; built at first use, see
  :mod:`.build`) or raises; for CPU tensors it runs the plain version.
- :func:`streamed_cmul_reference` is the plain PyTorch version, on any
  device: the broadcast products ``xr*rr - xi*ri`` and ``xr*ri + xi*rr``,
  each op rounded on its own, which the kernel reproduces bit for bit.
- :data:`launches` counts the kernel's launches.

The TPU wrapper's refusal of chunks too big for VMEM is a TPU workaround
and is not ported; the refusal of rows that ``chunk_rows`` does not
divide stays.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

#: Launches of the CUDA kernel in this process (the plain version and
#: calls that raise do not count).
launches = 0


def _check_args(xr, xi, rr, ri, chunk_rows: int):
    """Validate shapes and types; returns ``(rows, lanes)``."""
    for name, t in (("xr", xr), ("xi", xi), ("rr", rr), ("ri", ri)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"streamed_cmul takes torch tensors ({name})")
        if t.dtype != torch.float32:
            raise TypeError(f"streamed_cmul takes float32 planes, got {name} {t.dtype}")
    if xr.ndim != 2 or xr.shape != xi.shape:
        raise ValueError(f"x planes must be one [rows, lanes] shape, got "
                         f"{tuple(xr.shape)} and {tuple(xi.shape)}")
    rows, lanes = xr.shape
    chunk_rows = int(chunk_rows)
    if chunk_rows < 1 or rows % chunk_rows:
        raise ValueError(f"rows {rows} not divisible by chunk_rows {chunk_rows}")
    if rr.shape != (chunk_rows, lanes) or ri.shape != rr.shape:
        raise ValueError(f"r planes must be [chunk_rows, lanes] = [{chunk_rows}, {lanes}], "
                         f"got {tuple(rr.shape)} and {tuple(ri.shape)}")
    return rows, lanes


def streamed_cmul_reference(xr, xi, rr, ri):
    """Plain PyTorch version of :func:`streamed_cmul` (``chunk_rows`` is
    ``rr.shape[0]``), on any device."""
    rows, lanes = xr.shape
    c = rr.shape[0]
    x_re = xr.reshape(rows // c, c, lanes)
    x_im = xi.reshape(rows // c, c, lanes)
    out_re = x_re * rr - x_im * ri
    out_im = x_re * ri + x_im * rr
    return out_re.reshape(rows, lanes), out_im.reshape(rows, lanes)


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.load("stream").stream_launch
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong] + [ctypes.c_int] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def streamed_cmul(xr, xi, rr, ri, chunk_rows: int = 256):
    """``x * tile(r)`` over split planes ``x [rows, lanes]`` and ``r
    [chunk_rows, lanes]``; returns ``(out_re, out_im)``, each ``[rows,
    lanes]``.

    Raises ValueError when ``chunk_rows`` does not divide ``rows``. On CUDA
    tensors it launches the kernel on the current stream; it raises for a
    dtype other than float32, shapes that do not match, tensors on
    different devices or not contiguous, a missing ``nvcc``, a failed build
    or a failed launch. On CPU tensors it is :func:`streamed_cmul_reference`.
    """
    global launches
    rows, lanes = _check_args(xr, xi, rr, ri, chunk_rows)
    dev = xr.device
    if dev.type == "cpu":
        return streamed_cmul_reference(xr, xi, rr, ri)
    if dev.type != "cuda":
        raise ValueError(f"streamed_cmul runs on cpu or cuda, not {dev.type}")
    planes = (xr, xi, rr, ri)
    if any(t.device != dev for t in planes):
        raise ValueError("streamed_cmul takes x and r on one device")
    if not all(t.is_contiguous() for t in planes):
        raise ValueError("streamed_cmul takes contiguous planes")
    out_re = torch.empty((rows, lanes), dtype=torch.float32, device=dev)
    out_im = torch.empty_like(out_re)
    chunk = int(chunk_rows) * lanes
    n_chunks = rows // int(chunk_rows)
    if chunk == 0 or n_chunks == 0:
        return out_re, out_im
    if n_chunks >= 1 << 31:
        raise ValueError(f"{n_chunks} chunks exceed one launch")
    vec = chunk % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in (*planes, out_re, out_im))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _entry()(
            *(t.data_ptr() for t in planes), out_re.data_ptr(), out_im.data_ptr(),
            chunk, n_chunks, int(vec), stream,
        )
    if rc != 0:
        raise RuntimeError(f"stream kernel launch failed: CUDA error {rc}")
    launches += 1
    return out_re, out_im
