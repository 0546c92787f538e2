"""Streamed chunk-broadcast complex multiply ``x * tile(r)``.

Port of the TPU kernel ``aether_primitives_tpu/ops/pallas/stream.py``
(``_stream_kernel``, wrapper ``streamed_cmul``): a long block stays in
device memory and streams chunk by chunk past a small resident operand,
the template of a streaming stage whose block is too big for fast memory.

- :func:`streamed_cmul` takes ``x`` as split float32 planes ``[rows,
  lanes]`` and ``r`` as ``[chunk_rows, lanes]`` planes, with ``rows`` a
  multiple of ``chunk_rows``, and returns ``x * tile(r)`` as split planes.
  For CUDA tensors it launches the hand-written kernel of
  ``csrc/stream.cu`` (a grid of position tiles x chunk groups, r kept in
  registers, x through a ``cp.async`` ring in shared memory, streaming
  stores; built at first use, see :mod:`.build`) or raises; for CPU
  tensors it runs the plain version.
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

#: The kernel's launch shape: ring ``stages`` (2-4), 16-byte copies per
#: plane a thread a stage (``unroll`` 1, 2 or 4) and the CTAs per SM the
#: chunk groups aim at; chosen by ``benches/torch_stream_sweep.py`` on an
#: H100 at x [2048, 2048], chunk_rows 128 (every shape it tried came within
#: 4% of the fastest, ``PERF.md``).
STAGES, UNROLL, CTAS_PER_SM = 4, 2, 2
_THREADS = 256  # kThreads in csrc/stream.cu
_SCALAR_UNROLL = 4  # kScalarUnroll: the scalar instance's copies per plane a stage


def _check_args(xr, xi, rr, ri, chunk_rows: int):
    """Validate shapes and types; returns ``(rows, lanes)``. Kept lean: on
    the card its host time is the floor of a call."""
    f32 = torch.float32
    if not (isinstance(xr, torch.Tensor) and isinstance(xi, torch.Tensor)
            and isinstance(rr, torch.Tensor) and isinstance(ri, torch.Tensor)
            and xr.dtype is f32 and xi.dtype is f32 and rr.dtype is f32 and ri.dtype is f32):
        for name, t in zip(("xr", "xi", "rr", "ri"), (xr, xi, rr, ri)):
            if not isinstance(t, torch.Tensor):
                raise TypeError(f"streamed_cmul takes torch tensors ({name})")
            if t.dtype != f32:
                raise TypeError(f"streamed_cmul takes float32 planes, got {name} {t.dtype}")
    shape = xr.shape
    if len(shape) != 2 or xi.shape != shape:
        raise ValueError(f"x planes must be one [rows, lanes] shape, got "
                         f"{tuple(xr.shape)} and {tuple(xi.shape)}")
    rows, lanes = shape
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
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def chunks_per_cta(chunk: int, n_chunks: int, sm_count: int, vec: bool,
                   unroll: int = UNROLL, ctas_per_sm: int = CTAS_PER_SM) -> int:
    """Consecutive chunks one CTA walks: the chunk groups are as many as
    bring the grid (position tiles x groups) to ``ctas_per_sm`` CTAs on
    each of ``sm_count`` SMs, at most one group per chunk and at most
    65,535 groups."""
    tile = _THREADS * (4 * unroll if vec else _SCALAR_UNROLL)
    tiles = -(-chunk // tile)
    groups = max(1, min(n_chunks, -(-ctas_per_sm * sm_count // tiles)))
    per = -(-n_chunks // groups)
    return max(per, -(-n_chunks // 65535))


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.load("stream").stream_launch
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong] + [ctypes.c_int] * 6
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
    rows, lanes = _check_args(xr, xi, rr, ri, chunk_rows)
    index = xr.get_device()
    if index < 0:
        if xr.device.type == "cpu":
            return streamed_cmul_reference(xr, xi, rr, ri)
        raise ValueError(f"streamed_cmul runs on cpu or cuda, not {xr.device.type}")
    if not (xi.get_device() == index and rr.get_device() == index
            and ri.get_device() == index):
        raise ValueError("streamed_cmul takes x and r on one device")
    if not (xr.is_contiguous() and xi.is_contiguous() and rr.is_contiguous()
            and ri.is_contiguous()):
        raise ValueError("streamed_cmul takes contiguous planes")
    out_re = torch.empty_like(xr)
    out_im = torch.empty_like(xr)
    chunk = int(chunk_rows) * lanes
    n_chunks = rows // int(chunk_rows)
    if chunk == 0 or n_chunks == 0:
        return out_re, out_im
    if n_chunks >= 1 << 31:
        raise ValueError(f"{n_chunks} chunks exceed one launch")
    ptrs = (xr.data_ptr(), xi.data_ptr(), rr.data_ptr(), ri.data_ptr(), out_re.data_ptr(),
            out_im.data_ptr())
    vec = chunk % 4 == 0 and not any(p % 16 for p in ptrs)
    _launch(ptrs, index, chunk, n_chunks, vec, STAGES, UNROLL, CTAS_PER_SM)
    return out_re, out_im


def _launch(ptrs, device: int, chunk: int, n_chunks: int, vec: bool, stages: int,
            unroll: int, ctas_per_sm: int) -> None:
    """One launch of the kernel on card ``device``'s current stream over the
    planes at ``ptrs`` (``xr, xi, rr, ri, out_re, out_im``) at a given ring
    depth, unroll and CTAs per SM (:func:`streamed_cmul` passes the
    module's choice; the sweep bench passes its own), counted in
    :data:`launches`. The C entry makes ``device`` current for the launch
    itself: the wrapper's host time is the floor of a 16 MB call."""
    global launches
    per = chunks_per_cta(chunk, n_chunks, _sm_count(device), vec, unroll, ctas_per_sm)
    rc = _entry()(*ptrs, chunk, n_chunks, per, int(vec), unroll, stages, device,
                  torch._C._cuda_getCurrentRawStream(device))
    if rc != 0:
        raise RuntimeError(f"stream kernel launch failed: CUDA error {rc}")
    launches += 1
