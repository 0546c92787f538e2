"""The left-halo exchange between shards as a peer-push kernel.

Port of the TPU kernel ``aether_primitives_tpu/ops/pallas/halo_rdma.py``
(``_halo_kernel``, wrapper ``halo_left_rdma``): along one mesh axis every
shard pushes the last ``overlap`` samples of its last tensor axis into its
right neighbour's receive buffer, and the first shard's buffer ends as
zeros (the causal initial state). It is a drop-in for the plain exchange of
:func:`~aether_primitives_tpu_torch.parallel.halo.left_tail`, which takes
it for CUDA shards.

- :func:`halo_left_rdma` takes a :class:`~aether_primitives_tpu_torch.
  parallel.mesh.Sharded` value and returns the per-shard halos ``[...,
  overlap]``, each on its own shard's device. For CUDA shards it launches
  the hand-written kernel of ``csrc/halo.cu`` (built at first use, see
  :mod:`.build`), one launch per sending shard on the sender's device and
  stream, or raises; for CPU shards it runs :func:`halo_left_rdma_reference`.
- :func:`halo_left_rdma_reference` is the plain PyTorch version on any
  device: slices, ``Tensor.copy_`` into the neighbour's device, and zeros.
  The kernel copies bytes, so it is bit-identical to it for every dtype.
- :data:`launches` counts the kernel's launches.

The receive buffer lives on the receiver's device and is written by a
kernel on the sender's stream. Where the two lie on different cards, two
events order their streams, the counterparts of the TPU kernel's
semaphores: the sender's stream waits for an event recorded on the
receiver's stream after the buffer was allocated there (whatever last used
that memory is done: the send semaphore), and the receiver's stream waits
for an event recorded on the sender's stream after the push (the receive
semaphore), so whatever the receiver enqueues next sees the halo. On one
card sender and receiver share one stream, which orders them already. Two cards without peer access raise
and name ``left_tail(..., backend="reference")``.

Unlike the TPU kernel, the last shard pushes zeros into the first shard's
buffer instead of its tail (``csrc/halo.cu`` says why). Meshes of any rank
work: each ring along the exchanged axis is independent, the other
coordinates are the sender's own.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import build

#: Launches of the CUDA kernel in this process, one per sending shard (the
#: plain version and calls that raise do not count).
launches = 0


def _check(x, overlap: int, axis_name: str, mesh) -> int:
    """The position of ``axis_name`` in the mesh; the JAX wrappers' checks."""
    names = (mesh if mesh is not None else x.mesh).axis_names
    if axis_name not in names:
        raise ValueError(f"axis {axis_name!r} not in mesh axes {tuple(names)}")
    j = x.mesh.axis(axis_name)
    span = x.shards.flat[0].shape[-1]
    if overlap > span:
        raise ValueError(
            f"halo overlap {overlap} exceeds the per-device span "
            f"{span}: the exchange reaches only ONE neighbor — "
            "use fewer shards or a longer capture"
        )
    if overlap < 1:
        raise ValueError(f"halo overlap must be >= 1, got {overlap}")
    return j


def _neighbour(coord, j: int, step: int, size: int):
    c = list(coord)
    c[j] = (c[j] + step) % size
    return tuple(c)


def halo_left_rdma_reference(x, overlap: int, axis_name: str, mesh=None):
    """Plain PyTorch version of :func:`halo_left_rdma` (same arguments and
    output), on any devices: shard ``s > 0`` gets a copy of shard ``s - 1``'s
    last ``overlap`` samples on its own device, shard 0 zeros."""
    from ...parallel.mesh import Sharded

    j = _check(x, overlap, axis_name, mesh)
    size = x.mesh.devices.shape[j]
    out = np.empty(x.mesh.devices.shape, dtype=object)
    for c in x.mesh.coords():
        mine = x.shards[c]
        shape = mine.shape[:-1] + (overlap,)
        if c[j] == 0:
            out[c] = torch.zeros(shape, dtype=mine.dtype, device=mine.device)
        else:
            left = x.shards[_neighbour(c, j, -1, size)]
            buf = torch.empty(shape, dtype=mine.dtype, device=mine.device)
            out[c] = buf.copy_(left[..., left.shape[-1] - overlap:])
    return Sharded(x.mesh, x.spec, out)


@functools.lru_cache(maxsize=None)
def _entries():
    lib = build.load("halo")
    push = lib.halo_push_launch
    push.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 3
                     + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    push.restype = ctypes.c_int
    peer = lib.halo_enable_peer
    peer.argtypes = [ctypes.c_int, ctypes.c_int]
    peer.restype = ctypes.c_int
    return push, peer


@functools.lru_cache(maxsize=None)
def _enable_peer(sender: int, receiver: int) -> None:
    """Peer access for kernels on card ``sender`` into card ``receiver``,
    enabled once per ordered pair; raises where the pair has none."""
    rc = _entries()[1](sender, receiver)
    if rc == -1:
        raise RuntimeError(
            f"cuda:{sender} has no peer access to cuda:{receiver}: the halo kernel "
            "cannot push between them; use left_tail(..., backend=\"reference\")"
        )
    if rc != 0:
        raise RuntimeError(
            f"enabling peer access cuda:{sender} -> cuda:{receiver} failed: CUDA error {rc}"
        )


def _copy_unit(src_ptr: int, dst_ptr: int, row_bytes: int, stride_bytes: int,
               itemsize: int) -> int:
    """16 where both addresses, the row length and the source row stride
    are 16-byte aligned, else the element size."""
    if all(v % 16 == 0 for v in (src_ptr, dst_ptr, row_bytes, stride_bytes)):
        return 16
    return itemsize


def halo_left_rdma(x, overlap: int, axis_name: str, mesh=None):
    """Left-neighbour tails along ``axis_name``: a :class:`~aether_primitives_tpu_torch.
    parallel.mesh.Sharded` of ``[..., overlap]`` halos, shard ``s`` holding
    shard ``s - 1``'s last ``overlap`` samples and shard 0 zeros, like
    :func:`~aether_primitives_tpu_torch.parallel.halo.left_tail`.

    ``mesh`` (default: the value's own) only validates ``axis_name``, as
    the JAX wrapper's ``mesh_axis_names`` does. On CUDA shards this
    launches the kernel once per sending shard; it raises for shards that
    are not contiguous, of differing shape or dtype, or partly on the CPU,
    for cards without peer access, a missing ``nvcc``, a failed build or a
    failed launch. On CPU shards it is :func:`halo_left_rdma_reference`.
    """
    global launches
    from ...parallel.mesh import Sharded

    j = _check(x, overlap, axis_name, mesh)
    locals_ = list(x.shards.flat)
    kinds = {t.device.type for t in locals_}
    if kinds == {"cpu"}:
        return halo_left_rdma_reference(x, overlap, axis_name, mesh)
    if kinds != {"cuda"}:
        raise ValueError(f"halo_left_rdma takes shards on cpu or on cuda, got {sorted(kinds)}")
    first = locals_[0]
    if any(t.shape != first.shape or t.dtype != first.dtype for t in locals_):
        raise ValueError("halo_left_rdma takes shards of one shape and dtype")
    if not all(t.is_contiguous() for t in locals_):
        raise ValueError("halo_left_rdma takes contiguous shards")
    size = x.mesh.devices.shape[j]
    n_local = first.shape[-1]
    itemsize = first.element_size()
    rows = first.numel() // n_local if n_local else 0
    row_bytes, stride_bytes = overlap * itemsize, n_local * itemsize
    shape = first.shape[:-1] + (overlap,)
    out = np.empty(x.mesh.devices.shape, dtype=object)
    for c in x.mesh.coords():  # every receive buffer, on its receiver's stream
        out[c] = torch.empty(shape, dtype=first.dtype, device=x.shards[c].device)
    if rows == 0:
        return Sharded(x.mesh, x.spec, out)
    push = _entries()[0]
    streams = {}  # each card's current stream, looked up once per call
    for t in locals_:
        if t.device not in streams:
            streams[t.device] = torch.cuda.current_stream(t.device)
    for c in x.mesh.coords():
        src, dst = x.shards[c], out[_neighbour(c, j, 1, size)]
        send_stream, recv_stream = streams[src.device], streams[dst.device]
        remote = src.device != dst.device  # one card: one stream, already in order
        if remote:
            _enable_peer(src.device.index, dst.device.index)
            # the buffer's memory is free of its last use (send semaphore)
            send_stream.wait_event(recv_stream.record_event())
        src_ptr = src.data_ptr() + (n_local - overlap) * itemsize
        dst_ptr = dst.data_ptr()
        rc = push(
            src_ptr, dst_ptr, rows, row_bytes, stride_bytes,
            _copy_unit(src_ptr, dst_ptr, row_bytes, stride_bytes, itemsize),
            int(c[j] == size - 1), src.device.index, send_stream.cuda_stream,
        )
        if rc != 0:
            raise RuntimeError(f"halo kernel launch failed: CUDA error {rc}")
        launches += 1
        if remote:  # the receiver's next work sees the halo (receive semaphore)
            recv_stream.wait_event(send_stream.record_event())
    return Sharded(x.mesh, x.spec, out)
