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
  :mod:`.build`), one launch per sending card on its stream, with a table
  of that card's pushes, or raises; for CPU shards it runs
  :func:`halo_left_rdma_reference`.
- :func:`halo_left_rdma_reference` is the plain PyTorch version on any
  device: slices, ``Tensor.copy_`` into the neighbour's device, and zeros.
  The kernel copies bytes, so it is bit-identical to it for every dtype.
- :data:`launches` counts the kernel's launches.

The halos of the shards on one card are slices of one receive allocation
made on that card's stream per call (nothing is cached across calls: the
callers keep the halos as state). A launch on the sending card writes them,
also where they lie on another card. Where they do, one event per ordered
pair of cards orders the two streams, the counterparts of the TPU kernel's
semaphores: the sender's stream waits once for an event recorded on the
receiver's stream after the allocation (whatever last used that memory is
done: the send semaphore), and the receiver's stream waits once for an event
recorded on the sender's stream after its launch (the receive semaphore),
so whatever the receiver enqueues next sees the halos. On one card the one
stream orders them already. Two cards without peer access raise and name
``left_tail(..., backend="reference")``.

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

#: Launches of the CUDA kernel in this process, one per sending card and
#: exchange (the plain version and calls that raise do not count).
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
    push.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_longlong] * 3
                     + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    push.restype = ctypes.c_int
    peer = lib.halo_enable_peer
    peer.argtypes = [ctypes.c_int, ctypes.c_int]
    peer.restype = ctypes.c_int
    return push, peer, int(lib.halo_max_pushes())


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


def _copy_unit(ptrs, row_bytes: int, stride_bytes: int, itemsize: int) -> int:
    """16 where every address, the row length and the source row stride are
    16-byte aligned, else the element size."""
    if row_bytes % 16 == 0 and stride_bytes % 16 == 0 and not any(p % 16 for p in ptrs):
        return 16
    return itemsize


@functools.lru_cache(maxsize=256)
def _layout(cards: tuple, shape: tuple, j: int) -> tuple:
    """The exchange's plan for shards (row-major mesh order) on ``cards`` of
    a mesh of ``shape`` exchanging along axis ``j``, made once per layout:
    ``(on_card, slot, senders)``. ``on_card``: ``{card: flat indices of its
    shards}``, whose halos are slices of one allocation; ``slot[i]``:
    ``(card, position)`` of shard ``i``'s halo there; ``senders``: ``[(card,
    [(source index or None for zeros, receiving index), ...], remote
    cards)]``, one launch each (the ring's last shard pushes zeros into the
    first shard's buffer)."""
    coords = list(np.ndindex(*shape))
    flat = {c: i for i, c in enumerate(coords)}
    on_card, slot = {}, []
    for i, card in enumerate(cards):
        idx = on_card.setdefault(card, [])
        slot.append((card, len(idx)))
        idx.append(i)
    senders = []
    for card, idx in on_card.items():
        pushes, remote = [], []
        for i in idx:
            c = coords[i]
            dst = flat[_neighbour(c, j, 1, shape[j])]
            pushes.append((None if c[j] == shape[j] - 1 else i, dst))
            if cards[dst] != card and cards[dst] not in remote:
                remote.append(cards[dst])
        senders.append((card, pushes, remote))
    return on_card, slot, senders


def halo_left_rdma(x, overlap: int, axis_name: str, mesh=None):
    """Left-neighbour tails along ``axis_name``: a :class:`~aether_primitives_tpu_torch.
    parallel.mesh.Sharded` of ``[..., overlap]`` halos, shard ``s`` holding
    shard ``s - 1``'s last ``overlap`` samples and shard 0 zeros, like
    :func:`~aether_primitives_tpu_torch.parallel.halo.left_tail`.

    ``mesh`` (default: the value's own) only validates ``axis_name``, as
    the JAX wrapper's ``mesh_axis_names`` does. On CUDA shards this
    launches the kernel once per sending card; it raises for shards that
    are not contiguous, of differing shape or dtype, or partly on the CPU,
    for a card holding more shards than one launch's table, for cards
    without peer access, a missing ``nvcc``, a failed build or a failed
    launch. On CPU shards it is :func:`halo_left_rdma_reference`. The
    host's work is the floor of an exchange (its bytes take nanoseconds),
    so the plan of each layout is made once (:func:`_layout`).
    """
    global launches
    from ...parallel.mesh import Sharded

    j = _check(x, overlap, axis_name, mesh)
    locals_ = list(x.shards.flat)
    cards = tuple(t.get_device() for t in locals_)
    if min(cards) < 0:
        kinds = {t.device.type for t in locals_}
        if kinds == {"cpu"}:
            return halo_left_rdma_reference(x, overlap, axis_name, mesh)
        raise ValueError(f"halo_left_rdma takes shards on cpu or on cuda, got {sorted(kinds)}")
    first = locals_[0]
    shape, dtype = first.shape, first.dtype
    if not all(t.shape == shape and t.dtype == dtype and t.is_contiguous() for t in locals_):
        if not all(t.shape == shape and t.dtype == dtype for t in locals_):
            raise ValueError("halo_left_rdma takes shards of one shape and dtype")
        raise ValueError("halo_left_rdma takes contiguous shards")
    mesh_shape = x.mesh.devices.shape
    on_card, slot, senders = _layout(cards, mesh_shape, j)
    n_local = shape[-1]
    itemsize = first.element_size()
    rows = first.numel() // n_local if n_local else 0
    row_bytes, stride_bytes = overlap * itemsize, n_local * itemsize
    halo_shape = shape[:-1] + (overlap,)
    halo_bytes = rows * row_bytes
    bufs, halos = {}, [None] * len(locals_)
    for card, idx in on_card.items():  # one receive allocation per card, on its stream
        buf = torch.empty((len(idx),) + halo_shape, dtype=dtype, device=f"cuda:{card}")
        bufs[card] = buf.data_ptr()
        for i, h in zip(idx, buf.unbind(0)):
            halos[i] = h
    out = np.empty(mesh_shape, dtype=object)
    out_flat = out.reshape(-1)
    for i, h in enumerate(halos):
        out_flat[i] = h
    if rows == 0:
        return Sharded(x.mesh, x.spec, out)
    push, _, max_pushes = _entries()
    most = max(len(idx) for idx in on_card.values())
    if most > max_pushes:
        raise ValueError(
            f"halo_left_rdma pushes at most {max_pushes} shards from one card in one launch, "
            f"got {most}"
        )
    tail = (n_local - overlap) * itemsize
    streams, allocated = {}, {}  # Stream objects and allocation events, where cards differ
    for card, pushes, remote in senders:
        srcs = [0 if i is None else locals_[i].data_ptr() + tail for i, _ in pushes]
        dsts = [bufs[slot[d][0]] + slot[d][1] * halo_bytes for _, d in pushes]
        for r in remote:  # the buffers' memory is free of its last use (send semaphore)
            _enable_peer(card, r)
            if r not in allocated:
                streams.setdefault(r, torch.cuda.current_stream(r))
                allocated[r] = streams[r].record_event()
            streams.setdefault(card, torch.cuda.current_stream(card)).wait_event(allocated[r])
        n = len(pushes)
        rc = push(
            (ctypes.c_void_p * n)(*[p or None for p in srcs]), (ctypes.c_void_p * n)(*dsts), n,
            rows, row_bytes, stride_bytes,
            _copy_unit([p for p in srcs if p] + dsts, row_bytes, stride_bytes, itemsize),
            card, torch._C._cuda_getCurrentRawStream(card),
        )
        if rc != 0:
            raise RuntimeError(f"halo kernel launch failed: CUDA error {rc}")
        launches += 1
        if remote:  # the receivers' next work sees the halos (receive semaphore)
            pushed = streams[card].record_event()
            for r in remote:
                streams[r].wait_event(pushed)
    return Sharded(x.mesh, x.spec, out)
