"""Overlap-save halo exchange between the shards of a mesh (PyTorch).

Counterpart of ``aether_primitives_tpu/parallel/halo.py``: when a long
capture is sharded into contiguous time blocks across the mesh, FIR and
correlation at block boundaries need each shard to see the last ``K-1``
samples of its **left** (earlier-time) neighbour. The first shard receives
zeros: exactly the zero initial filter state of the causal convention.

Every function takes and returns whole :class:`~aether_primitives_tpu_torch.
parallel.mesh.Sharded` values (the JAX functions run inside ``shard_map``;
here the exchange sees all shards at once). :func:`left_tail` on CUDA
shards goes through the hand-written peer-push kernel
(:func:`~aether_primitives_tpu_torch.ops.cuda.halo.halo_left_rdma`), so the
kernel is on every left-halo path; on CPU shards, or with
``backend="reference"``, it is the kernel's plain version.
:func:`right_head` is plain peer copies: the JAX package computes it with
``ppermute`` outside any kernel, and the TPU kernel pushes left tails only.

On a mesh that spans processes each process exchanges its own shards as
above (its coordinates form a box of the mesh), and the one edge a box has
along the axis on each side crosses to the neighbouring rank through
``torch.distributed`` ``isend`` / ``irecv``: CUDA tensors themselves with
the ``nccl`` backend, and with ``gloo`` a host copy of the edge (the
backend the caller chose; gloo sends host tensors). Complex edges travel
as their float32 ``view_as_real``. :func:`take_from` moves any piece of
one shard to other coordinates the same way (a streaming step's carried
state). A mesh that spans processes in a process that has joined no
process group raises RuntimeError (:func:`~aether_primitives_tpu_torch.
parallel.mesh.process_group`).

Use :func:`sharded_fir` for the sharded FIR, or :func:`halo_left` in your
own sharded stages.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops import fir as _fir
from ..ops.cuda import halo as _halo_kernel
from ..types import cf32
from .mesh import TIME_AXIS, Mesh, Sharded, _wire, process_group, shard_last

#: "auto": the peer-push kernel for CUDA shards and its plain version for
#: CPU shards; "reference": the plain version on any device.
BACKENDS = ("auto", "reference")


def left_tail(x: Sharded, overlap: int, axis_name: str = TIME_AXIS,
              backend: str = "auto") -> Sharded:
    """The left neighbour's trailing ``overlap`` samples along mesh axis
    ``axis_name`` (zeros on the first shard): a :class:`Sharded` of
    ``[..., overlap]`` halos, each on its shard's device."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (expected one of {BACKENDS})")
    if x.mesh.spans_processes:
        inner = left_tail(x.local_view(), overlap, axis_name, backend)
        return _across_ranks(x, inner, overlap, axis_name, step=-1)
    if backend == "reference":
        return _halo_kernel.halo_left_rdma_reference(x, overlap, axis_name)
    return _halo_kernel.halo_left_rdma(x, overlap, axis_name)


def right_head(x: Sharded, overlap: int, axis_name: str = TIME_AXIS) -> Sharded:
    """The RIGHT neighbour's leading ``overlap`` samples (zeros on the last
    shard): the halo for FORWARD-looking windows (the oversampled PFB's
    frames), dual of :func:`left_tail`. Plain copies between devices."""
    if x.mesh.spans_processes:
        inner = right_head(x.local_view(), overlap, axis_name)
        return _across_ranks(x, inner, overlap, axis_name, step=1)
    j = x.mesh.axis(axis_name)
    size = x.mesh.devices.shape[j]
    span = x.shards.flat[0].shape[-1]
    if overlap > span:
        raise ValueError(
            f"halo overlap {overlap} exceeds the per-device span "
            f"{span}: the exchange reaches only ONE neighbor — "
            "use fewer shards or a longer capture"
        )
    out = np.empty(x.mesh.devices.shape, dtype=object)
    for c in x.mesh.coords():
        mine = x.shards[c]
        shape = mine.shape[:-1] + (overlap,)
        if c[j] == size - 1:
            out[c] = torch.zeros(shape, dtype=mine.dtype, device=mine.device)
        else:
            right = x.shards[c[:j] + (c[j] + 1,) + c[j + 1:]]
            buf = torch.empty(shape, dtype=mine.dtype, device=mine.device)
            out[c] = buf.copy_(right[..., :overlap])
    return Sharded(x.mesh, x.spec, out)


def _send_recv(x: Sharded, pairs, piece) -> dict:
    """The pieces that cross ranks along ``pairs``, ``(taker, source)``
    coordinates in one order on every rank: a rank sends ``piece`` of its
    source shard once to each other rank that takes it, and gets the pieces
    it takes keyed by source (host tensors under gloo, on the first taker's
    device under nccl). Every rank posts its sends and receives in the
    pairs' order, so each pair of ranks matches them in the same order
    (NCCL matches by order, gloo by tag: the source's flat index)."""
    mesh = x.mesh
    dist = process_group(mesh)
    on_card = dist.get_backend() == "nccl"
    like = piece(x._first())
    works, keep, arrived, seen = [], [], {}, set()
    for c, src in pairs:
        sender, receiver = int(mesh.ranks[src]), int(mesh.ranks[c])
        if sender == receiver or (src, receiver) in seen:
            continue
        seen.add((src, receiver))
        tag = int(np.ravel_multi_index(src, mesh.devices.shape))
        if sender == mesh.rank:
            t = piece(x.shards[src])
            t = t.contiguous() if on_card else t.to("cpu").contiguous()
            keep.append(t)
            works.append(dist.isend(_wire(t), receiver, tag=tag))
        elif receiver == mesh.rank:
            buf = torch.empty(like.shape, dtype=like.dtype,
                              device=mesh.devices[c] if on_card else "cpu")
            works.append(dist.irecv(_wire(buf), sender, tag=tag))
            arrived[src] = buf
    for w in works:
        w.wait()
    return arrived


def _across_ranks(x: Sharded, inner: Sharded, overlap: int, axis_name: str,
                  step: int) -> Sharded:
    """The halos of ``inner`` (this process's exchange on its own box, the
    box's edge shards holding zeros) placed on ``x``'s mesh, with the edges
    whose neighbour (``step`` -1: left, +1: right, along ``axis_name``) is
    another rank's received from that rank, and this rank's own edges sent
    (:func:`_send_recv`)."""
    mesh = x.mesh
    j = mesh.axis(axis_name)
    size = mesh.devices.shape[j]
    pairs = [(c, c[:j] + (c[j] + step,) + c[j + 1:]) for c in mesh.coords()
             if 0 <= c[j] + step < size]
    if step < 0:
        arrived = _send_recv(x, pairs, lambda t: t[..., t.shape[-1] - overlap:])
    else:
        arrived = _send_recv(x, pairs, lambda t: t[..., :overlap])
    out = np.full(mesh.devices.shape, None, dtype=object)
    out[mesh.local_box()] = inner.shards
    for c, src in pairs:
        if src in arrived and mesh.ranks[c] == mesh.rank:
            out[c] = arrived[src].to(mesh.devices[c])
    return Sharded(mesh, x.spec, out)


def take_from(x: Sharded, source, piece, spec=None) -> Sharded:
    """A value on ``x``'s mesh (laid out by ``spec``, default ``x``'s)
    whose every coordinate ``c`` of this process holds a copy of
    ``piece(shard)`` of the shard at coordinate ``source(c)``, on ``c``'s
    device: one copy per (source, device). Where the source is another
    rank's, that rank sends its piece once to each rank that takes it
    (:func:`_send_recv`). E.g. a streaming step's carried state: every
    coordinate of a channel row takes the tail of the row's last time
    shard."""
    mesh = x.mesh
    pairs = [(c, source(c)) for c in mesh.coords()]
    arrived = _send_recv(x, pairs, piece) if mesh.spans_processes else {}
    out = np.full(mesh.devices.shape, None, dtype=object)
    placed = {}
    for c in mesh.local_coords():
        src, dev = source(c), mesh.devices[c]
        if (src, dev) not in placed:
            t = arrived[src] if src in arrived else piece(x.shards[src])
            placed[src, dev] = torch.empty(t.shape, dtype=t.dtype, device=dev).copy_(t)
        out[c] = placed[src, dev]
    return Sharded(mesh, x.spec if spec is None else spec, out)


def halo_left(x: Sharded, overlap: int, axis_name: str = TIME_AXIS,
              backend: str = "auto") -> Sharded:
    """Prepend the left neighbour's trailing ``overlap`` samples (zeros on
    the first shard): shards of ``[..., overlap + n_local]``."""
    if overlap <= 0:
        return x
    halo = left_tail(x, overlap, axis_name, backend)
    return x.map(lambda xl, hl: torch.cat([hl, xl], dim=-1), halo)


def sharded_fir(x, taps, mesh: Mesh, axis_name: str = TIME_AXIS, use_os: bool = False,
                block_len: Optional[int] = None) -> Sharded:
    """Continuous causal FIR over a time-sharded capture.

    ``x``: ``[..., n]`` with ``n`` divisible by the mesh axis size (a
    tensor or array-like, split here over ``axis_name`` on its last axis,
    or a :class:`Sharded` laid out so). Equal (to rounding) to
    :func:`~aether_primitives_tpu_torch.ops.fir.fir_filter` on the
    gathered signal: the halo exchange supplies the true cross-shard
    history. Returns the :class:`Sharded` result; ``.gather()`` it.
    """
    taps = np.asarray(taps, dtype=np.complex64)
    xs = shard_last(x, mesh, axis_name, dtype=cf32)
    k = taps.shape[-1]
    if use_os:
        # the halo becomes overlap-save's external history: the local
        # length stays divisible by block_len
        h = left_tail(xs, k - 1, axis_name) if k > 1 else None
        return xs.map(lambda xl, hl: _fir.fir_filter_os(xl, taps, block_len=block_len,
                                                        history=hl), h)
    ext = halo_left(xs, k - 1, axis_name)
    return ext.map(lambda el: _fir.fir_filter(el, taps)[..., k - 1:])
