"""Device-mesh helpers and the sharded value (PyTorch).

Counterpart of ``aether_primitives_tpu/parallel/mesh.py`` and of what
``jax.shard_map`` and ``jax.device_put`` do for the sharded entry points.
In one process a :class:`Mesh` is a **list of torch devices**, reshaped to
named axes. A device may appear more than once:
``["cpu"] * 8`` is the CPU rehearsal of an eight-device mesh, ``["cuda:0"]
* 8`` runs eight shards on one card, ``cuda:0..3`` spreads four over the
cards of one host. Long captures shard into contiguous **time blocks**
along one mesh axis and independent **channels** along another.

A :class:`Sharded` value is the port's global array: one local tensor per
mesh coordinate, each on its coordinate's device, and the spec (a mesh-axis
name or None per tensor axis) that says how they tile the global tensor.
:func:`shard` splits a tensor, :meth:`Sharded.map` runs a per-shard body,
:meth:`Sharded.gather` concatenates. The bodies are plain Python over the
shards: each shard's work is enqueued on its own device, so cards run
concurrently without threads. Exchanges between shards
(:mod:`~aether_primitives_tpu_torch.parallel.halo`) take and return whole
:class:`Sharded` values.

A mesh may also span processes, as the JAX package's does after
``jax.distributed.initialize``: after :func:`init_distributed` (a
``torch.distributed`` process group), :func:`make_mesh` gathers every
process's local devices in rank order, and each coordinate records the rank
that owns it (:attr:`Mesh.ranks`). A :class:`Sharded` value then holds
tensors only for its own rank's coordinates (None elsewhere); its
``map`` runs the local shards, :func:`shard_process_local` builds one from
each process's part of the global tensor (the counterpart of
``jax.make_array_from_process_local_data``), and
:attr:`Sharded.addressable_shards` gives each local shard with its global
index. Exchanges between ranks go through ``torch.distributed``
(:mod:`~aether_primitives_tpu_torch.parallel.halo`). With one process
nothing of this shows: every coordinate is rank 0's.
"""

from __future__ import annotations

import contextlib
import itertools
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..types import stage_device

TIME_AXIS = "time"
CHANNEL_AXIS = "channel"


class Mesh:
    """Devices arranged on named axes: ``devices`` is an object array of
    ``torch.device`` with one dimension per axis name. ``ranks`` (same
    shape; default all 0) is the process that owns each coordinate and
    ``rank`` this process's; a device of another rank is that process's
    own name for it."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str],
                 ranks: Optional[np.ndarray] = None, rank: int = 0):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        if devices.ndim != len(self.axis_names):
            raise ValueError(
                f"{devices.ndim}-d device array for axes {self.axis_names}"
            )
        self.ranks = (np.zeros(devices.shape, dtype=np.int64) if ranks is None
                      else np.asarray(ranks, dtype=np.int64).reshape(devices.shape))
        self.rank = int(rank)
        #: whether another process owns some of the coordinates
        self.spans_processes = bool((self.ranks != self.rank).any())
        self._local_coords = [c for c in self.coords() if self.ranks[c] == self.rank]
        self._box = self._local = None

    @property
    def shape(self) -> dict:
        """``{axis name: size}``, in axis order."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def coords(self):
        """Every mesh coordinate, in row-major order."""
        return itertools.product(*(range(s) for s in self.devices.shape))

    def local_coords(self) -> list:
        """This process's coordinates, in row-major order."""
        return self._local_coords

    def local_box(self) -> tuple:
        """The slices, one per axis, that hold this process's coordinates.
        ValueError where they do not fill a box (devices gathered in rank
        order fill one whenever each process holds a whole number of rows
        of the trailing axes)."""
        if self._box is None:
            mine = np.argwhere(self.ranks == self.rank)
            if not len(mine):
                raise ValueError(f"rank {self.rank} holds no coordinate of {self}")
            box = tuple(slice(int(lo), int(hi) + 1) for lo, hi in zip(mine.min(0), mine.max(0)))
            if self.ranks[box].size != len(mine):
                raise ValueError(f"rank {self.rank}'s coordinates of {self} do not fill a box")
            self._box = box
        return self._box

    def local_mesh(self) -> "Mesh":
        """The sub-mesh of this process's coordinates (a mesh of one
        process; the mesh itself where it spans no other)."""
        if not self.spans_processes:
            return self
        if self._local is None:
            self._local = Mesh(self.devices[self.local_box()], self.axis_names)
        return self._local

    def axis(self, name: str) -> int:
        """Position of axis ``name``; ValueError when the mesh has none."""
        if name not in self.axis_names:
            raise ValueError(f"axis {name!r} not in mesh axes {self.axis_names}")
        return self.axis_names.index(name)

    def __repr__(self) -> str:
        ranks = f", ranks={self.ranks.ravel().tolist()}" if self.spans_processes else ""
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]}{ranks})"


def make_mesh(axes: Optional[dict] = None, devices: Optional[Sequence] = None) -> Mesh:
    """Build a mesh. Default: every visible card on one ``time`` axis (it
    raises RuntimeError without a card; the CPU runs only when asked for,
    ``devices=["cpu"] * n``).

    ``axes``: ordered {name: size} dict; sizes must multiply to the device
    count (one size may be -1 to infer). ``devices``: anything
    ``torch.device`` takes; a device may repeat. After
    :func:`init_distributed` ``devices`` are this process's own, and the
    mesh is built from every process's, in rank order (one
    ``all_gather_object`` of their names): every process must call it.
    """
    if devices is None:
        stage_device("cuda", "make_mesh")
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devs = [stage_device(d, "make_mesh") for d in devices]
        devs = [torch.device("cuda", torch.cuda.current_device())
                if d.type == "cuda" and d.index is None else d for d in devs]
    ranks, rank = [0] * len(devs), 0
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        names = [None] * dist.get_world_size()
        dist.all_gather_object(names, [str(d) for d in devs])
        rank = dist.get_rank()
        devs = [d for r, ds in enumerate(names)
                for d in (devs if r == rank else [torch.device(n) for n in ds])]
        ranks = [r for r, ds in enumerate(names) for _ in ds]
    n = len(devs)
    if axes is None:
        axes = {TIME_AXIS: n}
    names = list(axes.keys())
    sizes = [int(s) for s in axes.values()]
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        sizes[sizes.index(-1)] = n // known
    if int(np.prod(sizes)) != n:
        raise ValueError(f"Mesh axes {dict(zip(names, sizes))} != {n} devices")
    dev_array = np.empty(n, dtype=object)
    dev_array[:] = devs
    return Mesh(dev_array.reshape(sizes), names, np.asarray(ranks).reshape(sizes), rank)


class Sharding(NamedTuple):
    """Where a tensor goes: a mesh and a spec (a mesh-axis name or None per
    tensor axis; trailing axes left out are not split)."""

    mesh: Mesh
    spec: Tuple[Optional[str], ...]


def time_sharding(mesh: Mesh, axis: str = TIME_AXIS) -> Sharding:
    """The sharding that places the leading (block) axis on ``axis``."""
    mesh.axis(axis)
    return Sharding(mesh, (axis,))


BACKENDS = ("gloo", "nccl")


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None) -> None:
    """Join this process to a ``torch.distributed`` process group, the
    counterpart of ``jax.distributed.initialize``; a no-op when it has
    joined one already.

    ``coordinator_address``: ``"host:port"`` of rank 0 (``tcp://`` init;
    None reads ``MASTER_ADDR`` / ``MASTER_PORT`` from the environment);
    ``num_processes``: the world size; ``process_id``: this process's rank
    (None: ``WORLD_SIZE`` / ``RANK`` from the environment). ``backend``:
    ``"gloo"`` (host tensors: CPU shards, or several ranks on one card) or
    ``"nccl"`` (CUDA tensors, one rank a card); it is not guessed, and any
    other value raises ValueError.
    """
    if backend not in BACKENDS:
        raise ValueError(f"init_distributed takes backend one of {BACKENDS}, got {backend!r}")
    dist = torch.distributed
    if not dist.is_available():
        raise RuntimeError("this torch build has no torch.distributed")
    if dist.is_initialized():
        return
    kwargs = {}
    if coordinator_address is not None:
        kwargs["init_method"] = f"tcp://{coordinator_address}"
    if num_processes is not None:
        kwargs["world_size"] = int(num_processes)
    if process_id is not None:
        kwargs["rank"] = int(process_id)
    dist.init_process_group(backend=backend, **kwargs)


def process_group(mesh: Mesh):
    """``torch.distributed``, once checked to hold the process group that
    ``mesh`` spans: RuntimeError where this process has joined none (a mesh
    that spans processes was used without :func:`init_distributed`, or
    after the group was destroyed) or joined another one, before an
    exchange that would otherwise fail deep inside or wait for ever."""
    dist = torch.distributed
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"{mesh} spans processes, but this process has joined no process group: "
            "call init_distributed in every process before make_mesh"
        )
    if dist.get_rank() != mesh.rank or dist.get_world_size() <= int(mesh.ranks.max()):
        raise RuntimeError(
            f"{mesh} is rank {mesh.rank}'s of {int(mesh.ranks.max()) + 1} processes, but this "
            f"process is rank {dist.get_rank()} of a group of {dist.get_world_size()}"
        )
    return dist


def _wire(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor as it travels between ranks: complex as its
    float32 pairs."""
    return torch.view_as_real(t) if t.is_complex() else t


def _on_device(device):
    """``device`` made current for a per-shard body, where it is a card and
    not current already (switching costs more than a small body)."""
    if device.type == "cuda" and device.index != torch.cuda.current_device():
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class Shard(NamedTuple):
    """One local shard of a :class:`Sharded` value: its device, its place
    in the global tensor (one slice per tensor axis) and its tensor, the
    counterpart of a JAX array's ``addressable_shards`` entry."""

    device: torch.device
    index: Tuple[slice, ...]
    data: torch.Tensor


class Sharded:
    """One local tensor per mesh coordinate (``shards``, an object array of
    the mesh's shape) tiling a global tensor by ``spec``. Along a mesh axis
    that the spec does not name the value is replicated: every coordinate
    holds the same data (coordinates on one device may share one tensor).
    On a mesh that spans processes the coordinates of other ranks hold
    None.
    """

    def __init__(self, mesh: Mesh, spec, shards: np.ndarray):
        self.mesh = mesh
        self.spec = tuple(spec)
        self.shards = shards
        for name in self.spec:
            if name is not None:
                mesh.axis(name)

    def _first(self) -> torch.Tensor:
        return self.shards[self.mesh.local_coords()[0]]

    @property
    def shape(self) -> tuple:
        """The global tensor's shape."""
        local = self._first().shape
        spec = self.spec + (None,) * (len(local) - len(self.spec))
        return tuple(n if name is None else n * self.mesh.shape[name]
                     for n, name in zip(local, spec))

    @property
    def ndim(self) -> int:
        return self._first().ndim

    def numel(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64))

    @property
    def addressable_shards(self) -> list:
        """This process's shards as :class:`Shard` records, in row-major
        mesh order."""
        mesh = self.mesh
        out = []
        for c in mesh.local_coords():
            t = self.shards[c]
            spec = self.spec + (None,) * (t.ndim - len(self.spec))
            index = tuple(slice(None) if name is None else
                          slice(c[mesh.axis(name)] * n, (c[mesh.axis(name)] + 1) * n)
                          for n, name in zip(t.shape, spec))
            out.append(Shard(t.device, index, t))
        return out

    def local_view(self) -> "Sharded":
        """This process's shards as a value on :meth:`Mesh.local_mesh`
        (the value itself on a mesh of one process)."""
        if not self.mesh.spans_processes:
            return self
        return Sharded(self.mesh.local_mesh(), self.spec, self.shards[self.mesh.local_box()])

    def map(self, fn, *others: Optional["Sharded"], spec=None, with_index: bool = False):
        """``fn(local, *other_locals)`` on every coordinate of this process,
        each call with its shard's device current; with ``with_index``
        ``fn`` also gets ``index=`` the (global) coordinate as ``{axis name:
        position}``. ``others`` are values on the same mesh (None passes
        None). Returns a :class:`Sharded` with ``spec`` (default: this
        value's), or a tuple of them when ``fn`` returns a tuple (``spec``
        then a tuple of specs)."""
        mesh = self.mesh
        if any(o is not None and o.mesh is not mesh for o in others):
            raise ValueError("Sharded.map takes values on one mesh")
        out = None
        for c in mesh.local_coords():
            args = [None if o is None else o.shards[c] for o in others]
            kw = {"index": dict(zip(mesh.axis_names, c))} if with_index else {}
            with _on_device(mesh.devices[c]):
                y = fn(self.shards[c], *args, **kw)
            ys = y if isinstance(y, tuple) else (y,)
            if out is None:
                out = [np.full(mesh.devices.shape, None, dtype=object) for _ in ys]
            for o, v in zip(out, ys):
                o[c] = v
        if isinstance(y, tuple):
            specs = spec if spec is not None else (self.spec,) * len(out)
            return tuple(Sharded(mesh, s, o) for s, o in zip(specs, out))
        return Sharded(mesh, self.spec if spec is None else spec, out[0])

    def gather(self, device=None, local: bool = False) -> torch.Tensor:
        """The global tensor on ``device`` (default: the mesh's first
        device): the shards concatenated along every split axis. A value on
        a mesh that spans processes has no global tensor in one process:
        it raises ValueError unless ``local`` asks for this process's part
        (the shards of :meth:`local_view`, concatenated)."""
        if self.mesh.spans_processes:
            if not local:
                raise ValueError(
                    "gather of a value that spans processes: this process holds only its "
                    "own shards (gather(local=True) concatenates them; addressable_shards "
                    "gives each with its global index)"
                )
            return self.local_view().gather(device)
        mesh = self.mesh
        dev = mesh.devices.flat[0] if device is None else torch.device(device)
        arr = self.shards
        for j in reversed(range(len(mesh.axis_names))):
            name = mesh.axis_names[j]
            if name in self.spec:
                d = self.spec.index(name)
                merged = np.empty(arr.shape[:-1], dtype=object)
                for c in itertools.product(*(range(s) for s in arr.shape[:-1])):
                    merged[c] = torch.cat([t.to(dev) for t in arr[c]], dim=d)
                arr = merged
            else:
                arr = arr[..., 0]
        return arr[()].to(dev)

    def __array__(self, dtype=None, copy=None):
        a = self.gather("cpu").numpy()
        return a if dtype is None else a.astype(dtype)

    def __repr__(self) -> str:
        return f"Sharded(shape={self.shape}, spec={self.spec}, mesh={self.mesh.shape})"


def allgather(x: Sharded, device=None) -> torch.Tensor:
    """The global tensor of ``x`` in every process, on ``device`` (default:
    the first device of this process's coordinates). On a mesh of one
    process it is :meth:`Sharded.gather`. Across processes each rank's part
    (its box's shards, concatenated) goes to every rank in one
    ``all_gather`` (host tensors under gloo, CUDA tensors under nccl;
    complex as float32 pairs, each part padded to the largest) and is
    placed where its box lies: for small values that every rank needs
    whole, such as a CAF surface."""
    mesh = x.mesh
    if not mesh.spans_processes:
        return x.gather(device)
    dist = process_group(mesh)
    dev = mesh.devices[mesh.local_coords()[0]] if device is None else torch.device(device)
    on_card = dist.get_backend() == "nccl"
    local_shape = x._first().shape
    spec = x.spec + (None,) * (len(local_shape) - len(x.spec))
    regions = []  # each rank's (slices, shape) of the global tensor
    for r in range(dist.get_world_size()):
        held = np.argwhere(mesh.ranks == r)
        if not len(held):
            regions.append(None)
            continue
        lo, hi = held.min(0), held.max(0) + 1
        cut = [(0, n) if name is None else
               (lo[mesh.axis(name)] * n, hi[mesh.axis(name)] * n)
               for n, name in zip(local_shape, spec)]
        regions.append((tuple(slice(int(a), int(b)) for a, b in cut),
                        tuple(int(b - a) for a, b in cut)))
    mine = _wire(x.gather(dev if on_card else "cpu", local=True).contiguous()).reshape(-1)
    out = torch.empty(x.shape, dtype=x._first().dtype, device=dev)
    pair = 2 if out.is_complex() else 1
    buf = torch.zeros(max(int(np.prod(r[1])) for r in regions if r is not None) * pair,
                      dtype=mine.dtype, device=mine.device)
    buf[:mine.numel()] = mine
    parts = [torch.empty_like(buf) for _ in regions]
    dist.all_gather(parts, buf)
    for part, region in zip(parts, regions):
        if region is None:
            continue
        where, shape = region
        piece = part[:int(np.prod(shape)) * pair]
        piece = (torch.view_as_complex(piece.reshape(shape + (2,))) if pair == 2
                 else piece.reshape(shape))
        out[where] = piece.to(dev)
    return out


def _lift(local: Sharded, mesh: Mesh) -> Sharded:
    """A value on ``mesh.local_mesh()`` placed on ``mesh`` (None at the
    other ranks' coordinates)."""
    if local.mesh is mesh:
        return local
    shards = np.full(mesh.devices.shape, None, dtype=object)
    shards[mesh.local_box()] = local.shards
    return Sharded(mesh, local.spec, shards)


def shard(x, mesh: Mesh, spec) -> Sharded:
    """Split ``x`` (a tensor or array-like) by ``spec`` onto ``mesh``:
    tensor axis ``d`` named ``spec[d]`` is cut into as many equal
    contiguous spans as that mesh axis is long (ValueError when it does not
    divide), and every coordinate's piece is moved to its device and made
    contiguous. A piece that already lies there contiguous is a view of
    ``x``, not a copy. A :class:`Sharded` value passes through when its
    mesh and spec agree. On a mesh that spans processes every process
    passes the whole of ``x`` and places only its own coordinates' pieces
    (:func:`shard_process_local` takes only this process's part)."""
    spec = tuple(spec)
    if isinstance(x, Sharded):
        if x.mesh is not mesh or _trim(x.spec) != _trim(spec):
            raise ValueError(
                f"value is laid out as {x.spec} on {x.mesh}, not {spec} on {mesh}"
            )
        return x
    t = torch.as_tensor(x)
    if len(spec) > t.ndim:
        raise ValueError(f"spec {spec} names more axes than the tensor's {t.ndim}")
    spec = spec + (None,) * (t.ndim - len(spec))
    cut = []  # (tensor axis, mesh axis, local length)
    for d, name in enumerate(spec):
        if name is None:
            continue
        j = mesh.axis(name)
        size = mesh.devices.shape[j]
        if t.shape[d] % size:
            raise ValueError(
                f"axis {d} of length {t.shape[d]} does not divide over "
                f"{size} shards of mesh axis {name!r}"
            )
        cut.append((d, j, t.shape[d] // size))
    shards = np.full(mesh.devices.shape, None, dtype=object)
    placed = {}
    for c in mesh.local_coords():
        dev = mesh.devices[c]
        key = (tuple(c[j] for _, j, _ in cut), dev)
        if key not in placed:
            piece = t
            for d, j, n_local in cut:
                piece = piece.narrow(d, c[j] * n_local, n_local)
            placed[key] = piece.to(dev).contiguous()
        shards[c] = placed[key]
    return Sharded(mesh, spec, shards)


def shard_process_local(local, mesh: Mesh, spec, global_shape) -> Sharded:
    """A :class:`Sharded` value of ``global_shape`` laid out by ``spec``
    from this process's part of it, the counterpart of
    ``jax.make_array_from_process_local_data``: ``local`` is the block of
    the global tensor that this process's coordinates (:meth:`Mesh.local_box`)
    cover, split here over them. On a mesh of one process it is the whole
    tensor and this is :func:`shard`."""
    t = torch.as_tensor(local)
    global_shape = tuple(int(n) for n in global_shape)
    spec = tuple(spec) + (None,) * (len(global_shape) - len(tuple(spec)))
    box = mesh.local_box()
    want = []
    for d, name in enumerate(spec):
        if name is None:
            want.append(global_shape[d])
            continue
        j = mesh.axis(name)
        if global_shape[d] % mesh.devices.shape[j]:
            raise ValueError(
                f"axis {d} of length {global_shape[d]} does not divide over "
                f"{mesh.devices.shape[j]} shards of mesh axis {name!r}"
            )
        want.append(global_shape[d] // mesh.devices.shape[j]
                    * (box[j].stop - box[j].start))
    if tuple(t.shape) != tuple(want):
        raise ValueError(
            f"process-local data of shape {tuple(t.shape)}; rank {mesh.rank}'s part of "
            f"{global_shape} laid out as {spec} is {tuple(want)}"
        )
    return _lift(shard(t, mesh.local_mesh(), spec), mesh)


def shard_last(x, mesh: Mesh, axis_name: str, leading: Optional[str] = None,
               dtype=None) -> Sharded:
    """:func:`shard` along the last axis over ``axis_name`` (and, with
    ``leading``, along the first axis over that); array-likes are taken as
    tensors of ``dtype``."""
    if not isinstance(x, Sharded):
        x = torch.as_tensor(x, dtype=dtype)
    if leading is None:
        return shard(x, mesh, (None,) * (x.ndim - 1) + (axis_name,))
    return shard(x, mesh, (leading,) + (None,) * (x.ndim - 2) + (axis_name,))


def _trim(spec):
    spec = tuple(spec)
    while spec and spec[-1] is None:
        spec = spec[:-1]
    return spec
