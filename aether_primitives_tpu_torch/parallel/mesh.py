"""Device-mesh helpers and the sharded value (PyTorch).

Counterpart of ``aether_primitives_tpu/parallel/mesh.py`` and of what
``jax.shard_map`` and ``jax.device_put`` do for the sharded entry points.
The JAX package is single-controller: one process drives every device of
the mesh. So is the port: a :class:`Mesh` is a **list of torch devices in
one process**, reshaped to named axes. A device may appear more than once:
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

Multi-process and multi-host bring-up is not ported:
:func:`init_distributed` raises.
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
    ``torch.device`` with one dimension per axis name."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        if devices.ndim != len(self.axis_names):
            raise ValueError(
                f"{devices.ndim}-d device array for axes {self.axis_names}"
            )

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

    def axis(self, name: str) -> int:
        """Position of axis ``name``; ValueError when the mesh has none."""
        if name not in self.axis_names:
            raise ValueError(f"axis {name!r} not in mesh axes {self.axis_names}")
        return self.axis_names.index(name)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


def make_mesh(axes: Optional[dict] = None, devices: Optional[Sequence] = None) -> Mesh:
    """Build a mesh. Default: every visible card on one ``time`` axis (it
    raises RuntimeError without a card; the CPU runs only when asked for,
    ``devices=["cpu"] * n``).

    ``axes``: ordered {name: size} dict; sizes must multiply to the device
    count (one size may be -1 to infer). ``devices``: anything
    ``torch.device`` takes; a device may repeat.
    """
    if devices is None:
        stage_device("cuda", "make_mesh")
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devs = [stage_device(d, "make_mesh") for d in devices]
        devs = [torch.device("cuda", torch.cuda.current_device())
                if d.type == "cuda" and d.index is None else d for d in devs]
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
    return Mesh(dev_array.reshape(sizes), names)


class Sharding(NamedTuple):
    """Where a tensor goes: a mesh and a spec (a mesh-axis name or None per
    tensor axis; trailing axes left out are not split)."""

    mesh: Mesh
    spec: Tuple[Optional[str], ...]


def time_sharding(mesh: Mesh, axis: str = TIME_AXIS) -> Sharding:
    """The sharding that places the leading (block) axis on ``axis``."""
    mesh.axis(axis)
    return Sharding(mesh, (axis,))


def init_distributed(**kwargs) -> None:
    """Multi-process bring-up is not ported: the port's mesh is the devices
    of one process."""
    raise NotImplementedError(
        "multi-process meshes are not ported yet (ROADMAP.md, queue 1 item 17b); "
        "make_mesh takes the devices of one process"
    )


def _on_device(device):
    """``device`` made current for a per-shard body, where it is a card and
    not current already (switching costs more than a small body)."""
    if device.type == "cuda" and device.index != torch.cuda.current_device():
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class Sharded:
    """One local tensor per mesh coordinate (``shards``, an object array of
    the mesh's shape) tiling a global tensor by ``spec``. Along a mesh axis
    that the spec does not name the value is replicated: every coordinate
    holds the same data (coordinates on one device may share one tensor).
    """

    def __init__(self, mesh: Mesh, spec, shards: np.ndarray):
        self.mesh = mesh
        self.spec = tuple(spec)
        self.shards = shards
        for name in self.spec:
            if name is not None:
                mesh.axis(name)

    @property
    def shape(self) -> tuple:
        """The global tensor's shape."""
        local = self.shards.flat[0].shape
        spec = self.spec + (None,) * (len(local) - len(self.spec))
        return tuple(n if name is None else n * self.mesh.shape[name]
                     for n, name in zip(local, spec))

    @property
    def ndim(self) -> int:
        return self.shards.flat[0].ndim

    def numel(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64))

    def map(self, fn, *others: Optional["Sharded"], spec=None, with_index: bool = False):
        """``fn(local, *other_locals)`` on every coordinate, each call with
        its shard's device current; with ``with_index`` ``fn`` also gets
        ``index=`` the coordinate as ``{axis name: position}``. ``others``
        are values on the same mesh (None passes None). Returns a
        :class:`Sharded` with ``spec`` (default: this value's), or a tuple
        of them when ``fn`` returns a tuple (``spec`` then a tuple of
        specs)."""
        mesh = self.mesh
        if any(o is not None and o.mesh is not mesh for o in others):
            raise ValueError("Sharded.map takes values on one mesh")
        out = None
        for c in mesh.coords():
            args = [None if o is None else o.shards[c] for o in others]
            kw = {"index": dict(zip(mesh.axis_names, c))} if with_index else {}
            with _on_device(mesh.devices[c]):
                y = fn(self.shards[c], *args, **kw)
            ys = y if isinstance(y, tuple) else (y,)
            if out is None:
                out = [np.empty(mesh.devices.shape, dtype=object) for _ in ys]
            for o, v in zip(out, ys):
                o[c] = v
        if isinstance(y, tuple):
            specs = spec if spec is not None else (self.spec,) * len(out)
            return tuple(Sharded(mesh, s, o) for s, o in zip(specs, out))
        return Sharded(mesh, self.spec if spec is None else spec, out[0])

    def gather(self, device=None) -> torch.Tensor:
        """The global tensor on ``device`` (default: the mesh's first
        device): the shards concatenated along every split axis."""
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


def shard(x, mesh: Mesh, spec) -> Sharded:
    """Split ``x`` (a tensor or array-like) by ``spec`` onto ``mesh``:
    tensor axis ``d`` named ``spec[d]`` is cut into as many equal
    contiguous spans as that mesh axis is long (ValueError when it does not
    divide), and every coordinate's piece is moved to its device and made
    contiguous. A piece that already lies there contiguous is a view of
    ``x``, not a copy. A :class:`Sharded` value passes through when its
    mesh and spec agree."""
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
    shards = np.empty(mesh.devices.shape, dtype=object)
    placed = {}
    for c in mesh.coords():
        dev = mesh.devices[c]
        key = (tuple(c[j] for _, j, _ in cut), dev)
        if key not in placed:
            piece = t
            for d, j, n_local in cut:
                piece = piece.narrow(d, c[j] * n_local, n_local)
            placed[key] = piece.to(dev).contiguous()
        shards[c] = placed[key]
    return Sharded(mesh, spec, shards)


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
