"""Bounded-depth streaming executors and the host block pool (PyTorch).

Counterpart of ``aether_primitives_tpu/parallel/streaming.py``, the
re-imagination of the reference's two concurrency components (reference
src/pipeline.rs and src/pool.rs):

- :class:`Pipeline` of named block transforms and its
  :class:`StreamExecutor`, which streams blocks through the composed chain
  with **bounded in-flight depth** (the reference's channels are unbounded,
  examples/pipeline.rs:61-66), with the reference's per-stage throughput
  and utilisation reports;
- :class:`StatefulExecutor` for chains that carry state from block to block
  (the RX chain's FIR history);
- :class:`BlockPool`, the reference pool's ``take`` / ``take_or_make`` /
  ``len`` / ``cap`` surface over reusable host staging buffers (pinned
  tensors, for a host-fed stream on a card).

JAX overlaps the host with the device through asynchronous dispatch and
``jnp.asarray``; here the overlap is explicit. On a CUDA device each
executor owns a side ``torch.cuda.Stream`` for host->device copies
(``non_blocking=True``, asynchronous from pinned memory) and runs the chain
on the stream that was current when it was built:

- a block's copies are recorded by one event that the compute stream waits
  on before the chain runs, so the copy of block i + 1 overlaps the chain on
  block i;
- ``send`` returns once that copy event has passed (not the compute), so the
  caller may reuse or release its host buffer at once
  (``examples/pipeline.py`` releases a pooled buffer straight after
  ``send``);
- a copied block is allocated on the copy stream and marked with
  ``record_stream`` for the compute stream, so the caching allocator does
  not hand its memory out again while the chain still reads it: that is
  the port's donation of the executor's own staged blocks. A tensor the
  caller passes already on the device is used as it is, never written and
  never freed;
- backpressure synchronises the done-event of the block ``depth`` back, and
  ``recv`` synchronises the oldest block's done-event and records the host
  time since its ``send``.

Pageable host memory (a numpy block) is staged like pinned memory, but its
copy is synchronous with the host: only pinned blocks overlap.

On ``device="cpu"`` (the tests) every call runs eagerly and the events are
skipped.

With a ``sharding`` (a :class:`~aether_primitives_tpu_torch.parallel.mesh.
Sharding`: a mesh and a spec) each block is laid out across the mesh before
the chain runs, as the JAX executors ``device_put`` it: the chain gets a
:class:`~aether_primitives_tpu_torch.parallel.mesh.Sharded` value. The mesh
says where the block goes, so ``device`` is not read; every shard is copied
on its own device's current stream (no side copy stream), and the
done-event of a block is one event per card of the mesh. On a mesh that
spans processes each process stages only its own shards, and its cards and
``device`` are its own coordinates'.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from ..types import stage_device
from ..utils.metrics import StageStats
from .mesh import Sharded, Sharding, shard

#: Host dtypes that the JAX package (without x64) stages as 32-bit; the
#: port stages them the same way.
_CANONICAL = {
    np.dtype(np.float64): np.float32,
    np.dtype(np.complex128): np.complex64,
    np.dtype(np.int64): np.int32,
    np.dtype(np.uint64): np.uint32,
}


def _host_tensor(a) -> torch.Tensor:
    """Host data as a CPU tensor, with ``jnp.asarray``'s numpy semantics
    (a tuple of equal arrays stacks; 64-bit types become 32-bit)."""
    arr = np.asarray(a)
    canonical = _CANONICAL.get(arr.dtype)
    if canonical is not None:
        arr = arr.astype(canonical)
    if not (arr.flags.c_contiguous and arr.flags.writeable):
        arr = np.array(arr, order="C")
    return torch.from_numpy(arr)


def _tree_map(fn, x):
    """``fn`` over the leaves of nested tuples (named ones, such as
    :class:`~aether_primitives_tpu_torch.boundary.Split`, kept)."""
    if isinstance(x, tuple):
        vals = [_tree_map(fn, v) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
    return fn(x)


def _copy_leaf(a):
    if isinstance(a, Sharded):
        return a.map(torch.clone)
    return a.clone() if isinstance(a, torch.Tensor) else a


def _leaves(x) -> list:
    out = []
    _tree_map(out.append, x)
    return out


class _Stager:
    """Moves blocks onto the executor's device; on a CUDA device through a
    side copy stream, as the module docstring sets out."""

    def __init__(self, device, sharding: Optional[Sharding] = None):
        self.sharding = sharding
        if sharding is not None:
            self.sharding = sharding = Sharding(*sharding)
            mesh = sharding.mesh
            local = [mesh.devices[c] for c in mesh.local_coords()]  # this process's
            cards = sorted({d.index for d in local if d.type == "cuda"})
            self.device = local[0]
            self.cuda = False  # no side copy stream: each shard's own stream
            self.streams = [torch.cuda.current_stream(torch.device("cuda", i)) for i in cards]
            return
        self.device = stage_device(device, "the streaming executor")
        self.cuda = self.device.type == "cuda"
        self.streams = []
        if self.cuda:
            if self.device.index is None:  # compare equal to the tensors' cuda:N
                self.device = torch.device("cuda", torch.cuda.current_device())
            self.compute = torch.cuda.current_stream(self.device)
            self.copy = torch.cuda.Stream(self.device)
            self.streams = [self.compute]

    def state_leaf(self, a):
        """A leaf of the carried state: with a sharding it stays as given
        (the step lays it out), else it is staged like a block."""
        if self.sharding is None:
            return self.leaf(a)
        return a if isinstance(a, (torch.Tensor, Sharded)) else _host_tensor(a)

    def leaf(self, a):
        if isinstance(a, Sharded):
            return a
        t = a if isinstance(a, torch.Tensor) else _host_tensor(a)
        if self.sharding is not None:
            return shard(t, *self.sharding)
        if t.device == self.device:
            return t  # already there: the caller's tensor, used as it is
        if not self.cuda:
            return t.to(self.device)
        with torch.cuda.stream(self.copy):
            d = t.to(self.device, non_blocking=True)
        d.record_stream(self.compute)
        return d

    def copied(self):
        """After a block's copies: the event that marks them, which the
        compute stream waits on (None on the CPU)."""
        if not self.cuda:
            return None
        ev = torch.cuda.Event()
        ev.record(self.copy)
        self.compute.wait_event(ev)
        return ev

    def on_compute(self):
        return torch.cuda.stream(self.compute) if self.cuda else contextlib.nullcontext()

    def done(self) -> list:
        """Events recorded after a block's chain, one per compute stream
        (the executor's, or one per card of the mesh; none on the CPU)."""
        return [s.record_event() for s in self.streams]

    def sync(self) -> None:
        for s in self.streams:
            s.synchronize()


def _wait(events) -> None:
    """Synchronise an event, a list of events, or None."""
    if events is None:
        return
    for ev in events if isinstance(events, list) else [events]:
        ev.synchronize()


class _Bounded:
    """What both executors share: the in-flight queue of ``(result, t0,
    samples, done-event)``, its backpressure and its draining."""

    #: hard cap on enqueued-but-uncollected results; beyond this, send
    #: raises instead of letting device memory grow without bound
    MAX_BACKLOG_FACTOR = 8

    def _check_room(self) -> None:
        if self._closed:
            raise RuntimeError("Executor is closed")
        if len(self._inflight) >= self.depth * self.MAX_BACKLOG_FACTOR:
            raise RuntimeError(
                "in-flight backlog exceeded: drain results with recv() "
                "(or use run(), which interleaves send/recv)"
            )
        if len(self._inflight) >= self.depth:
            _wait(self._inflight[-self.depth][3])

    def recv(self):
        """Wait for and return the oldest in-flight result."""
        if not self._inflight:
            raise IndexError("No blocks in flight")
        y, t0, nsamp, done = self._inflight.popleft()
        _wait(done)
        self.chain_stats.record(time.monotonic() - t0, samples=nsamp)
        return y

    def close(self) -> None:
        self._closed = True

    def __iter__(self):
        while self._inflight:
            yield self.recv()

    def run(self, blocks) -> list:
        """Push all blocks through in order and return all results (keeps
        at most ``depth`` blocks in flight)."""
        out = []
        for b in blocks:
            if len(self._inflight) >= self.depth:
                out.append(self.recv())
            self.send(b)
        out.extend(self)
        return out


@dataclass
class Stage:
    name: str
    op: Callable[[Any], Any]


class Pipeline:
    """A streaming chain of named block transforms, assembled stage by stage.

    Mirrors the reference's API (``pipeline::new(name, op)`` ->
    ``add_stage`` -> ``finish``, src/pipeline.rs:26-48,123-137)::

        pipe = Pipeline("Abs", lambda b: b.abs())
        pipe = pipe.add_stage("Mul 20", lambda b: b * 20.0)
        ex = pipe.finish(depth=2)
        results = ex.run(blocks)   # keeps at most `depth` blocks in flight

    (or interleave ``send``/``recv`` by hand: ``recv`` must drain what
    ``send`` produces; the executor refuses to grow an unbounded backlog.)
    """

    def __init__(self, name: str, op: Callable[[Any], Any]):
        self.stages: List[Stage] = [Stage(name, op)]

    def add_stage(self, name: str, op: Callable[[Any], Any]) -> "Pipeline":
        self.stages.append(Stage(name, op))
        return self

    def composed(self) -> Callable[[Any], Any]:
        """The chain as a single callable."""
        stages = list(self.stages)

        def chain(x):
            for s in stages:
                x = s.op(x)
            return x

        return chain

    def finish(
        self,
        depth: int = 2,
        donate: bool = True,
        sharding=None,
        profile: bool = False,
        report_every_s: float = 1.0,
        printer: Optional[Callable[[str], None]] = print,
        profile_every: int = 16,
        device="cuda",
    ) -> "StreamExecutor":
        """The executor of this chain (the analog of the reference's
        ``finish() -> (Sender, Receiver)``)."""
        return StreamExecutor(
            self.stages,
            depth=depth,
            donate=donate,
            sharding=sharding,
            profile=profile,
            report_every_s=report_every_s,
            printer=printer,
            profile_every=profile_every,
            device=device,
        )


def new(name: str, op: Callable[[Any], Any]) -> Pipeline:
    """Create a pipeline (API parity with reference ``pipeline::new``)."""
    return Pipeline(name, op)


class StreamExecutor(_Bounded):
    """Runs blocks through the chain with bounded in-flight depth.

    ``send`` stages a block on the device and enqueues the chain (waiting
    once ``depth`` blocks are in flight: that is the backpressure); ``recv``
    returns the oldest finished result. On a card, the copy of the next
    block overlaps the chain on this one (module docstring).

    ``profile=True`` runs the stages one at a time and synchronises after
    each, to attribute time per stage on every block (slower; for tuning).
    The default mode runs the composed chain and attributes time to it, but
    still feeds the per-stage stats by routing every ``profile_every``-th
    block through the per-stage path (periodic sampling), the reference's
    always-on per-stage report (src/pipeline.rs:89-114) without a per-stage
    synchronisation on every block. ``profile_every=0`` disables sampling.

    ``donate``: PyTorch has no buffer donation. A block the executor copied
    to the device is released to the caching allocator as soon as its chain
    is enqueued, donated or not; a tensor the caller passes on the device is
    never written or freed. The flag is kept for API parity.

    ``device``: ``"cuda"`` (the default) or ``"cpu"`` when asked for.
    """

    def __init__(
        self,
        stages: List[Stage],
        depth: int = 2,
        donate: bool = True,
        sharding=None,
        profile: bool = False,
        report_every_s: float = 1.0,
        printer: Optional[Callable[[str], None]] = print,
        profile_every: int = 16,
        device="cuda",
    ):
        self.stages = stages
        self.depth = max(1, int(depth))
        self.sharding = sharding
        self.profile = profile
        self._inflight: deque = deque()
        self._closed = False
        self._donate = donate
        self.profile_every = 0 if profile else max(0, int(profile_every))
        self._sent = 0
        self._stager = _Stager(device, sharding)
        self.device = self._stager.device
        self._stage_fns = [s.op for s in stages]

        def chain(x):
            for s in stages:
                x = s.op(x)
            return x

        self._chain = chain
        self.stats = [
            StageStats(s.name, report_every_s=report_every_s, printer=printer)
            for s in stages
        ]
        self.chain_stats = StageStats(
            "chain", report_every_s=report_every_s, printer=printer
        )
        self._started = time.monotonic()

    def send(self, block) -> None:
        """Feed one block (a tensor, or host data taken as ``jnp.asarray``
        takes it).

        Backpressure: when ``depth`` blocks are pending, waits for the oldest
        of them to finish before enqueueing more. Results must still be
        drained with :meth:`recv` (or :meth:`run`, which interleaves); the
        executor raises once ``depth * MAX_BACKLOG_FACTOR`` are waiting.
        Returns once the block's host->device copy is done.
        """
        self._check_room()
        t0 = time.monotonic()
        st = self._stager
        x = st.leaf(block)
        copied = st.copied()
        nsamp = x.numel()
        sample_stages = self.profile or (
            self.profile_every and self._sent % self.profile_every == 0
        )
        self._sent += 1
        with st.on_compute():
            if sample_stages:
                _wait(copied)  # time the stages, not the copy
                y = x
                for fn, stats in zip(self._stage_fns, self.stats):
                    s0 = time.monotonic()
                    y = fn(y)
                    st.sync()
                    stats.record(time.monotonic() - s0, samples=nsamp)
            else:
                y = self._chain(x)
            done = st.done()
        self._inflight.append((y, t0, nsamp, done))
        _wait(copied)


class StatefulExecutor(_Bounded):
    """Bounded-depth executor for STATEFUL streaming steps: chains whose
    blocks are successive spans of one contiguous capture and must thread
    carry-over state (e.g. FIR history) from block to block.

    ``step(block, state) -> (out, new_state)`` (e.g.
    :meth:`~aether_primitives_tpu_torch.models.modem.RxChain.streaming_step`,
    or ``streaming_step_split`` with :class:`~aether_primitives_tpu_torch.
    boundary.Split` blocks and state); ``init_state`` is the pre-capture
    state (zeros for a causal chain), a tensor, host data, or a tuple of
    them. It is moved to the executor's device, so the carried state of the
    JAX package's executor (``np.asarray(ex.state)``) resumes its stream
    here. This is the continuous-stream form of the reference's pipeline
    (src/pipeline.rs:70-79) that the stateless :class:`StreamExecutor`
    cannot express.

    The state stays on the device and the chain is enqueued without a host
    synchronisation, so block i + 1's dependence on block i's state is
    resolved in the compute stream's order while the host stages block
    i + 2. ``donate_state`` is kept for API parity: each step's state
    replaces the last, which the allocator then recycles.

    The sample count of a block is the sum over its leaves, as in the JAX
    executor: a ``Split`` block of n samples counts 2n.
    """

    def __init__(
        self,
        step: Callable[[Any, Any], Any],
        init_state,
        name: str = "stream",
        depth: int = 2,
        donate_state: bool = True,
        sharding=None,
        report_every_s: float = 1.0,
        printer: Optional[Callable[[str], None]] = print,
        device="cuda",
    ):
        self.depth = max(1, int(depth))
        self.sharding = sharding
        self._fn = step
        self._stager = _Stager(device, sharding)
        self.device = self._stager.device
        self._state = _tree_map(self._stager.state_leaf, init_state)
        _wait(self._stager.copied())
        self._inflight: deque = deque()
        self._closed = False
        self.chain_stats = StageStats(
            name, report_every_s=report_every_s, printer=printer
        )

    def send(self, block) -> None:
        """Feed the next contiguous block (same backpressure contract as
        :meth:`StreamExecutor.send`)."""
        self._check_room()
        t0 = time.monotonic()
        st = self._stager
        x = _tree_map(st.leaf, block)
        copied = st.copied()
        nsamp = int(sum(leaf.numel() for leaf in _leaves(x)))
        with st.on_compute():
            y, self._state = self._fn(x, self._state)
            done = st.done()
        self._inflight.append((y, t0, nsamp, done))
        _wait(copied)

    @property
    def state(self):
        """Current carry state (e.g. to checkpoint or resume a stream), as a
        COPY: later sends never change a checkpoint taken here."""
        with self._stager.on_compute():
            return _tree_map(_copy_leaf, self._state)


# --------------------------------------------------------------------------
# Block pool (reference src/pool.rs)
# --------------------------------------------------------------------------


class PoolElem:
    """RAII guard: derefs to the buffer via ``.value``; returning happens on
    ``release()`` or context-manager exit (reference ``Elem``,
    src/pool.rs:189-221)."""

    def __init__(self, pool: "BlockPool", value):
        self._pool = pool
        self.value = value
        self._returned = False

    def release(self) -> None:
        if not self._returned:
            self._returned = True
            self._pool._give_back(self.value)

    def __enter__(self):
        return self.value

    def __exit__(self, *exc):
        self.release()


class BlockPool:
    """Thread-safe pool of reusable host staging buffers.

    Same surface as the reference pool (``make``/``take``/``take_or_make``/
    ``len``/``cap``, src/pool.rs:43-160): ``maker`` builds a buffer,
    ``resetter`` runs when one is returned. For a host-fed stream on a card
    the maker makes pinned tensors (``torch.empty(n, dtype=...).pin_memory()``),
    whose copies overlap the chain; device memory is the caching
    allocator's to reuse.

    Checkout/return contract (the reference's doctest, src/pool.rs:13-42;
    cross-thread moves work because the pool is lock-guarded):

    >>> pool = BlockPool(1, maker=lambda: [0, 0], resetter=lambda b: b.clear())
    >>> elem = pool.take()
    >>> elem.value.append(7)
    >>> pool.take() is None    # bounded: empty while checked out
    True
    >>> elem.release()         # resetter runs, buffer returns
    >>> pool.len(), pool.cap()
    (1, 1)
    >>> pool.take().value      # reset cleared it
    []
    """

    def __init__(self, initial_len: int, maker: Callable[[], Any], resetter=None):
        self._maker = maker
        self._resetter = resetter or (lambda buf: None)
        self._lock = threading.Lock()
        self._elems = []
        for _ in range(int(initial_len)):
            e = maker()
            self._resetter(e)
            self._elems.append(e)
        self._cap = len(self._elems)

    def take(self) -> Optional[PoolElem]:
        """Bounded checkout: ``None`` when empty (reference ``take``)."""
        with self._lock:
            if not self._elems:
                return None
            return PoolElem(self, self._elems.pop())

    def take_or_make(self) -> PoolElem:
        """Growing checkout (reference ``take_or_make``)."""
        with self._lock:
            if self._elems:
                return PoolElem(self, self._elems.pop())
            self._cap += 1
        return PoolElem(self, self._maker())

    def _give_back(self, value) -> None:
        self._resetter(value)
        with self._lock:
            self._elems.append(value)

    def __len__(self) -> int:
        with self._lock:
            return len(self._elems)

    def len(self) -> int:
        return len(self)

    def cap(self) -> int:
        with self._lock:
            return self._cap

    def is_empty(self) -> bool:
        return len(self) == 0

    # the reference ships this method name with a typo (``is_emtpy``,
    # src/pool.rs:145); alias kept so ported call sites keep working
    is_emtpy = is_empty


def make(initial_len: int, maker: Callable[[], Any], resetter=None) -> BlockPool:
    """Create a pool (API parity with reference ``pool::make``)."""
    return BlockPool(initial_len, maker, resetter)
