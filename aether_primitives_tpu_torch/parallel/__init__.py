"""Streaming: the bounded-depth executors and the host block pool
(counterpart of ``aether_primitives_tpu/parallel``'s ``streaming``; the
mesh and halo modules belong to the multi-device slice, not ported yet)."""

from . import streaming

__all__ = ["streaming"]
