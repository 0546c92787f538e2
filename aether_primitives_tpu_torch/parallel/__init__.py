"""Streaming and sharding: the bounded-depth executors and the host block
pool, the device mesh with its sharded value, and the halo exchange
(counterpart of ``aether_primitives_tpu/parallel``)."""

from . import halo, mesh, streaming

__all__ = ["halo", "mesh", "streaming"]
