"""Host utilities: capture-file I/O, per-stage throughput counters and the
profiler helpers (counterparts of ``aether_primitives_tpu/utils``'s
``file``, ``metrics`` and ``profiling``)."""

from . import file, metrics, profiling
from .metrics import StageStats

__all__ = ["file", "metrics", "profiling", "StageStats"]
