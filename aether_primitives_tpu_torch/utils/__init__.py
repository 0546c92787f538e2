"""Host utilities: dB conversion, capture-file I/O, per-stage throughput
counters and the profiler helpers (counterparts of
``aether_primitives_tpu/utils``'s ``db``, ``file``, ``metrics`` and
``profiling``)."""

from . import db, file, metrics, profiling
from .db import DB
from .metrics import StageStats

__all__ = ["DB", "db", "file", "metrics", "profiling", "StageStats"]
