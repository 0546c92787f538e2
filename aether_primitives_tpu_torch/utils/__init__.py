"""Host utilities: dB conversion, capture-file I/O, per-stage throughput
counters, the profiler helpers and plotting (counterparts of
``aether_primitives_tpu/utils``'s ``db``, ``file``, ``metrics``,
``profiling`` and ``plot``). ``plot`` is imported on first use: it is the
only module that needs matplotlib, and only inside its plotting calls."""

from . import db, file, metrics, profiling
from .db import DB
from .metrics import StageStats

__all__ = ["DB", "db", "file", "metrics", "plot", "profiling", "StageStats"]


def __getattr__(name):
    if name == "plot":
        import importlib

        mod = importlib.import_module("." + name, __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
