"""Profiler integration on ``torch.profiler``.

Counterpart of ``aether_primitives_tpu/utils/profiling.py``. The online
counters live in :mod:`.metrics` and the streaming executor; this module
adds the device-level view: a ``torch.profiler`` trace written as a Chrome
trace (open it in Perfetto or ``chrome://tracing``), annotations that label
pipeline stages in its timeline, and a snapshot of the card's allocator.

As in the JAX package, a trace that cannot start or stop warns and lets
the traced code run.
"""

from __future__ import annotations

import contextlib
import os
import warnings

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a host and device trace of the enclosed block into
    ``log_dir/trace.json`` (Chrome trace format).

    >>> with profiling.trace("traces/run1"):  # doctest: +SKIP
    ...     executor.run(blocks)
    """
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    try:
        prof.start()
    except Exception as e:  # a build without profiler support
        warnings.warn(f"torch profiler trace unavailable: {e}")
        prof = None
    try:
        yield
    finally:
        if prof is not None:
            try:
                prof.stop()
                os.makedirs(log_dir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
            except Exception as e:
                warnings.warn(f"torch profiler stop failed: {e}")


def annotate(name: str):
    """Label a region in the profiler timeline
    (``torch.profiler.record_function``); usable as a context manager
    around stage dispatches."""
    return torch.profiler.record_function(name)


def device_memory_stats() -> dict:
    """The current CUDA device's allocator snapshot: ``bytes_in_use`` and
    ``peak_bytes_in_use`` (the caching allocator's allocated bytes, current
    and peak) and ``bytes_limit`` (the card's total memory). ``{}`` on a
    machine without CUDA, as the JAX version returns on failure."""
    if not torch.cuda.is_available():
        return {}
    stats = torch.cuda.memory_stats()
    _free, total = torch.cuda.mem_get_info()
    return {
        "bytes_in_use": stats.get("allocated_bytes.all.current"),
        "peak_bytes_in_use": stats.get("allocated_bytes.all.peak"),
        "bytes_limit": total,
    }
