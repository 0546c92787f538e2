"""A traced window: ``torch.profiler`` over a short steady stretch of a
cell's loop, reduced to what the per-layer metrics read.

Device activities are kernels (by name) and copies (``Memcpy``/``Memset``).
The window is the span of the ``portbench.window`` host annotation; the
device is busy where any activity runs, and idle elsewhere in the window.
Each idle gap is named by the innermost host event that covers its middle:
what the host was doing while the card waited.
"""

from __future__ import annotations

from collections import defaultdict

import torch

WINDOW = "portbench.window"
COPY_PREFIXES = ("Memcpy", "Memset")
TOP = 10


class TraceWindow:
    """The traced window's device activities and host events, in
    microseconds on the profiler's clock, and the loop's own counts
    (``units``, e.g. ``{"steps": 480}``)."""

    def __init__(self, device_events, host_events, window, units):
        self.start, self.end = window
        self.units = units
        self.kernels = [e for e in device_events if not e[0].startswith(COPY_PREFIXES)]
        self.copies = [e for e in device_events if e[0].startswith(COPY_PREFIXES)]
        self.host = host_events
        self.window_s = (self.end - self.start) / 1e6
        self.busy_s = self._busy() / 1e6

    def kernel_times(self, pattern: str) -> list:
        """Device microseconds of each kernel whose name holds ``pattern``."""
        return [d for name, _s, d in self.kernels if pattern in name]

    def copy_times(self, pattern: str) -> list:
        """Device microseconds of each copy whose name holds ``pattern``
        (``"HtoD"``, ``"DtoH"``, ``"DtoD"``)."""
        return [d for name, _s, d in self.copies if pattern in name]

    def _intervals(self):
        out = []
        for _n, s, d in self.kernels + self.copies:
            a, b = max(s, self.start), min(s + d, self.end)
            if b > a:
                out.append((a, b))
        out.sort()
        merged = []
        for a, b in out:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    def _busy(self) -> float:
        return sum(b - a for a, b in self._intervals())

    def gaps(self) -> list:
        """Idle stretches ``(start, end)`` of the window, longest first."""
        out, t = [], self.start
        for a, b in self._intervals():
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if self.end > t:
            out.append((t, self.end))
        return sorted(out, key=lambda g: g[0] - g[1])

    def _host_at(self, t: float) -> str:
        best = None
        for name, s, e in self.host:
            if s <= t <= e and name != WINDOW and (best is None or e - s < best[1]):
                best = (name, e - s)
        return best[0] if best else "no host event"

    def breakdown(self) -> dict:
        """The device operations that took most time and the longest idle
        gaps by what the host was doing, at most ten of each, in seconds."""
        ops = defaultdict(float)
        for name, _s, d in self.kernels + self.copies:
            ops[name[:160]] += d / 1e6
        top = sorted(ops.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = [[self._host_at((a + b) / 2), (b - a) / 1e6] for a, b in self.gaps()[:TOP]]
        return {"device_ops": [[k, v] for k, v in top], "idle_gaps": gaps}


def capture(loop, device: torch.device) -> TraceWindow:
    """Profile ``loop()`` (which returns its counts) under the
    ``portbench.window`` annotation."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize(device)
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            units = loop()
            if cuda:
                torch.cuda.synchronize(device)
    dev, host, window = [], [], None
    for e in prof.events():
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if e.name != WINDOW:  # the annotation's own span on the device timeline
                dev.append((e.name, s, t - s))
        else:
            host.append((e.name, s, t))
            if e.name == WINDOW:
                window = (s, t)
    if window is None:
        raise RuntimeError("the profiler recorded no window annotation")
    return TraceWindow(dev, host, window, units)
