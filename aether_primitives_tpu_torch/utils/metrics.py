"""Per-stage throughput metrics.

Equivalent of the reference pipeline's self-instrumentation: each stage
counts items and active time and reports ``Processed N in S (ops/s);
Utilisation: X%`` about once per second (reference src/pipeline.rs:67-114).
Here stats are first-class objects (queryable, not just printed) and the
executor also tracks samples/s — the metric the north star is measured in.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional


@dataclass
class StageStats:
    """Rolling throughput/utilization counters for one stage."""

    name: str
    report_every_s: float = 1.0
    printer: Optional[Callable[[str], None]] = print
    # window counters (reset each report)
    n: int = 0
    samples: int = 0
    active_s: float = 0.0
    window_started: float = field(default_factory=time.monotonic)
    # lifetime totals
    total_n: int = 0
    total_samples: int = 0
    total_active_s: float = 0.0

    def record(self, active_s: float, samples: int = 0) -> None:
        """Record one processed item and maybe emit a report."""
        self.n += 1
        self.samples += samples
        self.active_s += active_s
        self.total_n += 1
        self.total_samples += samples
        self.total_active_s += active_s
        now = time.monotonic()
        dur = now - self.window_started
        if dur >= self.report_every_s:
            if self.printer is not None:
                ops = self.n / dur
                util = 100.0 * self.active_s / dur
                msg = (
                    f"Stage: {self.name:15} : Processed {self.n} in {dur:3.3f}s "
                    f"({ops:9.2f}/s); Utilisation: {util:3.2f}%"
                )
                if self.samples:
                    msg += f"; {self.samples / dur / 1e6:.1f} Msamples/s"
                self.printer(msg)
            self.window_started = now
            self.n = 0
            self.samples = 0
            self.active_s = 0.0

    def lifetime_ops_per_s(self, wall_s: float) -> float:
        return self.total_n / wall_s if wall_s > 0 else 0.0

    def summary(self) -> str:
        """Lifetime one-liner (per-block mean + samples/s over active time)."""
        if self.total_n == 0:
            return f"Stage: {self.name:15} : no samples recorded"
        mean_ms = 1e3 * self.total_active_s / self.total_n
        msg = (
            f"Stage: {self.name:15} : {self.total_n} blocks, "
            f"{mean_ms:.3f} ms/block"
        )
        if self.total_samples and self.total_active_s > 0:
            msg += (
                f", {self.total_samples / self.total_active_s / 1e6:.1f}"
                " Msamples/s active"
            )
        return msg
