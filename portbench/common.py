"""What the drivers share: a seeded reservoir sample of a window's outputs
and the percentile of a window's latencies."""

from __future__ import annotations

import random

import numpy as np


class Reservoir:
    """A uniform sample of ``size`` of the items offered, drawn from
    ``seed`` (Vitter's algorithm R): ``offer(i)`` gives the slot that item
    ``i`` takes, or None; ``taken`` maps each slot to its item."""

    def __init__(self, size: int, seed: int):
        self.size = int(size)
        self.rng = random.Random(seed)
        self.seen = 0
        self.taken = {}

    def offer(self, item):
        k = self.seen
        self.seen += 1
        slot = k if k < self.size else self.rng.randrange(k + 1)
        if slot >= self.size:
            return None
        self.taken[slot] = item
        return slot


def percentile(values, q: float) -> float:
    """The ``q``-th percentile of all ``values`` (linear interpolation)."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))
