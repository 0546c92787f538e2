"""Decibel conversion: a copy of ``aether_primitives_tpu/utils/db.py``
(numpy only; the tests pin it equal).

``DB`` stores the value in dB; construct from a power ratio with
:meth:`DB.from_ratio` (the analog of the reference's ``From<T: Into<f64>>``
impl: ``10 * log10(ratio)``) and convert back with :meth:`DB.ratio`.
All math is f64, like the reference.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class DB:
    """A value in decibels.

    >>> DB.from_ratio(100).db()
    20.0
    >>> DB(30.0).ratio()
    1000.0
    """

    value: float

    @staticmethod
    def from_ratio(ratio) -> "DB":
        return DB(10.0 * math.log10(float(ratio)))

    def db(self) -> float:
        return float(self.value)

    def ratio(self) -> float:
        return float(10.0 ** (self.value / 10.0))


def to_db(ratio):
    """Vectorized ratio -> dB (works on arrays)."""
    return 10.0 * np.log10(ratio)


def from_db(db):
    """Vectorized dB -> ratio (works on arrays)."""
    return 10.0 ** (np.asarray(db) / 10.0)
