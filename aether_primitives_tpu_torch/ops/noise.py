"""AWGN generation and injection (PyTorch).

Counterpart of ``aether_primitives_tpu/ops/noise.py``: seeded complex white
Gaussian noise with per-component std ``sqrt(power)``, the single-scale
convention (complex noise power ``2 * power``) of every sampler here,
``apply`` included (the reference's ``apply`` alone scales a second time;
neither package copies that).

The JAX package's counter-based keys become ``torch.Generator`` objects:
a fixed ``(power, seed)`` and call sequence gives the same noise on one
device, but the streams are neither threefry's nor equal between a CPU and
a CUDA generator of the same seed. Compare them by statistics, never
sample by sample. A generator argument is a ``torch.Generator`` on the
device the noise is made on, or an integer seed for a new one.
"""

from __future__ import annotations

import numpy as np
import torch

from ..types import as_cf32, stage_device

DEFAULT_RNG_SEED = 815  # reference src/noise.rs:6


def make_generator(generator, device) -> torch.Generator:
    """``generator`` as a ``torch.Generator`` on ``device``: an integer seeds
    a new one there; a generator is returned as it is (its device must be
    ``device``: ``torch`` raises where it is not)."""
    if isinstance(generator, torch.Generator):
        return generator
    return torch.Generator(device=torch.device(device)).manual_seed(int(generator))


def awgn(generator, shape, power=1.0, device="cuda") -> torch.Tensor:
    """Complex AWGN block of ``shape`` on ``device``: each component ~
    ``N(0, power)``. ``power`` is a float or a scalar tensor."""
    dev = stage_device(device, "awgn")
    g = make_generator(generator, dev)
    if isinstance(shape, int):
        shape = (shape,)
    if isinstance(power, torch.Tensor):
        scale = power.to(device=dev, dtype=torch.float32).sqrt()
    else:  # sqrt of the float32 power, as the JAX package takes it
        scale = float(np.sqrt(np.float32(power)))
    ri = torch.randn(tuple(shape) + (2,), generator=g, dtype=torch.float32, device=dev)
    return torch.view_as_complex(ri) * scale


def apply(generator, signal, power=1.0, device=None) -> torch.Tensor:
    """``signal + awgn(generator, signal.shape, power)``, on ``device``
    (None: the signal's device when it is a tensor, else the card)."""
    if device is None:
        device = signal.device if isinstance(signal, torch.Tensor) else "cuda"
    dev = stage_device(device, "noise.apply")
    signal = as_cf32(signal, device=dev)
    return signal + awgn(generator, signal.shape, power, dev)


class Awgn:
    """Stateful AWGN generator with the reference's object API. It owns a
    ``torch.Generator`` on ``device`` seeded by ``seed``; each call draws
    the next samples of its stream. ``device`` defaults to the card
    (``"cuda"`` without CUDA raises); signals are moved there."""

    def __init__(self, power: float = 1.0, seed: int = DEFAULT_RNG_SEED, device="cuda"):
        self.power = float(power)
        self.device = stage_device(device, "Awgn")
        self._gen = make_generator(seed, self.device)

    def set_power(self, power: float) -> None:
        """Change the noise power (reference src/noise.rs:47-50)."""
        self.power = float(power)

    def next_block(self, shape) -> torch.Tensor:
        """A block of noise samples (vectorised ``next()`` / ``NoiseIter``)."""
        return awgn(self._gen, shape, self.power, self.device)

    def apply(self, signal) -> torch.Tensor:
        """Overlay the signal with noise (single-scale convention)."""
        return apply(self._gen, signal, self.power, self.device)

    def fill(self, n: int) -> torch.Tensor:
        """A length-``n`` noise vector (reference ``fill``, src/noise.rs:62-66)."""
        return self.next_block((int(n),))

    def iter(self, block: int = 4096):
        """Endless generator of ``block``-sample noise blocks (the block form
        of the reference's per-sample ``NoiseIter``, src/noise.rs:68-85)."""
        while True:
            yield self.next_block((int(block),))


def generator(device="cuda") -> Awgn:
    """Default AWGN generator: power 1, seed 815 (reference src/noise.rs:8-11)."""
    return Awgn(1.0, DEFAULT_RNG_SEED, device)


def new(power: float, seed: int, device="cuda") -> Awgn:
    """AWGN generator with the given power and seed (reference src/noise.rs:14-16)."""
    return Awgn(power, seed, device)
