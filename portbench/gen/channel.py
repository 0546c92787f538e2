"""The capture channel of a burst: each capture of ``window`` samples holds
one burst at a uniform offset, turned by a uniform carrier offset and a
unit-magnitude gain of uniform phase, in complex AWGN everywhere.

A plain-PyTorch rewrite of the pattern of ``benches/burst_bench.py``'s
``_channel``. Every draw comes from one ``torch.Generator`` on the
device, in a fixed order, so a seed fixes the captures.
"""

from __future__ import annotations

import math

import torch


def noise_sigma(ebn0_db: float, info_bits: int, coded_bits: int, bits_per_symbol: int,
                symbol_energy: float) -> float:
    """Per-component noise deviation for ``ebn0_db`` per information bit:
    ``Es/N0 = Eb/N0 * bits_per_symbol * info_bits / coded_bits``."""
    esn0 = 10.0 ** (ebn0_db / 10.0) * bits_per_symbol * info_bits / coded_bits
    return math.sqrt(symbol_energy / esn0 / 2.0)


def captures(bursts: torch.Tensor, window: int, sigma: float, max_cfo: float,
             gen: torch.Generator):
    """``bursts [B, L]`` -> complex64 captures ``[B, window]`` and the
    truth ``{"offset", "cfo", "phase"}`` (on the bursts' device)."""
    b, length = bursts.shape
    dev = bursts.device
    offset = torch.randint(0, window - length + 1, (b,), generator=gen, device=dev)
    cfo = (torch.rand(b, generator=gen, device=dev, dtype=torch.float64) * 2 - 1) * max_cfo
    phase = torch.rand(b, generator=gen, device=dev, dtype=torch.float64) * 2 * math.pi
    noise = torch.randn(b, window, 2, generator=gen, device=dev, dtype=torch.float32) * sigma
    x = torch.zeros(b, window, dtype=torch.complex128, device=dev)
    x.scatter_(1, offset[:, None] + torch.arange(length, device=dev), bursts.to(torch.complex128))
    n = torch.arange(window, device=dev, dtype=torch.float64)
    x = x * torch.polar(torch.ones_like(n), 2 * math.pi * cfo[:, None] * n + phase[:, None])
    x = x.to(torch.complex64) + torch.view_as_complex(noise)
    return x, {"offset": offset, "cfo": cfo, "phase": phase}
