"""Frequency-hopping spread spectrum (FHSS) (PyTorch).

Counterpart of ``aether_primitives_tpu/models/fhss.py``: the hop/dehop pair
of a synchronized slow-FHSS link. The baseband signal is carved into hop
dwells and each dwell mixed to its channel by a per-dwell complex rotator,
one batched elementwise pass on the input's device. The hop pattern comes
from :func:`~..ops.sequence.lte_gold`, so TX and RX regenerate it from a
shared seed. The rotators are computed in float64 on the host, as in the
JAX package, and kept on each device they were used on (a few per
configuration), so a call does not copy them from the host again.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..ops import sequence as _seq
from ..types import as_cf32, cf32

__all__ = ["FhssConfig", "hop_sequence", "hop_spread", "hop_despread"]


@dataclass(frozen=True)
class FhssConfig:
    n_channels: int = 16
    dwell: int = 256  # samples per hop
    cinit: int = 0x7E57  # PN seed shared by TX and RX
    spacing: float = 0.0  # channel spacing in cycles/sample; 0 = 1/n_channels

    @property
    def channel_spacing(self) -> float:
        return self.spacing if self.spacing > 0 else 1.0 / self.n_channels


def hop_sequence(cfg: FhssConfig, n_hops: int) -> np.ndarray:
    """Channel index per dwell from the shared Gold-sequence PN: ``ceil
    log2(n_channels)`` bits per hop, wrapped into range (host numpy)."""
    bits_per = max(1, int(np.ceil(np.log2(cfg.n_channels))))
    bits = np.asarray(_seq.lte_gold(cfg.cinit, n_hops * bits_per)).astype(np.int64)
    weights = 2 ** np.arange(bits_per)
    idx = bits.reshape(n_hops, bits_per) @ weights
    return (idx % cfg.n_channels).astype(np.int64)


def _dwell_rotators(cfg: FhssConfig, n_hops: int, conj: bool) -> np.ndarray:
    """[n_hops, dwell] complex rotators e^{+-2 pi i f_h n} (host float64:
    exact per-dwell phase; the dwell-start phase resets each hop)."""
    seq = hop_sequence(cfg, n_hops)
    # channels centered around 0: index c -> (c - (N-1)/2) * spacing
    f = (seq - (cfg.n_channels - 1) / 2.0) * cfg.channel_spacing
    n = np.arange(cfg.dwell, dtype=np.float64)
    ang = 2.0 * np.pi * f[:, None] * n[None, :]
    if conj:
        ang = -ang
    return np.exp(1j * ang).astype(np.complex64)


@functools.lru_cache(maxsize=8)
def _device_rotators(cfg: FhssConfig, n_hops: int, conj: bool, device: str) -> torch.Tensor:
    """:func:`_dwell_rotators` on ``device``, made once per key (callers
    only read it)."""
    return torch.from_numpy(_dwell_rotators(cfg, n_hops, conj)).to(device)


def _hop(x, cfg: FhssConfig, conj: bool) -> torch.Tensor:
    x = as_cf32(x)
    n = int(x.shape[-1])
    if n % cfg.dwell:
        raise ValueError(f"length {n} must be a multiple of the dwell {cfg.dwell}")
    n_hops = n // cfg.dwell
    rot = _device_rotators(cfg, n_hops, conj, str(x.device))
    xb = x.reshape(x.shape[:-1] + (n_hops, cfg.dwell))
    return (xb * rot).reshape(x.shape).to(cf32)


def hop_spread(x, cfg: FhssConfig) -> torch.Tensor:
    """TX hop: ``[..., n]`` baseband (``n % dwell == 0``) -> the hopped
    signal at the same rate."""
    return _hop(x, cfg, conj=False)


def hop_despread(y, cfg: FhssConfig) -> torch.Tensor:
    """RX dehop (synchronized): conjugate per-dwell rotators."""
    return _hop(y, cfg, conj=True)
