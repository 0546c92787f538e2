"""Channel simulation: composable RF impairments for link testing (PyTorch).

Counterpart of ``aether_primitives_tpu/models/channel.py``. Every
impairment is a function on ``[..., n]`` complex64 tensors, batched over
leading axes, computed where the tensor lies:

- :func:`delay_pad`: a burst placed at an offset inside a zero capture;
- :func:`multipath`: static FIR channel (causal linear convolution);
- :func:`rayleigh_block`: iid block fading (one CN(0, 1) gain a block);
- :func:`jakes`: flat Rayleigh fading with the Clarke/Jakes Doppler
  spectrum, by a sum of sinusoids;
- :func:`cfo` / :func:`phase_noise`: carrier rotation / Wiener phase walk;
- :func:`iq_imbalance` / :func:`dc_offset`: front-end impairments;
- :func:`pa_saturate`: Rapp-model power-amplifier compression;
- :class:`Channel`: a :class:`ChannelConfig` composition of them, ending in
  AWGN.

The keyed impairments (:func:`rayleigh_block`, :func:`jakes`,
:func:`phase_noise`, the AWGN) take a ``torch.Generator`` on the tensor's
device, or an integer seed, where the JAX package takes a key: their
streams differ from threefry's, so they agree with it in statistics, not
samples (:mod:`~aether_primitives_tpu_torch.ops.noise`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops import fir as _fir
from ..ops import noise as _noise
from ..types import as_cf32, stage_device


def delay_pad(x, offset: int, total_len: int) -> torch.Tensor:
    """Place a burst at ``offset`` inside a zero capture of ``total_len``
    samples. As the JAX package's ``dynamic_update_slice``, a negative
    offset counts from the end (``offset + total_len``), and the offset is
    then clamped to ``[0, total_len - n]``; a burst longer than the capture
    raises."""
    x = as_cf32(x)
    n, total_len = x.shape[-1], int(total_len)
    if n > total_len:
        raise ValueError(f"burst of {n} samples longer than the capture ({total_len})")
    offset = int(offset)
    if offset < 0:
        offset += total_len
    offset = min(max(offset, 0), total_len - n)
    cap = torch.zeros(x.shape[:-1] + (total_len,), dtype=x.dtype, device=x.device)
    cap[..., offset:offset + n] = x
    return cap


def multipath(x, taps) -> torch.Tensor:
    """Static multipath: causal linear convolution with complex channel
    taps, output as long as ``x`` (later echoes spill off the end)."""
    return _fir.fir_filter(as_cf32(x), np.asarray(taps, dtype=np.complex64))


def rayleigh_block(generator, x, block_len: int) -> torch.Tensor:
    """IID block fading: one CN(0, 1) gain per ``block_len`` samples,
    constant within a block and independent across blocks. The length must
    divide by ``block_len``."""
    x = as_cf32(x)
    n = x.shape[-1]
    if n % block_len:
        raise ValueError(f"length {n} not divisible by block_len {block_len}")
    nb = n // block_len
    g = _noise.make_generator(generator, x.device)
    ri = torch.randn(x.shape[:-1] + (nb, 2), generator=g, dtype=torch.float32,
                     device=x.device)
    gain = torch.view_as_complex(ri) / math.sqrt(2.0)
    frames = x.reshape(x.shape[:-1] + (nb, block_len))
    return (frames * gain[..., None]).reshape(x.shape)


def jakes(generator, n: int, doppler: float, n_paths: int = 32, device="cuda") -> torch.Tensor:
    """Time-varying flat Rayleigh fading with the Clarke/Jakes Doppler
    spectrum: ``h[t] = (1/sqrt(M)) sum_m e^{j(2 pi f_d cos(a_m) t + phi_m)}``
    with uniform arrival angles and phases (unit mean power, envelope
    Rayleigh, autocorrelation ``J0(2 pi f_d tau)`` as M grows). ``doppler``
    in cycles/sample. ``n`` samples on ``device``."""
    dev = stage_device(device, "jakes")
    g = _noise.make_generator(generator, dev)
    two_pi = 2.0 * np.pi
    alpha = torch.rand(n_paths, generator=g, dtype=torch.float32, device=dev) * two_pi
    phi = torch.rand(n_paths, generator=g, dtype=torch.float32, device=dev) * two_pi
    t = torch.arange(n, dtype=torch.float32, device=dev)
    ang = 2.0 * math.pi * doppler * torch.cos(alpha)[:, None] * t[None, :] + phi[:, None]
    h = torch.complex(torch.cos(ang), torch.sin(ang)).sum(dim=0)
    return h / math.sqrt(n_paths)


def cfo(x, cycles_per_sample: float, phase0: float = 0.0) -> torch.Tensor:
    """Carrier frequency offset: rotate by ``e^{j(2 pi f n + phase0)}`` (the
    angle in float32, as the JAX package takes it)."""
    x = as_cf32(x)
    n = torch.arange(x.shape[-1], dtype=torch.float32, device=x.device)
    ang = 2.0 * math.pi * cycles_per_sample * n + phase0
    return x * torch.complex(torch.cos(ang), torch.sin(ang))


def phase_noise(generator, x, linewidth: float) -> torch.Tensor:
    """Wiener (random-walk) oscillator phase noise: per-sample phase
    increments ``N(0, 2 pi linewidth)``, ``linewidth`` the normalised 3-dB
    linewidth in cycles/sample; one cumsum."""
    x = as_cf32(x)
    g = _noise.make_generator(generator, x.device)
    dphi = torch.randn(x.shape, generator=g, dtype=torch.float32, device=x.device) * float(
        np.sqrt(np.float32(2.0 * np.pi * linewidth)))
    walk = torch.cumsum(dphi, dim=-1)
    return x * torch.complex(torch.cos(walk), torch.sin(walk))


def iq_imbalance(x, amp_db: float = 0.0, phase_deg: float = 0.0) -> torch.Tensor:
    """Receiver IQ imbalance on the rails: ``I' = I``, ``Q' = g (Q cos(e) -
    I sin(e))`` with ``g = 10^(amp_db/20)``, ``e = phase_deg`` in radians."""
    x = as_cf32(x)
    g = 10.0 ** (amp_db / 20.0)
    e = np.deg2rad(phase_deg)
    i, q = x.real, x.imag
    q2 = g * (q * float(np.cos(e)) - i * float(np.sin(e)))
    return torch.complex(i, q2)


def dc_offset(x, offset: complex) -> torch.Tensor:
    """Additive LO-leakage DC term."""
    x = as_cf32(x)
    return x + complex(np.complex64(offset))


def pa_saturate(x, sat_level: float = 1.0, p: float = 2.0) -> torch.Tensor:
    """Rapp solid-state PA model: AM/AM compression ``|y| = |x| / (1 +
    (|x|/A)^{2p})^{1/(2p)}``, phase preserved (``p -> inf`` is a hard
    limiter; ``p ~ 2`` a typical SSPA)."""
    x = as_cf32(x)
    mag = x.abs()
    comp = (1.0 + (mag / sat_level) ** (2.0 * p)) ** (1.0 / (2.0 * p))
    return x / torch.clamp(comp, min=1e-30)


@dataclass(frozen=True)
class ChannelConfig:
    """Composition order: PA -> multipath -> fading -> delay -> CFO ->
    phase noise -> IQ imbalance -> DC -> AWGN (TX impairments first, then
    propagation, then the RX front end)."""

    taps: Optional[Tuple[complex, ...]] = None
    doppler: float = 0.0  # Jakes fading when > 0 (cycles/sample)
    delay: int = 0
    capture_len: Optional[int] = None  # None: len(x) + delay
    cfo: float = 0.0
    phase0: float = 0.0
    linewidth: float = 0.0  # Wiener phase noise
    iq_amp_db: float = 0.0
    iq_phase_deg: float = 0.0
    dc: complex = 0j
    sat_level: float = 0.0  # 0: no PA model
    noise_power: float = 0.0


class Channel:
    """Config-driven impairment chain: ``Channel(cfg).apply(generator, x)``
    on ``device`` (the card by default; ``"cuda"`` without CUDA raises).
    The keyed stages draw from ``generator`` (a ``torch.Generator`` on that
    device, or a seed) in the order fading, phase noise, AWGN."""

    def __init__(self, config: ChannelConfig = ChannelConfig(), device="cuda"):
        self.config = config
        self.device = stage_device(device, "Channel")

    def apply(self, generator, x) -> torch.Tensor:
        c = self.config
        x = as_cf32(x, device=self.device)
        g = _noise.make_generator(generator, self.device)
        if c.sat_level > 0.0:
            x = pa_saturate(x, c.sat_level)
        if c.taps is not None:
            x = multipath(x, np.asarray(c.taps, np.complex64))
        if c.doppler > 0.0:
            x = x * jakes(g, x.shape[-1], c.doppler, device=self.device)
        total = c.capture_len or (x.shape[-1] + c.delay)
        if c.delay or c.capture_len:
            x = delay_pad(x, c.delay, total)
        if c.cfo or c.phase0:
            x = cfo(x, c.cfo, c.phase0)
        if c.linewidth > 0.0:
            x = phase_noise(g, x, c.linewidth)
        if c.iq_amp_db or c.iq_phase_deg:
            x = iq_imbalance(x, c.iq_amp_db, c.iq_phase_deg)
        if c.dc:
            x = dc_offset(x, c.dc)
        if c.noise_power > 0.0:
            x = _noise.apply(g, x, c.noise_power, self.device)
        return x
