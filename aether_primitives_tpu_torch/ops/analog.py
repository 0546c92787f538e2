"""Analog modes: FM, AM and SSB modulation and demodulation (PyTorch).

Counterpart of ``aether_primitives_tpu/ops/analog.py``: elementwise and
shift math on complex baseband blocks, batched over leading axes, on the
input's device. Frequencies are normalized to cycles/sample; modulation
index and deviation are in the same unit.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..types import as_cf32
from . import fft as _fft
from . import frontend as _fe

_FM_BLOCK = 1024  # the phase accumulator's block


def _real(x, device=None) -> torch.Tensor:
    """A real message (array-like or tensor, which keeps its device) as
    float32."""
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _cumsum(x: torch.Tensor) -> torch.Tensor:
    """Float32 cumulative sum over the last axis, accumulated in float64 and
    each output rounded once: what ``torch.cumsum`` does on the CPU, here on
    every device (a float32 scan on the card rounds its partial sums)."""
    return torch.cumsum(x, dim=-1, dtype=torch.float64).to(torch.float32)


def fm_mod(msg, deviation: float, phase0: float = 0.0) -> torch.Tensor:
    """Frequency-modulate a real message onto complex baseband:
    ``y[n] = exp(j (phase0 + 2 pi deviation cumsum(msg)[n]))``.

    ``msg`` is scaled to [-1, 1]; ``deviation`` is the peak swing in
    cycles/sample. The phase accumulator is block-modular: a float32
    cumulative sum over a whole block would reach ~2e5 cycles after 1M
    samples and lose the fractional phase, so the sum runs within
    1,024-sample blocks, the block totals are reduced mod 1 cycle before
    the sum across blocks, and the two add back mod 1.
    """
    m = _real(msg)
    inc = float(np.float32(deviation)) * m
    n = inc.shape[-1]
    blk = _FM_BLOCK
    if n <= blk:
        cycles = _cumsum(inc)
    else:
        npad = -(-n // blk) * blk
        if npad != n:
            inc = torch.nn.functional.pad(inc, (0, npad - n))
        b = inc.reshape(inc.shape[:-1] + (npad // blk, blk))
        local = _cumsum(b)  # bounded: <= blk * max|inc|
        totals = torch.remainder(local[..., -1], 1.0)  # mod before accumulating
        offs = _cumsum(totals) - totals  # exclusive prefix
        cycles = (local + torch.remainder(offs, 1.0)[..., None]).reshape(
            inc.shape[:-1] + (npad,))[..., :n]
    cycles = cycles + float(np.float32(phase0 / (2.0 * np.pi)))
    ang = float(2.0 * np.float32(np.pi)) * torch.remainder(cycles, 1.0)
    return torch.complex(torch.cos(ang), torch.sin(ang))


def fm_demod(x, deviation: float = 1.0) -> torch.Tensor:
    """Quadrature FM discriminator: ``m[n] = angle(x[n] conj(x[n-1])) /
    (2 pi deviation)``, float32, the shape of ``x``; ``m[0]`` takes its step
    from ``1+0j``."""
    x = as_cf32(x)
    prev = torch.cat([torch.ones(x.shape[:-1] + (1,), dtype=x.dtype, device=x.device),
                      x[..., :-1]], dim=-1)
    d = x * prev.conj()
    scale = float(np.float32(2.0 * np.float32(np.pi) * np.float32(deviation)))
    return torch.atan2(d.imag, d.real) / scale


def am_mod(msg, depth: float = 0.5, carrier_freq: float = 0.0) -> torch.Tensor:
    """Amplitude-modulate a real message (scaled to [-1, 1]): ``y = (1 +
    depth msg) e^{j 2 pi f n}``, DSB with carrier at complex baseband;
    ``carrier_freq = 0`` leaves it at DC."""
    m = _real(msg)
    env = 1.0 + float(np.float32(depth)) * m
    base = torch.complex(env, torch.zeros_like(env))
    if carrier_freq == 0.0:
        return base
    return _fe.nco_mix(base, carrier_freq)


def am_demod(x, depth: float = 0.5) -> torch.Tensor:
    """Envelope AM detector: ``m = (|x| - mean|x|) / (depth mean|x|)``
    (float32; the mean estimates the carrier level of a zero-mean
    message)."""
    x = as_cf32(x)
    env = torch.sqrt(x.real ** 2 + x.imag ** 2)
    c = env.mean(dim=-1, keepdim=True)
    return (env - c) / (float(np.float32(depth)) * c)


def analytic_signal(x, fft_backend: Optional[str] = None) -> torch.Tensor:
    """Analytic signal of a real block: the negative half of the spectrum
    zeroed, the positive half doubled (DC and Nyquist kept), one forward and
    one backward FFT. ``imag(out)`` is the Hilbert transform of ``x``.
    Exact for block-periodic content. ``fft_backend``: see
    :func:`~aether_primitives_tpu_torch.ops.fft.check_backend`."""
    xr = _real(x)
    n = xr.shape[-1]
    plan = _fft.plan(n, fft_backend)
    spec = plan.fwd(torch.complex(xr, torch.zeros_like(xr)), _fft.Scale.NONE)
    gain = torch.zeros(n, dtype=torch.float32, device=xr.device)
    gain[0] = 1.0
    if n % 2 == 0:
        gain[n // 2] = 1.0
        gain[1:n // 2] = 2.0
    else:
        gain[1:(n + 1) // 2] = 2.0
    return plan.bwd(spec * gain, _fft.Scale.N)


def ssb_modulate(msg, carrier_freq: float, sideband: str = "upper",
                 fft_backend: Optional[str] = None) -> torch.Tensor:
    """Single-sideband modulation (the phasing method, block form): the
    message's analytic signal (conjugated for the lower sideband) mixed to
    ``carrier_freq``."""
    a = analytic_signal(msg, fft_backend)
    if sideband == "lower":
        a = a.conj().resolve_conj()
    elif sideband != "upper":
        raise ValueError("sideband must be 'upper' or 'lower'")
    if carrier_freq == 0.0:
        return a
    return _fe.nco_mix(a, float(carrier_freq))


def ssb_demodulate(x, carrier_freq: float, sideband: str = "upper",
                   fft_backend: Optional[str] = None) -> torch.Tensor:
    """SSB product detector: the sideband mixed back to DC, the real part
    taken (float32). The inverse of :func:`ssb_modulate` for a real
    message. ``fft_backend`` is checked, as in the JAX package's signature."""
    _fft.check_backend(fft_backend)
    x = as_cf32(x)
    if carrier_freq != 0.0:
        x = _fe.nco_mix(x, -float(carrier_freq))
    if sideband == "lower":
        x = x.conj()
    return x.real.contiguous()
