"""Resampling: interpolation, decimation, FFT and polyphase resamplers,
fractional delay (PyTorch).

Counterpart of ``aether_primitives_tpu/ops/sampling.py``, every function
batched over leading axes and computed where its tensor lies. The JAX
package's ``dense=`` option picks a TPU realisation (chunked one-hot and
interpolation-operator matmuls, because strided slices and small minor
axes are slow there); it is accepted and ignored here, where the strided
slice and the broadcast are the plain forms. The output does not depend
on it.

Kept from the JAX package: its fix of the reference's ``interpolate``,
whose imaginary ramp starts from the *real* base value (reference
src/sampling.rs:19); here the imaginary part is interpolated from the
imaginary base.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from ..types import as_cf32
from . import fft as _fft
from . import fir as _fir
from .fft import Scale


def interpolate(src, n_between: int, dense: Optional[bool] = None) -> torch.Tensor:
    """Linearly interpolate ``n_between`` samples between consecutive pairs:
    output length ``n + (n - 1) * n_between`` (each of the ``n - 1``
    intervals gives ``n_between + 1`` points, then the last sample).
    ``dense`` is accepted and ignored (module docstring)."""
    src = as_cf32(src)
    n = src.shape[-1]
    if n < 2:
        return src
    x1 = src[..., :-1]
    rate = (src[..., 1:] - x1) * float(np.float32(1.0 / (n_between + 1)))
    i = torch.arange(n_between + 1, dtype=torch.float32, device=src.device)
    seg = x1[..., :, None] + i * rate[..., :, None]  # [..., n-1, n_between+1]
    flat = seg.reshape(src.shape[:-1] + ((n - 1) * (n_between + 1),))
    return torch.cat([flat, src[..., -1:]], dim=-1)


def downsample(src, out_len: int, dense: Optional[bool] = None) -> torch.Tensor:
    """Integer decimation without a filter: every ``(n / out_len)``-th sample
    from 0 (the reference's ``downsample``, src/sampling.rs:28-42; ``n %
    out_len == 0`` required). Returns a new tensor, not a view. ``dense`` is
    accepted and ignored."""
    src = torch.as_tensor(src)
    n = src.shape[-1]
    out_len = int(out_len)
    if n % out_len != 0:
        raise ValueError(f"Only even decimations are supported ({n} % {out_len} != 0)")
    dec = n // out_len
    if dec == 1:
        return src
    return src[..., ::dec].contiguous()


def downsample_by(src, factor: int, dense: Optional[bool] = None) -> torch.Tensor:
    """Decimate by an explicit integer factor (:func:`downsample`)."""
    factor = int(factor)
    n = torch.as_tensor(src).shape[-1]
    if n % factor != 0:
        raise ValueError("Input length must be divisible by the decimation factor")
    return downsample(src, n // factor, dense=dense)


def resample_fft(src, out_len: int, fft_backend=None) -> torch.Tensor:
    """Bandlimited resampling to ``out_len`` samples in the frequency
    domain: the spectrum zero-padded (upsampling; an even input's Nyquist
    bin split between +/- frequencies) or truncated (downsampling; an even
    output's Nyquist bin the sum of the two edge bins, scipy's convention),
    amplitude kept. ``fft_backend``: see
    :func:`~aether_primitives_tpu_torch.ops.fft.check_backend`."""
    src = as_cf32(src)
    n = src.shape[-1]
    out_len = int(out_len)
    if out_len == n:
        return src
    spec = _fft.plan(n, fft_backend).fwd(src, Scale.NONE)
    batch = src.shape[:-1]

    def zeros(m):
        return torch.zeros(batch + (m,), dtype=spec.dtype, device=spec.device)

    if out_len > n:
        if n % 2 == 0:
            h = n // 2
            ny = 0.5 * spec[..., h:h + 1]
            parts = [spec[..., :h], ny, zeros(out_len - n - 1), ny, spec[..., h + 1:]]
        else:
            h = (n + 1) // 2
            parts = [spec[..., :h], zeros(out_len - n), spec[..., h:]]
    else:
        if out_len % 2 == 0:
            h = out_len // 2
            ny = spec[..., h:h + 1] + spec[..., n - h:n - h + 1]
            parts = [spec[..., :h], ny, spec[..., n - h + 1:]]
        else:
            h = (out_len + 1) // 2
            parts = [spec[..., :h], spec[..., n - (out_len - h):]]
    y = _fft.plan(out_len, fft_backend).bwd(torch.cat(parts, dim=-1), Scale.N)
    return y * float(np.float32(out_len) / np.float32(n))


@functools.lru_cache(maxsize=None)
def _farrow_matrix(p: int, q: int) -> np.ndarray:
    """``[q+3, p]`` cubic-Lagrange resampling operator for one period.

    Output phase ``j`` of each period sits at input position
    ``t_j = j*q/p = n_j + mu_j``; column ``j`` holds the 4 Lagrange weights
    of ``x[n_j - 1 .. n_j + 2]`` at fraction ``mu_j`` (f64 design). A
    period consumes ``q`` inputs and produces ``p`` outputs; the operator
    contracts an input window of ``q + 3`` samples (1 left + 2 right
    neighbors)."""
    m = np.zeros((q + 3, p), np.float64)
    for j in range(p):
        t = j * q / p
        n = int(np.floor(t))
        mu = t - n
        # cubic Lagrange weights at points (-1, 0, 1, 2)
        w = np.array([
            -mu * (mu - 1) * (mu - 2) / 6.0,
            (mu + 1) * (mu - 1) * (mu - 2) / 2.0,
            -(mu + 1) * mu * (mu - 2) / 2.0,
            (mu + 1) * mu * (mu - 1) / 6.0,
        ])
        m[n : n + 4, j] = w  # rows are x[n-1 .. n+2] shifted by the +1 halo
    return m.astype(np.float32)


def resample_poly(src, p: int, q: int) -> torch.Tensor:
    """Rational resampling by ``p/q`` with cubic (Farrow-style) Lagrange
    interpolation: each period of ``q`` inputs, extended by 1 left and 2
    right neighbours (zeros at the edges), times the ``[q+3, p]`` operator
    :func:`_farrow_matrix` gives ``p`` outputs. Output length ``n p / q``
    (``n`` must divide by ``q`` after ``p/q`` is reduced)."""
    src = as_cf32(src)
    p, q = int(p), int(q)
    g = int(np.gcd(p, q))
    p //= g
    q //= g
    if p == q:
        return src
    n = src.shape[-1]
    if n % q:
        raise ValueError(f"input length {n} must be divisible by q = {q}")
    nper = n // q
    xp = torch.nn.functional.pad(src, (1, 2))
    idx = (torch.arange(nper, device=src.device)[:, None] * q
           + torch.arange(q + 3, device=src.device))
    win = xp[..., idx]  # [..., nper, q+3]
    m = torch.from_numpy(_farrow_matrix(p, q)).to(device=src.device, dtype=src.dtype)
    return torch.matmul(win, m).reshape(src.shape[:-1] + (nper * p,))


def fractional_delay(src, tau, fft_backend=None) -> torch.Tensor:
    """Delay by ``tau`` samples (any real value, a float or a tensor of the
    batch shape) through the spectral phase ramp ``e^{-j 2 pi f tau}``;
    circular (the last ``ceil(|tau|)`` samples wrap). A host ``tau`` takes a
    float64 ramp; a tensor ``tau`` a float32 one on its device."""
    src = as_cf32(src)
    n = src.shape[-1]
    freqs = np.fft.fftfreq(n)
    if isinstance(tau, (int, float, np.floating, np.integer)):
        ramp = torch.from_numpy(
            np.exp(-2j * np.pi * freqs * float(tau)).astype(np.complex64)).to(src.device)
    else:
        t = torch.as_tensor(tau, dtype=torch.float32, device=src.device)
        f32 = torch.from_numpy(freqs.astype(np.float32)).to(src.device)
        ang = -2.0 * float(np.float32(np.pi)) * f32 * t[..., None]
        ramp = torch.complex(torch.cos(ang), torch.sin(ang))
    plan = _fft.plan(n, fft_backend)
    return plan.bwd(plan.fwd(src, Scale.NONE) * ramp, Scale.N)


def decimate(src, factor: int, cutoff: float = 0.8, atten_db: float = 60.0,
             fft_backend=None) -> torch.Tensor:
    """Anti-aliased decimation: a Kaiser lowpass (:func:`_decimate_taps`)
    with its passband edge at ``cutoff`` of the output Nyquist, through the
    decimating overlap-save FIR
    :func:`~aether_primitives_tpu_torch.ops.fir.fir_filter_os_decimate`
    (causal: the group delay is not compensated)."""
    factor = int(factor)
    if factor < 1:
        raise ValueError("factor must be >= 1")
    src = as_cf32(src)
    if factor == 1:
        return src
    if not (0.0 < cutoff < 1.0):
        raise ValueError("cutoff must be in (0, 1) of the output Nyquist")
    taps = _decimate_taps(factor, float(cutoff), float(atten_db))
    return _fir.fir_filter_os_decimate(src, taps, factor, fft_backend=fft_backend)


@functools.lru_cache(maxsize=None)
def _decimate_taps(factor: int, cutoff: float, atten_db: float) -> np.ndarray:
    """The JAX package's design: a Kaiser lowpass centred in the transition
    band from ``cutoff`` of the output Nyquist to that Nyquist (float32)."""
    from .firdes import kaiser_lowpass

    out_nyq = 0.5 / factor
    edge = cutoff * out_nyq
    width = out_nyq - edge
    return kaiser_lowpass(edge + width / 2.0, width, atten_db).astype(np.float32)
