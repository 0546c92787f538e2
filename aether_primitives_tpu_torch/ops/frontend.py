"""Receiver front end: the NCO mixer and the conditioning stages.

Counterpart of ``aether_primitives_tpu/ops/frontend.py``: the numerically
controlled oscillator (:func:`nco_mix`, :func:`next_phase`), DC removal
(:func:`dc_offset`, :func:`remove_dc`), IQ imbalance (:func:`apply_iq_imbalance`,
the blind :func:`estimate_iq_imbalance`, :func:`correct_iq_imbalance`,
:func:`image_rejection_db`), the M2M4 SNR estimate, the block AGC
(:func:`agc`) and :func:`normalize_rms`, the impulse blanker and the power
squelch. Frequencies are in cycles/sample (normalized to the sample rate),
phases in radians. Every function is batched over leading axes (except the
1-D :func:`agc`) and runs on its input's device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..types import as_cf32, cf32
from ._stats import median_midpoint

_NCO_BLOCK = 1024  # index-split size for the exact-mod phase tables


def _is_concrete(v) -> bool:
    """True when ``v`` is host data (python/numpy scalars or arrays): exact
    float64 values for the phase tables."""
    return isinstance(v, (int, float, np.floating, np.integer, np.ndarray, list, tuple))


def _host_f64(v, device) -> torch.Tensor:
    """A host scalar or array as a float64 tensor on ``device``: a scalar is
    created there from a Python float (no copy), an array is uploaded."""
    a = np.asarray(v, np.float64)
    if a.ndim == 0:
        return torch.full((), float(a), dtype=torch.float64, device=device)
    return torch.from_numpy(a).to(device)


def nco_mix(x, freq, phase0=0.0) -> torch.Tensor:
    """Mix ``x`` with an oscillator: ``y[n] = x[n] * e^{j*(2*pi*freq*n +
    phase0)}``, batched over leading axes; a per-row ``freq`` broadcasts
    against the sample index.

    A float32 ramp ``f*n`` loses about ``log2(n)`` bits before the mod: at
    4M samples the phase error reaches whole cycles. So when ``freq`` and
    ``phase0`` are host values (the usual case) the cycle ramp is built from
    two small float64-exact mod-1 tables over the index split ``n = q*B +
    r``::

        cycles[n] = hi[q] + lo[r],   hi[q] = (f*B*q + p0) mod 1,
                                     lo[r] = (f*r) mod 1

    whose rotators (``e^{2 pi i hi}`` and ``e^{2 pi i lo}``, exact to
    float32) multiply as an outer product. The tables are computed in
    float64 on ``x``'s device, so a scalar frequency uploads nothing (an
    upload from pageable memory would synchronise the stream on every
    block). A tensor ``freq`` (or ``phase0``) takes the direct float32 ramp
    instead: fine for short blocks only.

    For streaming continuity carry ``phase0' = next_phase(n, freq,
    phase0)`` into the next call.

    >>> import numpy as np
    >>> y = nco_mix(np.ones(4, np.complex64), 0.25).numpy()
    >>> bool(np.allclose(y, [1, 1j, -1, -1j], atol=1e-6))
    True
    >>> float(next_phase(4, 0.25))  # a whole number of cycles -> phase 0
    0.0
    """
    x = as_cf32(x)
    n = x.shape[-1]
    two_pi = 2.0 * np.float32(np.pi)
    if _is_concrete(freq) and _is_concrete(phase0):
        f, p0 = (_host_f64(v, x.device) for v in (freq, np.asarray(phase0) / (2.0 * np.pi)))
        b = _NCO_BLOCK
        nq = -(-n // b)
        q = torch.arange(nq, dtype=torch.float64, device=x.device)
        r = torch.arange(b, dtype=torch.float64, device=x.device)
        hi = torch.remainder(f[..., None] * (b * q) + p0[..., None], 1.0)  # [..., nq]
        lo = torch.remainder(f[..., None] * r, 1.0)  # [..., b]
        rot_hi = torch.exp((2j * np.pi) * hi).to(torch.complex64)
        rot_lo = torch.exp((2j * np.pi) * lo).to(torch.complex64)
        rot = (rot_hi[..., :, None] * rot_lo[..., None, :]).reshape(
            hi.shape[:-1] + (nq * b,)
        )[..., :n]
        return x * rot
    nn = torch.arange(n, dtype=torch.float32, device=x.device)
    f = torch.as_tensor(freq, dtype=torch.float32, device=x.device)
    if f.ndim:
        f = f[..., None]
    p0 = torch.as_tensor(phase0, dtype=torch.float32, device=x.device)
    cycles = f * nn + p0 / float(two_pi)
    ang = float(two_pi) * torch.remainder(cycles, 1.0)
    return x * torch.complex(torch.cos(ang), torch.sin(ang))


def next_phase(n_samples: int, freq, phase0=0.0):
    """Oscillator phase (radians, in [0, 2*pi)) after ``n_samples``: the
    ``phase0`` of the next :func:`nco_mix` block. Host float64 for host
    inputs (exact continuity), a float32 tensor otherwise."""
    if _is_concrete(freq) and _is_concrete(phase0):
        f = np.asarray(freq, np.float64)
        cycles = f * n_samples + np.asarray(phase0, np.float64) / (2.0 * np.pi)
        return 2.0 * np.pi * np.mod(cycles, 1.0)
    f = torch.as_tensor(freq, dtype=torch.float32)
    p0 = torch.as_tensor(phase0, dtype=torch.float32, device=f.device)
    two_pi = float(2.0 * np.float32(np.pi))
    cycles = f * n_samples + p0 / two_pi
    return two_pi * torch.remainder(cycles, 1.0)


def _f32(v) -> float:
    """A host number rounded to float32, as the JAX package's weakly typed
    constants meet a float32 array."""
    return float(np.float32(v))


def dc_offset(x) -> torch.Tensor:
    """Mean of the block: the DC estimate (one complex value per row)."""
    return as_cf32(x).mean(dim=-1)


def remove_dc(x) -> torch.Tensor:
    """Subtract the per-row block mean (one-shot DC removal)."""
    x = as_cf32(x)
    return x - x.mean(dim=-1, keepdim=True)


def apply_iq_imbalance(x, gain: float, phase: float) -> torch.Tensor:
    """A direct-conversion front end with Q-arm gain error ``gain`` (linear,
    1.0 = balanced) and phase error ``phase`` (radians): ``I' = I``,
    ``Q' = gain * (Q cos(phase) + I sin(phase))``."""
    x = as_cf32(x)
    i, q = x.real, x.imag
    qp = _f32(gain) * (q * _f32(np.cos(phase)) + i * _f32(np.sin(phase)))
    return torch.complex(i, qp)


def estimate_iq_imbalance(x):
    """Blind imbalance estimate from second-order statistics of a proper
    (circularly symmetric) signal: ``gain = sqrt(E[Q^2] / E[I^2])``,
    ``phase = asin(E[I Q] / sqrt(E[I^2] E[Q^2]))``, over the last axis.
    Returns ``(gain, phase)`` float32 (per row for batched input); remove
    DC first."""
    x = as_cf32(x)
    i, q = x.real, x.imag
    pii = (i * i).mean(dim=-1)
    pqq = (q * q).mean(dim=-1)
    piq = (i * q).mean(dim=-1)
    gain = torch.sqrt(pqq / pii)
    phase = torch.asin(torch.clamp(piq / torch.sqrt(pii * pqq), -1.0, 1.0))
    return gain, phase


def correct_iq_imbalance(x, gain, phase) -> torch.Tensor:
    """Invert :func:`apply_iq_imbalance`: ``Q = (Q'/gain - I' sin(phase)) /
    cos(phase)``, ``I = I'``; a per-row ``gain`` / ``phase`` broadcasts
    against the samples."""
    x = as_cf32(x)
    i, q = x.real, x.imag
    g = torch.as_tensor(gain, dtype=torch.float32, device=x.device)
    ph = torch.as_tensor(phase, dtype=torch.float32, device=x.device)
    if g.ndim:
        g = g[..., None]
    if ph.ndim:
        ph = ph[..., None]
    return torch.complex(i, (q / g - i * torch.sin(ph)) / torch.cos(ph))


def image_rejection_db(x, tone_bin: int) -> torch.Tensor:
    """Image-rejection ratio (dB, float32) of a single-tone capture: power
    at ``tone_bin`` over power at its image bin ``-tone_bin``."""
    x = as_cf32(x)
    spec = torch.fft.fft(x, dim=-1)
    n = x.shape[-1]
    p_sig = spec[..., tone_bin % n].abs() ** 2
    p_img = spec[..., (-tone_bin) % n].abs() ** 2
    return 10.0 * torch.log10(p_sig / (p_img + 1e-30))


def estimate_snr_m2m4(y) -> torch.Tensor:
    """Blind M2M4 SNR estimate (linear ``S / N``, float32, per row) of a
    constant-modulus signal in circular AWGN: ``m2 = E|y|^2``, ``m4 =
    E|y|^4``, ``S = sqrt(2 m2^2 - m4)``, ``N = m2 - S``; ``inf`` where the
    noise estimate is <= 0."""
    y = as_cf32(y)
    p = y.real ** 2 + y.imag ** 2
    m2 = p.mean(dim=-1)
    m4 = (p * p).mean(dim=-1)
    s = torch.sqrt(torch.clamp(2.0 * m2 * m2 - m4, min=0.0))
    n = m2 - s
    pos = n > 0
    return torch.where(pos, s / torch.where(pos, n, torch.ones_like(n)),
                       torch.full_like(n, float("inf")))


def agc(x, target_rms: float = 1.0, block: int = 1024, alpha: float = 0.5,
        gain0=None, eps: float = 1e-12):
    """Block automatic gain control on a 1-D stream: block ``k`` is scaled
    by the running gain ``g_k``, then ``g_{k+1} = (1 - alpha) g_k + alpha *
    target / rms_k`` (the loop acts on the previous block's measurement);
    the ragged tail takes the final gain. Returns ``(y, final_gain)``; feed
    ``final_gain`` as ``gain0`` of the next block.

    A block's RMS does not depend on the gain, so every block's RMS comes
    from one pass; only the scalar recurrence runs a step a block (two
    device operations, no host read), and one multiply applies the gains.
    """
    x = as_cf32(x)
    if x.ndim != 1:
        raise ValueError("agc is a stream op: 1-D input (vmap for channels)")
    n = x.shape[-1]
    block = int(block)
    nb = n // block
    a = np.float32(alpha)
    g = torch.as_tensor(1.0 if gain0 is None else gain0, dtype=torch.float32,
                        device=x.device).reshape(())
    if not nb:
        return x * g, g
    head = x[:nb * block].reshape(nb, block)
    rms = torch.sqrt((head.real ** 2 + head.imag ** 2).mean(dim=-1) + eps)
    drive = float(a) * (rms.new_full((), _f32(target_rms)) / rms)  # alpha * target / rms_k
    keep = float(np.float32(1.0) - a)
    gains = []
    for k in range(nb):
        gains.append(g)
        g = keep * g + drive[k]
    y = (head * torch.stack(gains)[:, None]).reshape(nb * block)
    if n > nb * block:
        y = torch.cat([y, x[nb * block:] * g])
    return y, g


def normalize_rms(x, target_rms: float = 1.0, eps: float = 1e-12) -> torch.Tensor:
    """One-shot per-row RMS normalization (the ``alpha=1`` whole-block AGC)."""
    x = as_cf32(x)
    rms = torch.sqrt((x.real ** 2 + x.imag ** 2).mean(dim=-1, keepdim=True) + eps)
    return x * (rms.new_full((), _f32(target_rms)) / rms)


def impulse_blank(x, threshold_sigma: float = 5.0, mode: str = "zero") -> torch.Tensor:
    """Impulse blanker: samples whose envelope exceeds ``threshold_sigma``
    times the row's robust scale (median envelope / sqrt(ln 4), the
    Rayleigh-consistent estimator; the median averages the middle pair, as
    ``jnp.median``) are zeroed (``mode="zero"``) or clipped to the
    threshold magnitude with their phase kept (``mode="clip"``)."""
    x = as_cf32(x)
    env = torch.sqrt(x.real ** 2 + x.imag ** 2)
    scale = median_midpoint(env, keepdim=True) / _f32(np.sqrt(np.log(4.0)))
    thresh = _f32(threshold_sigma) * scale
    if mode == "zero":
        return torch.where(env <= thresh, x, torch.zeros((), dtype=cf32, device=x.device))
    if mode == "clip":
        g = torch.where(env > thresh, thresh / torch.clamp(env, min=1e-30),
                        torch.ones((), device=x.device))
        return x * g
    raise ValueError(f"mode must be 'zero' or 'clip', got {mode!r}")


def squelch(x, threshold_db: float, ref_power: float = 1.0):
    """Power squelch: rows whose mean power falls below ``threshold_db``
    relative to ``ref_power`` are zeroed. Returns ``(gated, open)``, with
    ``open`` the per-row bool gate."""
    x = as_cf32(x)
    p = (x.real ** 2 + x.imag ** 2).mean(dim=-1, keepdim=True)
    open_ = p > _f32(ref_power * 10.0 ** (threshold_db / 10.0))
    return torch.where(open_, x, torch.zeros((), dtype=cf32, device=x.device)), open_[..., 0]
