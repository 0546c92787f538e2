"""Receiver front end: the numerically controlled oscillator (NCO) mixer.

Counterpart of ``aether_primitives_tpu/ops/frontend.py``, DDC subset:
:func:`nco_mix` and :func:`next_phase`. Frequencies are in cycles/sample
(normalized to the sample rate), phases in radians. DC removal, IQ
imbalance and AGC are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..types import as_cf32

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
