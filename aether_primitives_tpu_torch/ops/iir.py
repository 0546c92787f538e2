"""IIR filtering through the truncated impulse response, and classic
recursive-filter designs (PyTorch).

Counterpart of ``aether_primitives_tpu/ops/iir.py``. A biquad's state map
``s' = M s + v x`` is constant, so the section is a convolution with a
geometrically decaying kernel; truncated where its envelope falls below
1e-7 (-140 dB, a few hundred taps for typical designs) it runs through
:func:`~.fir.fir_filter_os` (the overlap-save FFT convolution), with the
truncation and the float32 FFT as the only error. Streaming state is
exact: the initial state's response and the final state are two small
kernel products. The kernels and the designs (Butterworth low/high/band
pass by the prewarped bilinear transform into second-order sections, the
FM broadcast de-emphasis pole) are host float64 numpy, copies of the JAX
package's (the tests pin them equal).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from ..types import as_cf32
from . import fir as _fir

__all__ = [
    "sosfilt",
    "sosfilt_stream",
    "biquad_apply",
    "butter_sos",
    "fm_deemphasis_sos",
]

_EPS = 1e-7  # kernel truncation: -140 dB
_MAX_KERNEL = 1 << 17


def _biquad_system(sos_row) -> Tuple[float, np.ndarray, np.ndarray]:
    """Normalized DF2T biquad: ``y = b0 x + s[0]``, ``s' = M s + v x``."""
    b0, b1, b2, a0, a1, a2 = (float(c) for c in np.asarray(sos_row, np.float64))
    b0, b1, b2, a1, a2 = b0 / a0, b1 / a0, b2 / a0, a1 / a0, a2 / a0
    m = np.array([[-a1, 1.0], [-a2, 0.0]], np.float64)
    v = np.array([b1 - a1 * b0, b2 - a2 * b0], np.float64)
    return b0, m, v


@functools.lru_cache(maxsize=None)
def _biquad_kernels(sos_key: tuple):
    """Host-precomputed truncated kernels for one biquad:

    - ``h``  [L]      impulse response (the FIR realization),
    - ``ks`` [L, 2]   initial-state response ``c . M^t s0`` rows,
    - ``sk`` [L, 2]   final-state kernels: ``s_end = sum_j sk[j] x[n-1-j]``
      (+ the decayed initial state, below truncation for n >= L).
    """
    b0, m, v = _biquad_system(np.array(sos_key))
    hs, kss = [b0], [np.array([1.0, 0.0])]
    s = v.copy()  # state after the impulse
    p = np.eye(2)
    for _ in range(_MAX_KERNEL):
        hs.append(s[0])
        p = m @ p
        kss.append(p[0])
        s = m @ s
        if abs(s[0]) + abs(s[1]) < _EPS and len(hs) > 8:
            break
    l = len(hs)
    # sk[j] = M^j v (state contribution of the input j steps back)
    sk = np.empty((l, 2))
    acc = v.copy()
    for j in range(l):
        sk[j] = acc
        acc = m @ acc
    h = np.array(hs, np.float64)
    ks = np.array(kss[:l], np.float64)
    return h, ks, sk, m


def biquad_apply(x, sos_row, state=None):
    """One biquad over the last axis (the truncated-IR realization).
    Returns ``(y, final_state)``; ``state``: optional ``[..., 2]`` initial
    DF2T state (zeros = rest), on any device (moved to ``x``'s)."""
    xc = as_cf32(x)
    key = tuple(float(c) for c in np.asarray(sos_row, np.float64))
    h, ks, sk, m = _biquad_kernels(key)
    l = h.shape[0]
    n = int(xc.shape[-1])
    dev = xc.device
    y = _fir.fir_filter_os(xc, h.astype(np.complex64))
    s0 = None if state is None else as_cf32(state, device=dev)
    if s0 is not None:
        ks_t = torch.from_numpy(ks.astype(np.float32)).to(dev, torch.complex64)
        resp = torch.einsum("lj,...j->...l", ks_t, s0)
        if l >= n:
            y = y + resp[..., :n]
        else:
            y = torch.cat([y[..., :l] + resp, y[..., l:]], dim=-1)
    # the final state from the trailing min(L, n) inputs (+ the decayed s0)
    lt = min(l, n)
    tail = xc[..., n - lt:].flip(-1)  # x[n-1], x[n-2], ...
    sk_t = torch.from_numpy(sk[:lt].astype(np.float32)).to(dev, torch.complex64)
    s_end = torch.einsum("jk,...j->...k", sk_t, tail)
    if s0 is not None and n < l:
        mp = torch.from_numpy(np.linalg.matrix_power(m, n).astype(np.float32))
        s_end = s_end + torch.einsum("kj,...j->...k", mp.to(dev, torch.complex64), s0)
    return y, s_end


def sosfilt(sos, x, state=None):
    """Cascade of second-order sections over the last axis (the
    ``scipy.signal.sosfilt`` contract): ``sos`` is ``[k, 6]`` rows ``(b0,
    b1, b2, a0, a1, a2)``; ``state`` an optional list of per-section
    ``[..., 2]`` states. Batched over leading axes."""
    y = as_cf32(x)
    sos = np.atleast_2d(np.asarray(sos, np.float64))
    for i, row in enumerate(sos):
        y, _ = biquad_apply(y, row, None if state is None else state[i])
    return y


def sosfilt_stream(sos, x, states):
    """Streaming :func:`sosfilt`: ``states`` is a list of per-section
    ``[..., 2]`` states (or empty / None at cold start); returns ``(y,
    new_states)``, so that block-by-block filtering equals the one-shot
    call to the truncation floor."""
    y = as_cf32(x)
    sos = np.atleast_2d(np.asarray(sos, np.float64))
    new_states = []
    for i, row in enumerate(sos):
        y, s = biquad_apply(y, row, states[i] if states else None)
        new_states.append(s)
    return y, new_states


# ------------------------------------------------------------------ designs


def _zpk_to_sos(zeros, poles, zref_z):
    """Pair conjugate digital zeros/poles into real SOS rows, normalized
    to unity gain at the reference point ``zref_z`` on the unit circle."""
    def pair(roots):
        roots = list(np.asarray(roots, np.complex128))
        out, reals = [], []
        used = [False] * len(roots)
        for j, r in enumerate(roots):
            if used[j]:
                continue
            used[j] = True
            if abs(r.imag) > 1e-10:
                for l in range(j + 1, len(roots)):
                    if not used[l] and abs(roots[l] - np.conj(r)) < 1e-8:
                        used[l] = True
                        break
                out.append(np.poly([r, np.conj(r)]).real)
            else:
                reals.append(r.real)
        while len(reals) >= 2:  # real roots pair into quadratic sections
            a, b = reals.pop(), reals.pop()
            out.append(np.poly([a, b]).real)
        if reals:
            out.append(np.array([1.0, -reals[0], 0.0]))
        return out

    zs, ps = pair(zeros), pair(poles)
    while len(zs) < len(ps):
        zs.append(np.array([1.0, 0.0, 0.0]))
    sos = np.array([np.concatenate([b, a]) for b, a in zip(zs, ps)], np.float64)
    g = 1.0 + 0.0j
    zi = 1.0 / zref_z  # polynomial sections are in z^-1 powers
    for row in sos:
        g *= np.polyval(row[:3][::-1], zi) / np.polyval(row[3:][::-1], zi)
    sos[0, :3] /= abs(g)
    return sos


@functools.lru_cache(maxsize=None)
def butter_sos(order: int, cutoff, btype: str = "lowpass") -> np.ndarray:
    """Butterworth design as second-order sections (host f64, prewarped
    bilinear transform). ``btype``: "lowpass" | "highpass" (scalar
    ``cutoff``) or "bandpass" | "bandstop" (``cutoff = (f1, f2)``),
    frequencies in cycles/sample (0, 0.5). ``order`` is the PROTOTYPE
    order (band filters have ``2*order`` poles, the scipy convention).
    Magnitude response matches ``scipy.signal.butter(.., output='sos')``
    (tested)."""
    order = int(order)
    k = np.arange(1, order + 1)
    p_unit = np.exp(1j * (np.pi * (2 * k - 1) / (2 * order) + np.pi / 2))

    def warp(f):
        f = float(f)
        if not 0.0 < f < 0.5:
            raise ValueError("cutoff must be in (0, 0.5) cycles/sample")
        return 2.0 * np.tan(np.pi * f)

    def bilin(p):  # s = 2 (z - 1)/(z + 1)
        return (2.0 + p) / (2.0 - p)

    if btype in ("lowpass", "highpass"):
        wc = warp(cutoff)
        if btype == "lowpass":
            p_analog = wc * p_unit
            zeros = np.full(order, -1.0 + 0.0j)
            zref = 1.0
        else:
            p_analog = wc / p_unit
            zeros = np.full(order, 1.0 + 0.0j)
            zref = -1.0
        return _zpk_to_sos(zeros, bilin(p_analog), zref)

    if btype not in ("bandpass", "bandstop"):
        raise ValueError(
            "btype must be 'lowpass', 'highpass', 'bandpass' or 'bandstop'"
        )
    try:
        f1, f2 = cutoff
    except TypeError:
        raise ValueError(f"{btype} needs cutoff = (f_low, f_high)") from None
    if not f1 < f2:
        raise ValueError("band edges must satisfy f_low < f_high")
    w1, w2 = warp(f1), warp(f2)
    bw, w0 = w2 - w1, np.sqrt(w1 * w2)
    poles = []
    if btype == "bandpass":
        # LP -> BP: s -> (s^2 + w0^2)/(bw s); each prototype pole p gives
        # the two roots of s^2 - p*bw*s + w0^2 = 0
        for p in p_unit:
            d = np.sqrt((p * bw) ** 2 / 4.0 - w0 * w0 + 0j)
            poles += [p * bw / 2.0 + d, p * bw / 2.0 - d]
        zeros_d = np.concatenate([np.ones(order), -np.ones(order)])
        z0 = np.exp(2j * np.pi * np.sqrt(f1 * f2))  # in-band reference
        zref = z0
    else:
        # LP -> BS: s -> bw s/(s^2 + w0^2)
        for p in p_unit:
            d = np.sqrt((bw / p) ** 2 / 4.0 - w0 * w0 + 0j)
            poles += [bw / (2.0 * p) + d, bw / (2.0 * p) - d]
        # analog zeros at +-j w0 -> digital via bilinear, order copies each
        zd = bilin(np.array([1j * w0, -1j * w0]))
        zeros_d = np.concatenate([np.full(order, zd[0]), np.full(order, zd[1])])
        zref = 1.0  # passband at DC
    poles_d = bilin(np.asarray(poles))
    return _zpk_to_sos(zeros_d, poles_d, zref)


def fm_deemphasis_sos(tau_samples: float) -> np.ndarray:
    """Single-pole FM broadcast de-emphasis (``tau`` in SAMPLES, e.g.
    ``50e-6 * fs``): ``H(z) = b / (1 - a z^-1)`` with ``a = exp(-1/tau)``,
    unity DC gain — apply after the discriminator
    (:func:`~aether_primitives_tpu_torch.ops.analog.fm_demod`)."""
    a = float(np.exp(-1.0 / float(tau_samples)))
    return np.array([[1.0 - a, 0.0, 0.0, 1.0, -a, 0.0]], np.float64)
