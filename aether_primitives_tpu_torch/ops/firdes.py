"""FIR filter design: windowed-sinc / Kaiser / Parks-McClellan (remez).

A numpy-only copy of ``aether_primitives_tpu/ops/firdes.py``: design is a
host activity in float64, done once at configuration time, so the port
carries the module over unchanged (its tests pin every designer equal to
the original's output). It feeds the FIR ops, the DDC/DUC lowpass and the
PFB prototypes.

Provided designs:

- :func:`windowed_sinc` — lowpass by the classic truncated-sinc × window;
- :func:`kaiser_lowpass` (+ :func:`kaiser_beta` / :func:`kaiser_order`) —
  windowed design meeting an attenuation/transition-width spec;
- :func:`remez` — true minimax (equiripple) multiband design via the
  Parks-McClellan exchange with barycentric Lagrange interpolation,
  type-I (odd length, symmetric) linear phase;
- :func:`hilbert_taps` — type-III wideband 90° phase shifter (odd length,
  antisymmetric) for analytic-signal / SSB work;
- :func:`band_transform` — lowpass -> highpass/bandpass/bandstop
  spectral shifts.

Frequencies are normalized to the SAMPLE RATE (band edges in [0, 0.5]).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


# ----------------------------------------------------------- windowed designs


def windowed_sinc(ntaps: int, cutoff: float, window: str = "hamming") -> np.ndarray:
    """Lowpass: ideal sinc truncated to ``ntaps`` × a named window
    (``"hamming"``, ``"hann"``, ``"blackman"``, ``"rect"``), unit DC gain.
    ``cutoff`` in cycles/sample (0, 0.5)."""
    if not 0.0 < cutoff < 0.5:
        raise ValueError("cutoff must be in (0, 0.5) cycles/sample")
    n = np.arange(ntaps, dtype=np.float64) - (ntaps - 1) / 2.0
    h = 2.0 * cutoff * np.sinc(2.0 * cutoff * n)
    w = {
        "hamming": np.hamming,
        "hann": np.hanning,
        "blackman": np.blackman,
        "rect": np.ones,
    }[window](ntaps)
    h *= w
    return (h / h.sum()).astype(np.float64)


def kaiser_beta(atten_db: float) -> float:
    """Kaiser window shape parameter for a stopband attenuation spec
    (the standard Kaiser empirical formula)."""
    a = float(atten_db)
    if a > 50.0:
        return 0.1102 * (a - 8.7)
    if a >= 21.0:
        return 0.5842 * (a - 21.0) ** 0.4 + 0.07886 * (a - 21.0)
    return 0.0


def kaiser_order(atten_db: float, transition_width: float) -> int:
    """Estimated tap count to meet ``atten_db`` of stopband rejection over
    a ``transition_width`` (cycles/sample) band — Kaiser's formula,
    rounded up to the next odd length (type-I symmetry)."""
    n = int(np.ceil((float(atten_db) - 7.95) / (14.36 * float(transition_width)))) + 1
    return n + 1 if n % 2 == 0 else n


def kaiser_lowpass(
    cutoff: float, transition_width: float, atten_db: float = 80.0
) -> np.ndarray:
    """Lowpass meeting an (attenuation, transition width) spec with a
    Kaiser window; cutoff at the middle of the transition band."""
    ntaps = kaiser_order(atten_db, transition_width)
    n = np.arange(ntaps, dtype=np.float64) - (ntaps - 1) / 2.0
    h = 2.0 * cutoff * np.sinc(2.0 * cutoff * n)
    h *= np.kaiser(ntaps, kaiser_beta(atten_db))
    return (h / h.sum()).astype(np.float64)


# ----------------------------------------------------------- Parks-McClellan


def _remez_grid(
    bands: np.ndarray, desired: np.ndarray, weights: np.ndarray, m: int, density: int
):
    """Dense frequency grid over the union of bands with per-point
    desired response and weight."""
    grid, dgrid, wgrid = [], [], []
    step = 0.5 / (density * (m + 1))
    for (f0, f1), d, w in zip(bands, desired, weights):
        pts = max(int(np.ceil((f1 - f0) / step)) + 1, 2)
        f = np.linspace(f0, f1, pts)
        grid.append(f)
        dgrid.append(np.full(pts, d))
        wgrid.append(np.full(pts, w))
    return np.concatenate(grid), np.concatenate(dgrid), np.concatenate(wgrid)


def _barycentric_weights(x: np.ndarray) -> np.ndarray:
    """Barycentric Lagrange weights 1/prod(x_k - x_j), computed with a
    running rescale so products of ~100 small differences stay finite."""
    k = x.size
    b = np.ones(k)
    for i in range(k):
        d = x[i] - x
        d[i] = 1.0
        # log-scale product for robustness
        b[i] = np.prod(np.sign(d)) * np.exp(-np.sum(np.log(np.abs(d))))
    return b


def remez(
    ntaps: int,
    bands: Sequence[Tuple[float, float]],
    desired: Sequence[float],
    weights: Sequence[float] = None,
    density: int = 16,
    max_iters: int = 40,
) -> np.ndarray:
    """Minimax (equiripple) type-I linear-phase FIR via the
    Parks-McClellan Remez exchange.

    ``bands``: disjoint ``(lo, hi)`` edges in cycles/sample, ascending in
    [0, 0.5]; ``desired``: target amplitude per band; ``weights``: error
    weight per band (default 1). ``ntaps`` must be odd (type-I symmetry
    — every response shape is reachable; use :func:`hilbert_taps` for the
    antisymmetric case). Returns ``ntaps`` float64 taps.

    Each iteration solves for the levelled error ``delta`` on the current
    extremal set analytically (barycentric form), interpolates the
    resulting cosine polynomial across the dense grid, and re-picks the
    ``M+2`` alternating extrema of the weighted error; convergence is
    reached when ``delta`` stops growing (standard PM termination). Taps
    are recovered by sampling the final polynomial at ``M+1`` uniform
    frequencies and inverting the cosine series (an IDCT).
    """
    if ntaps % 2 == 0:
        raise ValueError("remez here designs type-I filters: ntaps must be odd")
    bands = np.asarray(bands, np.float64)
    desired = np.asarray(desired, np.float64)
    if weights is None:
        weights = np.ones(len(bands))
    weights = np.asarray(weights, np.float64)
    if bands.ndim != 2 or bands.shape[1] != 2:
        raise ValueError("bands must be a list of (lo, hi) pairs")
    if np.any(bands < 0) or np.any(bands > 0.5) or np.any(np.diff(bands.ravel()) < 0):
        raise ValueError("band edges must ascend within [0, 0.5]")
    m = (ntaps - 1) // 2  # cosine-series order: A(f) = sum a_k cos(2 pi k f)
    r = m + 2  # extremal count (Chebyshev alternation)
    grid, dg, wg = _remez_grid(bands, desired, weights, m, density)
    ng = grid.size
    if ng < r:
        raise ValueError("grid too small — raise density or lower ntaps")
    # initial extremal guess: uniform over the grid
    ext = np.round(np.linspace(0, ng - 1, r)).astype(int)

    x_all = np.cos(2.0 * np.pi * grid)
    last_delta = 0.0
    for _ in range(max_iters):
        xe = x_all[ext]
        be = _barycentric_weights(xe)
        signs = (-1.0) ** np.arange(r)
        delta = np.sum(be * dg[ext]) / np.sum(be * signs / wg[ext])
        # values of the interpolating polynomial at the extremal points
        ce = dg[ext] - signs * delta / wg[ext]
        # barycentric evaluation of A(f) over the whole grid
        num = np.zeros(ng)
        den = np.zeros(ng)
        exact = np.full(ng, -1, dtype=int)
        for k in range(r):
            d = x_all - xe[k]
            hit = np.abs(d) < 1e-14
            exact[hit] = k
            d[hit] = 1.0
            t = be[k] / d
            num += t * ce[k]
            den += t
        a = num / den
        hitmask = exact >= 0
        a[hitmask] = ce[exact[hitmask]]
        err = wg * (a - dg)
        # ---- new extremal set: local extrema of the weighted error
        cand = [0]
        for i in range(1, ng - 1):
            if (err[i] - err[i - 1]) * (err[i + 1] - err[i]) <= 0:
                cand.append(i)
        cand.append(ng - 1)
        cand = np.unique(cand)
        # enforce sign alternation: among runs of same-sign candidates
        # keep the largest magnitude
        keep = []
        for i in cand:
            if keep and np.sign(err[i]) == np.sign(err[keep[-1]]):
                if np.abs(err[i]) > np.abs(err[keep[-1]]):
                    keep[-1] = i
            else:
                keep.append(i)
        # trim to r extrema, dropping the smallest end(s)
        while len(keep) > r:
            if np.abs(err[keep[0]]) < np.abs(err[keep[-1]]):
                keep.pop(0)
            else:
                keep.pop()
        if len(keep) < r:
            # degenerate exchange — pad with largest remaining candidates
            rest = [i for i in cand if i not in keep]
            rest.sort(key=lambda i: -np.abs(err[i]))
            keep = sorted(keep + rest[: r - len(keep)])
        new_ext = np.asarray(sorted(keep), int)
        if np.array_equal(new_ext, ext) or abs(abs(delta) - last_delta) < 1e-12 * max(
            1.0, abs(delta)
        ):
            ext = new_ext
            break
        ext = new_ext
        last_delta = abs(delta)

    # ---- recover taps: sample A(f) at M+1 uniform points, invert the
    # cosine series (type-I IDCT)
    fs = np.arange(m + 1) / ntaps
    xs = np.cos(2.0 * np.pi * fs)
    xe = x_all[ext]
    be = _barycentric_weights(xe)
    signs = (-1.0) ** np.arange(r)
    delta = np.sum(be * dg[ext]) / np.sum(be * signs / wg[ext])
    ce = dg[ext] - signs * delta / wg[ext]
    a_s = np.zeros(m + 1)
    for i, xv in enumerate(xs):
        d = xv - xe
        hit = np.abs(d) < 1e-14
        if hit.any():
            a_s[i] = ce[np.argmax(hit)]
        else:
            t = be / d
            a_s[i] = np.sum(t * ce) / np.sum(t)
    # A(f_j) = a_0 + sum_{k>=1} a_k cos(2 pi k j / ntaps): invert by DFT
    # symmetry — h[n] = (1/ntaps) [A(0) + 2 sum_j A(f_j) cos(2 pi j (n-m)/ntaps)]
    n_idx = np.arange(ntaps) - m
    h = np.zeros(ntaps)
    for j in range(m + 1):
        c = np.cos(2.0 * np.pi * fs[j] * n_idx)
        h += (1.0 if j == 0 else 2.0) * a_s[j] * c
    return (h / ntaps).astype(np.float64)


def hilbert_taps(ntaps: int, window: str = "hamming") -> np.ndarray:
    """Type-III FIR Hilbert transformer (odd length, antisymmetric):
    +90° phase shift across the band. Ideal impulse response
    ``2/(pi n)`` for odd ``n``, 0 otherwise, windowed. Delay is
    ``(ntaps-1)/2`` samples — pair with the same delay on the I path
    (see :func:`~.analog.ssb_modulate`, which uses the exact spectral
    method instead for block work)."""
    if ntaps % 2 == 0:
        raise ValueError("hilbert_taps: ntaps must be odd (type III)")
    n = np.arange(ntaps, dtype=np.float64) - (ntaps - 1) / 2.0
    h = np.zeros(ntaps)
    odd = (np.abs(n) % 2) == 1
    h[odd] = 2.0 / (np.pi * n[odd])
    w = {
        "hamming": np.hamming,
        "hann": np.hanning,
        "blackman": np.blackman,
        "rect": np.ones,
    }[window](ntaps)
    return (h * w).astype(np.float64)


def band_transform(lowpass: np.ndarray, kind: str, center: float = 0.25) -> np.ndarray:
    """Spectral transforms of a lowpass prototype:

    - ``"highpass"``: ``h[n] * (-1)^n`` (shift by 0.5);
    - ``"bandpass"``: ``2 h[n] cos(2 pi center (n - mid))`` — passband
      moved to ``±center``;
    - ``"bandstop"``: delta at center minus the bandpass.
    """
    h = np.asarray(lowpass, np.float64)
    n = np.arange(h.size, dtype=np.float64)
    mid = (h.size - 1) / 2.0
    if kind == "highpass":
        return h * ((-1.0) ** n)
    if kind == "bandpass":
        return 2.0 * h * np.cos(2.0 * np.pi * center * (n - mid))
    if kind == "bandstop":
        bp = 2.0 * h * np.cos(2.0 * np.pi * center * (n - mid))
        out = -bp
        out[int(mid)] += 1.0
        return out
    raise ValueError(f"unknown transform {kind!r}")
