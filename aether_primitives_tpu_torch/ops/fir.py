"""Causal FIR filtering and the fused FIR -> decimate -> frame-FFT op (PyTorch).

Counterpart of ``aether_primitives_tpu/ops/fir.py``, main-path subset:
:func:`fir_filter` and :func:`fir_decimate_fft`, with the float64 constant
builders :func:`_fused_stage_matrices` and :func:`_fused_rx_matrices` copied
verbatim (numpy only) so that both packages contract against byte-identical
constants. These functions are the plain PyTorch versions; the hand-written
kernel of the RX chain lives in :mod:`.cuda.rx_frame`.

Convention: ``y[n] = sum_k taps[k] * x[n - k]`` with zero initial state
(causal, "same" length output).
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from ..types import as_cf32, cf32
from . import fft as _fft
from .fft import Scale


def _history(history, batch, k: int, device) -> torch.Tensor:
    """``[..., K-1]`` samples preceding a block (zeros when ``history`` is
    None), broadcast to the block's batch shape."""
    if history is None:
        return torch.zeros(batch + (k - 1,), dtype=cf32, device=device)
    h0 = as_cf32(history, device=device)
    if h0.shape[-1] != k - 1:
        raise ValueError(f"history must have K-1 = {k - 1} samples")
    return h0.expand(batch + (k - 1,))


def fir_filter(x, taps, history=None) -> torch.Tensor:
    """Causal FIR ``y[n] = sum_k taps[k] x[n-k]``, output as long as ``x``.

    A shift-and-add over the K taps on float32 re/im planes: exact time
    domain, and no cuDNN convolution (which would run in TF32 by default).
    ``history``: optional ``[..., K-1]`` samples preceding ``x`` (zeros =
    causal start). Batched over leading axes.
    """
    x = as_cf32(x)
    taps = np.asarray(taps, dtype=np.complex64).ravel()
    k = taps.shape[-1]
    n = x.shape[-1]
    if k > 1:
        x = torch.cat([_history(history, x.shape[:-1], k, x.device), x], dim=-1)
    xr, xi = x.real, x.imag
    yr = torch.zeros(x.shape[:-1] + (n,), dtype=torch.float32, device=x.device)
    yi = torch.zeros_like(yr)
    for t in range(k):
        start = k - 1 - t
        sr = xr[..., start:start + n]
        si = xi[..., start:start + n]
        a = float(taps[t].real)
        b = float(taps[t].imag)
        yr = yr + a * sr - b * si
        yi = yi + a * si + b * sr
    return torch.complex(yr, yi)


@functools.lru_cache(maxsize=None)
def _fused_stage_matrices(
    taps_bytes: bytes, k: int, dec: int, fft_len: int, n1: int
):
    """Two-matrix factorization of (circular FIR ∘ decimate ∘ DFT) per frame.

    Cooley-Tukey over ``span = n1 * n2`` with output ``X[k1 + n1*k2]``:
    stage 1 is the dense ``DFT_{n1}`` contraction; stage 2's DFT, the
    twiddles, the tap spectrum ``Hs`` (circular convolution diagonal), and
    the decimation **spectral fold** ``Z[j] = (1/dec) sum_p Y[j + p*fft_len]``
    all collapse into one precomputed (f64) tensor

        G'[k1, m2, d] = T[k1, m2] * (1/dec) *
                        sum_p F2[m2, d + p*r] * Hs[k1 + n1*(d + p*r)]

    (``r = fft_len / n1``, ``d < r``; ``T`` = twiddles, ``F2 = DFT_{n2}``),
    so the on-device work is exactly two einsums and the folded 8192-point
    spectrum is never materialized. Returns ``(f1 [n1, n1], G' [n1, n2, r])``
    complex64.
    """
    h = np.frombuffer(taps_bytes, dtype=np.complex64).astype(np.complex128)
    span = dec * fft_len
    n2 = span // n1
    r = fft_len // n1
    hs = np.fft.fft(h, span)  # [span], f64
    k1 = np.arange(n1, dtype=np.float64)
    m2 = np.arange(n2, dtype=np.float64)
    f1 = np.exp(-2j * np.pi / n1 * np.outer(k1, k1))  # [n, k1] (symmetric)
    t = np.exp(-2j * np.pi / span * np.outer(k1, m2))  # twiddle [k1, m2]
    f2 = np.exp(-2j * np.pi / n2 * np.outer(m2, m2))  # [m2, k2]
    # k2 grid of the fold: k2 = d + p*r, d < r, p < dec
    k2_idx = np.arange(r)[:, None] + r * np.arange(dec)[None, :]  # [d, p]
    f2_sel = f2[:, k2_idx]  # [m2, d, p]
    hs_m = hs.reshape(n2, n1).T  # Hs[k1 + n1*k2] -> [k1, k2]
    hs_sel = hs_m[:, k2_idx]  # [k1, d, p]
    g = np.einsum("mdp,kdp->kmd", f2_sel, hs_sel) / dec  # [k1, m2, d]
    g *= t[:, :, None]
    return f1.astype(np.complex64), g.astype(np.complex64)


def _fused_stage_n1(
    dec: int, fft_len: int, override: Optional[int] = None
) -> Optional[int]:
    """First-stage size ``n1`` of the two-einsum path, or None when no
    geometry fits.

    ``override`` wins when given (it must divide ``fft_len``; G' is capped
    at 64 MB to catch typos). Otherwise the heuristic: the largest
    ``n1 | fft_len`` with ``n1 <= 128`` whose G' tensor (``span * fft_len /
    n1`` complex64 entries) stays under 4 MB. For (dec 4, fft_len 2048) that
    is n1 = 128, n2 = 64, r = 16, the same as the JAX package off the TPU.
    """
    span = dec * fft_len
    if override is not None:
        n1 = int(override)
        if n1 < 1 or fft_len % n1:
            raise ValueError(
                f"stage_n1 {n1} must divide fft_len {fft_len}"
            )
        if span * (fft_len // n1) * 8 > 64 << 20:
            raise ValueError(f"stage_n1 {n1} implies a >64 MB G' tensor")
        return n1
    for n1 in range(min(fft_len, 128), 0, -1):
        if fft_len % n1 == 0:
            if span * (fft_len // n1) * 8 <= 4 << 20:
                return n1
            return None
    return None


@functools.lru_cache(maxsize=None)
def _fused_rx_matrices(taps_bytes: bytes, k: int, dec: int, fft_len: int):
    """Precomputed (f64) constants for :func:`fir_decimate_fft`.

    Returns ``(Hs [span], Cm [K-1, fft_len])`` complex64:

    - ``Hs``: span-point DFT of the taps — the circular-convolution diagonal.
    - ``Cm``: the wrap-correction operator. The span-point circular
      convolution ``c`` of a frame differs from the true causal FIR output
      ``y`` only in its first ``K-1`` samples:
      ``e[m] = c[m] - y[m] = sum_{u=m}^{K-2} h[m+(K-1)-u] *
      (cur_tail[u] - prev_tail[u])`` where the tails are the last ``K-1``
      samples of the current / previous frame. Decimating ``e`` and taking
      its ``fft_len``-point DFT is the composite
      ``Cm[u, k] = sum_{m2} T[dec*m2, u] e^{-2pi i k m2 / fft_len}`` with
      ``T[m, u] = h[m + (K-1) - u]`` (upper-triangular band).
    """
    h = np.frombuffer(taps_bytes, dtype=np.complex64).astype(np.complex128)
    span = dec * fft_len
    hs = np.fft.fft(h, span).astype(np.complex64)
    if k <= 1:
        return hs, np.zeros((0, fft_len), np.complex64)
    t = np.zeros((k - 1, k - 1), np.complex128)
    for m in range(k - 1):
        for u in range(m, k - 1):
            t[m, u] = h[m + (k - 1) - u]
    td = t[::dec, :]  # decimated error rows: m = 0, dec, 2*dec, ...
    m2 = np.arange(td.shape[0], dtype=np.float64)
    kk = np.arange(fft_len, dtype=np.float64)
    f = np.exp(-2j * np.pi / fft_len * np.outer(m2, kk))
    cm = np.einsum("mu,mk->uk", td, f).astype(np.complex64)
    return hs, cm


@functools.lru_cache(maxsize=None)
def _device_constants(taps_bytes: bytes, k: int, dec: int, fft_len: int,
                      n1: Optional[int], device: str) -> dict:
    """The complex64 constants of :func:`fir_decimate_fft`, uploaded once
    per ``(taps, geometry, device)``."""
    hs, cm = _fused_rx_matrices(taps_bytes, k, dec, fft_len)
    out = {"hs": hs, "cm": cm}
    if n1 is not None:
        out["f1"], out["gp"] = _fused_stage_matrices(
            taps_bytes, k, dec, fft_len, n1
        )
        if k > 1:
            # natural bin k = k1 + n1*d: Cm's bin axis reshapes to [d, k1]
            out["cm_kd"] = np.ascontiguousarray(
                cm.reshape(k - 1, fft_len // n1, n1).transpose(0, 2, 1)
            )
    return {key: torch.from_numpy(v).to(device) for key, v in out.items()}


def fir_decimate_fft(
    x,
    taps: np.ndarray,
    dec: int,
    fft_len: int,
    scale: Scale = Scale.NONE,
    history=None,
    stage_n1: Optional[int] = None,
    _staged_layout: bool = False,
) -> torch.Tensor:
    """Fused causal FIR -> decimate-by-``dec`` -> blocked ``fft_len``-point
    FFT per frame of ``span = dec * fft_len`` samples.

    Equal (to rounding) to ``fft(fir_filter(x, taps).reshape(..., nsym,
    span)[..., ::dec])``. Each frame's circular convolution is taken in the
    frequency domain and decimated by folding its spectrum; the error of
    the circular wrap lives in the first ``K-1`` samples of each frame and
    is subtracted as ``delta @ Cm``, where ``delta`` is the frame's tail
    minus the previous frame's tail (``history`` for the first frame).

    When a two-einsum geometry exists (:func:`_fused_stage_n1`) the frame
    op is two complex64 contractions, stage 1 with ``DFT_{n1}`` and stage 2
    with G'; otherwise a span-point ``torch.fft`` with the fold.

    ``x``: ``[..., n]`` with ``n % span == 0``. ``taps``: host numpy.
    ``history``: optional ``[..., K-1]`` samples preceding ``x``. Returns
    ``[..., n // span, fft_len]`` spectra scaled by ``scale``; with
    ``_staged_layout=True`` (two-einsum path only) ``[n1, ..., nsym, r]``
    with ``k1`` leading and natural bin ``k = k1 + n1*d``; callers of the
    staged layout pass ``Scale.NONE`` (a scale would read ``r`` as the
    transform length).
    """
    x = as_cf32(x)
    taps = np.asarray(taps, dtype=np.complex64).ravel()
    k = taps.shape[-1]
    span = dec * fft_len
    n = x.shape[-1]
    if n % span:
        raise ValueError(f"length {n} not divisible by dec*fft_len = {span}")
    if k - 1 > span:
        raise ValueError(f"taps ({k}) longer than a frame ({span}) + 1")
    batch = tuple(x.shape[:-1])
    nsym = n // span
    frames = x.reshape(batch + (nsym, span))
    n1 = _fused_stage_n1(dec, fft_len, stage_n1)
    c = _device_constants(taps.tobytes(), k, dec, fft_len, n1, str(x.device))
    if n1 is not None:
        n2 = span // n1
        xv = frames.reshape(batch + (nsym, n1, n2))
        if _staged_layout:
            a = torch.einsum("...nm,nk->k...m", xv, c["f1"])
            z = torch.einsum("k...m,kmd->k...d", a, c["gp"])  # [k1, ..., nsym, d]
        else:
            a = torch.einsum("...nm,nk->...km", xv, c["f1"])
            zk = torch.einsum("...km,kmd->...kd", a, c["gp"])
            # output index j = k1 + n1*d -> natural order is (d, k1)
            z = zk.transpose(-1, -2).reshape(batch + (nsym, fft_len))
    else:
        if _staged_layout:
            raise ValueError(
                "_staged_layout requires the two-einsum geometry"
            )
        spec = _fft.plan(span).fwd(frames) * c["hs"]
        # spectral fold = decimation in time
        z = spec.reshape(batch + (nsym, dec, fft_len)).sum(dim=-2) * (1.0 / dec)

    if k > 1:
        tails = frames[..., :, span - (k - 1):]
        h0 = _history(history, batch, k, x.device)[..., None, :]
        prev = torch.cat([h0, tails[..., :-1, :]], dim=-2)
        delta = tails - prev
        if _staged_layout:
            ecorr = torch.einsum("...nu,ukd->k...nd", delta, c["cm_kd"])
        else:
            ecorr = torch.einsum("...nu,uk->...nk", delta, c["cm"])
        z = z - ecorr
    return scale.apply(z)
