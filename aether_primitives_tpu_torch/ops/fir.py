"""Causal FIR filtering and the fused FIR -> decimate -> frame-FFT op (PyTorch).

Counterpart of ``aether_primitives_tpu/ops/fir.py``, subset:
:func:`fir_filter`, :func:`fir_filter_decimate`, :func:`fir_decimate_fft`,
the overlap-save :func:`fir_filter_os` / :func:`matched_filter` of the
burst receiver's preamble search, the DDC's decimating overlap-save
:func:`fir_filter_os_decimate`, and host copies (numpy only, pinned equal
by the tests) of :func:`rrc_taps` and the float64 constant builders
:func:`_fused_stage_matrices` and :func:`_fused_rx_matrices`, so that both
packages contract against byte-identical constants. These functions are the plain PyTorch versions; the hand-written
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


def _taps_1d(taps, fn: str) -> np.ndarray:
    """``taps`` as a host complex64 ``[K]``; per-row taps raise (only
    :func:`fir_filter_os` and :func:`matched_filter` filter each row by its
    own taps)."""
    taps = np.asarray(taps, dtype=np.complex64)
    if taps.ndim > 1:
        raise ValueError(
            f"{fn} takes one [K] tap vector, got taps of shape {taps.shape}; "
            "per-row taps go through fir_filter_os"
        )
    return taps.reshape(-1)


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
    taps = _taps_1d(taps, "fir_filter")
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


def fir_filter_decimate(x, taps, factor: int, padding: str = "causal") -> torch.Tensor:
    """Fused causal FIR + decimation: ``y[m] = sum_k taps[k] x[m*factor - k]``,
    equal to ``fir_filter(x, taps)[..., ::factor]`` but computing only the
    kept outputs.

    ``padding="causal"`` starts from zero history; ``padding="valid"``
    takes an input already extended by its ``K-1``-sample history and
    emits ``(n - K + 1 - 1) // factor + 1`` outputs aligned to the first
    fresh sample. The shift-and-add over K strided slices of the float32
    planes keeps the JAX package's order of operations.
    """
    x = as_cf32(x)
    taps = _taps_1d(taps, "fir_filter_decimate")
    k = taps.shape[-1]
    s = int(factor)
    if padding == "causal":
        x = torch.nn.functional.pad(x, (k - 1, 0))
    elif padding != "valid":
        raise ValueError(f"unknown padding {padding!r} (expected 'causal' or 'valid')")
    n_out = (x.shape[-1] - k) // s + 1
    xr, xi = x.real, x.imag
    yr = torch.zeros(x.shape[:-1] + (n_out,), dtype=torch.float32, device=x.device)
    yi = torch.zeros_like(yr)
    for t in range(k):
        start = k - 1 - t  # column for tap t: ext[m*s + (k-1) - t]
        sr = xr[..., start:start + (n_out - 1) * s + 1:s]
        si = xi[..., start:start + (n_out - 1) * s + 1:s]
        a = float(taps[t].real)
        b = float(taps[t].imag)
        yr = yr + a * sr - b * si
        yi = yi + a * si + b * sr
    return torch.complex(yr, yi)


def rrc_taps(sps: int, span: int = 10, beta: float = 0.35) -> np.ndarray:
    """Root-raised-cosine pulse-shaping taps (host f64 design, complex64).

    ``sps`` samples/symbol, ``span`` symbols each side (length
    ``2*span*sps + 1``), roll-off ``beta`` in (0, 1]. Normalized to unit
    energy so a matched TX/RX pair has unity cascade gain at the symbol
    instants. The standard pulse for the timing-recovery path
    (:func:`~aether_primitives_tpu.models.sync.estimate_timing` needs the
    excess-bandwidth line beta > 0 provides).
    """
    if not 0.0 < beta <= 1.0:
        raise ValueError("beta must be in (0, 1]")
    t = np.arange(-span * sps, span * sps + 1, dtype=np.float64) / sps
    h = np.empty_like(t)
    for i, ti in enumerate(t):
        if abs(ti) < 1e-12:
            h[i] = 1.0 - beta + 4.0 * beta / np.pi
        elif abs(abs(4.0 * beta * ti) - 1.0) < 1e-9:
            h[i] = (beta / np.sqrt(2.0)) * (
                (1.0 + 2.0 / np.pi) * np.sin(np.pi / (4.0 * beta))
                + (1.0 - 2.0 / np.pi) * np.cos(np.pi / (4.0 * beta))
            )
        else:
            num = np.sin(np.pi * ti * (1.0 - beta)) + 4.0 * beta * ti * np.cos(
                np.pi * ti * (1.0 + beta)
            )
            den = np.pi * ti * (1.0 - (4.0 * beta * ti) ** 2)
            h[i] = num / den
    h /= np.sqrt(np.sum(h * h))
    return h.astype(np.complex64)


def check_precision(precision) -> None:
    """Accept the matmul precisions a call may name: None and ``"highest"``
    (full float32, the port's only setting). The JAX package's ``"high"``
    is the TPU's bf16x3 MXU mode and raises, as does any other value."""
    name = precision if precision is None or isinstance(precision, str) else str(precision)
    if name is None or name.lower() in ("highest", "precision.highest"):
        return
    if name.lower() in ("high", "precision.high"):
        raise ValueError(
            "precision 'high' is the TPU's bf16x3 matmul setting and has no "
            "counterpart on the GPU; the port computes in full float32 "
            "('highest')"
        )
    raise ValueError(f"precision {precision!r} not allowed (expected 'highest')")


def _good_fft_size(n: int) -> int:
    """Smallest 7-smooth integer >= n (factors only 2, 3, 5, 7), the JAX
    package's overlap-save transform size (e.g. 1151 -> 1152)."""
    best = 1
    while best < n:
        best *= 2
    smooth = [1]
    for p in (2, 3, 5, 7):
        smooth = sorted(
            {s * p**e for s in smooth for e in range(0, 20) if s * p**e <= best}
        )
    for s in smooth:
        if s >= n:
            return int(s)
    return int(best)


def fir_filter_os(x, taps, block_len: Optional[int] = None,
                  fft_backend: Optional[str] = None, history=None,
                  fft_len: Optional[int] = None) -> torch.Tensor:
    """Causal FIR by overlap-save block convolution on ``torch.fft``.

    Blocks of ``block_len`` fresh samples, each extended with the previous
    ``K-1`` samples (``history`` before the first block, zeros when None),
    are multiplied by the tap spectrum and inverse-transformed; the first
    ``K-1`` outputs of each block are dropped. Equal (to rounding) to
    :func:`fir_filter`. ``taps``: ``[K]``, or ``[..., K]`` with leading
    axes that broadcast against ``x``'s batch axes: each row filtered by
    its own taps, as in the JAX package. ``fft_backend``: see
    :func:`~aether_primitives_tpu_torch.ops.fft.check_backend`. The
    defaults are the JAX package's: the power of two nearest ``max(1024,
    8 K)`` (at most the signal length) and the smallest 7-smooth transform
    that holds ``block_len + K - 1``.
    """
    _fft.check_backend(fft_backend)
    x = as_cf32(x)
    taps = as_cf32(taps, device=x.device)
    n = x.shape[-1]
    k = taps.shape[-1]
    if block_len is None:
        target = max(1024, 8 * k)
        block_len = 1024
        while block_len * 2 <= target:
            block_len *= 2
        block_len = min(block_len, max(n, k - 1 if k > 1 else 1))
    block_len = int(block_len)
    if k > 1 and block_len < k - 1:
        raise ValueError(f"block_len {block_len} must be >= taps-1 ({k - 1})")
    n_pad = -(-n // block_len) * block_len
    if n_pad != n:
        x = torch.nn.functional.pad(x, (0, n_pad - n))
    if fft_len is None:
        fft_len = _good_fft_size(block_len + k - 1)
    elif fft_len < block_len + k - 1:
        raise ValueError(f"fft_len {fft_len} < block_len + taps - 1")
    nblocks = n_pad // block_len
    batch = tuple(x.shape[:-1])
    xb = x.reshape(batch + (nblocks, block_len))
    if k > 1:
        h0 = _history(history, batch, k, x.device)[..., None, :]
        hist = torch.cat([h0, xb[..., :-1, block_len - (k - 1):]], dim=-2)
        ext = torch.cat([hist, xb], dim=-1)  # [..., nblocks, K-1+block_len]
    else:
        ext = xb
    ext = torch.nn.functional.pad(ext, (0, fft_len - ext.shape[-1]))
    h = torch.nn.functional.pad(taps, (0, fft_len - k))
    plan = _fft.plan(fft_len)
    hspec = plan.fwd(h, Scale.NONE)
    if h.ndim > 1:  # per-row taps: broadcast across the block axis
        hspec = hspec[..., None, :]
    y = plan.bwd(plan.fwd(ext, Scale.NONE) * hspec, Scale.N)
    y = y[..., k - 1:k - 1 + block_len]
    return y.reshape(batch + (n_pad,))[..., :n]


@functools.lru_cache(maxsize=None)
def _rotated_tap_spectrum(taps_bytes: bytes, k: int, fft_len: int, device: str):
    """The tap spectrum times the overlap-save discard rotation
    ``e^{+2 pi i q (K-1) / fft_len}``, built in float64 on the host and
    uploaded once per ``(taps, fft_len, device)``."""
    taps = np.frombuffer(taps_bytes, dtype=np.complex64)
    hs = np.fft.fft(taps.astype(np.complex128), fft_len)
    hs *= np.exp(2j * np.pi * np.arange(fft_len) * (k - 1) / fft_len)
    return torch.from_numpy(hs.astype(np.complex64)).to(device)


def fir_filter_os_decimate(x, taps, factor: int, block_len: Optional[int] = None,
                           fft_backend: Optional[str] = None,
                           history=None) -> torch.Tensor:
    """Fused overlap-save FIR + decimation with a time-domain output,
    ``y[m] = sum_k taps[k] x[m*factor - k]`` (equal, to rounding, to
    :func:`fir_filter_decimate`), the core of the DDC.

    Keeping every ``factor``-th sample of a block's circular convolution is
    a fold of its spectrum: with ``M = fft_len / factor``, ``y_dec =
    iFFT_M(fold)``, ``fold[r] = (1/factor) sum_p Y[r + p*M]``, where the
    product spectrum ``Y`` is pre-rotated so that the overlap-save discard
    of the first ``K-1`` samples lands on fold index 0 (the rotation rides
    the tap spectrum, :func:`_rotated_tap_spectrum`). The backward FFT runs
    at ``1/factor`` the points. ``M`` is the smallest 7-smooth size that
    holds the block, as in the JAX package.

    Outputs sit at global multiples of ``factor``: ``ceil(n / factor)``
    samples. ``history``: optional ``[..., K-1]`` samples preceding ``x``.
    ``taps``: host numpy ``[K]``. ``fft_backend``: see
    :func:`~aether_primitives_tpu_torch.ops.fft.check_backend`.
    """
    _fft.check_backend(fft_backend)
    x = as_cf32(x)
    taps = _taps_1d(taps, "fir_filter_os_decimate")
    n = x.shape[-1]
    k = taps.shape[-1]
    s = int(factor)
    if s < 1:
        raise ValueError("factor must be >= 1")
    if s == 1:
        return fir_filter_os(x, taps, block_len=block_len, history=history)
    if block_len is None:
        target = max(1024, 8 * k)
        block_len = s
        while block_len * 2 <= target:
            block_len *= 2
    block_len = int(block_len)
    if block_len % s:
        raise ValueError(f"block_len {block_len} must be a multiple of {s}")
    if k > 1 and block_len < k - 1:
        raise ValueError(f"block_len {block_len} must be >= taps-1 ({k - 1})")
    m_len = _good_fft_size(-(-(block_len + k - 1) // s))
    fft_len = s * m_len

    n_pad = -(-n // block_len) * block_len
    if n_pad != n:
        x = torch.nn.functional.pad(x, (0, n_pad - n))
    nblocks = n_pad // block_len
    batch = tuple(x.shape[:-1])
    xb = x.reshape(batch + (nblocks, block_len))
    if k > 1:
        h0 = _history(history, batch, k, x.device)[..., None, :]
        hist = torch.cat([h0, xb[..., :-1, block_len - (k - 1):]], dim=-2)
        ext = torch.cat([hist, xb], dim=-1)
    else:
        ext = xb
    ext = torch.nn.functional.pad(ext, (0, fft_len - ext.shape[-1]))
    hs = _rotated_tap_spectrum(taps.tobytes(), k, fft_len, str(x.device))
    spec = _fft.plan(fft_len).fwd(ext) * hs
    fold = spec.reshape(spec.shape[:-1] + (s, m_len)).mean(dim=-2)
    yd = _fft.plan(m_len).bwd(fold, Scale.N)[..., :block_len // s]
    return yd.reshape(batch + (n_pad // s,))[..., :-(-n // s)]


def matched_filter(x, ref, block_len: Optional[int] = None,
                   fft_backend: Optional[str] = None, history=None) -> torch.Tensor:
    """Linear sliding correlation against ``ref`` by overlap-save:
    ``y[n] = sum_m x[n - m] conj(ref[M-1 - m])``, so ``|y|`` peaks at
    ``n = offset + M - 1`` where ``ref`` starts at ``offset``. ``ref``
    ``[..., M]``: leading axes are per-row references, as the taps of
    :func:`fir_filter_os`."""
    if isinstance(ref, torch.Tensor):
        taps = ref.to(cf32).conj().flip(-1)
    else:
        taps = np.conj(np.asarray(ref, dtype=np.complex64))[..., ::-1].copy()
    return fir_filter_os(x, taps, block_len=block_len, fft_backend=fft_backend,
                         history=history)


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
    fft_backend: Optional[str] = None,
    precision=None,
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

    ``x``: ``[..., n]`` with ``n % span == 0``. ``taps``: host numpy
    ``[K]``. ``history``: optional ``[..., K-1]`` samples preceding ``x``.
    ``fft_backend``: see :func:`~aether_primitives_tpu_torch.ops.fft.
    check_backend`; ``precision``: None or ``"highest"`` (full float32, the
    only setting; the JAX package's reduced MXU precisions are TPU
    settings). Returns
    ``[..., n // span, fft_len]`` spectra scaled by ``scale``; with
    ``_staged_layout=True`` (two-einsum path only) ``[n1, ..., nsym, r]``
    with ``k1`` leading and natural bin ``k = k1 + n1*d``; callers of the
    staged layout pass ``Scale.NONE`` (a scale would read ``r`` as the
    transform length).
    """
    _fft.check_backend(fft_backend)
    check_precision(precision)
    x = as_cf32(x)
    taps = _taps_1d(taps, "fir_decimate_fft")
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
