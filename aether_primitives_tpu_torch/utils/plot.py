"""Visualization (matplotlib): constellation, waterfall, spectrum, PSD, time,
compare, ambiguity surface, eye diagram and spatial spectrum.

Counterpart of ``aether_primitives_tpu/utils/plot.py``, with its signatures
(``file=None`` shows the figure; a filename saves it). matplotlib is
imported only inside the plotting calls (the Agg backend when saving), so
the package never needs it for compute. The compute cores run on the input
tensor's device and only their result crosses to the host for rendering:
:func:`spectrum_levels` (the first chunk's FFT), :func:`ambiguity_levels`
(the CAF surface), :func:`doa_levels` (the spatial spectrum in dB) and the
channelizer's waterfall and Welch PSD.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.fft import Scale, plan as fft_plan
from ..types import as_cf32


def _plt():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def _finish(fig, file: Optional[str]):
    if file is not None:
        fig.savefig(file, bbox_inches="tight")
        _plt().close(fig)
    else:  # pragma: no cover - interactive path
        _plt().show()


def _host(x) -> np.ndarray:
    """``x`` (a tensor on any device, or array-like) as host numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def constellation(symbols, title: str, file: Optional[str] = None):
    """Scatter of I/Q points."""
    plt = _plt()
    s = _host(symbols).reshape(-1)
    fig, ax = plt.subplots()
    ax.plot(s.real, s.imag, ".", color="blue", label="Constellation")
    ax.set_title(title)
    ax.set_xlabel("I")
    ax.set_ylabel("Q")
    ax.legend(loc="upper left")
    ax.grid(True, alpha=0.3)
    _finish(fig, file)


def waterfall(
    symbols,
    fft_len: int,
    use_db: bool,
    title: str,
    file: Optional[str] = None,
    fft_backend: Optional[str] = None,
):
    """Time-frequency map: per-chunk ``fft(SN)`` + fftshift + magnitude
    (:func:`~..models.channelizer.waterfall_spectra`, zero-padding the
    capture to a whole number of rows)."""
    from ..models.channelizer import waterfall_spectra

    plt = _plt()
    levels = _host(waterfall_spectra(as_cf32(symbols), fft_len, use_db=use_db,
                                     fft_backend=fft_backend))
    fig, ax = plt.subplots()
    im = ax.imshow(levels, aspect="auto", origin="lower", cmap="viridis")
    ax.set_title(title)
    ax.set_xlabel("bin")
    ax.set_ylabel("row (time)")
    fig.colorbar(im, ax=ax, label="Magnitude [dB]" if use_db else "Magnitude")
    _finish(fig, file)


def spectrum_levels(symbols, fft_len: int, use_db: bool,
                    fft_backend: Optional[str] = None) -> np.ndarray:
    """:func:`spectrum`'s curve: ``|fft(SN)|`` of the first ``fft_len``
    samples (zero-padded if shorter), ``10 log10`` of it with ``use_db``;
    computed on the input's device, returned as host numpy."""
    s = as_cf32(symbols).reshape(-1)
    if s.shape[-1] < fft_len:
        s = torch.nn.functional.pad(s, (0, fft_len - s.shape[-1]))
    mag = fft_plan(fft_len, fft_backend).fwd(s[:fft_len], Scale.SN).abs()
    if use_db:
        mag = 10.0 * torch.log10(mag)
    return _host(mag)


def spectrum(
    symbols,
    fft_len: int,
    use_db: bool,
    title: str,
    file: Optional[str] = None,
    fft_backend: Optional[str] = None,
):
    """Magnitude spectrum of the **first** ``fft_len`` chunk only."""
    plt = _plt()
    mag = spectrum_levels(symbols, fft_len, use_db, fft_backend)
    fig, ax = plt.subplots()
    ax.plot(np.arange(fft_len), mag, "-o", color="green", markersize=2, label="Spectrum")
    ax.set_title(title)
    ax.set_xlim(0, fft_len)
    ax.set_xlabel("bin")
    ax.set_ylabel("Magnitude [dB]" if use_db else "Magnitude")
    ax.legend(loc="upper left")
    _finish(fig, file)


def psd(
    samples,
    fft_len: int,
    title: str,
    file: Optional[str] = None,
    fs: float = 1.0,
    window: str = "hann",
    fft_backend: Optional[str] = None,
):
    """Welch power-spectral-density plot (dB/Hz, fftshifted frequencies)
    by :func:`~..models.channelizer.welch_psd`."""
    from ..models.channelizer import welch_psd as _welch

    plt = _plt()
    freqs, p = _welch(
        as_cf32(samples).reshape(-1), fft_len, window=window, fs=fs,
        fft_backend=fft_backend, shift=True,
    )
    fig, ax = plt.subplots()
    ax.plot(freqs, 10.0 * np.log10(_host(p) + 1e-30), color="green")
    ax.set_title(title)
    ax.set_xlabel("frequency" + (" [Hz]" if fs != 1.0 else " [cycles/sample]"))
    ax.set_ylabel("PSD [dB/Hz]")
    ax.grid(True, alpha=0.3)
    _finish(fig, file)


def time(symbol, title: str, file: Optional[str] = None):
    """Real/imag traces with a magnitude subplot."""
    plt = _plt()
    s = _host(symbol).reshape(-1)
    x = np.arange(len(s))
    mx = float(np.abs(s).max()) * 1.1 if len(s) else 1.0
    fig, (ax0, ax1) = plt.subplots(
        2, 1, sharex=True, gridspec_kw={"height_ratios": [3, 1]}
    )
    ax0.plot(x, s.real, "-o", color="blue", markersize=2, label="Real")
    ax0.plot(x, s.imag, "-o", color="red", markersize=2, label="Imaginary")
    ax0.set_xlim(0, len(s))
    ax0.set_ylim(-mx, mx)
    ax0.set_title(title)
    ax0.legend(loc="upper left", ncols=2)
    ax1.plot(x, np.abs(s), color="green", label="Magnitude")
    ax1.set_ylim(0, mx)
    ax1.legend(loc="upper left")
    _finish(fig, file)


def compare(symbols1, symbols2, title: str, file: Optional[str] = None):
    """Two signals overlaid + |error| subplot. Lengths must match."""
    plt = _plt()
    a = _host(symbols1).reshape(-1)
    b = _host(symbols2).reshape(-1)
    if len(a) != len(b):
        raise ValueError("Can only plot vectors of equal length")
    x = np.arange(len(a))
    err = np.abs(a - b)
    fig, (ax0, ax1) = plt.subplots(
        2, 1, sharex=True, gridspec_kw={"height_ratios": [3, 1]}
    )
    ax0.plot(x, a.real, "-", color="green", label="Input 0: real")
    ax0.plot(x, a.imag, ":", color="green", label="Input 0: imaginary")
    ax0.plot(x, b.real, "-", color="blue", label="Input 1: real")
    ax0.plot(x, b.imag, ":", color="blue", label="Input 1: imaginary")
    ax0.set_xlim(0, len(a))
    ax0.set_title(title)
    ax0.legend(loc="upper left", fontsize=7, ncols=2)
    ax1.plot(x, err, "-.", color="red", label="Deviation")
    ax1.legend(loc="upper left")
    _finish(fig, file)


def ambiguity_levels(x, ref, max_doppler: float, n_dopplers: int = 64,
                     use_db: bool = True):
    """:func:`ambiguity_surface`'s image: ``(dopplers float64 numpy,
    |CAF| [n_dopplers, N] float32 numpy)`` (``20 log10`` of it, floored at
    1e-12, with ``use_db``); the surface computed on ``x``'s device."""
    from ..models.caf import ambiguity as _caf

    dops = np.linspace(-max_doppler, max_doppler, int(n_dopplers))
    surf = _caf(x, ref, dops.astype(np.float32)).abs()
    if use_db:
        surf = 20.0 * torch.log10(torch.clamp_min(surf, 1e-12))
    return dops, _host(surf)


def ambiguity_surface(
    x,
    ref,
    max_doppler: float,
    n_dopplers: int = 64,
    title: str = "ambiguity",
    use_db: bool = True,
    file: Optional[str] = None,
):
    """Delay-Doppler magnitude surface of the cross-ambiguity function
    (:func:`~..models.caf.ambiguity`): rows are Doppler hypotheses,
    columns circular delay; the peak marks the detected (delay, doppler)."""
    dops, surf = ambiguity_levels(x, ref, max_doppler, n_dopplers, use_db)
    plt = _plt()
    fig, ax = plt.subplots(figsize=(9, 5))
    im = ax.imshow(
        surf,
        aspect="auto",
        origin="lower",
        extent=[0, surf.shape[1], dops[0], dops[-1]],
        cmap="viridis",
    )
    ax.set_xlabel("delay [samples]")
    ax.set_ylabel("doppler [cycles/sample]")
    ax.set_title(title)
    fig.colorbar(im, ax=ax, label="|CAF| [dB]" if use_db else "|CAF|")
    _finish(fig, file)


def eye(
    x,
    sps: int,
    n_traces: int = 200,
    offset: int = 0,
    title: str = "eye",
    file: Optional[str] = None,
):
    """Eye diagram: overlay of 2-symbol-long segments of a pulse-shaped
    stream (I on top, Q below); ``offset`` shifts the fold so a recovered
    timing phase can be centered in the eye."""
    xs = _host(x).astype(np.complex64)
    seg = 2 * int(sps)
    start = int(offset) % int(sps)
    n_avail = (len(xs) - start - 1) // seg
    n = min(int(n_traces), n_avail)
    if n <= 0:
        raise ValueError("stream too short for one eye trace")
    traces = xs[start:start + n * seg].reshape(n, seg)
    t = np.arange(seg + 1) / float(sps)
    # close each trace with the first sample of the next segment
    nxt = xs[start + seg:start + n * seg + 1:seg]
    if len(nxt) < n:
        traces, n = traces[:len(nxt)], len(nxt)
    closed = np.concatenate([traces, nxt[:n, None]], axis=1)
    plt = _plt()
    fig, (ax0, ax1) = plt.subplots(2, 1, figsize=(8, 6), sharex=True)
    for row in closed:
        ax0.plot(t, row.real, color="steelblue", alpha=0.15, lw=0.8)
        ax1.plot(t, row.imag, color="darkorange", alpha=0.15, lw=0.8)
    ax0.set_ylabel("I")
    ax1.set_ylabel("Q")
    ax1.set_xlabel("time [symbols]")
    ax0.set_title(title)
    _finish(fig, file)


def doa_levels(angles, spectrum):
    """:func:`doa_spectrum`'s curve: ``(degrees, dB relative to the peak)``
    as float64 host numpy, computed in float64 on ``spectrum``'s device."""
    s = torch.as_tensor(spectrum).to(torch.float64).abs()
    s_db = 10.0 * torch.log10(s / (s.max() + 1e-30) + 1e-12)
    return np.degrees(_host(angles).astype(np.float64)), _host(s_db)


def doa_spectrum(
    angles,
    spectrum,
    title: str = "spatial spectrum",
    estimates=None,
    file: Optional[str] = None,
):
    """Spatial (MUSIC/Capon) pseudo-spectrum vs bearing, in dB relative to
    the peak; optional vertical markers at estimated bearings."""
    ang, s_db = doa_levels(angles, spectrum)
    plt = _plt()
    fig, ax = plt.subplots(figsize=(8, 4))
    ax.plot(ang, s_db, lw=1.2)
    if estimates is not None:
        for e in np.degrees(np.atleast_1d(_host(estimates).astype(np.float64))):
            ax.axvline(e, color="darkorange", ls="--", lw=1.0)
    ax.set_xlabel("bearing [deg from broadside]")
    ax.set_ylabel("power [dB rel. peak]")
    ax.set_title(title)
    ax.grid(True, alpha=0.3)
    _finish(fig, file)
