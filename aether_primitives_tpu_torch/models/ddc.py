"""Digital down- and up-converters (PyTorch): channel extraction and its
transmit dual.

Counterpart of ``aether_primitives_tpu/models/ddc.py`` without the sharded
entry points:

- :class:`Ddc`: ``y = decimate(lowpass(x * e^{-j 2 pi f n}))``, the exact-mod
  NCO (:func:`..ops.frontend.nco_mix`) then the decimating overlap-save FIR
  (:func:`..ops.fir.fir_filter_os_decimate`), whose inverse transform is
  ``1/decimation`` the size;
- :func:`ddc_bank`: ``C`` arbitrarily placed channels of one capture at
  once (the non-uniform counterpart of the PFB);
- :class:`Duc`: polyphase interpolation (``L`` low-rate overlap-save branch
  filters, interleaved) then the NCO mix up to the carrier.

The stages carry the oscillator phase (host float64) and the filter
history (the last ``K-1`` mixed samples for the DDC, the last ``kb-1``
inputs for the DUC), so a capture fed block by block equals the one-shot
computation. They run on an explicit ``device``, ``"cuda"`` by default,
which raises RuntimeError without a CUDA device. No kernel of the port
runs here: the work is ``torch.fft`` and elementwise.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..ops import fir as _fir
from ..ops import frontend as _fe
from ..types import as_cf32, cf32, stage_device


def _design_lowpass(ntaps: int, cutoff: float) -> np.ndarray:
    """Hamming-windowed sinc, unit DC gain (the chain's house design)."""
    n = np.arange(ntaps) - (ntaps - 1) / 2.0
    h = 2 * cutoff * np.sinc(2 * cutoff * n)
    h *= np.hamming(ntaps)
    return (h / h.sum()).astype(np.complex64)


def _carry(history: Optional[torch.Tensor], x: torch.Tensor, keep: int) -> torch.Tensor:
    """The last ``keep`` samples of the stream ``history ++ x`` (zeros
    before the stream start), as a new tensor."""
    n = x.shape[-1]
    if n >= keep:
        return x[..., n - keep:].clone()
    prev = (history if history is not None
            else torch.zeros(x.shape[:-1] + (keep,), dtype=cf32, device=x.device))
    return torch.cat([prev[..., n:], x], dim=-1)


@dataclass(frozen=True)
class DdcConfig:
    """Digital down-converter parameters.

    ``freq``: channel center, cycles/sample at the INPUT rate.
    ``decimation``: output rate = input rate / decimation.
    ``taps``: channel-select lowpass (None: Hamming-windowed sinc, cutoff
    ``1/(2*decimation)``, ``16*decimation + 1`` taps).
    ``block_len``: overlap-save block (None: the FIR op's default). The JAX
    config's ``fft_backend`` has no counterpart: the port has one FFT.
    """

    freq: float = 0.0
    decimation: int = 4
    taps: Optional[np.ndarray] = None
    block_len: Optional[int] = None

    def resolved_taps(self) -> np.ndarray:
        if self.taps is not None:
            return np.asarray(self.taps, np.complex64).ravel()
        if self.decimation == 1:
            return np.asarray([1.0 + 0j], np.complex64)
        return _design_lowpass(16 * self.decimation + 1, 1.0 / (2 * self.decimation))


class Ddc:
    """Streaming digital down-converter on ``device``.

    ``step(block)`` takes ``[..., n]`` complex64 samples at the input rate
    and returns ``ceil(n / decimation)`` baseband samples; the oscillator
    phase and the ``K-1``-sample filter history carry across calls.

    >>> import numpy as np
    >>> t = np.arange(4096)
    >>> x = np.exp(2j * np.pi * 0.2 * t).astype(np.complex64)
    >>> y = Ddc(DdcConfig(freq=0.2, decimation=4), device="cpu").step(x).numpy()
    >>> y.shape
    (1024,)
    >>> bool(np.abs(np.fft.fft(y[256:768])).argmax() == 0)
    True
    """

    def __init__(self, config: DdcConfig = DdcConfig(), device="cuda"):
        self.config = config
        self.device = stage_device(device, "Ddc")
        self.taps = config.resolved_taps()
        self._phase = 0.0
        self._history: Optional[torch.Tensor] = None

    def step(self, block) -> torch.Tensor:
        x = as_cf32(block, device=self.device)
        n = x.shape[-1]
        mixed = _fe.nco_mix(x, -self.config.freq, self._phase)
        y = _fir.fir_filter_os_decimate(
            mixed, self.taps, self.config.decimation,
            block_len=self.config.block_len, history=self._history,
        )
        k = self.taps.shape[-1]
        if k > 1:
            self._history = _carry(self._history, mixed, k - 1)
        self._phase = float(_fe.next_phase(n, -self.config.freq, self._phase))
        return y

    __call__ = step


def ddc_bank(x, freqs, decimation: int, taps=None) -> torch.Tensor:
    """Extract ``C`` arbitrarily placed channels of a 1-D capture at once:
    each row of a ``[C, n]`` broadcast mixes by its own float64-exact NCO
    tables, and all rows share one batched decimating overlap-save. Returns
    ``[C, ceil(n/decimation)]``; one-shot (phase 0). For streaming, run one
    :class:`Ddc` per channel."""
    x = as_cf32(x)
    if x.ndim != 1:
        raise ValueError("ddc_bank takes a 1-D capture")
    f = np.asarray(freqs, np.float64).ravel()
    if taps is None:
        taps = DdcConfig(decimation=decimation).resolved_taps()
    mixed = _fe.nco_mix(x.expand(f.shape[0], x.shape[-1]), -f)
    return _fir.fir_filter_os_decimate(mixed, taps, decimation)


@dataclass(frozen=True)
class DucConfig:
    """Digital up-converter parameters.

    ``freq``: carrier, cycles/sample at the OUTPUT rate.
    ``interpolation``: output rate = input rate * interpolation.
    ``taps``: interpolation lowpass at the output rate (None: cutoff
    ``1/(2*interpolation)``, ``16*interpolation + 1`` taps, gain
    ``interpolation``, so a passband tone keeps its amplitude).
    ``block_len``: overlap-save block of the branch filters.
    """

    freq: float = 0.0
    interpolation: int = 4
    taps: Optional[np.ndarray] = None
    block_len: Optional[int] = None

    def resolved_taps(self) -> np.ndarray:
        if self.taps is not None:
            return np.asarray(self.taps, np.complex64).ravel()
        if self.interpolation == 1:
            return np.asarray([1.0 + 0j], np.complex64)
        h = _design_lowpass(16 * self.interpolation + 1, 1.0 / (2 * self.interpolation))
        return (h * self.interpolation).astype(np.complex64)


def _polyphase_branches(taps: np.ndarray, ell: int) -> np.ndarray:
    """``[L, kb]`` polyphase decomposition: branch ``t`` holds
    ``h[t], h[t+L], h[t+2L], ...`` (zero-padded to equal length)."""
    k = taps.shape[-1]
    kb = -(-k // ell)
    padded = np.zeros(kb * ell, np.complex64)
    padded[:k] = taps
    return padded.reshape(kb, ell).T.copy()


class Duc:
    """Streaming digital up-converter on ``device``: with ``L`` branches the
    interpolated signal is ``y[L*u + t] = sum_m h[t + L*m] * x[u - m]``, ``L``
    low-rate overlap-save FIRs whose outputs interleave; the zero-stuffed
    stream never exists. Then the NCO mix to ``freq``."""

    def __init__(self, config: DucConfig = DucConfig(), device="cuda"):
        self.config = config
        self.device = stage_device(device, "Duc")
        self.taps = config.resolved_taps()
        self._branches = _polyphase_branches(self.taps, int(config.interpolation))
        self._phase = 0.0
        self._history: Optional[torch.Tensor] = None

    def step(self, block) -> torch.Tensor:
        x = as_cf32(block, device=self.device)
        n = x.shape[-1]
        ell = int(self.config.interpolation)
        kb = self._branches.shape[-1]
        hist = None if self._history is None or kb == 1 else self._history[..., -(kb - 1):]
        outs = [
            _fir.fir_filter_os(x, self._branches[t], block_len=self.config.block_len,
                               history=hist)
            for t in range(ell)
        ]
        y = torch.stack(outs, dim=-1).reshape(x.shape[:-1] + (n * ell,))
        if kb > 1:
            self._history = _carry(self._history, x, kb - 1)
        y = _fe.nco_mix(y, self.config.freq, self._phase)
        self._phase = float(_fe.next_phase(n * ell, self.config.freq, self._phase))
        return y

    __call__ = step
