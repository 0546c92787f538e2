"""Digital down- and up-converters (PyTorch): channel extraction and its
transmit dual.

Counterpart of ``aether_primitives_tpu/models/ddc.py``:

- :class:`Ddc`: ``y = decimate(lowpass(x * e^{-j 2 pi f n}))``, the exact-mod
  NCO (:func:`..ops.frontend.nco_mix`) then the decimating overlap-save FIR
  (:func:`..ops.fir.fir_filter_os_decimate`), whose inverse transform is
  ``1/decimation`` the size;
- :func:`ddc_bank`: ``C`` arbitrarily placed channels of one capture at
  once (the non-uniform counterpart of the PFB);
- :class:`Duc`: polyphase interpolation (``L`` low-rate overlap-save branch
  filters, interleaved) then the NCO mix up to the carrier;
- :func:`sharded_ddc` and :func:`sharded_duc`: both over a capture sharded
  into contiguous time spans on a device mesh, the filter history crossing
  the shard boundaries through the halo exchange
  (:func:`~aether_primitives_tpu_torch.parallel.halo.left_tail`: the
  peer-push kernel on CUDA shards).

The stages carry the oscillator phase (host float64) and the filter
history (the last ``K-1`` mixed samples for the DDC, the last ``kb-1``
inputs for the DUC), so a capture fed block by block equals the one-shot
computation. They run on an explicit ``device``, ``"cuda"`` by default,
which raises RuntimeError without a CUDA device. Apart from the sharded
forms' halo kernel no kernel of the port runs here: the work is
``torch.fft`` and elementwise.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..ops import fir as _fir
from ..ops import frontend as _fe
from ..ops.fft import check_backend
from ..parallel.halo import left_tail
from ..parallel.mesh import TIME_AXIS, Mesh, Sharded, shard_last
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
    ``block_len``: overlap-save block (None: the FIR op's default).
    ``fft_backend``: None or ``"xla"`` (cuFFT, the port's one FFT backend;
    see :func:`~aether_primitives_tpu_torch.ops.fft.check_backend`).
    """

    freq: float = 0.0
    decimation: int = 4
    taps: Optional[np.ndarray] = None
    block_len: Optional[int] = None
    fft_backend: Optional[str] = None

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
        check_backend(config.fft_backend)
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


def ddc_bank(x, freqs, decimation: int, taps=None,
             fft_backend: Optional[str] = None) -> torch.Tensor:
    """Extract ``C`` arbitrarily placed channels of a 1-D capture at once:
    each row of a ``[C, n]`` broadcast mixes by its own float64-exact NCO
    tables, and all rows share one batched decimating overlap-save. Returns
    ``[C, ceil(n/decimation)]``; one-shot (phase 0). For streaming, run one
    :class:`Ddc` per channel."""
    check_backend(fft_backend)
    x = as_cf32(x)
    if x.ndim != 1:
        raise ValueError("ddc_bank takes a 1-D capture")
    f = np.asarray(freqs, np.float64).ravel()
    if taps is None:
        taps = DdcConfig(decimation=decimation).resolved_taps()
    mixed = _fe.nco_mix(x.expand(f.shape[0], x.shape[-1]), -f)
    return _fir.fir_filter_os_decimate(mixed, taps, decimation)


def _shard_rotators(freq: float, step: int, size: int) -> np.ndarray:
    """Float64-exact per-shard oscillator phases ``e^{j 2 pi freq * i * step}``,
    ``i < size``, rounded to complex64 once."""
    cyc = np.mod(np.float64(freq) * step * np.arange(size), 1.0)
    return np.exp(2j * np.pi * cyc).astype(np.complex64)


def sharded_ddc(x, config: DdcConfig, mesh: Mesh, axis_name: str = TIME_AXIS) -> Sharded:
    """DDC over a time-sharded capture: equal to rounding to
    ``Ddc(config).step`` on the gathered signal. Returns the
    :class:`~aether_primitives_tpu_torch.parallel.mesh.Sharded` baseband.

    Each shard holds a contiguous span of the capture. Two pieces make the
    result exactly continuous across shards:

    - **global oscillator phase**: shard ``i`` starts at global sample
      ``i * n_local``, so its local mix is the phase-0 mix rotated by the
      per-shard constant ``e^{-j 2 pi f i n_local}``, a float64-exact host
      table indexed by the shard's position (no long in-shard ramps, the
      same precision as the exact-mod NCO);
    - **filter halo**: the left neighbour's last ``K-1`` *mixed* samples
      arrive through the halo exchange as the decimating overlap-save
      history.

    ``n_local`` must be divisible by ``decimation`` so the decimated
    streams concatenate on the global grid.
    """
    size = mesh.shape[axis_name]
    n = np.shape(x)[-1]
    if n % size:
        raise ValueError(f"capture length {n} must divide over {size} shards")
    n_local = n // size
    if n_local % config.decimation:
        raise ValueError(
            f"local shard length {n_local} must be divisible by the "
            f"decimation {config.decimation}"
        )
    taps = config.resolved_taps()
    rotators = _shard_rotators(-config.freq, n_local, size)
    xs = shard_last(x, mesh, axis_name, dtype=cf32)
    mixed = xs.map(lambda xl, index: complex(rotators[index[axis_name]])
                   * _fe.nco_mix(xl, -config.freq), with_index=True)
    k = taps.shape[-1]
    h = left_tail(mixed, k - 1, axis_name) if k > 1 else None
    return mixed.map(lambda ml, hl: _fir.fir_filter_os_decimate(
        ml, taps, config.decimation, block_len=config.block_len, history=hl), h)


@dataclass(frozen=True)
class DucConfig:
    """Digital up-converter parameters.

    ``freq``: carrier, cycles/sample at the OUTPUT rate.
    ``interpolation``: output rate = input rate * interpolation.
    ``taps``: interpolation lowpass at the output rate (None: cutoff
    ``1/(2*interpolation)``, ``16*interpolation + 1`` taps, gain
    ``interpolation``, so a passband tone keeps its amplitude).
    ``block_len``: overlap-save block of the branch filters.
    ``fft_backend``: as in :class:`DdcConfig`.
    """

    freq: float = 0.0
    interpolation: int = 4
    taps: Optional[np.ndarray] = None
    block_len: Optional[int] = None
    fft_backend: Optional[str] = None

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
        check_backend(config.fft_backend)
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


def sharded_duc(x, config: DucConfig, mesh: Mesh, axis_name: str = TIME_AXIS) -> Sharded:
    """DUC over a time-sharded baseband: equal to rounding to
    ``Duc(config).step`` on the gathered signal. Returns the
    :class:`~aether_primitives_tpu_torch.parallel.mesh.Sharded` output.

    The mirror of :func:`sharded_ddc`: each shard runs the polyphase branch
    filters with the left neighbour's ``kb-1`` input samples as overlap-save
    history (the halo exchange), interleaves locally (a shard's ``n_local``
    inputs produce exactly its ``n_local * L`` contiguous outputs: the
    interleave never crosses shards), and mixes up with a per-shard
    float64-exact oscillator rotator at the OUTPUT rate.
    """
    size = mesh.shape[axis_name]
    n = np.shape(x)[-1]
    if n % size:
        raise ValueError(f"baseband length {n} must divide over {size} shards")
    n_local = n // size
    ell = int(config.interpolation)
    branches = _polyphase_branches(config.resolved_taps(), ell)
    kb = branches.shape[-1]
    rotators = _shard_rotators(config.freq, n_local * ell, size)
    xs = shard_last(x, mesh, axis_name, dtype=cf32)
    halo = left_tail(xs, kb - 1, axis_name) if kb > 1 else None

    def shard_fn(xl, hl, index):
        outs = [_fir.fir_filter_os(xl, branches[t], block_len=config.block_len, history=hl)
                for t in range(ell)]
        y = torch.stack(outs, dim=-1).reshape(xl.shape[:-1] + (xl.shape[-1] * ell,))
        return complex(rotators[index[axis_name]]) * _fe.nco_mix(y, config.freq)

    return xs.map(shard_fn, halo, with_index=True)
