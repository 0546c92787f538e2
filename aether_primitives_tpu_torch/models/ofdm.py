"""Cyclic-prefix OFDM (PyTorch): modulator, demodulator, and CP-based and
Schmidl-Cox timing/CFO synchronization.

Counterpart of ``aether_primitives_tpu/models/ofdm.py``. Multipath shorter
than the CP becomes a pure per-bin complex gain, so the one-tap
:class:`~.sync.OfdmEqualizer` is exact, and frame alignment and CFO come
from the CP's self-similarity. Frames are one batched (i)FFT (cuFFT on a
card); the CP prepend/strip are slices and a concatenation; the syncs are
lag products, cumulative-sum moving windows and argmaxes, in float32 as in
the JAX package. :func:`sc_preamble` is host numpy, a copy of the JAX
package's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops import modulation as _mod
from ..ops.fft import Scale, plan as fft_plan
from ..types import as_cf32, cf32, stage_device


@dataclass(frozen=True)
class OfdmConfig:
    """CP-OFDM parameters. ``active_bins`` (even, < fft_len) occupies the
    band center (FFT bins ``[0, a/2)`` and ``[N - a/2, N)``), leaving guard
    bands at the Nyquist edges (None = all bins). ``cp_len`` must exceed
    the channel's delay spread for exact one-tap equalization."""

    fft_len: int = 256
    cp_len: int = 32
    active_bins: Optional[int] = None
    modulation: str = "qpsk"
    fft_backend: Optional[str] = None

    @property
    def symbol_len(self) -> int:
        return self.fft_len + self.cp_len

    def bins(self) -> int:
        return self.active_bins or self.fft_len


class OfdmModem:
    """CP-OFDM modulator/demodulator (one batched transform per direction).

    ``modulate(bits)``: ``nframes * bins * bits_per_symbol`` bits ->
    ``[nframes * (fft_len + cp_len)]`` time samples (``Scale.SN`` both
    ways). ``demodulate(x, h=None)``: aligned time samples -> bits,
    optionally dividing a per-bin channel estimate ``h`` out first.
    ``device``: where it computes (the card by default; ``"cuda"`` without
    CUDA raises)."""

    def __init__(self, config: OfdmConfig = OfdmConfig(), device="cuda"):
        self.config = config
        self.device = stage_device(device, "OfdmModem")
        name = config.modulation
        if name == "qpsk":
            self.modulation = _mod.qpsk()
        elif name == "bpsk":
            self.modulation = _mod.bpsk()
        elif name.startswith("qam") and name[3:].isdigit():
            self.modulation = _mod.qam(int(name[3:]))
        else:
            raise ValueError(f"unknown modulation {name!r}")
        a = config.bins()
        if a > config.fft_len or a % 2:
            raise ValueError("active_bins must be even and <= fft_len")
        self._plan = fft_plan(config.fft_len, config.fft_backend)

    def bits_per_frame(self) -> int:
        return self.config.bins() * self.modulation.bits_per_symbol

    # -- TX -----------------------------------------------------------------
    def frames_to_spectra(self, syms) -> torch.Tensor:
        """Map ``[..., nf, bins]`` symbols onto full ``[..., nf, N]`` frames
        (center band split across the DC edges, zeros in the guards)."""
        cfg = self.config
        syms = as_cf32(syms, device=self.device)
        a = cfg.bins()
        if a == cfg.fft_len:
            return syms
        half = a // 2
        gap = torch.zeros(syms.shape[:-1] + (cfg.fft_len - a,), dtype=cf32, device=syms.device)
        return torch.cat([syms[..., :half], gap, syms[..., half:]], dim=-1)

    def modulate(self, bits) -> torch.Tensor:
        cfg = self.config
        bpf = self.bits_per_frame()
        bits = torch.as_tensor(bits, device=self.device)
        if bits.shape[-1] % bpf:
            raise ValueError(f"bit count must divide into frames of {bpf}")
        nf = bits.shape[-1] // bpf
        syms = self.modulation.modulate(bits).reshape(bits.shape[:-1] + (nf, cfg.bins()))
        time = self._plan.bwd(self.frames_to_spectra(syms), Scale.SN)  # [..., nf, N]
        cp = time[..., time.shape[-1] - cfg.cp_len:]
        frames = torch.cat([cp, time], dim=-1)
        return frames.reshape(bits.shape[:-1] + (nf * cfg.symbol_len,))

    # -- RX -----------------------------------------------------------------
    def spectra(self, x) -> torch.Tensor:
        """Aligned time samples -> active-bin spectra ``[..., nf, bins]``."""
        cfg = self.config
        x = as_cf32(x, device=self.device)
        nf = x.shape[-1] // cfg.symbol_len
        fr = x[..., :nf * cfg.symbol_len].reshape(
            x.shape[:-1] + (nf, cfg.symbol_len))[..., cfg.cp_len:]
        spec = self._plan.fwd(fr, Scale.SN)
        a = cfg.bins()
        if a == cfg.fft_len:
            return spec
        half = a // 2
        return torch.cat([spec[..., :half], spec[..., cfg.fft_len - (a - half):]], dim=-1)

    def demodulate(self, x, h=None) -> torch.Tensor:
        spec = self.spectra(x)
        if h is not None:
            spec = spec / as_cf32(h, device=spec.device)
        bits = self.modulation.demod(spec)
        return bits.reshape(bits.shape[:-2] + (-1,))


def _moving_sum(v: torch.Tensor, w: int) -> torch.Tensor:
    """``out[m] = sum_{i<w} v[m + i]`` along the last axis, as the
    difference of a zero-led float32 cumulative sum."""
    c = torch.nn.functional.pad(torch.cumsum(v, dim=-1), (1, 0))
    return c[..., w:] - c[..., :-w]


def _last_axis_pick(v: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    return v.gather(-1, i[..., None])[..., 0]


def cp_sync(x, config: OfdmConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blind frame timing + fractional CFO from the cyclic prefix (van de
    Beek): ``c[n] = sum_{i<cp} x[n+i] conj(x[n+i+N])`` peaks at every frame
    start; all frames' contributions are folded onto one symbol period
    before the argmax. Returns ``(offset, cfo)``: ``offset`` (int64) into the
    first full symbol and the carrier offset in cycles/sample (unambiguous
    for ``|cfo| < 1/(2*fft_len)``). On ``x``'s device."""
    cfg = config
    x = as_cf32(x)
    n = cfg.fft_len
    sym = cfg.symbol_len
    p = x[..., :-n] * x[..., n:].conj()
    w = _moving_sum(p, cfg.cp_len)  # w[m] = sum_{i<cp} p[m+i]
    nf = w.shape[-1] // sym
    folded = w[..., :nf * sym].reshape(w.shape[:-1] + (nf, sym)).sum(dim=-2)
    off = torch.argmax(folded.abs(), dim=-1)
    peak = _last_axis_pick(folded, off)
    cfo = -torch.angle(peak) / float(np.float32(2.0 * np.pi * n))
    return off, cfo.to(torch.float32)


def sc_preamble(config: OfdmConfig, seed: int = 815) -> np.ndarray:
    """Schmidl-Cox preamble symbol (CP included): PN QPSK on the *even*
    active subcarriers only (amplitude sqrt(2) keeps unit average power), so
    the useful part is two identical ``fft_len/2`` halves, the
    self-similarity :func:`sc_sync` detects. Host numpy."""
    cfg = config
    if cfg.fft_len % 2:
        raise ValueError("sc_preamble needs an even fft_len")
    rng = np.random.default_rng(seed)
    a = cfg.bins()
    half = a // 2
    # even-bin indices inside the active band (centered split, cf.
    # frames_to_spectra)
    bins = np.concatenate(
        [np.arange(0, half), np.arange(cfg.fft_len - (a - half), cfg.fft_len)]
    )
    even = bins[bins % 2 == 0]
    spec = np.zeros(cfg.fft_len, np.complex64)
    qpsk = (1 + 1j, -1 + 1j, 1 - 1j, -1 - 1j)
    spec[even] = np.sqrt(2.0) * np.array(
        [qpsk[i] for i in rng.integers(0, 4, even.shape[0])], np.complex64
    ) / np.sqrt(2.0 * a / cfg.fft_len)
    time = np.fft.ifft(spec) * np.sqrt(cfg.fft_len)  # Scale.SN convention
    pre = np.concatenate([time[-cfg.cp_len:], time]) if cfg.cp_len else time
    return pre.astype(np.complex64)


def sc_sync(x, config: OfdmConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Schmidl-Cox timing + fractional CFO from a :func:`sc_preamble`.

    Timing metric ``M(d) = |P(d)|^2 / R(d)^2`` with ``P(d) = sum_{i<N/2}
    conj(x[d+i]) x[d+i+N/2]`` and ``R(d) = sum_{i<N/2} |x[d+i+N/2]|^2``
    (cumulative-sum moving windows). The metric plateaus over the preamble
    CP; ``offset`` (int64) is the start of the useful part, the plateau
    midpoint (first and last samples with ``M > 0.9 * peak``) plus
    ``cp/2``. ``cfo`` (cycles/sample) is the angle of ``P`` mid-plateau,
    unambiguous for ``|cfo| < 1/fft_len``. On ``x``'s device."""
    cfg = config
    x = as_cf32(x)
    n = cfg.fft_len
    h = n // 2
    p = _moving_sum(x[..., :-h].conj() * x[..., h:], h)  # P(d), d + N <= L
    r = _moving_sum(x[..., h:].abs() ** 2, h)
    m = p.abs() ** 2 / torch.clamp_min(r, 1e-12) ** 2
    peak = m.amax(dim=-1, keepdim=True)
    above = (m > 0.9 * peak).to(torch.uint8)
    first = torch.argmax(above, dim=-1)
    last = above.shape[-1] - 1 - torch.argmax(above.flip(-1), dim=-1)
    mid = (first + last) // 2
    offset = mid + cfg.cp_len - cfg.cp_len // 2  # plateau mid -> useful start
    cfo = torch.angle(_last_axis_pick(p, mid)) / float(np.float32(math.pi * n))
    return offset, cfo.to(torch.float32)
