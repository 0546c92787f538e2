"""Chirp spread spectrum (CSS, LoRa-style) modem (PyTorch).

Counterpart of ``aether_primitives_tpu/models/css.py``. Each ``SF``-bit
symbol spreads over ``N = 2^SF`` chips of a linear chirp: symbol ``s`` is
the base upchirp cyclically shifted by ``s`` chips. The receiver multiplies
by the conjugate base chirp ("dechirp"), which turns every symbol into a
tone at bin ``s``: demodulation is one batched FFT and an argmax.

Modulation builds the phase from exact integer products reduced mod ``N``
(int32) before the float32 trig, in the JAX package's order, so the chips
agree with its chips to float32 rounding. For even ``N``, ``u[(k+s) mod N]
= u[s] * u[k] * e^{j 2 pi s k / N}`` with ``u[k] = e^{j pi k^2 / N}``: the
cyclic shift is a tone.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..ops import fft as _fft
from ..ops.fft import Scale
from ..types import as_cf32, cf32, stage_device


@dataclass(frozen=True)
class CssConfig:
    sf: int = 8  # spreading factor: 2^sf chips/symbol, sf bits/symbol
    fft_backend: str = None

    @property
    def n_chips(self) -> int:
        return 1 << self.sf


class CssModem:
    """CSS modulator/demodulator for a given spreading factor.

    ``tx(bits)``: ``sf``-bit LSB-first symbols -> shifted-upchirp blocks
    (``[..., n_sym * N]`` complex chips). ``rx(chips)``: dechirp,
    frame-FFT, argmax -> bits. ``demod_symbols`` gives the raw symbol
    decisions and peak magnitudes (a per-symbol confidence). ``device``:
    where it computes (the card by default; ``"cuda"`` without CUDA
    raises)."""

    def __init__(self, config: CssConfig = CssConfig(), device="cuda"):
        self.config = config
        self.device = stage_device(device, "CssModem")
        _fft.check_backend(config.fft_backend)
        n = config.n_chips
        k = np.arange(n, dtype=np.int64)
        # base upchirp e^{j pi k^2 / N}: phase in half-turns = k^2 / N,
        # reduced mod 2 N in exact integers before the division
        ph = (k * k) % (2 * n)
        self._upchirp = torch.from_numpy(
            np.exp(1j * np.pi * ph / n).astype(np.complex64)).to(self.device)

    # ------------------------------------------------------------ TX

    def tx(self, bits) -> torch.Tensor:
        sf = self.config.sf
        b = torch.remainder(torch.as_tensor(bits, device=self.device).to(torch.int32), 2)
        if b.shape[-1] % sf:
            raise ValueError(f"bit count must divide by sf = {sf}")
        groups = b.reshape(b.shape[:-1] + (-1, sf))
        weights = 2 ** torch.arange(sf, dtype=torch.int32, device=self.device)
        sym = (groups * weights).sum(dim=-1, dtype=torch.int32)  # [..., n_sym] LSB-first
        return self.modulate_symbols(sym)

    def modulate_symbols(self, symbols) -> torch.Tensor:
        """Symbols in [0, N) -> chips. Phase built as exact int32 mod-N
        products; one elementwise exp per block."""
        n = self.config.n_chips
        s = torch.as_tensor(symbols, device=self.device).to(torch.int32)
        k = torch.arange(n, dtype=torch.int32, device=self.device)
        # tone phase (s k mod N)/N turns + shift phase (s^2 mod 2N)/2N
        tone = (s[..., None] * k) % n  # int32: s k < N^2 <= 2^30
        ang = 2.0 * math.pi * tone.to(torch.float32) / n
        shift_ph = (s * s) % (2 * n)
        ang = ang + math.pi * shift_ph.to(torch.float32)[..., None] / n
        chips = torch.complex(torch.cos(ang), torch.sin(ang)) * self._upchirp
        return chips.reshape(chips.shape[:-2] + (-1,)).to(cf32)

    # ------------------------------------------------------------ RX

    def demod_symbols(self, chips):
        """(symbols int32, peak_magnitude) per frame: dechirp, batched FFT,
        argmax. ``peak_magnitude`` is normalized to 1.0 for clean input."""
        cfg = self.config
        n = cfg.n_chips
        x = as_cf32(chips, device=self.device)
        if x.shape[-1] % n:
            raise ValueError(f"chip count must divide by N = {n}")
        frames = x.reshape(x.shape[:-1] + (-1, n))
        d = frames * self._upchirp.conj()
        spec = _fft.plan(n, cfg.fft_backend).fwd(d, Scale.NONE)
        mag = spec.abs()
        sym = torch.argmax(mag, dim=-1)
        peak = mag.gather(-1, sym[..., None])[..., 0] / n
        return sym.to(torch.int32), peak

    def rx(self, chips) -> torch.Tensor:
        sym, _ = self.demod_symbols(chips)
        bit_idx = torch.arange(self.config.sf, dtype=torch.int32, device=sym.device)
        bits = (sym[..., None] >> bit_idx) & 1  # LSB-first
        return bits.reshape(bits.shape[:-2] + (-1,)).to(torch.uint8)

    def loopback(self, bits) -> torch.Tensor:
        return self.rx(self.tx(bits))
