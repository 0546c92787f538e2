"""Continuous-phase FSK (CPFSK / MSK / GMSK) and offset QPSK (PyTorch).

Counterpart of ``aether_primitives_tpu/models/fsk.py``. Modulation is NRZ
bits -> frequency pulse shaping (:func:`~..ops.fir.fir_filter`) ->
:func:`~..ops.analog.fm_mod` (the block-modular phase accumulator);
demodulation is the quadrature discriminator -> per-symbol integrate and
dump -> sign, all feedforward. ``h = 0.5`` (MSK) shifts the phase by
exactly +-pi/2 a symbol; a Gaussian pre-filter (``bt``, e.g. GSM's 0.3)
gives GMSK. :func:`gaussian_pulse` is host float64 numpy, a copy of the
JAX package's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..ops import analog as _analog
from ..ops import fir as _fir
from ..ops.modulation import _interleave_bits
from ..types import as_cf32, stage_device


def gaussian_pulse(bt: float, sps: int, span: int = 3) -> np.ndarray:
    """GMSK Gaussian frequency pulse (f64 design, unit area): the rect NRZ
    pulse convolved with a Gaussian of bandwidth-time product ``bt``,
    sampled at ``sps`` samples/symbol over ``±span`` symbols."""
    from math import erfc

    def q(x):
        return 0.5 * erfc(x / np.sqrt(2.0))

    t = np.arange(-span * sps, span * sps + 1, dtype=np.float64) / sps
    a = 2.0 * np.pi * bt / np.sqrt(np.log(2.0))
    g = 0.5 * (np.vectorize(q)(a * (t - 0.5)) - np.vectorize(q)(a * (t + 0.5)))
    g /= g.sum() / sps  # unit area in symbol-time units
    return g.astype(np.float32)


@dataclass(frozen=True)
class FskConfig:
    """CPFSK parameters: ``sps`` samples/symbol, modulation index ``h``
    (phase advance per symbol = ``h * pi``; 0.5 = MSK), optional Gaussian
    ``bt`` (None = rectangular NRZ pulse = plain CPFSK/MSK)."""

    sps: int = 8
    h: float = 0.5
    bt: Optional[float] = None
    pulse_span: int = 3


class FskModem:
    """Constant-envelope CPFSK/MSK/GMSK modulator and discriminator
    detector. ``modulate(bits)``: ``[n]`` bits -> ``[n * sps]`` unit-modulus
    complex baseband (plus the pulse tail); ``demodulate(x)``:
    discriminator -> integrate and dump a symbol -> sign (noncoherent,
    amplitude-insensitive). ``device``: where it computes (the card by
    default; ``"cuda"`` without CUDA raises)."""

    def __init__(self, config: FskConfig = FskConfig(), device="cuda"):
        self.config = config
        self.device = stage_device(device, "FskModem")
        sps = int(config.sps)
        if config.bt is not None:
            self.pulse = gaussian_pulse(config.bt, sps, config.pulse_span)
        else:
            self.pulse = np.full(sps, 1.0, np.float32)  # rect NRZ
        # peak frequency deviation: +-h/(2*sps) cycles/sample for NRZ +-1
        self.deviation = float(config.h) / (2.0 * sps)

    def modulate(self, bits) -> torch.Tensor:
        sps = int(self.config.sps)
        nrz = 2.0 * torch.as_tensor(bits, device=self.device).to(torch.float32) - 1.0
        # an impulse a symbol (column 0 of [n, sps]) -> frequency pulse shaping
        imp = torch.nn.functional.pad(nrz[..., None], (0, sps - 1)).reshape(
            nrz.shape[:-1] + (nrz.shape[-1] * sps,))
        # flush the pulse tail so the last symbols' lobes are emitted
        tail = self.pulse.shape[-1] - sps
        if tail > 0:
            imp = torch.nn.functional.pad(imp, (0, tail))
        # unit-area pulses (sum = sps) on +-1 impulses: each symbol's
        # frequency integrates to +-sps, i.e. +-h*pi of phase
        freq = _fir.fir_filter(imp.to(torch.complex64), self.pulse).real
        return _analog.fm_mod(freq, self.deviation)

    def demodulate(self, x) -> torch.Tensor:
        sps = int(self.config.sps)
        inst = _analog.fm_demod(as_cf32(x, device=self.device), self.deviation)
        # integrate and dump over windows centred on the pulse: the causal
        # pulse delays symbol k's lobe by (len(pulse) - sps) / 2 samples
        d = (self.pulse.shape[-1] - sps) // 2
        n_sym = (inst.shape[-1] - 2 * d) // sps
        inst = inst[..., d:]
        acc = inst[..., :n_sym * sps].reshape(inst.shape[:-1] + (n_sym, sps)).sum(dim=-1)
        return (acc > 0).to(torch.uint8)

    __call__ = modulate


# ----------------------------------------------------------------- OQPSK


def oqpsk_modulate(bits, sps: int = 4, taps=None) -> torch.Tensor:
    """Offset QPSK (802.15.4-style): the Q rail staggered by half a symbol,
    so the envelope never crosses zero. ``bits``: flat {0,1}, an even count;
    ``sps`` even. Returns the shaped complex baseband (length ``(n_bits/2)
    * sps + sps/2 + len(taps)``, the stagger and the filter tail); ``taps``
    default to ``rrc_taps(sps, span=6, beta=0.5)``. On ``bits``' device."""
    b = torch.remainder(torch.as_tensor(bits).to(torch.int32), 2)
    if b.shape[-1] % 2:
        raise ValueError("OQPSK consumes bit PAIRS")
    sps = int(sps)
    if sps % 2:
        raise ValueError("sps must be even (half-symbol stagger)")
    if taps is None:
        taps = _fir.rrc_taps(sps, span=6, beta=0.5)
    i_sym = (1.0 - 2.0 * b[0::2]).to(torch.float32)
    q_sym = (1.0 - 2.0 * b[1::2]).to(torch.float32)
    n_sym = i_sym.shape[-1]
    half = sps // 2
    tail = int(np.asarray(taps).shape[-1])  # let every pulse fully emerge
    up_i = torch.zeros(n_sym * sps + half + tail, dtype=torch.float32, device=b.device)
    up_q = torch.zeros_like(up_i)
    up_i[:n_sym * sps:sps] = i_sym
    up_q[half:half + n_sym * sps:sps] = q_sym
    return _fir.fir_filter(torch.complex(up_i, up_q), taps)


def oqpsk_demodulate(x, n_bits: int, sps: int = 4, taps=None) -> torch.Tensor:
    """Matched-filter OQPSK demodulation (synchronized): filter, strobe the
    I rail at ``k * sps`` and the Q rail at ``k * sps + sps/2`` after the
    two filters' group delay, sign-detect. The inverse of
    :func:`oqpsk_modulate`; uint8 bits, LSB-first pairs."""
    xc = as_cf32(x)
    sps = int(sps)
    if taps is None:
        taps = _fir.rrc_taps(sps, span=6, beta=0.5)
    taps = np.asarray(taps)
    gd_pad = taps.shape[-1]  # let the tail symbols' matched peaks emerge
    mf = _fir.fir_filter(torch.nn.functional.pad(xc, (0, gd_pad)), taps)
    gd = taps.shape[-1] - 1  # two cascaded filters' total group delay
    n_sym = int(n_bits) // 2
    i_pts = mf.real[gd::sps][:n_sym]
    q_pts = mf.imag[gd + sps // 2::sps][:n_sym]
    return _interleave_bits([(i_pts < 0), (q_pts < 0)])
