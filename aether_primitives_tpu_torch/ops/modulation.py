"""Constellation-table modulation and hard demodulation (PyTorch).

Counterpart of ``aether_primitives_tpu/ops/modulation.py``: the tables
(bpsk, qpsk, qam16, ``qam(N)``, ``psk(N)``, ``apsk(16|32)``), modulation,
hard demod, the max-log soft demod, differential index coding,
:func:`nearest_index` and pi/4-DQPSK. Bit conventions are the JAX package's:
LSB-first symbol index ``sum_i bits[i] << i``, strictly {0,1} bits, and
ties to the lowest table index. The generic BPSK and QPSK tables demodulate by sign tests
(strict ``< 0``); every other table by argmax of correlation.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import numpy as np
import torch

from ..types import as_cf32

GENERIC_BPSK_TABLE = np.array([1.0 + 1.0j, -1.0 - 1.0j], dtype=np.complex64)
GENERIC_QPSK_TABLE = np.array(
    [1.0 + 1.0j, -1.0 + 1.0j, 1.0 - 1.0j, -1.0 - 1.0j], dtype=np.complex64
)


@functools.lru_cache(maxsize=None)
def _device_table(table_bytes: bytes, device: str) -> torch.Tensor:
    """A complex64 table uploaded once per device: a host copy in every call
    would wait for the card's queue to drain. Callers only read it."""
    return torch.from_numpy(np.frombuffer(table_bytes, np.complex64).copy()).to(device)


def _interleave_bits(planes) -> torch.Tensor:
    """Per-bit planes ``[b0, b1, ...]`` (each ``[..., n]``) -> ``[..., n * bps]``
    uint8, LSB-first within each symbol."""
    out = torch.stack([p.to(torch.uint8) for p in planes], dim=-1)
    return out.reshape(out.shape[:-2] + (out.shape[-2] * len(planes),))


@dataclass(frozen=True, eq=False)
class Modulation:
    """A constellation-table modulation (2**bits_per_symbol points)."""

    table: np.ndarray
    name: str = "custom"
    bits_per_symbol: int = field(init=False)

    def __post_init__(self):
        table = np.asarray(self.table, dtype=np.complex64)
        bps = int(np.log2(table.shape[0]))
        if 2**bps != table.shape[0]:
            raise ValueError("Constellation size must be a power of two")
        object.__setattr__(self, "table", table)
        object.__setattr__(self, "bits_per_symbol", bps)
        sign_fast = (
            self.name == "bpsk" and np.array_equal(table, GENERIC_BPSK_TABLE)
        ) or (self.name == "qpsk" and np.array_equal(table, GENERIC_QPSK_TABLE))
        object.__setattr__(self, "_sign_fast", sign_fast)

    def _table(self, device) -> torch.Tensor:
        return _device_table(self.table.tobytes(), str(torch.device(device)))

    def symbol(self, idx) -> torch.Tensor:
        """Constellation point(s) for symbol index/indices (the reference's
        ``symbol()``), on the indices' device."""
        idx = torch.as_tensor(idx)
        return self._table(idx.device)[idx.to(torch.long)]

    def index(self, bits) -> torch.Tensor:
        """LSB-first bit-pack: ``[..., bits_per_symbol]`` -> symbol indices."""
        bits = torch.as_tensor(bits)
        if bits.shape[-1] != self.bits_per_symbol:
            raise ValueError(
                f"Expected {self.bits_per_symbol} bits per symbol, got {bits.shape[-1]}"
            )
        weights = 2 ** torch.arange(self.bits_per_symbol, device=bits.device)
        return ((bits.to(torch.long) % 2) * weights).sum(dim=-1)

    def modulate(self, bits) -> torch.Tensor:
        """``[..., n_bits]`` {0,1} bits -> ``[..., n_bits / bits_per_symbol]``
        complex64 symbols (``n_bits`` must divide by ``bits_per_symbol``)."""
        bits = torch.as_tensor(bits)
        n = bits.shape[-1]
        bps = self.bits_per_symbol
        if n % bps != 0:
            raise ValueError(f"Bit count {n} not divisible by bits/symbol {bps}")
        grouped = bits.reshape(bits.shape[:-1] + (n // bps, bps))
        return self._table(bits.device)[self.index(grouped)]

    def demod(self, symbols) -> torch.Tensor:
        """Hard nearest-neighbour demod: ``[..., n_sym]`` symbols ->
        ``[..., n_sym * bits_per_symbol]`` uint8 bits, LSB-first.

        The argmin of ``|s - c|^2`` is the argmax of
        ``Re(s) Re(c) + Im(s) Im(c) - |c|^2 / 2``; ``torch.argmax`` returns
        the first maximum, so ties go to the lowest index.
        """
        s = as_cf32(symbols)
        if self._sign_fast:
            return self._demod_sign(s)
        table = self._table(s.device)
        score = (
            s.real[..., None] * table.real
            + s.imag[..., None] * table.imag
            - 0.5 * table.abs() ** 2
        )
        idx = torch.argmax(score, dim=-1)
        return _interleave_bits(
            [(idx >> j) & 1 for j in range(self.bits_per_symbol)]
        )

    def demod_naive(self, symbols) -> torch.Tensor:
        """The reference's name for :meth:`demod`."""
        return self.demod(symbols)

    def _demod_sign(self, s: torch.Tensor) -> torch.Tensor:
        """Sign-test demod of the generic Gray tables. QPSK: bit0 =
        ``Re(s) < 0``, bit1 = ``Im(s) < 0``; BPSK: bit = ``Re(s) + Im(s) < 0``.
        Strict comparisons send a boundary point to bit 0, as argmax does."""
        if self.name == "bpsk":
            return (s.real + s.imag < 0).to(torch.uint8)
        return _interleave_bits([s.real < 0, s.imag < 0])

    def demod_soft(self, symbols, noise_var=1.0) -> torch.Tensor:
        """Max-log per-bit LLRs, LSB-first: ``LLR(b_i) = (min_{c: b_i=1}
        |s-c|^2 - min_{c: b_i=0} |s-c|^2) / noise_var``; positive = bit 0.

        ``[..., n_sym]`` symbols -> ``[..., n_sym * bits_per_symbol]``
        float32. ``noise_var`` is a float or a tensor that broadcasts
        against ``[..., n_sym]`` (one variance per burst: shape ``[..., 1]``).
        """
        s = as_cf32(symbols)
        table = self._table(s.device)
        d2 = ((s.real[..., None] - table.real).abs() ** 2
              + (s.imag[..., None] - table.imag).abs() ** 2)  # [..., n_sym, M]
        nv = torch.as_tensor(noise_var, dtype=torch.float32, device=s.device)
        idx = np.arange(table.shape[0])
        llrs = []
        for i in range(self.bits_per_symbol):
            ones = torch.from_numpy(np.flatnonzero((idx >> i) & 1)).to(s.device)
            zeros = torch.from_numpy(np.flatnonzero(~(idx >> i) & 1)).to(s.device)
            d1 = d2.index_select(-1, ones).amin(dim=-1)
            d0 = d2.index_select(-1, zeros).amin(dim=-1)
            llrs.append((d1 - d0) / nv)
        out = torch.stack(llrs, dim=-1)  # [..., n_sym, bits]
        return out.reshape(s.shape[:-1] + (s.shape[-1] * self.bits_per_symbol,))

    def hard_from_soft(self, llrs) -> torch.Tensor:
        """LLRs -> hard bits (``llr < 0`` is bit 1), uint8."""
        return (torch.as_tensor(llrs) < 0).to(torch.uint8)


def _qam16_table() -> np.ndarray:
    """Gray-coded 16-QAM, unit average energy: (b0,b1) Gray-select the I
    level and (b2,b3) the Q level from (-3,-1,+1,+3)/sqrt(10)."""
    gray = np.array([-3.0, -1.0, 3.0, 1.0]) / np.sqrt(10.0)  # index b0+2*b1
    table = np.empty(16, np.complex64)
    for idx in range(16):
        i_bits = idx & 3
        q_bits = (idx >> 2) & 3
        table[idx] = gray[i_bits] + 1j * gray[q_bits]
    return table


GENERIC_QAM16_TABLE = _qam16_table()


def bpsk() -> Modulation:
    return Modulation(GENERIC_BPSK_TABLE, name="bpsk")


def qpsk() -> Modulation:
    return Modulation(GENERIC_QPSK_TABLE, name="qpsk")


def qam16() -> Modulation:
    """Gray-coded 16-QAM with unit average symbol energy."""
    return Modulation(GENERIC_QAM16_TABLE, name="qam16")


def _gray_rank(g: int) -> int:
    """Inverse binary-reflected Gray code."""
    b, shift = g, 1
    while (g >> shift) > 0:
        b ^= g >> shift
        shift += 1
    return b


def _gray_levels(bits: int) -> np.ndarray:
    """PAM levels indexed by their Gray-coded bit pattern, unit spacing 2."""
    m = 1 << bits
    levels = np.empty(m, np.float64)
    for g in range(m):
        levels[g] = 2.0 * _gray_rank(g) - (m - 1)
    return levels


def psk(order: int) -> Modulation:
    """Gray-coded M-PSK, unit energy: ``table[g] = e^{j 2 pi rank(g) / M}``."""
    order = int(order)
    bits = int(np.log2(order))
    if 2**bits != order or bits < 1:
        raise ValueError(f"order must be a power of two >= 2, got {order}")
    table = np.empty(order, np.complex64)
    for g in range(order):
        table[g] = np.exp(2j * np.pi * _gray_rank(g) / order)
    return Modulation(table, name=f"psk{order}")


def qam(order: int) -> Modulation:
    """Gray-coded square QAM (4, 16, 64, ...), unit average energy; the low
    half of the index bits Gray-selects the I level, the high half Q."""
    order = int(order)
    bits = int(np.log2(order))
    if 2**bits != order or bits % 2 or bits < 2:
        raise ValueError(
            f"order must be an even power of two >= 4, got {order}"
        )
    half = bits // 2
    m = 1 << half
    levels = _gray_levels(half)
    energy = np.sqrt(2.0 * (m * m - 1) / 3.0)
    table = np.empty(order, np.complex64)
    for idx in range(order):
        i_bits = idx & (m - 1)
        q_bits = (idx >> half) & (m - 1)
        table[idx] = (levels[i_bits] + 1j * levels[q_bits]) / energy
    return Modulation(table, name=f"qam{order}")


#: DVB-S2 ring-ratio tables (EN 302 307 §5.4.3/5.4.4): code rate -> ratios.
APSK16_GAMMA = {
    "2/3": 3.15, "3/4": 2.85, "4/5": 2.75, "5/6": 2.70,
    "8/9": 2.60, "9/10": 2.57,
}
APSK32_GAMMA = {
    "3/4": (2.84, 5.27), "4/5": (2.72, 4.87), "5/6": (2.64, 4.64),
    "8/9": (2.54, 4.33), "9/10": (2.53, 4.30),
}


def apsk(order: int, gamma=None) -> Modulation:
    """Amplitude-phase-shift keying on concentric rings, unit average energy.

    ``apsk(16)``: the DVB-S2 4+12 geometry (inner ring at ``pi/4 + k pi/2``,
    12 outer points at ``pi/12 + k pi/6``), ``gamma`` the outer/inner radius
    ratio (a float or a rate of :data:`APSK16_GAMMA`, default ``"3/4"``); the
    JAX package's quadrant-Gray labelling (index bits 2-3 Gray-select the
    quadrant, bits 0-1 the point in it: 00 inner, 01/11/10 the outer trio).
    ``apsk(32)``: 4+12+16 (outer ring at ``k pi/8``), ``gamma`` a pair or a
    rate of :data:`APSK32_GAMMA`, ring-major labels. Tables equal the JAX
    package's."""
    order = int(order)
    if order == 16:
        g = gamma if gamma is not None else "3/4"
        if isinstance(g, str):
            g = APSK16_GAMMA[g]
        r1, r2 = 1.0, float(g)
        quad_for_code = (0, 1, 3, 2)
        within_walk = {0b01: 0, 0b11: 1, 0b10: 2}
        table = np.empty(16, np.complex64)
        for idx in range(16):
            q = quad_for_code[(idx >> 2) & 3]
            w = idx & 3
            if w == 0:
                table[idx] = r1 * np.exp(1j * (np.pi / 4 + q * np.pi / 2))
            else:
                j = within_walk[w]
                table[idx] = r2 * np.exp(1j * (np.pi / 12 + (3 * q + j) * np.pi / 6))
    elif order == 32:
        g = gamma if gamma is not None else "3/4"
        if isinstance(g, str):
            g = APSK32_GAMMA[g]
        g2, g3 = (float(g[0]), float(g[1]))
        inner = [np.exp(1j * (np.pi / 4 + k * np.pi / 2)) for k in range(4)]
        mid = [g2 * np.exp(1j * (np.pi / 12 + k * np.pi / 6)) for k in range(12)]
        outer = [g3 * np.exp(1j * (k * np.pi / 8)) for k in range(16)]
        table = np.array(inner + mid + outer, np.complex64)
    else:
        raise ValueError(f"apsk supports order 16 or 32, got {order}")
    table /= np.sqrt(np.mean(np.abs(table) ** 2))
    return Modulation(table, name=f"apsk{order}")


def differential_encode(indices, order: int) -> torch.Tensor:
    """Differential symbol-index encoding ``tx[i] = sum_{j<=i} d[j] mod M``
    (int32), for tables whose index maps linearly to phase (:func:`psk_table`)."""
    d = torch.as_tensor(indices).to(torch.int32)
    return torch.remainder(torch.cumsum(d, dim=-1, dtype=torch.int32), order)


def differential_decode(indices, order: int) -> torch.Tensor:
    """Inverse of :func:`differential_encode`: the first-order index
    difference mod M, the first symbol referenced to index 0 (int32)."""
    r = torch.as_tensor(indices).to(torch.int32)
    prev = torch.nn.functional.pad(r, (1, 0))[..., :-1]
    return torch.remainder(r - prev, order)


def psk_table(order: int) -> np.ndarray:
    """M-PSK table with index-linear phase ``e^{j 2 pi i / M}`` (not Gray)."""
    i = np.arange(int(order), dtype=np.float64)
    return np.exp(2j * np.pi * i / order).astype(np.complex64)


def nearest_index(symbols, table) -> torch.Tensor:
    """Index of the nearest constellation point per symbol (int32; the
    first of equal distances)."""
    s = as_cf32(symbols)
    t = torch.as_tensor(np.asarray(table, np.complex64), device=s.device)
    d2 = (s.real[..., None] - t.real) ** 2 + (s.imag[..., None] - t.imag) ** 2
    return torch.argmin(d2, dim=-1).to(torch.int32)


#: pi/4-DQPSK phase increments by Gray dibit index ``b0 + 2 b1``.
_PI4_INCREMENTS = np.array(
    [np.pi / 4, 3 * np.pi / 4, -np.pi / 4, -3 * np.pi / 4], np.float64
)


def pi4dqpsk_modulate(bits) -> torch.Tensor:
    """pi/4-DQPSK: ``[..., 2k]`` bits -> ``[..., k]`` unit-modulus symbols,
    LSB-first dibits, the first symbol at phase ``pi/4`` plus its increment
    (float32 phase accumulation, as in the JAX package)."""
    b = torch.as_tensor(bits).to(torch.int32) % 2
    if b.shape[-1] % 2:
        raise ValueError("pi/4-DQPSK consumes bit PAIRS")
    d = b[..., 0::2] + 2 * b[..., 1::2]
    inc = torch.from_numpy(_PI4_INCREMENTS.astype(np.float32)).to(b.device)[d.to(torch.long)]
    phase = torch.cumsum(inc, dim=-1) + np.float32(np.pi / 4)
    return torch.complex(torch.cos(phase), torch.sin(phase))


def pi4dqpsk_demod(symbols) -> torch.Tensor:
    """Differential demod of :func:`pi4dqpsk_modulate`: phase differences
    (the first referenced to ``pi/4``) -> nearest increment on the circle ->
    LSB-first bits (uint8)."""
    s = as_cf32(symbols)
    ref = torch.full(s.shape[:-1] + (1,), complex(np.complex64(np.exp(1j * np.pi / 4))),
                     dtype=s.dtype, device=s.device)
    prev = torch.cat([ref, s[..., :-1]], dim=-1)
    dphi = torch.angle(s * prev.conj())
    inc = torch.from_numpy(_PI4_INCREMENTS.astype(np.float32)).to(s.device)
    err = torch.abs(torch.remainder(dphi[..., None] - inc + np.pi, 2 * np.pi) - np.pi)
    d = torch.argmin(err, dim=-1)
    return _interleave_bits([d & 1, (d >> 1) & 1])
