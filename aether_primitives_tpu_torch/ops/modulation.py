"""Constellation-table modulation and hard demodulation (PyTorch).

Counterpart of ``aether_primitives_tpu/ops/modulation.py``, subset: the
tables (bpsk, qpsk, qam16, ``qam(N)``, ``psk(N)``), modulation, hard demod
and the max-log soft demod. Bit conventions are the JAX package's:
LSB-first symbol index ``sum_i bits[i] << i``, strictly {0,1} bits, and
ties to the lowest table index. The generic BPSK and QPSK tables demodulate by sign tests
(strict ``< 0``); every other table by argmax of correlation.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..types import as_cf32

GENERIC_BPSK_TABLE = np.array([1.0 + 1.0j, -1.0 - 1.0j], dtype=np.complex64)
GENERIC_QPSK_TABLE = np.array(
    [1.0 + 1.0j, -1.0 + 1.0j, 1.0 - 1.0j, -1.0 - 1.0j], dtype=np.complex64
)


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
        return torch.as_tensor(self.table, device=device)

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
