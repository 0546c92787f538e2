"""The burst transmitter, frozen in plain PyTorch: payload -> CRC ->
multiplicative scrambler -> RS(n, k) over GF(2^8) -> bit interleaver ->
K=7 rate-1/2 convolutional code -> QPSK -> [preamble | symbols].

A copy of what the port's ``PacketModem.tx`` does for ``fec="ccsds"``
(``models/packet.py``, ``ops/fec.py``, ``ops/rs.py``, ``ops/sequence.py``,
``ops/modulation.py``), written as plain loops over the bit or symbol
axis, batched over bursts, on any device. Bits are uint8 {0, 1}; bytes
are LSB-first; RS symbol 0 is the highest-degree coefficient, sent first.
The receiver's reference (``reference/burst_rx.py``) shares these tables.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

#: CRC parameter sets: (poly, width, init); no reflection, no final XOR.
CRC = {"crc16-ccitt": (0x1021, 16, 0xFFFF)}
QPSK = np.array([1 + 1j, -1 + 1j, 1 - 1j, -1 - 1j], dtype=np.complex64)


def crc(bits: torch.Tensor, kind: str) -> torch.Tensor:
    """Check bits ``[B, width]`` (MSB first) of ``bits [B, n]`` fed MSB-first
    into the register."""
    poly, width, init = CRC[kind]
    top = 1 << (width - 1)
    mask = (1 << width) - 1
    reg = torch.full(bits.shape[:1], init, dtype=torch.int64, device=bits.device)
    b = bits.to(torch.int64)
    for i in range(bits.shape[-1]):
        fb = ((reg & top) != 0).to(torch.int64) ^ b[:, i]
        reg = ((reg << 1) & mask) ^ (fb * poly)
    sh = torch.arange(width - 1, -1, -1, device=bits.device)
    return ((reg[:, None] >> sh) & 1).to(torch.uint8)


def scramble(bits: torch.Tensor, delays=(14, 15)) -> torch.Tensor:
    """``y(n) = x(n) ^ sum_d y(n - d)`` from a zero history."""
    order, step = max(delays), min(delays)
    n = bits.shape[-1]
    y = torch.zeros(bits.shape[:-1] + (order + n,), dtype=torch.uint8, device=bits.device)
    for start in range(0, n, step):
        stop = min(n, start + step)
        acc = bits[:, start:stop].clone()
        for d in delays:
            acc ^= y[:, order + start - d:order + stop - d]
        y[:, order + start:order + stop] = acc
    return y[:, order:]


def descramble(bits: torch.Tensor, delays=(14, 15)) -> torch.Tensor:
    """Inverse of :func:`scramble`: ``x(n) = y(n) ^ sum_d y(n - d)``."""
    order = max(delays)
    n = bits.shape[-1]
    yp = torch.cat([torch.zeros(bits.shape[:-1] + (order,), dtype=torch.uint8,
                                device=bits.device), bits], dim=-1)
    acc = bits.clone()
    for d in delays:
        acc ^= yp[:, order - d:order - d + n]
    return acc


@functools.lru_cache(maxsize=None)
def gf_tables(prim: int = 0x11D):
    """GF(2^8) ``exp`` (510 entries) and ``log`` tables, numpy int64."""
    exp = np.zeros(510, np.int64)
    log = np.zeros(256, np.int64)
    v = 1
    for i in range(255):
        exp[i] = v
        log[v] = i
        v <<= 1
        if v & 0x100:
            v ^= prim
    exp[255:] = exp[:255]
    return exp, log


def gf_mul(a: int, b: int) -> int:
    exp, log = gf_tables()
    return 0 if a == 0 or b == 0 else int(exp[log[a] + log[b]])


@functools.lru_cache(maxsize=None)
def rs_generator(nsym: int, fcr: int = 1):
    """``g(x) = prod_i (x - alpha^(fcr + i))``, monic, highest degree
    first."""
    exp, _ = gf_tables()
    g = [1]
    for i in range(nsym):
        root = int(exp[(fcr + i) % 255])
        new = [0] * (len(g) + 1)
        for d, c in enumerate(g):
            new[d] ^= c
            new[d + 1] ^= gf_mul(c, root)
        g = new
    return tuple(g)


def rs_encode(msg: torch.Tensor, n: int, k: int) -> torch.Tensor:
    """Systematic RS(n, k): ``[B, k]`` symbols -> ``[B, n]`` = ``[msg |
    msg(x) x^(n-k) mod g(x)]``, by the division register."""
    nsym = n - k
    g = rs_generator(nsym)
    table = np.array([[gf_mul(v, c) for v in range(256)] for c in g[1:]], np.int64)
    tab = torch.from_numpy(table).to(msg.device)  # [nsym, 256]
    reg = torch.zeros(msg.shape[0], nsym, dtype=torch.int64, device=msg.device)
    m = msg.to(torch.int64)
    for i in range(k):
        fb = m[:, i] ^ reg[:, 0]
        prod = tab[:, fb].T  # [B, nsym]
        reg = torch.cat([reg[:, 1:], torch.zeros_like(reg[:, :1])], dim=1) ^ prod
    return torch.cat([m, reg], dim=1).to(torch.uint8)


def bits_to_bytes(bits: torch.Tensor) -> torch.Tensor:
    b = bits.reshape(bits.shape[0], -1, 8).to(torch.int64)
    return (b << torch.arange(8, device=bits.device)).sum(-1).to(torch.uint8)


def bytes_to_bits(sym: torch.Tensor) -> torch.Tensor:
    b = (sym.to(torch.int64)[..., None] >> torch.arange(8, device=sym.device)) & 1
    return b.reshape(sym.shape[0], -1).to(torch.uint8)


def interleave(x: torch.Tensor, rows: int) -> torch.Tensor:
    """Written row-wise into ``[rows, n / rows]``, read column-wise."""
    return x.reshape(x.shape[0], rows, -1).transpose(1, 2).reshape(x.shape)


def deinterleave(x: torch.Tensor, rows: int) -> torch.Tensor:
    return x.reshape(x.shape[0], -1, rows).transpose(1, 2).reshape(x.shape)


def conv_taps(poly: int, k: int) -> list:
    """Tap ``j`` multiplies ``x[i - j]``; the generator's MSB weights the
    current bit."""
    return [(poly >> (k - 1 - j)) & 1 for j in range(k)]


def conv_encode(bits: torch.Tensor, polys=(0o171, 0o133), k: int = 7) -> torch.Tensor:
    """Terminated rate-1/len(polys) encoder from state 0: ``[B, n]`` ->
    ``[B, len(polys) (n + k - 1)]``, the generators' bits interleaved."""
    x = torch.nn.functional.pad(bits, (k - 1, k - 1))
    n = bits.shape[-1] + k - 1
    outs = []
    for poly in polys:
        acc = torch.zeros(bits.shape[0], n, dtype=torch.uint8, device=bits.device)
        for j, t in enumerate(conv_taps(poly, k)):
            if t:
                acc ^= x[:, k - 1 - j:k - 1 - j + n]
        outs.append(acc)
    return torch.stack(outs, dim=-1).reshape(bits.shape[0], -1)


def gold(c_init: int, length: int, nc: int = 1600) -> np.ndarray:
    """3GPP TS 36.211 §7.2 Gold sequence."""
    total = nc + length
    x1 = np.zeros(total, np.uint8)
    x2 = np.zeros(total, np.uint8)
    x1[0] = 1
    x2[:31] = [(c_init >> i) & 1 for i in range(31)]
    for i in range(31, total):
        x1[i] = x1[i - 28] ^ x1[i - 31]
        x2[i] = x2[i - 28] ^ x2[i - 29] ^ x2[i - 30] ^ x2[i - 31]
    return (x1[nc:] ^ x2[nc:]).astype(np.uint8)


def preamble(half: int, c_init: int) -> np.ndarray:
    """Two identical halves of ``half`` QPSK symbols from the Gold
    sequence (LSB-first pairs)."""
    g = gold(c_init, 2 * half).reshape(-1, 2).astype(np.int64)
    h = QPSK[g[:, 0] + 2 * g[:, 1]]
    return np.concatenate([h, h])


class Link:
    """The link's sizes from a ``PacketConfig`` given as a dict (``fec``
    ``"ccsds"``, ``modulation`` ``"qpsk"``, a block interleaver and no outer
    interleaver)."""

    def __init__(self, packet: dict):
        if (packet.get("fec") != "ccsds" or packet.get("modulation", "qpsk") != "qpsk"
                or packet.get("ccsds_interleaver", "block") != "block"
                or packet.get("interleave_rows", 0) or packet.get("rs_erasures")):
            raise ValueError("the frozen transmitter covers fec 'ccsds' over QPSK, "
                             "a block interleaver, no erasures")
        self.payload_bits = int(packet["payload_bits"])
        self.crc = packet.get("crc", "crc16-ccitt")
        self.crc_width = CRC[self.crc][1]
        self.scrambler = tuple(packet.get("scrambler", (14, 15)))
        self.rs_n, self.rs_k = int(packet.get("rs_n", 255)), int(packet.get("rs_k", 223))
        self.rows = max(1, int(packet.get("ccsds_interleave_rows", 8)))
        frame = self.payload_bits + self.crc_width
        if frame != 8 * self.rs_k:
            raise ValueError(f"the frame ({frame} bits) must fill one RS codeword of "
                             f"{self.rs_k} bytes")
        self.frame_bits = frame
        self.rs_bits = 8 * self.rs_n
        if self.rs_bits % self.rows:
            raise ValueError("the interleaver's rows must divide the codeword's bits")
        self.k = 7
        self.coded_bits = 2 * (self.rs_bits + self.k - 1)
        self.preamble = preamble(int(packet.get("preamble_half", 64)),
                                 int(packet.get("preamble_cinit", 0x1234)))
        self.burst_len = self.preamble.size + self.coded_bits // 2

    def tx(self, payload: torch.Tensor) -> torch.Tensor:
        """Payload bits ``[B, payload_bits]`` -> complex64 bursts ``[B,
        burst_len]`` on the payload's device."""
        frame = torch.cat([payload, crc(payload, self.crc)], dim=-1)
        line = scramble(frame, self.scrambler)
        cw = rs_encode(bits_to_bytes(line), self.rs_n, self.rs_k)
        coded = conv_encode(interleave(bytes_to_bits(cw), self.rows))
        pairs = coded.reshape(coded.shape[0], -1, 2).to(torch.int64)
        table = torch.from_numpy(QPSK).to(payload.device)
        sym = table[pairs[..., 0] + 2 * pairs[..., 1]]
        pre = torch.from_numpy(self.preamble).to(payload.device)
        return torch.cat([pre.expand(payload.shape[0], -1), sym], dim=-1)
