"""Pseudo-random sequences, scramblers and DSSS spreading (PyTorch).

Counterpart of ``aether_primitives_tpu/ops/sequence.py``: :func:`expand`,
:func:`generate`, the LFSRs :func:`lfsr_generate` and
:func:`lfsr_matrix_generate`, :func:`lte_gold` (a host numpy constant: the
preamble is built from it once per modem), the scramblers
(:func:`scramble_multiplicative` / :func:`descramble_multiplicative`,
:func:`scramble_additive`), DSSS (:func:`bits_to_chips`,
:func:`dsss_spread`, :func:`dsss_despread`) and the host tables
:func:`zadoff_chu` and :func:`gps_ca_code`. Bits are exact {0, 1} uint8,
equal to the JAX package's. The LFSRs take the JAX package's GF(2)
companion-matrix form on the requested device: the states at every block's
start by doubling jumps, then every block's bits in one matmul (the
caller's ``init`` never goes through the host). The scrambler's feedback
recurrence runs as a plain loop that advances ``min(delays)`` bits per
step (every bit in such a chunk depends only on earlier chunks), batched
over leading axes.
"""

from __future__ import annotations

import functools
from typing import Callable, Sequence

import numpy as np
import torch

from ..types import stage_device
from ._gf import gf2_power


def expand(seed: int, length: int) -> np.ndarray:
    """LSB-first bit-unpack of ``seed`` into a {0,1} uint8 vector."""
    i = np.arange(length, dtype=np.uint64)
    return ((np.uint64(seed) >> i) & np.uint64(1)).astype(np.uint8)


def generate(init: Sequence[int], generator: Callable[[int, np.ndarray], int],
             length: int) -> np.ndarray:
    """Grow ``init`` with ``generator(pos, seq_so_far)`` until ``length``
    (the reference's ``generate``, src/sequence.rs:47-53): host numpy,
    serial."""
    seq = np.asarray(init, dtype=np.uint8).tolist()
    while len(seq) < length:
        seq.append(np.uint8(generator(len(seq), np.asarray(seq, dtype=np.uint8))))
    return np.asarray(seq, dtype=np.uint8)


def _lfsr(init: np.ndarray, delays: Sequence[int], length: int) -> np.ndarray:
    """``x(n) = sum_d x(n - d) mod 2`` from ``init`` (``max(delays)`` bits),
    ``length`` bits in all (host numpy), ``min(delays)`` bits a step: each
    bit of such a chunk depends on earlier chunks only."""
    order, step = max(delays), min(delays)
    x = np.zeros(max(length, order), np.uint8)
    x[:order] = init
    for start in range(order, length, step):
        stop = min(length, start + step)
        acc = np.zeros(stop - start, np.uint8)
        for d in delays:
            acc ^= x[start - d:stop - d]
        x[start:stop] = acc
    return x[:length]


@functools.lru_cache(maxsize=None)
def _lfsr_blocks(delays: tuple, order: int, block: int, levels: int, device: torch.device):
    """The JAX package's ``_lfsr_block_matrices`` on ``device``: with the
    state ``s_n = [x(n), ..., x(n + order - 1)]`` and the companion matrix
    ``C``, ``M_out.T`` (float32 ``[order, block]``, row ``j`` of ``M_out``
    ``e_0 C^j``: ``x(n + j) = M_out[j] s_n``) and the jumps ``((C^block)^(2^k)).T``
    for ``k < levels`` (``[levels, order, order]``), built with exact numpy
    integers once."""
    comp = np.zeros((order, order), np.int64)
    comp[:-1, 1:] = np.eye(order - 1, dtype=np.int64)
    for d in delays:
        comp[order - 1, order - d] = 1  # x(n + order) = sum x(n + order - d)
    rows = np.zeros((block, order), np.int64)
    row = np.eye(order, dtype=np.int64)[0]
    for j in range(block):
        rows[j] = row
        row = (row @ comp) % 2
    jump = gf2_power(comp, block)
    jumps = np.zeros((levels, order, order), np.float32)
    for k in range(levels):
        jumps[k] = jump.T
        jump = (jump @ jump) % 2
    return (torch.from_numpy(np.ascontiguousarray(rows.T, np.float32)).to(device),
            torch.from_numpy(jumps).to(device))


def _lfsr_tensor(init, delays: Sequence[int], length: int, device, block: int,
                 raw_head: bool) -> torch.Tensor:
    """``length`` bits of the LFSR from ``init`` on ``device`` (None:
    ``init``'s device when it is a tensor, else the card): the states at
    the blocks' starts by doubling (``s_{(k + 2^l) B} = (C^B)^(2^l)
    s_{kB}``, ``log2`` of the block count matmuls), then every block's bits
    as ``states @ M_out.T``, all mod 2 in float32 (exact: every sum is at
    most ``order``). ``raw_head``: the first ``order`` bits are ``init``
    as given (``lfsr_generate``), else ``init mod 2`` (the matrix form's)."""
    delays = tuple(int(d) for d in delays)
    order = max(delays)
    if device is None:
        device = init.device if isinstance(init, torch.Tensor) else "cuda"
    dev = stage_device(device, "lfsr")
    init = torch.as_tensor(init).to(dev, torch.uint8)
    if init.shape[-1] != order:
        raise ValueError(f"init length {init.shape[-1]} != max delay {order}")
    if length <= order and raw_head:
        return init[:length].clone()
    nb = -(-length // block)
    rows_t, jumps = _lfsr_blocks(delays, order, block, (nb - 1).bit_length(), init.device)
    states = torch.remainder(init.to(torch.float32), 2.0)[None]  # [1, order]
    for jump in jumps:
        states = torch.cat([states, torch.remainder(states @ jump, 2.0)])
    bits = torch.remainder(states[:nb] @ rows_t, 2.0).reshape(-1)[:length].to(torch.uint8)
    if raw_head:
        bits[:order] = init
    return bits


def lfsr_generate(init, delays: Sequence[int], length: int, device=None) -> torch.Tensor:
    """LFSR ``x(n) = sum_k x(n - d_k) mod 2`` from ``init`` (``max(delays)``
    bits), ``length`` bits in all, as a uint8 tensor on ``device`` (None:
    ``init``'s device when it is a tensor, else the card). Example, the LTE
    TS 36.211 §7.2 x1 recurrence: ``lfsr_generate(expand(1, 31), (28, 31),
    1600)``. The recurrence runs on ``device`` in the matrix form of
    :func:`lfsr_matrix_generate` (the same bits), ``init`` as the first
    ``max(delays)`` bits."""
    return _lfsr_tensor(init, delays, length, device, 1024, True)


def lfsr_matrix_generate(init, delays: Sequence[int], length: int, block: int = 1024,
                         device=None) -> torch.Tensor:
    """The same sequence as :func:`lfsr_generate`, ``block`` bits a matmul
    (the output does not depend on ``block``), every bit mod 2 as in the
    JAX package's matrix form."""
    return _lfsr_tensor(init, delays, length, device, int(block), False)


def lte_gold(c_init: int, length: int, nc: int = 1600) -> np.ndarray:
    """3GPP TS 36.211 §7.2 Gold sequence ``c(n) = x1(n + Nc) ^ x2(n + Nc)``:
    ``x1`` from ``x1(0) = 1`` with ``x1(n) = x1(n-28) + x1(n-31)``, ``x2``
    seeded by ``c_init`` with taps 28, 29, 30, 31. Host numpy uint8."""
    total = nc + length
    x1 = _lfsr(expand(1, 31), (28, 31), total)
    x2 = _lfsr(expand(c_init, 31), (28, 29, 30, 31), total)
    return ((x1[nc:] + x2[nc:]) % 2).astype(np.uint8)


def _bits(bits, device=None) -> torch.Tensor:
    return torch.as_tensor(bits, device=device).to(torch.uint8) % 2


def _init_state(init, order: int, batch, device) -> torch.Tensor:
    if init is None:
        return torch.zeros(tuple(batch) + (order,), dtype=torch.uint8,
                           device=device)
    h = _bits(init, device)
    if h.shape[-1] != order:
        raise ValueError(f"init length {h.shape[-1]} != max delay {order}")
    return h.expand(tuple(batch) + (order,))


def scramble_multiplicative(bits, delays: Sequence[int] = (14, 15),
                            init=None, block: int = 256) -> torch.Tensor:
    """Self-synchronising scrambler ``y(n) = x(n) ^ sum_d y(n-d)``; the
    default taps ``(14, 15)`` are the DVB / V.35 polynomial ``1 + x^14 +
    x^15``. ``init`` is the ``max(delays)`` bits of output history before
    the stream (zeros when None). ``[..., n]`` uint8 -> ``[..., n]``.
    ``block`` is accepted and ignored: it sizes the JAX package's GF(2)
    matmul steps, and the output does not depend on it."""
    x = _bits(bits)
    delays = tuple(int(d) for d in delays)
    order, step = max(delays), min(delays)
    n = x.shape[-1]
    y = torch.cat([_init_state(init, order, x.shape[:-1], x.device),
                   torch.zeros_like(x)], dim=-1)
    for start in range(0, n, step):
        stop = min(n, start + step)
        acc = x[..., start:stop].clone()
        for d in delays:
            acc ^= y[..., order + start - d:order + stop - d]
        y[..., order + start:order + stop] = acc
    return y[..., order:]


def descramble_multiplicative(bits, delays: Sequence[int] = (14, 15),
                              init=None) -> torch.Tensor:
    """Inverse of :func:`scramble_multiplicative`: ``x(n) = y(n) ^ sum_d
    y(n-d)``, feed-forward. A wrong ``init`` corrupts only the first
    ``max(delays)`` bits."""
    y = _bits(bits)
    delays = tuple(int(d) for d in delays)
    order = max(delays)
    n = y.shape[-1]
    yp = torch.cat([_init_state(init, order, y.shape[:-1], y.device), y], dim=-1)
    acc = y.clone()
    for d in delays:
        acc ^= yp[..., order - d:order - d + n]
    return acc


def scramble_additive(bits, sequence) -> torch.Tensor:
    """Additive (synchronous) scrambler: XOR with a free-running PN sequence
    (e.g. :func:`lte_gold`), self-inverse. ``sequence`` is cut to the bits'
    length and moved to their device."""
    b = _bits(bits)
    s = _bits(sequence, b.device)
    return b ^ s[..., :b.shape[-1]]


def bits_to_chips(bits) -> torch.Tensor:
    """{0,1} spreading bits -> antipodal float32 chips {+1, -1} (bit 0 -> +1)."""
    return 1.0 - 2.0 * torch.as_tensor(bits).to(torch.float32)


def dsss_spread(symbols, chips) -> torch.Tensor:
    """Direct-sequence spread: each symbol times the ``L``-chip code,
    ``[..., n]`` -> ``[..., n * L]``."""
    s = torch.as_tensor(symbols)
    c = torch.as_tensor(chips, device=s.device)
    out = s[..., :, None] * c
    return out.reshape(s.shape[:-1] + (s.shape[-1] * c.shape[-1],))


def dsss_despread(x, chips) -> torch.Tensor:
    """Matched despread, the inverse of :func:`dsss_spread`: each ``L``-chip
    span correlated with ``conj(chips) / sum |chips|^2``, ``[..., n*L] ->
    [..., n]`` (a trailing partial span is dropped)."""
    x = torch.as_tensor(x)
    c = torch.as_tensor(chips, device=x.device)
    ell = c.shape[-1]
    n = x.shape[-1] // ell
    frames = x[..., :n * ell].reshape(x.shape[:-1] + (n, ell))
    w = c.conj() / (c.abs() ** 2).sum()
    return (frames * w).sum(dim=-1)


def zadoff_chu(root: int, length: int, shift: int = 0) -> np.ndarray:
    """Zadoff-Chu CAZAC sequence (host table, complex64):
    ``x[n] = e^{-j pi u n (n+1+2q) / L}`` for odd ``L``, ``root`` coprime
    with ``length``, ``shift`` the cyclic-shift parameter ``q``. The
    quadratic phase is reduced mod ``2L`` in exact integers before the trig."""
    length = int(length)
    root = int(root)
    if length % 2 == 0:
        raise ValueError("zadoff_chu: length must be odd")
    if np.gcd(root, length) != 1:
        raise ValueError("root must be coprime with length")
    n = np.arange(length, dtype=np.int64)
    ph = (root * n * (n + 1 + 2 * int(shift))) % (2 * length)
    return np.exp(-1j * np.pi * ph / length).astype(np.complex64)


#: IS-GPS-200 Table 3-I: PRN -> (G2 phase-select taps, the published
#: first-10-chip octal); :func:`gps_ca_code` checks the one against the other.
_GPS_CA_TAPS = {
    1: (2, 6, 0o1440), 2: (3, 7, 0o1620), 3: (4, 8, 0o1710),
    4: (5, 9, 0o1744), 5: (1, 9, 0o1133), 6: (2, 10, 0o1455),
    7: (1, 8, 0o1131), 8: (2, 9, 0o1454), 9: (3, 10, 0o1626),
    10: (2, 3, 0o1504), 11: (3, 4, 0o1642), 12: (5, 6, 0o1750),
    13: (6, 7, 0o1764), 14: (7, 8, 0o1772), 15: (8, 9, 0o1775),
    16: (9, 10, 0o1776), 17: (1, 4, 0o1156), 18: (2, 5, 0o1467),
    19: (3, 6, 0o1633), 20: (4, 7, 0o1715), 21: (5, 8, 0o1746),
    22: (6, 9, 0o1763), 23: (1, 3, 0o1063), 24: (4, 6, 0o1706),
    25: (5, 7, 0o1743), 26: (6, 8, 0o1761), 27: (7, 9, 0o1770),
    28: (8, 10, 0o1774), 29: (1, 6, 0o1127), 30: (2, 7, 0o1453),
    31: (3, 8, 0o1625), 32: (4, 9, 0o1712),
}


@functools.lru_cache(maxsize=None)
def gps_ca_code(prn: int) -> np.ndarray:
    """GPS L1 C/A code of satellite ``prn`` (1..32): 1023 chips in {0, 1}
    (IS-GPS-200 §3.3.2.3), host numpy. G1 ``1 + x^3 + x^10``, G2 ``1 + x^2 +
    x^3 + x^6 + x^8 + x^9 + x^10`` (all-ones init), chip ``G1 ^ G2[s1] ^
    G2[s2]``; the first 10 chips are checked against the standard's octal."""
    if prn not in _GPS_CA_TAPS:
        raise ValueError(f"PRN {prn} not in 1..32")
    s1, s2, octal_ref = _GPS_CA_TAPS[prn]
    g1 = np.ones(10, np.uint8)
    g2 = np.ones(10, np.uint8)
    out = np.zeros(1023, np.uint8)
    for i in range(1023):
        out[i] = g1[9] ^ g2[s1 - 1] ^ g2[s2 - 1]
        f1 = g1[2] ^ g1[9]
        f2 = g2[1] ^ g2[2] ^ g2[5] ^ g2[7] ^ g2[8] ^ g2[9]
        g1 = np.concatenate([[f1], g1[:9]])
        g2 = np.concatenate([[f2], g2[:9]])
    prefix = int("".join(str(int(b)) for b in out[:10]), 2)
    if prefix != octal_ref:
        raise AssertionError(
            f"PRN {prn}: generated prefix {oct(prefix)} != standard {oct(octal_ref)}"
        )
    return out
