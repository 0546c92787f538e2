"""5G-NR-style QC-LDPC: lifting, structured encoding, rate matching, and
edge-message decoding (PyTorch).

Counterpart of ``aether_primitives_tpu/ops/nr_ldpc.py``, with the same
tables and the same results:

- host numpy, copied verbatim: the lifting-size table of TS 38.212
  Table 5.3.2-1 (:data:`LIFTING_SIZES`, :func:`lifting_set`), the base-graph
  dimensions, the redundancy-version offsets (:func:`rv_start`) and the
  NR-structured base graphs (:func:`make_nr_base_graph`: the JAX package's
  synthesised shift tables, drawn from the same seeded generator; not the
  3GPP tables, which a caller passes as ``base_graph=``);
- :class:`NrLdpc`: the telescoping encoder as cyclic rolls
  (:func:`torch.roll`), bit selection from a host index list, soft
  de-rate-matching, and the QC min-sum decoder of :mod:`.ldpc` with the
  filler bits pinned to +1e9;
- :class:`NrTransportBlock`: TB CRC24A, segmentation with CRC24B, one
  :class:`NrLdpc` for the equal-sized blocks, batched.

:meth:`NrLdpc.dematch` sums repeated positions pass by pass (each pass of
the circular buffer touches a position once), so the sum's order is fixed
on every device: first transmission first, as the reference's scatter-add.

LLR convention: positive = bit 0.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from . import fec as _fec
from . import ldpc as _ldpc

__all__ = ["LIFTING_SIZES", "lifting_set", "rv_start", "make_nr_base_graph", "NrLdpc",
           "NrTransportBlock"]


# ------------------------------------------------------------- lifting sizes

#: TS 38.212 Table 5.3.2-1: Zc = a * 2^j, a in {2,3,5,7,9,11,13,15},
#: all values <= 384. Set index iLS = index of a.
_A_VALUES = (2, 3, 5, 7, 9, 11, 13, 15)
LIFTING_SIZES: Tuple[int, ...] = tuple(sorted(
    a * (1 << j)
    for a in _A_VALUES
    for j in range(8)
    if a * (1 << j) <= 384
))


def lifting_set(z: int) -> int:
    """Set index ``iLS`` (0-7) of lifting size ``z`` — the index of the
    odd part ``a`` in ``{2,3,5,7,9,11,13,15}`` (TS 38.212 §5.3.2)."""
    if z not in LIFTING_SIZES:
        raise ValueError(f"{z} is not an NR lifting size")
    a = z
    while a % 2 == 0:
        a //= 2
    if a == 1:  # pure powers of two have odd part 1 -> a = 2 branch
        a = 2
    return _A_VALUES.index(a)


_BG_DIMS = {1: (46, 68, 22), 2: (42, 52, 10)}  # bg -> (mb, nb, kb)

#: rv -> k0 numerator fraction (x Ncb / (66 or 50 Zc), floored to a
#: multiple of Zc) — TS 38.212 Table 5.4.2.1-2
_RV_NUM = {1: {0: 0, 1: 17, 2: 33, 3: 56}, 2: {0: 0, 1: 13, 2: 25, 3: 43}}
_RV_DEN = {1: 66, 2: 50}


def rv_start(bg: int, z: int, rv: int, ncb: Optional[int] = None) -> int:
    """Circular-buffer start ``k0`` for redundancy version ``rv``
    (TS 38.212 Table 5.4.2.1-2; ``ncb`` defaults to the full buffer)."""
    mb, nb, _kb = _BG_DIMS[bg]
    if ncb is None:
        ncb = (nb - 2) * z
    num = _RV_NUM[bg][int(rv)]
    return (num * ncb // (_RV_DEN[bg] * z)) * z


# --------------------------------------------------------- base-graph design


def _four_cycle_free_shift(base, i, j, z, rng):
    """Greedy shift pick for edge (i, j): avoid creating a lifted 4-cycle
    with any already-assigned 2x2 all-edges submatrix. A 4-cycle through
    blocks (i,j),(i,j'),(i',j),(i',j') exists iff
    ``(s_ij - s_ij' + s_i'j' - s_i'j) mod z == 0``."""
    mb, nb = base.shape
    forbidden = set()
    rows = np.nonzero(base[:, j] >= 0)[0]
    for jp in range(nb):
        if jp == j or base[i, jp] < 0:
            continue
        for ip in rows:
            if ip == i or base[ip, jp] < 0:
                continue
            # need s_ij != s_ijp - s_ipjp + s_ipj (mod z)
            forbidden.add(
                (base[i, jp] - base[ip, jp] + base[ip, j]) % z
            )
    choices = [s for s in range(z) if s not in forbidden]
    if not choices:  # fully blocked (tiny z, dense row) — accept a 4-cycle
        return int(rng.integers(z))
    return int(choices[rng.integers(len(choices))])


@functools.lru_cache(maxsize=None)
def make_nr_base_graph(bg: int = 2, z: int = 128, seed: int = 1) -> np.ndarray:
    """NR-structured base graph ``[mb, nb]`` (shifts; -1 = zero block).

    Topology (the class TS 38.212's graphs belong to):

    - block-columns ``0..kb-1``: systematic (first two punctured);
    - columns ``kb..kb+3``: core parity. Column ``kb`` has weight 3 on
      rows (0, 1, 3) with shifts ``(1, 0, 0)`` — summing the four core
      rows then telescopes every other parity term away and leaves
      ``P^1 p0 = sum_i(A_i u)``, the single-shift solve the standard's
      encoder uses; columns ``kb+1..kb+3`` are the zero-shift double
      diagonal;
    - rows ``4..mb-1``: extension — a few systematic/core-parity
      connections plus one zero-shift identity column each (parity by
      direct XOR).

    Shifts are greedy 4-cycle-free for the given ``z``, drawn from
    ``np.random.default_rng(seed + 1000 * bg + z)``. NOT the 3GPP shift
    table: pass the real one as ``NrLdpc(base_graph=...)``.
    """
    if bg not in _BG_DIMS:
        raise ValueError("bg must be 1 or 2")
    mb, nb, kb = _BG_DIMS[bg]
    rng = np.random.default_rng(seed + 1000 * bg + z)
    base = np.full((mb, nb), -1, np.int64)

    # ---- core rows: dense over systematic columns
    core_sys = {
        0: list(range(kb)),
        1: list(range(kb)),
        2: [c for c in range(kb) if c % 2 == 0 or c < 4],
        3: [c for c in range(kb) if c % 2 == 1 or c < 4],
    }
    # core parity structure (weight-3 col kb + dual diagonal)
    base[0, kb] = 1   # the single non-zero shift of the weight-3 column
    base[1, kb] = 0
    base[3, kb] = 0
    base[0, kb + 1] = 0
    base[1, kb + 1] = 0
    base[1, kb + 2] = 0
    base[2, kb + 2] = 0
    base[2, kb + 3] = 0
    base[3, kb + 3] = 0
    # ---- extension rows: 3-4 connections into cols 0..kb+3 + identity
    for i in range(4, mb):
        deg = 4 if i < 4 + (mb - 4) // 2 else 3
        # always protect the two punctured columns with regular coverage
        cols = {(i - 4) % 2}
        while len(cols) < deg:
            cols.add(int(rng.integers(kb + 4)))
        for j in sorted(cols):
            base[i, j] = 0  # placeholder; shift assigned below
        base[i, kb + 4 + (i - 4)] = 0  # identity extension column
    # ---- assign shifts greedily (4-cycle-free where possible)
    for i in range(mb):
        sys_cols = core_sys.get(i, None)
        if sys_cols is not None:
            for j in sys_cols:
                base[i, j] = 0  # mark as edge first
        for j in range(kb + 4):
            if base[i, j] >= 0 and not (i <= 3 and j >= kb) \
                    and not (i >= 4 and j == kb + 4 + (i - 4)):
                base[i, j] = _four_cycle_free_shift(base, i, j, z, rng)
    return base


# ------------------------------------------------------------------ the code


@dataclass(frozen=True)
class NrLdpc:
    """A concrete NR(-structured) LDPC code at lifting size ``z``.

    ``k``: information bits carried per codeword (``<= kb * z``; the
    difference is filler bits, zeros known to both ends). ``base_graph``:
    optional ``[mb, nb]`` shift table (tuple of tuples or ndarray)
    overriding the built-in NR-structured one; it is stored as a tuple of
    tuples with its shifts taken mod ``z``.

    ``encode(bits, e, rv)``: ``[..., k]`` -> ``[..., e]`` rate-matched
    channel bits. ``decode(llrs, rv)``: soft inverse -> ``(info [..., k],
    ok [...])``. Several rv transmissions soft-combine by summing their
    :meth:`dematch` buffers before :meth:`decode_buffer`.
    """

    z: int
    bg: int = 2
    k: Optional[int] = None
    base_graph: Optional[tuple] = None  # hashable: tuple of tuples
    seed: int = 1

    def __post_init__(self):
        if self.z not in LIFTING_SIZES:
            raise ValueError(
                f"z={self.z} is not an NR lifting size {LIFTING_SIZES}"
            )
        mb, nb, kb = _BG_DIMS[self.bg]
        if self.base_graph is not None:
            base = np.asarray(self.base_graph, np.int64)
            if base.shape != (mb, nb):
                raise ValueError(
                    f"base graph must be [{mb}, {nb}] for BG{self.bg}"
                )
            # shifts are defined mod z
            base = np.where(base >= 0, base % self.z, -1)
            # the field becomes a hashable tuple of tuples: the frozen
            # dataclass's hash keys the lru_cache of _selection
            object.__setattr__(
                self, "base_graph", tuple(map(tuple, base.tolist()))
            )
        else:
            base = make_nr_base_graph(self.bg, self.z, self.seed)
        object.__setattr__(self, "_base", base)
        object.__setattr__(self, "mb", mb)
        object.__setattr__(self, "nb", nb)
        object.__setattr__(self, "kb", kb)
        k_max = kb * self.z
        k = self.k if self.k is not None else k_max
        if not 0 < k <= k_max:
            raise ValueError(f"k must be in (0, {k_max}], got {k}")
        object.__setattr__(self, "k", k)
        object.__setattr__(self, "n_filler", k_max - k)
        # circular buffer: codeword minus the 2 punctured leading blocks
        object.__setattr__(self, "ncb", (nb - 2) * self.z)
        # filler positions inside the circular buffer (they sit at
        # systematic positions k..kb*z, which shift left by 2z after
        # puncturing)
        f0, f1 = k - 2 * self.z, k_max - 2 * self.z
        object.__setattr__(self, "_filler_span", (max(f0, 0), max(f1, 0)))

    # ------------------------------------------------------------ encode

    def _row_sum(self, blocks, i: int, cols: int) -> torch.Tensor:
        """Row ``i``'s XOR over block columns ``0..cols-1``: qc_expand's
        block (i, j, s) makes check (i, t) touch bit (j, (t + s) mod z), so
        block column j contributes ``roll(v_j, -s)``."""
        acc = torch.zeros_like(blocks[..., 0, :])
        for j in range(cols):
            s = int(self._base[i, j])
            if s >= 0:
                acc = acc ^ torch.roll(blocks[..., j, :], -s, dims=-1)
        return acc

    def codeword(self, bits) -> torch.Tensor:
        """``[..., k]`` info bits -> FULL ``[..., nb*z]`` codeword
        (fillers included, nothing punctured); :meth:`encode` applies
        puncturing + rate matching on top."""
        z, kb, mb = self.z, self.kb, self.mb
        b = torch.as_tensor(bits).to(torch.uint8)
        if b.shape[-1] != self.k:
            raise ValueError(f"expected {self.k} info bits, got {b.shape[-1]}")
        lead = tuple(b.shape[:-1])
        if self.n_filler:
            b = torch.nn.functional.pad(b, (0, self.n_filler))
        u = b.reshape(lead + (kb, z))
        t = [self._row_sum(u, i, kb) for i in range(4)]
        # telescoping solve: P^1 p0 = t0 ^ t1 ^ t2 ^ t3
        p0 = torch.roll(t[0] ^ t[1] ^ t[2] ^ t[3], 1, dims=-1)  # inverse of roll(-1)
        p1 = t[0] ^ torch.roll(p0, -1, dims=-1)  # row 0: t0 ^ roll(p0, -1) ^ p1 = 0
        p2 = t[1] ^ p0 ^ p1  # row 1: t1 ^ p0 ^ p1 ^ p2 = 0
        p3 = t[3] ^ p0  # row 3: t3 ^ p0 ^ p3 = 0
        vars_ = torch.cat([u, torch.stack([p0, p1, p2, p3], dim=-2)], dim=-2)  # [..., kb+4, z]
        # extension rows: direct XOR
        ext = [self._row_sum(vars_, i, kb + 4) for i in range(4, mb)]
        cw = torch.cat([vars_] + [e.unsqueeze(-2) for e in ext], dim=-2)
        return cw.reshape(lead + (self.nb * z,))

    @functools.lru_cache(maxsize=8)
    def _selection(self, e: int, rv: int) -> np.ndarray:
        """Static bit-selection index list (positions in the circular
        buffer) for ``e`` output bits starting at ``k0(rv)``, skipping
        fillers, wrapping (TS 38.212 §5.4.2.1)."""
        f0, f1 = self._filler_span
        k0 = rv_start(self.bg, self.z, rv, self.ncb)
        idx, pos = [], k0
        while len(idx) < e:
            if not (f0 <= pos < f1):
                idx.append(pos)
            pos = (pos + 1) % self.ncb
        return np.asarray(idx, np.int32)

    def encode(self, bits, e: int, rv: int = 0) -> torch.Tensor:
        """``[..., k]`` info bits -> ``[..., e]`` rate-matched channel
        bits (redundancy version ``rv``)."""
        cw = self.codeword(bits)
        buf = cw[..., 2 * self.z:]  # puncture the 2 leading blocks
        sel = torch.from_numpy(self._selection(int(e), int(rv)).astype(np.int64))
        return buf.index_select(-1, sel.to(buf.device))

    # ------------------------------------------------------------ decode

    def dematch(self, llrs, rv: int = 0) -> torch.Tensor:
        """De-rate-match ``[..., e]`` channel LLRs into the ``[..., ncb]``
        circular-buffer LLR (repetitions accumulate; untransmitted = 0).
        Sum several calls' outputs to soft-combine rv retransmissions.

        The selection visits every non-filler position once before it
        repeats one, so it splits into passes of distinct positions; each
        pass is added in turn, which fixes the sum's order on any device."""
        lam = torch.as_tensor(llrs).to(torch.float32)
        e = int(lam.shape[-1])
        sel = torch.from_numpy(self._selection(e, int(rv)).astype(np.int64)).to(lam.device)
        f0, f1 = self._filler_span
        usable = self.ncb - (f1 - f0)
        buf = torch.zeros(tuple(lam.shape[:-1]) + (self.ncb,), dtype=torch.float32,
                          device=lam.device)
        for p0 in range(0, e, usable):
            idx = sel[p0:p0 + usable]
            buf[..., idx] = buf[..., idx] + lam[..., p0:p0 + usable]
        return buf

    def decode_buffer(self, buffer_llrs, iters: int = 25):
        """Decode ``[..., ncb]`` de-rate-matched LLRs ->
        ``(info [..., k], syndrome_ok [...])``."""
        lam = torch.as_tensor(buffer_llrs).to(torch.float32)
        lead = tuple(lam.shape[:-1])
        f0, f1 = self._filler_span
        full = torch.cat([lam.new_zeros(lead + (2 * self.z,)), lam], dim=-1)
        if f1 > f0:  # fillers are known zeros
            full[..., f0 + 2 * self.z:f1 + 2 * self.z] = 1e9
        hard, ok = _ldpc.qc_ldpc_decode(full, self._base, self.z, iters=int(iters))
        return hard[..., : self.k], ok

    def decode(self, llrs, rv: int = 0, iters: int = 25):
        """``[..., e]`` channel LLRs -> ``(info [..., k], ok [...])``."""
        return self.decode_buffer(self.dematch(llrs, rv), iters)

    def parity_check(self) -> np.ndarray:
        """Full binary ``[mb*z, nb*z]`` parity-check matrix."""
        return _ldpc.qc_expand(self._base, self.z)


# -------------------------------------------------- transport-block chain

#: TS 38.212 §5.2.2: maximum code-block size per base graph
_KCB = {1: 8448, 2: 3840}


@dataclass(frozen=True)
class NrTransportBlock:
    """The TS 38.212 §5.2.2/§5.3.2 transport-block chain: TB CRC24A ->
    segmentation into C code blocks with per-block CRC24B -> one
    :class:`NrLdpc` codec per (equal-sized) block, batched.

    ``B = tb_bits + 24``; if ``B <= Kcb`` one block with no CRC24B, else
    ``C = ceil(B / (Kcb - 24))`` blocks each carrying CRC24B; ``K' =
    ceil(B' / C)``; lifting size = smallest ``Zc`` with ``kb * Zc >= K'``;
    fillers absorb ``kb * Zc - K'``.

    ``encode(payload, e, rv)`` -> ``[..., C * e]`` channel bits;
    ``decode(llrs, rv)`` -> ``(payload, ok)`` with ``ok`` the TB CRC24A
    verdict.
    """

    tb_bits: int
    bg: int = 2
    base_graph: Optional[tuple] = None
    seed: int = 1

    def __post_init__(self):
        kcb = _KCB[self.bg]
        b = self.tb_bits + 24  # TB CRC24A
        if b <= kcb:
            c, b_prime = 1, b
            k_per = b
        else:
            c = -(-b // (kcb - 24))
            b_prime = b + 24 * c  # CRC24B per block
            k_per = -(-b_prime // c)
        object.__setattr__(self, "n_blocks", c)
        object.__setattr__(self, "k_per_block", k_per)
        code = NrLdpc(
            z=min(s for s in LIFTING_SIZES
                  if _BG_DIMS[self.bg][2] * s >= k_per),
            bg=self.bg, k=k_per, base_graph=self.base_graph, seed=self.seed,
        )
        object.__setattr__(self, "code", code)
        # leading block carries any shortfall as leading zero pad
        object.__setattr__(self, "pad", c * k_per - b_prime if c > 1 else 0)

    def _segments(self, payload) -> torch.Tensor:
        p = torch.as_tensor(payload).to(torch.uint8)
        if p.shape[-1] != self.tb_bits:
            raise ValueError(
                f"payload must be {self.tb_bits} bits, got {p.shape[-1]}"
            )
        lead = tuple(p.shape[:-1])
        tb = _fec.crc_append(p, "crc24a")
        if self.n_blocks == 1:
            return tb.reshape(lead + (1, self.k_per_block))
        if self.pad:
            tb = torch.nn.functional.pad(tb, (self.pad, 0))
        segs = tb.reshape(lead + (self.n_blocks, self.k_per_block - 24))
        return _fec.crc_append(segs, "crc24b")

    def encode(self, payload, e: int, rv: int = 0) -> torch.Tensor:
        """``[..., tb_bits]`` -> ``[..., n_blocks * e]`` channel bits."""
        coded = self.code.encode(self._segments(payload), e, rv)  # [..., C, e]
        return coded.reshape(tuple(coded.shape[:-2]) + (self.n_blocks * int(e),))

    def decode(self, llrs, rv: int = 0, iters: int = 25):
        """``[..., n_blocks * e]`` LLRs -> ``(payload [..., tb_bits],
        ok [...])`` — ``ok`` is the transport-block CRC24A verdict."""
        lam = torch.as_tensor(llrs).to(torch.float32)
        if lam.shape[-1] % self.n_blocks:
            raise ValueError(
                f"LLR count {lam.shape[-1]} not divisible by "
                f"{self.n_blocks} blocks"
            )
        e = lam.shape[-1] // self.n_blocks
        lead = tuple(lam.shape[:-1])
        segs, _syn_ok = self.code.decode(
            lam.reshape(lead + (self.n_blocks, e)), rv=rv, iters=iters
        )  # [..., C, k_per]
        if self.n_blocks > 1:
            segs = segs[..., : self.k_per_block - 24]  # strip CRC24B
        tb = segs.reshape(lead + (-1,))
        if self.pad:
            tb = tb[..., self.pad:]
        ok = _fec.crc_check(tb, "crc24a")
        return tb[..., : self.tb_bits], ok
