"""LDPC codes: GF(2) matmul encoding and batched normalized min-sum
decoding (PyTorch).

Counterpart of ``aether_primitives_tpu/ops/ldpc.py``: the same code
constructions (the Gallager ``(dv, dc)``-regular ensemble and the IEEE
802.11n n=648 Z=27 rate-1/2 QC code), the same generators and info
positions, the same decoders.

- :func:`make_regular_ldpc`, :func:`ldpc_generator`, :func:`qc_expand`,
  :func:`wifi_ldpc`: host numpy, copies of the JAX package's builders.
- :func:`ldpc_encode`: one float32 matmul mod 2 (exact).
- :func:`ldpc_decode` and :func:`qc_ldpc_decode`: normalized min-sum on
  the graph's edges, batched over leading axes. The messages live on a
  ``[..., m, d]`` plane of each check's edges (``d`` its largest degree,
  padded), and a variable's total is a gather of its edges added one at
  a time in ascending check order (the reference's order), so a run is
  deterministic on every device. The QC decoder's tables come from the
  base matrix, never the dense matrix. The JAX
  package holds the dense decoder's messages on a masked ``[m, n]``
  plane, because gathers are slow on its TPU; the QC decoder keeps them
  per base-matrix edge with static rolls. Both are the same update on
  the same edges: ``ldpc_decode`` makes ``iters + 1`` check updates (its
  last one before the posterior), ``qc_ldpc_decode`` makes ``iters``.
- :func:`extract_info`.

The decoders are float32: hard bits and ``ok`` equal the reference's on
every input tried (the check updates are exact, and the variable totals
are summed in its order).

LLR convention: positive = bit 0.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

__all__ = ["make_regular_ldpc", "ldpc_generator", "qc_expand", "wifi_ldpc", "ldpc_encode",
           "ldpc_decode", "qc_ldpc_decode", "extract_info"]


# --------------------------------------------------------------- GF(2) host math


def _gf2_row_reduce(h: np.ndarray) -> Tuple[np.ndarray, np.ndarray, int]:
    """Row-reduce ``h`` over GF(2) with column pivoting: ``(reduced, perm,
    rank)``, ``reduced[:, perm]`` in reduced row-echelon form."""
    h = h.copy().astype(np.uint8) % 2
    m, n = h.shape
    perm = np.arange(n)
    rank = 0
    for col in range(n):
        if rank == m:
            break
        sub = h[rank:, perm[col]]
        nz = np.nonzero(sub)[0]
        if nz.size == 0:
            continue
        piv = rank + nz[0]
        if piv != rank:
            h[[rank, piv]] = h[[piv, rank]]
        perm[[rank, col]] = perm[[col, rank]]
        hits = np.nonzero(h[:, perm[rank]])[0]
        hits = hits[hits != rank]
        h[hits] ^= h[rank]
        rank += 1
    return h, perm, rank


def ldpc_generator(h: np.ndarray) -> np.ndarray:
    """Systematic generator ``G [k, n]`` (``k = n - rank(h)``) with ``(G @
    h.T) % 2 == 0``; the info bits lie on the reduction's non-pivot
    columns."""
    g, _ = _generator_and_info(np.asarray(h, np.uint8))
    return g


def _generator_and_info(h: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    red, perm, rank = _gf2_row_reduce(h)
    _, n = h.shape
    k = n - rank
    p = red[:rank][:, perm[rank:]]  # [rank, k]
    g = np.zeros((k, n), np.uint8)
    g[np.arange(k), perm[rank:]] = 1
    g[:, perm[:rank]] = p.T
    return g, perm[rank:].copy()


@functools.lru_cache(maxsize=None)
def make_regular_ldpc(n: int = 648, dv: int = 3, dc: int = 6,
                      seed: int = 7) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Gallager ``(dv, dc)``-regular code: ``(H [m, n], G [k, n],
    info_indices [k])``, ``m = n dv / dc``; band 0 maps variable ``v`` to
    check ``v // dc``, each further band a fixed-seed column permutation."""
    if (n * dv) % dc:
        raise ValueError("n*dv must divide by dc")
    m = n * dv // dc
    if m % dv:
        raise ValueError("m must divide by dv (bands)")
    band_rows = m // dv
    if band_rows * dc != n:
        raise ValueError("inconsistent regular parameters")
    rng = np.random.default_rng(seed)
    h = np.zeros((m, n), np.uint8)
    for band in range(dv):
        cols = np.arange(n) if band == 0 else rng.permutation(n)
        for r in range(band_rows):
            h[band * band_rows + r, cols[r * dc:(r + 1) * dc]] = 1
    g, info = _generator_and_info(h)
    return h, g, info


def qc_expand(base: np.ndarray, z: int) -> np.ndarray:
    """A QC base matrix of circulant shifts -> the binary ``[mb z, nb z]``
    parity-check matrix: -1 a zero block, ``s >= 0`` the identity rolled so
    that check ``(i, u)`` touches bit ``(u + s) mod z`` of block ``j``."""
    base = np.asarray(base, np.int64)
    mb, nb = base.shape
    h = np.zeros((mb * z, nb * z), np.uint8)
    eye = np.eye(z, dtype=np.uint8)
    for i in range(mb):
        for j in range(nb):
            s = int(base[i, j])
            if s >= 0:
                h[i * z:(i + 1) * z, j * z:(j + 1) * z] = np.roll(eye, -(s % z), axis=0)
    return h


#: IEEE 802.11n rate-1/2 base matrix for n=648, Z=27 (IEEE Std 802.11-2012
#: Annex F, Table F-1), as the JAX package has it.
_WIFI_648_R12 = np.array([
    [0, -1, -1, -1, 0, 0, -1, -1, 0, -1, -1, 0, 1, 0, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1],
    [22, 0, -1, -1, 17, -1, 0, 0, 12, -1, -1, -1, -1, 0, 0, -1, -1, -1, -1, -1, -1, -1, -1, -1],
    [6, -1, 0, -1, 10, -1, -1, -1, 24, -1, 0, -1, -1, -1, 0, 0, -1, -1, -1, -1, -1, -1, -1, -1],
    [2, -1, -1, 0, 20, -1, -1, -1, 25, 0, -1, -1, -1, -1, -1, 0, 0, -1, -1, -1, -1, -1, -1, -1],
    [23, -1, -1, -1, 3, -1, -1, -1, 0, -1, 9, 11, -1, -1, -1, -1, 0, 0, -1, -1, -1, -1, -1, -1],
    [24, -1, 23, 1, 17, -1, 3, -1, 10, -1, -1, -1, -1, -1, -1, -1, -1, 0, 0, -1, -1, -1, -1, -1],
    [25, -1, -1, -1, 8, -1, -1, -1, 7, 18, -1, -1, 0, -1, -1, -1, -1, -1, 0, 0, -1, -1, -1, -1],
    [13, 24, -1, -1, 0, -1, 8, -1, 6, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, 0, 0, -1, -1, -1],
    [7, 20, -1, 16, 22, 10, -1, -1, 23, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, 0, 0, -1, -1],
    [11, -1, -1, -1, 19, -1, -1, -1, 13, -1, 3, 17, -1, -1, -1, -1, -1, -1, -1, -1, -1, 0, 0, -1],
    [25, -1, 8, -1, 23, 18, -1, 14, 9, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, 0, 0],
    [3, -1, -1, -1, 16, -1, -1, 2, 25, 5, -1, -1, 1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, 0],
], np.int64)


def _gf2_solve_parity(h: np.ndarray, k: int) -> np.ndarray:
    """For ``h = [A | B]`` with ``B [m, m]`` invertible over GF(2): ``P =
    B^{-1} A [m, k]``, the parity ``p = P u (mod 2)`` of ``[u | p]``."""
    m = h.shape[0]
    a = h[:, :k].astype(np.uint8).copy()
    b = h[:, k:].astype(np.uint8).copy()
    assert b.shape == (m, m)
    for col in range(m):
        piv = col + np.nonzero(b[col:, col])[0]
        if piv.size == 0:
            raise ValueError("parity block is singular over GF(2)")
        p = piv[0]
        if p != col:
            b[[col, p]] = b[[p, col]]
            a[[col, p]] = a[[p, col]]
        hits = np.nonzero(b[:, col])[0]
        hits = hits[hits != col]
        b[hits] ^= b[col]
        a[hits] ^= a[col]
    return a


@functools.lru_cache(maxsize=None)
def wifi_ldpc(rate: str = "1/2") -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """IEEE 802.11n QC-LDPC, n=648, Z=27: ``(H, G, info_indices)``, ``G =
    [I_k | P^T]`` (the message bits first)."""
    if rate != "1/2":
        raise ValueError("only the rate-1/2 n=648 code is built in; expand "
                         "any published base matrix with qc_expand")
    z = 27
    h = qc_expand(_WIFI_648_R12, z)
    m, n = h.shape
    k = n - m
    p = _gf2_solve_parity(h, k)
    g = np.concatenate([np.eye(k, dtype=np.uint8), p.T], axis=1)
    assert ((g @ h.T) % 2 == 0).all()
    return h, g, np.arange(k, dtype=np.int64)


# ------------------------------------------------------------------ the decoder


@functools.lru_cache(maxsize=16)
def _edges(shape: Tuple[int, int], packed: bytes):
    """The graph of a parity-check matrix: ``rows [m, d]`` each check's
    variables in ascending order (padded with ``n``), ``valid [m, d]``, and
    ``cols [n, dv]`` each variable's edges as flat indices of the ``[m,
    d]`` plane in ascending check order (padded with ``m d``, a zero)."""
    m, n = shape
    h = np.unpackbits(np.frombuffer(packed, np.uint8), count=m * n).reshape(m, n)
    deg_r = h.sum(axis=1)
    d = max(int(deg_r.max()), 1)
    rows = np.full((m, d), n, np.int64)
    for i in range(m):
        nz = np.nonzero(h[i])[0]
        rows[i, :nz.size] = nz
    valid = rows < n
    flat = np.arange(m * d).reshape(m, d)
    dv = max(int(h.sum(axis=0).max()), 1)
    cols = np.full((n, dv), m * d, np.int64)
    fill = np.zeros(n, np.int64)
    for i in range(m):
        for e in range(int(deg_r[i])):
            v = rows[i, e]
            cols[v, fill[v]] = flat[i, e]
            fill[v] += 1
    return rows, valid, cols


@functools.lru_cache(maxsize=16)
def _qc_edges(base_key: Tuple[Tuple[int, ...], ...], z: int):
    """:func:`_edges` of ``qc_expand(base, z)``, built from the base matrix
    in O(edges z) without the dense matrix: check ``(i, t)`` touches bit
    ``(t + s) mod z`` of every block ``j`` with a shift ``s`` in row ``i``
    (ascending in ``j``, so in ascending variable order), and bit ``(j,
    u)`` is touched by check ``(u - s) mod z`` of every such block row
    ``i`` (ascending in ``i``, so in ascending check order)."""
    base = np.asarray(base_key, np.int64)
    mb, nb = base.shape
    m, n = mb * z, nb * z
    on = base >= 0
    d = max(int(on.sum(axis=1).max(initial=0)), 1)
    dv = max(int(on.sum(axis=0).max(initial=0)), 1)
    ii, jj = np.nonzero(on)  # the edges, row-major
    s = (base[ii, jj] % z)[:, None]
    slot = (np.cumsum(on, axis=1) - 1)[ii, jj]  # the edge's place in its check
    rank = (np.cumsum(on, axis=0) - 1)[ii, jj]  # and in its variable
    t = np.arange(z)[None, :]
    rows = np.full((mb, z, d), n, np.int64)
    rows[ii, :, slot] = jj[:, None] * z + (t + s) % z
    cols = np.full((nb, z, dv), m * d, np.int64)
    cols[jj, :, rank] = (ii[:, None] * z + (t - s) % z) * d + slot[:, None]
    rows = rows.reshape(m, d)
    return rows, rows < n, cols.reshape(n, dv)


def _check_update(v2c: torch.Tensor, valid: torch.Tensor, alpha: float) -> torch.Tensor:
    """Normalized min-sum at every check: for each edge, ``alpha`` times the
    sign product of the check's other edges times their least magnitude;
    0 on the padding."""
    big = 1e30
    mag = torch.where(valid, v2c.abs(), torch.full_like(v2c, big))
    sgn = torch.where(v2c >= 0, 1.0, -1.0)
    sgn = torch.where(valid, sgn, torch.ones_like(sgn))
    row_sign = sgn.prod(dim=-1, keepdim=True)
    min1 = mag.amin(dim=-1, keepdim=True)
    first = torch.arange(mag.shape[-1], device=mag.device) == mag.argmin(dim=-1, keepdim=True)
    min2 = torch.where(first, torch.full_like(mag, big), mag).amin(dim=-1, keepdim=True)
    ext = torch.where(first, min2, min1)
    return torch.where(valid, alpha * row_sign * sgn * ext, torch.zeros_like(ext))


def _min_sum(llrs, tables, n: int, checks: int, alpha: float):
    """``checks`` check updates from ``v2c = llr`` on the edges of a code
    of length ``n`` given by its ``(rows, valid, cols)`` tables (numpy),
    each followed by the variable update but the last: ``(hard [..., n]
    uint8, syndrome ok [...])``."""
    lam = torch.as_tensor(llrs).to(torch.float32)
    if lam.shape[-1] != n:
        raise ValueError(f"LLR length {lam.shape[-1]} != code length {n}")
    rows, valid, cols = (torch.from_numpy(t).to(lam.device) for t in tables)
    cols = cols.T.contiguous()  # [dv, n]: an edge slot's messages lie together
    lead = tuple(lam.shape[:-1])
    lam = lam.reshape(-1, n)
    b_sz = lam.shape[0]
    lam_pad = torch.nn.functional.pad(lam, (0, 1))  # column n: the padding's
    v2c = lam_pad[:, rows]  # [B, m, d]

    def col_sums(c2v):
        """Each variable's messages [B, n], added one edge at a time in
        ascending check order: the reference's order (a reduction kernel
        would group the terms its own way, and the float32 sums of a
        variable of many edges, or beside a +1e9 filler, round apart)."""
        edges = torch.nn.functional.pad(c2v.reshape(b_sz, -1), (0, 1))[:, cols]  # [B, dv, n]
        acc = edges[:, 0]
        for e in range(1, edges.shape[1]):
            acc = acc + edges[:, e]
        return acc

    c2v = _check_update(v2c, valid, alpha)
    for _ in range(checks - 1):
        total = torch.nn.functional.pad(lam + col_sums(c2v), (0, 1))
        v2c = total[:, rows] - c2v
        c2v = _check_update(v2c, valid, alpha)
    hard = ((lam + col_sums(c2v)) < 0).to(torch.uint8)
    hits = torch.nn.functional.pad(hard, (0, 1))[:, rows].sum(dim=-1)
    ok = (hits % 2 == 0).all(dim=-1)
    return hard.reshape(lead + (n,)), ok.reshape(lead)


def ldpc_decode(llrs, h, iters: int = 25,
                alpha: float = 0.75) -> Tuple[torch.Tensor, torch.Tensor]:
    """Normalized min-sum decode of ``llrs [..., n]`` (positive = bit 0) on
    ``h [m, n]`` (numpy 0/1): ``iters`` iterations and a final check
    update, as the reference's dense decoder. Returns ``(hard [..., n]
    uint8, syndrome_ok [...])``."""
    h = np.asarray(h, np.uint8) % 2
    tables = _edges(h.shape, np.packbits(h).tobytes())
    return _min_sum(llrs, tables, h.shape[1], int(iters) + 1, float(alpha))


def qc_ldpc_decode(llrs, base, z: int, iters: int = 25,
                   alpha: float = 0.75) -> Tuple[torch.Tensor, torch.Tensor]:
    """Normalized min-sum decode of a QC code given by its base matrix of
    shifts ``base [mb, nb]`` and lifting ``z``: ``llrs [..., nb z]``,
    ``iters`` check updates, as the reference's edge-message decoder.
    Returns ``(hard [..., nb z] uint8, syndrome_ok [...])``. The graph's
    tables come from the base matrix (:func:`_qc_edges`), never from the
    dense ``[mb z, nb z]`` matrix."""
    base = np.asarray(base, np.int64)
    tables = _qc_edges(tuple(map(tuple, base.tolist())), int(z))
    return _min_sum(llrs, tables, base.shape[1] * int(z), int(iters), float(alpha))


def ldpc_encode(bits, g) -> torch.Tensor:
    """Encode ``[..., k]`` message bits to ``[..., n]`` codewords (uint8):
    one float32 matmul mod 2."""
    u = torch.as_tensor(bits).to(torch.float32) % 2
    gm = torch.from_numpy(np.asarray(g, np.float32)).to(u.device)
    return torch.remainder(u @ gm, 2.0).to(torch.uint8)


def extract_info(codeword_bits, info_indices) -> torch.Tensor:
    """The ``k`` message bits of decoded codewords ``[..., n]``."""
    x = torch.as_tensor(codeword_bits)
    idx = torch.from_numpy(np.asarray(info_indices, np.int64)).to(x.device)
    return x.index_select(-1, idx)
