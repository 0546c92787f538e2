"""Polar codes: construction, encoding, SC, flooding BP and CA-SCL
decoding (PyTorch).

Counterpart of ``aether_primitives_tpu/ops/polar.py``, with the same
indexing convention (natural order, no bit reversal: encoder, construction
and decoders share it) and the same results:

- :func:`polar_construct`: Bhattacharyya density evolution in host float64
  numpy, a verbatim copy;
- :func:`polar_encode`: ``log2(N)`` butterfly XOR stages on the ``[...,
  N]`` plane;
- :func:`polar_decode`: min-sum successive cancellation, the decode tree
  unrolled in Python (``2N - 1`` nodes, each batched over codewords);
- :func:`polar_decode_bp`: flooding belief propagation, ``iters`` full
  right-to-left and left-to-right sweeps;
- :func:`polar_decode_list`: node-classified fast SCL (Rate-0, REP,
  Rate-1 and SPC subtrees in closed form), and :func:`_decode_list_leafwise`,
  the leaf-by-leaf SCL it is held to path for path;
- :class:`PolarCode`: construction and codec, CA-SCL with an inner CRC.

The list decoders keep their paths on a list axis and move them with
gathers of parent indices (exact on every device). Where the reference
prunes with ``top_k`` (ties to the lower index) and picks the ``kk``
least reliable positions by iterative minima (ties to the lower
position), the port takes the first entries of a stable ascending sort,
which orders ties the same way. Path metrics start at 1e30 for the paths
not yet alive (``inf`` would give ``inf - inf`` in a penalty) and are
float32 sums, so they can differ from the reference's in the last place.

LLR convention: positive = bit 0.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

from . import fec as _fec

__all__ = ["polar_construct", "polar_encode", "polar_decode", "polar_decode_bp",
           "polar_decode_list", "PolarCode"]

_DEAD = 1e30  # the path metric of a path not yet alive


def polar_construct(n: int, k: int, design_snr_db: float = 0.0) -> np.ndarray:
    """Information set of the (N=n, K=k) polar code by Bhattacharyya
    density evolution at ``design_snr_db`` (Es/N0 of the BPSK design
    channel). Returns a ``[n]`` bool mask, True = information position.

    Evolution: z₀ = exp(−Es/N0); each Arikan doubling maps
    ``z → 2z−z²`` (the degraded / ``f`` branch) and ``z → z²`` (the
    upgraded / ``g`` branch). The K smallest final parameters carry
    information; the rest are frozen to 0.
    """
    if n < 2 or (n & (n - 1)) != 0:
        raise ValueError(f"polar N must be a power of two >= 2, got {n}")
    if not 0 < k <= n:
        raise ValueError(f"need 0 < K <= N, got K={k}, N={n}")
    z = np.array([np.exp(-(10.0 ** (design_snr_db / 10.0)))], dtype=np.float64)
    while z.shape[0] < n:
        upper = 2.0 * z - z * z
        lower = z * z
        z = np.stack([upper, lower], axis=1).reshape(-1)
    info = np.zeros(n, dtype=bool)
    info[np.argsort(z, kind="stable")[:k]] = True
    return info


def _check_mask(info_mask) -> np.ndarray:
    mask = np.asarray(info_mask, dtype=bool)
    n = mask.shape[0]
    if n < 2 or (n & (n - 1)) != 0:
        raise ValueError(f"polar N must be a power of two >= 2, got {n}")
    return mask


def _butterfly(x: torch.Tensor, xor) -> torch.Tensor:
    """The Arikan transform over the last axis, smallest blocks first:
    stage ``s`` replaces the left half of each ``2^{s+1}``-wide block by
    ``xor(left, right)``. Self-inverse."""
    m = x.shape[-1]
    lead = tuple(x.shape[:-1])
    step = 1
    while step < m:
        blk = x.reshape(lead + (m // (2 * step), 2, step))
        left = xor(blk[..., 0, :], blk[..., 1, :])
        x = torch.stack([left, blk[..., 1, :]], dim=-2).reshape(lead + (m,))
        step *= 2
    return x


def _fxor(a, b):
    # GF(2) XOR on exact {0, 1} float32 planes
    return a + b - 2.0 * a * b


def polar_encode(bits, info_mask) -> torch.Tensor:
    """Encode ``[..., K]`` information bits into ``[..., N]`` codewords
    (uint8): the bits go to the information positions of u (frozen
    positions 0), then ``log2(N)`` butterfly XOR stages."""
    mask = _check_mask(info_mask)
    n = mask.shape[0]
    k = int(mask.sum())
    b = torch.as_tensor(bits).to(torch.uint8)
    if b.shape[-1] != k:
        raise ValueError(f"expected {k} information bits, got {b.shape[-1]}")
    u = b.new_zeros(tuple(b.shape[:-1]) + (n,))
    u[..., torch.from_numpy(np.nonzero(mask)[0]).to(b.device)] = b
    return _butterfly(u, torch.bitwise_xor)


def _f_minsum(a, b):
    # min-sum check-node update; the sign as (1 - 2 (x < 0)), so an LLR of
    # 0 keeps magnitude 0 (torch.sign(0) would zero the product)
    sgn = (1 - 2 * (a < 0).to(a.dtype)) * (1 - 2 * (b < 0).to(b.dtype))
    return sgn * torch.minimum(a.abs(), b.abs())


def _llr_rows(llrs, n: int) -> torch.Tensor:
    llr = torch.as_tensor(llrs).to(torch.float32)
    if llr.shape[-1] != n:
        raise ValueError(f"expected {n} LLRs, got {llr.shape[-1]}")
    return llr


def polar_decode(llrs, info_mask) -> torch.Tensor:
    """Successive-cancellation decode of ``[..., N]`` channel LLRs
    (positive = bit 0) to ``[..., K]`` hard information bits (uint8).

    Each internal node computes the min-sum ``f`` LLR for its left child,
    recurses, forms the ``g`` LLR ``b + (1 - 2 x_left) a`` from the left
    child's re-encoded partial sums, recurses right, and returns the
    XOR-combined partial sums. Frozen leaves contribute u = 0."""
    mask = _check_mask(info_mask)
    n = mask.shape[0]
    llr = _llr_rows(llrs, n)
    lead = tuple(llr.shape[:-1])
    out_bits: List[torch.Tensor] = []

    def rec(v, m):
        half = m.shape[0] // 2
        if m.shape[0] == 1:
            if not m[0]:
                return torch.zeros_like(v, dtype=torch.uint8)
            u = (v < 0).to(torch.uint8)
            out_bits.append(u)
            return u
        a, b = v[:, :half], v[:, half:]
        x_left = rec(_f_minsum(a, b), m[:half])
        g = b + (1.0 - 2.0 * x_left.to(torch.float32)) * a
        x_right = rec(g, m[half:])
        return torch.cat([x_left ^ x_right, x_right], dim=-1)

    rec(llr.reshape(-1, n), mask)
    bits = torch.cat(out_bits, dim=-1)
    return bits.reshape(lead + (int(mask.sum()),))


# ---------------------------------------------------------------------------
# Belief-propagation (flooding) decoding
# ---------------------------------------------------------------------------


def polar_decode_bp(llrs, info_mask, iters: int = 40) -> Tuple[torch.Tensor, torch.Tensor]:
    """Belief-propagation decode of ``[..., N]`` channel LLRs over the
    polar factor graph: ``(info_bits [..., K] uint8, ok [...])``.

    Column 0 is the u side, column ``log2 N`` the x side; stage ``s``
    pairs offsets ``(j, j + 2^s)`` within ``2^{s+1}``-wide blocks, each
    butterfly ``x1 = u1 ^ u2, x2 = u2`` with the min-sum updates

    - ``L(u1) = f(L(x1), L(x2) + R(u2))``, ``L(u2) = f(L(x1), R(u1)) + L(x2)``
    - ``R(x1) = f(R(u1), R(u2) + L(x2))``, ``R(x2) = f(R(u1), L(x1)) + R(u2)``

    Frozen positions enter as R = 1e9 at column 0. An iteration is a full
    right-to-left L sweep, then a left-to-right R sweep; ``iters`` of them.
    ``ok``: the u-side decision re-encoded equals the x-side decision.
    """
    mask = _check_mask(info_mask)
    n = mask.shape[0]
    stages = int(np.log2(n))
    llr = _llr_rows(llrs, n)
    lead = tuple(llr.shape[:-1])
    flat = llr.reshape(-1, n)
    batch = flat.shape[0]
    r0 = torch.from_numpy(np.where(mask, 0.0, 1e9).astype(np.float32)).to(flat.device)

    def pairs(v, s):
        """[batch, n] -> the (a, b) halves of the stage-s butterflies."""
        blk = v.reshape(batch, n // (2 << s), 2, 1 << s)
        return blk[:, :, 0, :], blk[:, :, 1, :]

    def unpairs(a, b):
        return torch.stack([a, b], dim=2).reshape(batch, n)

    zeros = flat.new_zeros((batch, n))
    l_cols = [flat if s == stages else zeros for s in range(stages + 1)]
    r_cols = [r0.expand(batch, n) if s == 0 else zeros for s in range(stages + 1)]
    for _ in range(int(iters)):
        for s in range(stages - 1, -1, -1):  # right to left: L at column s
            lx1, lx2 = pairs(l_cols[s + 1], s)
            ru1, ru2 = pairs(r_cols[s], s)
            l_cols[s] = unpairs(_f_minsum(lx1, lx2 + ru2), _f_minsum(lx1, ru1) + lx2)
        for s in range(stages):  # left to right: R at column s + 1
            lx1, lx2 = pairs(l_cols[s + 1], s)
            ru1, ru2 = pairs(r_cols[s], s)
            r_cols[s + 1] = unpairs(_f_minsum(ru1, ru2 + lx2), _f_minsum(ru1, lx1) + ru2)

    u_hard = ((l_cols[0] + r_cols[0]) < 0).to(torch.uint8)
    x_hard = ((l_cols[stages] + r_cols[stages]) < 0).to(torch.uint8)
    bits = u_hard[:, torch.from_numpy(np.nonzero(mask)[0]).to(flat.device)]
    ok = (polar_encode(bits, mask) == x_hard).all(dim=-1)
    return bits.reshape(lead + (int(mask.sum()),)), ok.reshape(lead)


# ---------------------------------------------------------------------------
# CRC-aided successive-cancellation list decoding (CA-SCL)
# ---------------------------------------------------------------------------


def _pick(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``t[b, idx[b, l], ...]``: rows of ``t`` (list axis 1) by index."""
    if t.ndim == 2:
        return t.gather(1, idx)
    return t.gather(1, idx.reshape(idx.shape + (1,) * (t.ndim - 2)).expand(
        idx.shape + tuple(t.shape[2:])))


def _prune(pm2: torch.Tensor, L: int):
    """The ``L`` least of ``[batch, 2L]`` candidate metrics, ties to the
    lower index (``top_k(-pm2, L)``'s order): ``(metrics, indices)``."""
    vals, sel = torch.sort(pm2, dim=1, stable=True)
    return vals[:, :L], sel[:, :L]


def _start_metrics(batch: int, L: int, device) -> torch.Tensor:
    pm = torch.full((batch, L), _DEAD, dtype=torch.float32, device=device)
    pm[:, 0] = 0.0  # only path 0 is alive at first
    return pm


def _decode_list_leafwise(llrs, info_mask, list_size: int = 8):
    """Leaf-wise SCL, the reference :func:`polar_decode_list` is held to.

    ``L`` paths; at every information leaf each path forks into both bit
    decisions, the one disagreeing with the LLR's sign paying ``|llr|``
    (frozen leaves charge a negative LLR the same), and the best ``L`` of
    ``2L`` survive. Tensors of enclosing frames are brought to the
    current paths lazily through the composed parent indices; the bit
    sequences are rebuilt by one backward pass over the (parent, bit)
    trail. Returns ``(bits [..., L, K] uint8, metrics [..., L])``, paths
    best first."""
    mask = _check_mask(info_mask)
    n = mask.shape[0]
    L = int(list_size)
    llr = _llr_rows(llrs, n)
    lead = tuple(llr.shape[:-1])
    flat = llr.reshape(-1, n)
    batch = flat.shape[0]
    pm = _start_metrics(batch, L, flat.device)
    trail: List[Tuple[torch.Tensor, torch.Tensor]] = []  # (parents, bits) a leaf

    def align(t, made_at):
        ps = [p for p, _ in trail[made_at:]]
        if not ps:
            return t
        comp = ps[0]
        for p in ps[1:]:
            comp = comp.gather(1, p)
        return _pick(t, comp)

    def leaf(v, frozen):
        nonlocal pm
        lv = v[..., 0]
        pen = lv.abs()
        if frozen:
            pm = pm + torch.where(lv < 0, pen, torch.zeros_like(pen))
            return torch.zeros((batch, L, 1), dtype=torch.uint8, device=v.device)
        pm, sel = _prune(torch.cat([pm, pm + pen], dim=1), L)
        parents = sel % L
        nat = (lv < 0).to(torch.uint8)  # the sign-agreeing bit per old path
        bit = nat.gather(1, parents) ^ (sel >= L).to(torch.uint8)
        trail.append((parents, bit))
        return bit[..., None]

    def rec(v, m, made_at):
        half = m.shape[0] // 2
        if m.shape[0] == 1:
            return leaf(align(v, made_at), not bool(m[0]))
        a, b = v[..., :half], v[..., half:]
        x_left = rec(_f_minsum(a, b), m[:half], made_at)
        epoch = len(trail)
        a2, b2 = align(a, made_at), align(b, made_at)
        g = b2 + (1.0 - 2.0 * x_left.to(torch.float32)) * a2
        x_right = rec(g, m[half:], epoch)
        x_left = align(x_left, epoch)
        return torch.cat([x_left ^ x_right, x_right], dim=-1)

    rec(flat[:, None, :].expand(batch, L, n), mask, 0)
    k = int(mask.sum())
    idx = torch.arange(L, device=flat.device).expand(batch, L)
    cols = []
    for parents, bit in reversed(trail):
        cols.append(bit.gather(1, idx))
        idx = parents.gather(1, idx)
    bits = torch.stack(cols[::-1], dim=-1)  # [batch, L, K]
    pm, order = torch.sort(pm, dim=1, stable=True)
    bits = _pick(bits, order)
    return bits.reshape(lead + (L, k)), pm.reshape(lead + (L,))


def polar_decode_list(llrs, info_mask, list_size: int = 8):
    """Successive-cancellation *list* decode: ``[..., N]`` LLRs ->
    ``(bits [..., L, K] uint8, metrics [..., L])``, paths best first.

    Node-classified fast SCL: special subtrees resolve at their root, each
    exactly the leaf-wise SCL under the min-sum path metric:

    - **Rate-0** (all frozen): ``pm += Σ relu(−llr)``, x = 0. No fork.
    - **REP** (one info bit, the last): the all-zeros and all-ones
      codewords scored by their summed disagreeing magnitudes, one fork.
    - **Rate-1** (all info): per-path hard decisions, then ``min(L−1, m)``
      forks on the least reliable positions, each flipping one position
      with penalty ``|llr|``.
    - **SPC** (first bit frozen, the rest info): parity repaired at the
      least reliable position (``pm += γ·|llr₀|``), then ``min(L, m−1)``
      forks each flipping a sorted position and toggling the repair
      (penalty ``|llrᵢ| + (1−2s)·|llr₀|``, ``s`` the path's repair state).

    Each node's forks compose into one parent index per path; a node's
    decision bits are ``u = butterfly(x)``, and the sequences are rebuilt
    by one backward pass over the trail. Pair with an outer CRC and take
    the first path whose CRC checks (:meth:`PolarCode.decode`).
    """
    mask = _check_mask(info_mask)
    n = mask.shape[0]
    L = int(list_size)
    llr = _llr_rows(llrs, n)
    lead = tuple(llr.shape[:-1])
    flat = llr.reshape(-1, n)
    batch = flat.shape[0]
    dev = flat.device
    state = {"pm": _start_metrics(batch, L, dev)}
    # one entry per info-carrying node: (parents [batch, L] from the node's
    # paths back to the ones it started with, u bits [batch, L, nb] as exact
    # {0, 1} float32)
    trail: List[Tuple[torch.Tensor, torch.Tensor]] = []
    ident = torch.arange(L, device=dev).expand(batch, L)

    def align(t, made_at):
        ps = [p for p, _ in trail[made_at:]]
        if not ps:
            return t
        comp = ps[0]
        for p in ps[1:]:
            comp = comp.gather(1, p)
        return _pick(t, comp)

    def fork(pen_alt, base_add=None):
        """Prune 2L -> L: each path kept (plus ``base_add``) or taking the
        alternative (plus ``pen_alt``): ``(parents, took_alt float32)``."""
        pm = state["pm"]
        keep = pm if base_add is None else pm + base_add
        state["pm"], sel = _prune(torch.cat([keep, pm + pen_alt], dim=1), L)
        return sel % L, (sel >= L).to(torch.float32)

    def node_rate0(v):
        state["pm"] = state["pm"] + torch.clamp_min(-v, 0.0).sum(dim=-1)
        return torch.zeros_like(v)

    def node_rep(v):
        pen0 = torch.clamp_min(-v, 0.0).sum(dim=-1)  # all-zeros codeword
        pen1 = torch.clamp_min(v, 0.0).sum(dim=-1)  # all-ones codeword
        p, took = fork(pen1, base_add=pen0)
        trail.append((p, took[..., None]))
        return took[..., None].expand(took.shape + (v.shape[-1],))

    def smallest(mag, kk):
        """The ``kk`` least entries of ``mag`` on the last axis, ties to the
        lower position: ``(values [..., kk], positions [..., kk])``."""
        vals, pos = torch.sort(mag, dim=-1, stable=True)
        return vals[..., :kk], pos[..., :kk]

    def flips_at(comp, tooks, ps, pos, m):
        """The node's flip plane in its final paths: fork ``i``'s took flag
        (brought through the later forks' parents) at its position."""
        suffix = ident
        flips = [None] * len(ps)
        for i in range(len(ps) - 1, -1, -1):
            flips[i] = tooks[i].gather(1, suffix)
            suffix = ps[i].gather(1, suffix)
        onehot = (_pick(pos, comp)[..., None] == torch.arange(m, device=dev)).to(torch.float32)
        return (torch.stack(flips, dim=-1)[..., None] * onehot).sum(dim=-2)

    def node_rate1(v):
        m = v.shape[-1]
        t = min(L - 1, m)
        h = (v < 0).to(torch.float32)
        comp = ident
        x = h
        if t:
            vals, pos = smallest(v.abs(), t)
            ps, tooks = [], []
            for i in range(t):
                p, took = fork(vals[..., i].gather(1, comp))
                comp = comp.gather(1, p)
                ps.append(p)
                tooks.append(took)
            x = _fxor(_pick(h, comp), flips_at(comp, tooks, ps, pos, m))
        trail.append((comp, _butterfly(x, _fxor)))
        return x

    def node_spc(v):
        m = v.shape[-1]
        t = min(L, m - 1)  # >= 1: an SPC node has m >= 4
        h = (v < 0).to(torch.float32)
        vals, pos = smallest(v.abs(), t + 1)
        gamma = torch.remainder(h.sum(dim=-1), 2.0)  # parity violated?
        v0 = vals[..., 0]
        state["pm"] = state["pm"] + gamma * v0
        s = gamma  # per-path repair state: is the least reliable bit flipped?
        comp = ident
        ps, tooks = [], []
        for i in range(1, t + 1):
            vi = vals[..., i].gather(1, comp)
            v0g = v0.gather(1, comp)
            p, took = fork(vi + (1.0 - 2.0 * s) * v0g)
            s = _fxor(s.gather(1, p), took)
            comp = comp.gather(1, p)
            ps.append(p)
            tooks.append(took)
        repair = s[..., None] * (_pick(pos[..., :1], comp) == torch.arange(m, device=dev))
        x = _fxor(_pick(h, comp), repair + flips_at(comp, tooks, ps, pos[..., 1:], m))
        trail.append((comp, _butterfly(x, _fxor)[..., 1:]))
        return x

    def rec(v, m, made_at):
        if not m.any():
            return node_rate0(align(v, made_at))
        if m.all():
            return node_rate1(align(v, made_at))
        if not m[:-1].any():  # only the last bit carries info
            return node_rep(align(v, made_at))
        if not m[0] and m[1:].all():
            return node_spc(align(v, made_at))
        half = m.shape[0] // 2
        a, b = v[..., :half], v[..., half:]
        x_left = rec(_f_minsum(a, b), m[:half], made_at)
        epoch = len(trail)
        a2, b2 = align(a, made_at), align(b, made_at)
        g = b2 + (1.0 - 2.0 * x_left) * a2
        x_right = rec(g, m[half:], epoch)
        x_left = align(x_left, epoch)
        return torch.cat([_fxor(x_left, x_right), x_right], dim=-1)

    rec(flat[:, None, :].expand(batch, L, n), mask, 0)
    k = int(mask.sum())
    sel = ident
    cols = []
    for p_e, bits_e in reversed(trail):
        cols.append(_pick(bits_e, sel))
        sel = p_e.gather(1, sel)
    bits_f = torch.cat(cols[::-1], dim=-1)  # [batch, L, K]
    pm, order = torch.sort(state["pm"], dim=1, stable=True)
    bits = (_pick(bits_f, order) > 0.5).to(torch.uint8)
    return bits.reshape(lead + (L, k)), pm.reshape(lead + (L,))


@dataclass(frozen=True)
class PolarCode:
    """A concrete (N, K) polar code: construction + codec in one object.

    ``crc``: optional CRC kind of :data:`.fec.CRC_PARAMS` (e.g.
    ``"crc8"``). When set, :meth:`encode` appends the CRC inside the K
    information bits (payload ``K − crc_width``) and :meth:`decode` runs
    CA-SCL, returning the best CRC-passing path (the best metric when none
    passes) and a per-codeword ``ok`` flag.
    """

    n: int
    k: int
    design_snr_db: float = 0.0
    crc: str = ""
    list_size: int = 8

    def __post_init__(self):
        object.__setattr__(
            self, "info_mask", polar_construct(self.n, self.k, self.design_snr_db)
        )

    @property
    def payload_bits(self) -> int:
        if not self.crc:
            return self.k
        return self.k - _fec.CRC_PARAMS[self.crc][1]

    def encode(self, bits) -> torch.Tensor:
        if self.crc:
            bits = _fec.crc_append(bits, self.crc)
        return polar_encode(bits, self.info_mask)

    def decode(self, llrs):
        """-> ``(payload bits [..., payload_bits], ok [...] bool)``.

        Plain SC when ``crc`` is unset (ok all True); CA-SCL when set: the
        best-metric CRC-passing path (path 0 when none passes), and ``ok``
        says whether any passed."""
        if not self.crc:
            bits = polar_decode(llrs, self.info_mask)
            return bits, torch.ones(bits.shape[:-1], dtype=torch.bool, device=bits.device)
        cand, _pm = polar_decode_list(llrs, self.info_mask, self.list_size)  # [..., L, K]
        ok = _fec.crc_check(cand, self.crc)  # [..., L]
        any_ok = ok.any(dim=-1)
        # the first (best-metric) CRC-passing path, else path 0
        pick = torch.where(any_ok, ok.to(torch.uint8).argmax(dim=-1),
                           torch.zeros_like(any_ok, dtype=torch.int64))
        idx = pick[..., None, None].expand(tuple(pick.shape) + (1, self.k))
        bits = cand.gather(-2, idx)[..., 0, :]
        return bits[..., : self.payload_bits], any_ok

    def decode_bp(self, llrs, iters: int = 40):
        """Belief-propagation decode (:func:`polar_decode_bp`); when ``crc``
        is set, ``ok`` also requires the inner CRC to pass."""
        bits, ok = polar_decode_bp(llrs, self.info_mask, iters)
        if self.crc:
            ok = ok & _fec.crc_check(bits, self.crc)
        return bits[..., : self.payload_bits], ok
