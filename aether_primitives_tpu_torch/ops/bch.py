"""Binary BCH codes (PyTorch).

Counterpart of ``aether_primitives_tpu/ops/bch.py``: narrow-sense binary
BCH over GF(2^m), the same generator, the same decoders and the same
outputs, bit for bit. Bit order: index 0 = highest-degree coefficient =
transmitted first, systematic ``[message | parity]``.

- :class:`BCH` with :meth:`~BCH.encode` (one float32 matmul mod 2),
  :meth:`~BCH.decode` (hard bits: for ``t <= 2`` the reference's closed
  form, the locators matched against the positions and the quadratic
  solved by the half-trace map; beyond it inversionless Berlekamp-Massey
  over ``2t`` iterations and a Chien search) and :meth:`~BCH.decode_soft`
  (Chase-2 over the ``p`` least reliable positions), all batched over
  leading axes.
- :func:`bch_15_7`, :func:`bch_63_45`, :func:`bch_255_t`.

Maps by a constant (syndromes, the Chien search, squaring, the trace and
half-trace maps, the position match) are float32 matmuls mod 2 of bit
planes against the reference's host matrices; products and inverses of
two variables are log/antilog lookups (:mod:`._gf`), where the reference
uses a bilinear einsum and Fermat's theorem. The ``p`` least reliable
positions are the first ``p`` of a stable ascending sort of the
reliabilities, the order ``jax.lax.top_k`` gives (the lower index first
among equal values; ``torch.topk`` promises no order).

The host builders (``_field_tables`` to ``_gf2_left_inverse`` and the
matrices of ``__init__``) are copies of the JAX package's numpy code.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ._gf import Field, bits_of, symbols_of, windows

__all__ = ["BCH", "PRIMITIVE_POLYS", "bch_15_7", "bch_63_45", "bch_255_t"]


PRIMITIVE_POLYS: Dict[int, int] = {
    2: 0x7, 3: 0xB, 4: 0x13, 5: 0x25, 6: 0x43, 7: 0x89, 8: 0x11D, 9: 0x211,
    10: 0x409, 11: 0x805, 12: 0x1053,
}


# ---------------------------------------------------------------- host field math


def _field_tables(m: int, poly: int) -> Tuple[np.ndarray, np.ndarray]:
    """exp/log tables for GF(2^m); raises if ``poly`` is not primitive."""
    q = (1 << m) - 1
    exp = np.zeros(2 * q, np.int64)
    log = np.full(1 << m, -1, np.int64)
    v = 1
    for i in range(q):
        if log[v] >= 0:
            raise ValueError(
                f"0x{poly:X} is not primitive over GF(2^{m}): "
                f"alpha^{i} repeats alpha^{log[v]}"
            )
        exp[i] = v
        log[v] = i
        v <<= 1
        if v >> m:
            v ^= poly
    if v != 1:
        raise ValueError(f"0x{poly:X} does not generate GF(2^{m})")
    exp[q:] = exp[:q]
    return exp, log


def _mul_matrix(c: int, m: int, poly: int) -> np.ndarray:
    """m x m GF(2) matrix of multiplication by the constant ``c``."""
    out = np.zeros((m, m), np.uint8)
    for i in range(m):
        v = c
        for _ in range(i):
            v <<= 1
            if v >> m:
                v ^= poly
        for j in range(m):
            out[j, i] = (v >> j) & 1
    return out


def _cyclotomic_coset(i: int, q: int) -> Tuple[int, ...]:
    out, s = [], i % q
    while s not in out:
        out.append(s)
        s = (2 * s) % q
    return tuple(sorted(out))


def _minimal_poly(coset, exp, log, m, poly) -> int:
    """Minimal polynomial of alpha^i over GF(2) as an int bitmask."""
    q = (1 << m) - 1
    coeffs = [1]
    for s in coset:
        root = int(exp[s % q])
        new = [0] * (len(coeffs) + 1)
        for d, c in enumerate(coeffs):
            new[d + 1] ^= c
            if c and root:
                new[d] ^= int(exp[(log[c] + log[root]) % q])
        coeffs = new
    mask = 0
    for d, c in enumerate(coeffs):
        if c not in (0, 1):
            raise AssertionError(
                f"minimal polynomial coefficient {c} not in GF(2) — field table bug"
            )
        mask |= c << d
    return mask


def _gf2_poly_mul(a: int, b: int) -> int:
    out = 0
    while b:
        if b & 1:
            out ^= a
        a <<= 1
        b >>= 1
    return out


def _gf2_poly_mod(a: int, b: int) -> int:
    db = b.bit_length() - 1
    while a.bit_length() - 1 >= db and a:
        a ^= b << (a.bit_length() - 1 - db)
    return a


def _gf2_rank(a: np.ndarray) -> int:
    a = a.copy() % 2
    rank = 0
    rows, cols = a.shape
    for c in range(cols):
        piv = None
        for r in range(rank, rows):
            if a[r, c]:
                piv = r
                break
        if piv is None:
            continue
        a[[rank, piv]] = a[[piv, rank]]
        for r in range(rows):
            if r != rank and a[r, c]:
                a[r] = (a[r] + a[rank]) % 2
        rank += 1
    return rank


def _gf2_left_inverse(c: np.ndarray) -> np.ndarray:
    """For full-column-rank ``c [m, r]`` over GF(2), ``P [r, m]`` with
    ``P c = I_r``."""
    m, r = c.shape
    aug = np.concatenate([c.copy() % 2, np.eye(m, dtype=np.int64)], axis=1)
    row = 0
    for col in range(r):
        piv = None
        for rr in range(row, m):
            if aug[rr, col]:
                piv = rr
                break
        if piv is None:
            raise AssertionError("column-rank deficiency in GF(2) inverse")
        aug[[row, piv]] = aug[[piv, row]]
        for rr in range(m):
            if rr != row and aug[rr, col]:
                aug[rr] = (aug[rr] + aug[row]) % 2
        row += 1
    assert np.array_equal(aug[:r, :r] % 2, np.eye(r, dtype=np.int64))
    return aug[:r, c.shape[1]:] % 2


def _mod2(x: torch.Tensor) -> torch.Tensor:
    return torch.remainder(x, 2.0)


class BCH:
    """Narrow-sense binary BCH over GF(2^m): ``t`` correctable bit errors.

    ``n``: code length in bits (``m`` inferred as the smallest field degree
    with ``2^m - 1 >= n``; shorter ``n`` is the shortened code); ``t``: the
    designed capability (``k = n - deg g``); ``m``, ``primitive_poly``
    override the field (checked for primitivity).
    """

    def __init__(self, n: int, t: int, m: int | None = None,
                 primitive_poly: int | None = None):
        n, t = int(n), int(t)
        if m is None:
            m = max(2, n.bit_length())
        if not (3 <= n <= (1 << m) - 1):
            raise ValueError(f"need 3 <= n <= 2^{m}-1 = {(1 << m) - 1}, got n={n}")
        if primitive_poly is None:
            if m not in PRIMITIVE_POLYS:
                raise ValueError(
                    f"no built-in primitive polynomial for GF(2^{m}) "
                    f"(n={n} needs m={m}; built-ins cover m in "
                    f"{sorted(PRIMITIVE_POLYS)}) — pass primitive_poly="
                )
            poly = PRIMITIVE_POLYS[m]
        else:
            poly = int(primitive_poly)
        exp, log = _field_tables(m, poly)
        q = (1 << m) - 1
        self.n, self.t, self.m = n, t, m
        self.primitive_poly = poly
        self._exp, self._log = exp, log

        seen, g = set(), 1
        for i in range(1, 2 * t + 1):
            coset = _cyclotomic_coset(i, q)
            if coset in seen:
                continue
            seen.add(coset)
            g = _gf2_poly_mul(g, _minimal_poly(coset, exp, log, m, poly))
        self.generator = g
        nsym = g.bit_length() - 1
        if nsym >= n:
            raise ValueError(
                f"t={t} needs {nsym} parity bits but n={n}; no message room"
            )
        self.nsym = nsym
        self.k = n - nsym

        # encoder: parity = msg_bits @ A (mod 2)
        a = np.zeros((self.k, nsym), np.float32)
        r = _gf2_poly_mod(1 << nsym, g)
        for deg in range(nsym, n):
            j = n - 1 - deg
            a[j] = [(r >> (nsym - 1 - s)) & 1 for s in range(nsym)]
            r = _gf2_poly_mod(r << 1, g)
        self._enc = a

        # syndromes: S_i = sum_j r_j alpha^{i (n-1-j)}, i = 1..2t
        b = np.zeros((n, 2 * t * m), np.float32)
        for j in range(n):
            d = n - 1 - j
            for i in range(1, 2 * t + 1):
                v = int(exp[(i * d) % q])
                b[j, (i - 1) * m: i * m] = [(v >> bit) & 1 for bit in range(m)]
        self._synd = b

        # Chien evaluation matrix
        el = np.zeros(((t + 1) * m, n * m), np.uint8)
        for j in range(n):
            inv = (-(n - 1 - j)) % q
            for l in range(t + 1):
                c = int(exp[(inv * l) % q])
                el[l * m: (l + 1) * m, j * m: (j + 1) * m] = _mul_matrix(c, m, poly).T
        self._ev_lam = el.astype(np.float32)

        # closed-form tables (t <= 2): position match, squaring, trace and
        # the half-trace solver of y^2 + y = c
        if t <= 2:
            pos = np.zeros((n, m), np.float32)
            for j in range(n):
                v = int(exp[(n - 1 - j) % q])
                pos[j] = [(v >> bit) & 1 for bit in range(m)]
            self._loc_w = (1.0 - 2.0 * pos.T).astype(np.float32)
            self._loc_b = pos.sum(axis=1).astype(np.float32)
            sq = np.zeros((m, m), np.uint8)
            for i2 in range(m):
                v = int(exp[(2 * i2) % q])
                sq[:, i2] = [(v >> bit) & 1 for bit in range(m)]
            self._sqm = sq.astype(np.float32)
            if t == 2:
                tmat = np.zeros((m, m), np.int64)
                p2 = np.eye(m, dtype=np.int64)
                for _ in range(m):
                    tmat = (tmat + p2) % 2
                    p2 = (sq.astype(np.int64) @ p2) % 2
                self._trv = tmat[0].astype(np.float32)
                lmap = (sq.astype(np.int64) + np.eye(m, dtype=np.int64)) % 2
                cols, pre = [], []
                rank_rows = np.zeros((0, m), np.int64)
                for b2 in range(m):
                    cand = np.vstack([rank_rows, lmap[:, b2][None]])
                    if _gf2_rank(cand) > rank_rows.shape[0]:
                        rank_rows = cand
                        cols.append(lmap[:, b2])
                        pre.append(np.eye(m, dtype=np.int64)[b2])
                cmat = np.stack(cols, axis=1)
                ymat = np.stack(pre, axis=1)
                pmat = _gf2_left_inverse(cmat)
                self._ht = ((ymat @ pmat) % 2).astype(np.float32)
        self._dev = {}

    def _on(self, device) -> dict:
        """The device constants, made once per device."""
        device = torch.device(device)
        c = self._dev.get(device)
        if c is None:
            names = ("_enc", "_synd", "_ev_lam", "_loc_w", "_loc_b", "_sqm", "_trv", "_ht")
            c = {name: torch.from_numpy(np.ascontiguousarray(getattr(self, name))).to(device)
                 for name in names if hasattr(self, name)}
            c["field"] = Field(self._exp, self._log, self.m, device)
            self._dev[device] = c
        return c

    # ------------------------------------------------------------------ encode

    def encode(self, msg) -> torch.Tensor:
        """Systematic encode: bits ``[..., k]`` -> bits ``[..., n]``
        (``[message | parity]``), uint8."""
        msg = torch.as_tensor(msg)
        if msg.shape[-1] != self.k:
            raise ValueError(f"expected {self.k} message bits, got {msg.shape[-1]}")
        mb = msg.to(torch.float32)
        par = _mod2(mb @ self._on(msg.device)["_enc"])
        return torch.cat([mb, par], dim=-1).to(torch.uint8)

    # ------------------------------------------------------------------ decode

    def decode(self, rx) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Correct up to ``t`` bit errors in hard bits ``[..., n]``: ``(msg
        [..., k] uint8, ok [...] bool, n_errors [...] int32)``; ``ok``: the
        corrected word re-syndromes to zero (and, past ``t = 2``, the
        locator's root count equals its degree and the BM register length
        is at most ``t``); ``n_errors`` is -1 where not ok."""
        rx = torch.as_tensor(rx)
        if rx.shape[-1] != self.n:
            raise ValueError(f"expected {self.n} received bits, got {rx.shape[-1]}")
        lead = tuple(rx.shape[:-1])
        corr, ok, nerr = self._decode_full(rx.to(torch.float32).reshape(-1, self.n))
        msg = corr[:, : self.k].to(torch.uint8).reshape(lead + (self.k,))
        return msg, ok.reshape(lead), nerr.reshape(lead)

    def _decode_full(self, rbits: torch.Tensor):
        """Float32 bit rows ``[B, n]`` -> ``(corrected [B, n] float32, ok
        [B], n_errors [B] int32)``: the closed form for ``t <= 2``, else
        Berlekamp-Massey and Chien."""
        if self.t <= 2:
            return self._decode_closed(rbits)
        return self._decode_bm(rbits)

    def _syndromes(self, rbits: torch.Tensor, c: dict) -> torch.Tensor:
        """``[B, n]`` bits -> ``[B, 2t]`` syndrome symbols."""
        sb = _mod2(rbits @ c["_synd"])
        return symbols_of(sb.reshape(rbits.shape[0], 2 * self.t, self.m))

    def _loc_match(self, x: torch.Tensor, c: dict) -> torch.Tensor:
        """Locator symbols ``[B]`` -> one-hot ``[B, n]`` float32 over the
        positions (no position for 0 or a shortened-away locator)."""
        dist = bits_of(x, self.m) @ c["_loc_w"] + c["_loc_b"]
        return (dist == 0.0).to(torch.float32)

    def _decode_closed(self, rbits: torch.Tensor):
        c = self._on(rbits.device)
        f = c["field"]
        synd = self._syndromes(rbits, c)
        s1 = synd[:, 0]
        nz1 = (s1 != 0).to(torch.float32)[:, None]
        if self.t == 1:
            flips = self._loc_match(s1, c) * nz1
        else:
            s1cu = f.mul(f.mul(s1, s1), s1)  # S1^3
            delta = synd[:, 2] ^ s1cu
            dz = (delta == 0).to(torch.float32)[:, None]
            cq = f.mul(delta, f.inv(s1cu))  # (S3 + S1^3) / S1^3
            cb = bits_of(cq, self.m)
            solvable = (_mod2(cb @ c["_trv"]) == 0.0).to(torch.float32)[:, None]
            y0 = symbols_of(_mod2(cb @ c["_ht"].T))
            x1 = f.mul(s1, y0)
            x2 = x1 ^ s1
            single = nz1 * dz
            double = nz1 * (1.0 - dz) * solvable
            flips = (single * self._loc_match(s1, c)
                     + double * _mod2(self._loc_match(x1, c) + self._loc_match(x2, c)))
        corrected = _mod2(rbits + flips)
        ok = (self._syndromes(corrected, c) == 0).all(dim=-1)
        nerr = flips.sum(dim=-1).to(torch.int32)
        return corrected, ok, torch.where(ok, nerr, torch.full_like(nerr, -1))

    def _decode_bm(self, rbits: torch.Tensor):
        c = self._on(rbits.device)
        f = c["field"]
        tt, n, m = self.t, self.n, self.m
        synd = self._syndromes(rbits, c)
        b_sz = rbits.shape[0]
        lam = torch.zeros((b_sz, tt + 1), dtype=torch.int64, device=rbits.device)
        lam[:, 0] = 1
        ell = torch.zeros(b_sz, dtype=torch.int64, device=rbits.device)
        lam, ell = f.berlekamp_massey(windows(synd, tt + 1), lam, ell)
        val = _mod2(bits_of(lam, m).reshape(b_sz, -1) @ c["_ev_lam"]).reshape(b_sz, n, m)
        is_root = (val == 0.0).all(dim=-1)
        corrected = _mod2(rbits + is_root.to(torch.float32))
        n_roots = is_root.sum(dim=-1).to(torch.int32)
        ar = torch.arange(tt + 1, device=lam.device)
        deg = torch.where(lam != 0, ar, -1).amax(dim=-1).to(torch.int32)
        resyn_ok = (self._syndromes(corrected, c) == 0).all(dim=-1)
        ok = (n_roots == deg) & (ell <= tt) & resyn_ok
        return corrected, ok, torch.where(ok, n_roots, torch.full_like(n_roots, -1))

    # ------------------------------------------------------------- soft decode

    def decode_soft(self, llr, p: int = 4):
        """Chase-2 decode of channel LLRs ``[..., n]`` (positive = bit 0):
        every subset of the ``p`` least reliable positions flipped (``2^p``
        test patterns, one batched hard decode), the decoded codeword with
        the smallest ``sum |llr| [cw != hard]`` kept; the no-flip decode
        where none decodes. Returns ``(msg [..., k] uint8, ok [...])``."""
        p = int(p)
        llr = torch.as_tensor(llr).to(torch.float32)
        if llr.shape[-1] != self.n:
            raise ValueError(f"expected {self.n} LLRs, got {llr.shape[-1]}")
        lead = tuple(llr.shape[:-1])
        flat = llr.reshape(-1, self.n)
        hard = (flat < 0).to(torch.float32)
        rel = flat.abs()
        trial = _mod2(hard[:, None, :] + chase_flips(rel, p, self.n))  # [B, 2^p, n]
        corr, ok, _ = self._decode_full(trial.reshape(-1, self.n))
        corr = corr.reshape(-1, 1 << p, self.n)
        ok = ok.reshape(-1, 1 << p)
        metric = (_mod2(corr + hard[:, None, :]) * rel[:, None, :]).sum(dim=-1)
        metric = torch.where(ok, metric, torch.full_like(metric, float("inf")))
        best = metric.argmin(dim=-1)  # all inf -> 0, the no-flip trial
        chosen = corr.gather(1, best[:, None, None].expand(-1, 1, self.n))[:, 0]
        msg = chosen[:, : self.k].to(torch.uint8).reshape(lead + (self.k,))
        return msg, ok.any(dim=-1).reshape(lead)


def chase_flips(rel: torch.Tensor, p: int, n: int) -> torch.Tensor:
    """The Chase-2 flip patterns of reliabilities ``rel [B, n]``: float32
    ``[B, 2^p, n]``, pattern ``c`` flipping the ``i``-th least reliable
    position where bit ``i`` of ``c`` is set (pattern 0 flips none). The
    positions are the first ``p`` of a stable ascending sort: the lower
    index first among equal reliabilities, as ``jax.lax.top_k(-rel, p)``."""
    idx = torch.sort(rel, dim=-1, stable=True).indices[:, :p]  # [B, p]
    combos = ((np.arange(1 << p)[:, None] >> np.arange(p)) & 1).astype(np.float32)
    onehot = torch.nn.functional.one_hot(idx, n).to(torch.float32)  # [B, p, n]
    return torch.einsum("cp,bpn->bcn", torch.from_numpy(combos).to(rel.device), onehot)


def bch_15_7() -> BCH:
    """The textbook double-error-correcting BCH(15, 7, t=2)."""
    return BCH(15, 2)


def bch_63_45() -> BCH:
    """BCH(63, 45, t=3)."""
    return BCH(63, 3)


def bch_255_t(t: int) -> BCH:
    """Full-length m=8 code at capability t."""
    return BCH(255, t, m=8)
