"""GF(2^m) arithmetic on integer symbol tensors, shared by the RS and BCH
codecs: log/antilog tables for products and inverses, a float32 matmul
mod 2 of bit planes for maps by a constant, and XOR over terms as a sum of
bit planes mod 2. Symbols are int64 tensors holding values below ``2^m``."""

from __future__ import annotations

import numpy as np
import torch


def bits_of(v: torch.Tensor, m: int = 8) -> torch.Tensor:
    """Integer symbols ``[...]`` -> float32 bit planes ``[..., m]``, LSB first."""
    w = torch.arange(m, device=v.device)
    return ((v.to(torch.int64)[..., None] >> w) & 1).to(torch.float32)


def symbols_of(bits: torch.Tensor) -> torch.Tensor:
    """Bit planes ``[..., m]`` (0/1 values) -> int64 symbols ``[...]``."""
    w = torch.arange(bits.shape[-1], device=bits.device)
    return (bits.to(torch.int64) << w).sum(dim=-1)


def linear(sym: torch.Tensor, mat: torch.Tensor, m: int = 8) -> torch.Tensor:
    """A GF(2)-linear map of symbols ``[B, a]`` by a bit-plane matrix
    ``[a * m, b * m]``: symbols ``[B, b]``, one float32 matmul mod 2 (exact:
    0/1 operands and integer sums below 2^24)."""
    bits = bits_of(sym, m).reshape(sym.shape[0], -1)
    out = torch.remainder(bits @ mat, 2.0)
    return symbols_of(out.reshape(sym.shape[0], -1, m))


class Field:
    """GF(2^m) on one device: ``exp`` (at least ``2 (2^m - 1)`` entries)
    and ``log`` (``log[0]`` unused) from the host's integer tables."""

    def __init__(self, exp: np.ndarray, log: np.ndarray, m: int, device):
        self.m, self.q = int(m), (1 << int(m)) - 1
        self.exp = torch.from_numpy(np.asarray(exp, np.int64)).to(device)
        self.log = torch.from_numpy(np.maximum(np.asarray(log, np.int64), 0)).to(device)

    def mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        prod = self.exp[self.log[a] + self.log[b]]
        return torch.where((a != 0) & (b != 0), prod, torch.zeros_like(prod))

    def inv(self, a: torch.Tensor) -> torch.Tensor:
        """``a^{-1}``, and 0 for 0 (as a Fermat inverse gives)."""
        inv = self.exp[(self.q - self.log[a]) % self.q]
        return torch.where(a != 0, inv, torch.zeros_like(inv))

    def xor_reduce(self, v: torch.Tensor, dim: int) -> torch.Tensor:
        """XOR of symbols along ``dim`` (a sum of bit planes mod 2)."""
        dim = dim if dim >= 0 else v.dim() + dim
        w = torch.arange(self.m, device=v.device)
        par = ((v[..., None] >> w) & 1).sum(dim=dim) & 1
        return (par << w).sum(dim=-1)

    def poly_mul(self, a: torch.Tensor, b: torch.Tensor, out_len: int) -> torch.Tensor:
        """Product of polynomials ``a [..., La]`` and ``b [..., Lb]``
        (lowest degree first), truncated to ``out_len`` coefficients."""
        la, lb = a.shape[-1], b.shape[-1]
        prod = self.mul(a[..., :, None], b[..., None, :]).flatten(-2)  # [..., La * Lb]
        prod = torch.nn.functional.pad(prod, (0, 1))  # a zero for the missing terms
        j = np.arange(out_len)[:, None]
        i = np.arange(la)[None, :]
        idx = np.where((j - i >= 0) & (j - i < lb), i * lb + (j - i), la * lb)
        idx_t = torch.from_numpy(idx.reshape(-1)).to(a.device)
        terms = prod[..., idx_t].reshape(prod.shape[:-1] + (out_len, la))
        return self.xor_reduce(terms, -1)

    def berlekamp_massey(self, windows: torch.Tensor, lam: torch.Tensor, ell: torch.Tensor,
                         rho=None) -> tuple:
        """Inversionless Berlekamp-Massey over ``windows[:, r, i] =
        S_{r-i}`` (``[B, R, L]``, ``R`` iterations) from the locator ``lam
        [B, L]`` (also the first ``B`` polynomial), discrepancy 1 and
        register length ``ell``: ``(lam, ell)``. The updates are the JAX
        package's ``torch.where`` form; with ``rho`` (erasure counts
        ``[B]``) an iteration acts only from ``r >= rho`` on and its length
        test counts the erasures."""
        bpoly = lam
        bdisc = torch.ones_like(ell)
        for step in range(windows.shape[1]):
            delta = self.xor_reduce(self.mul(lam, windows[:, step]), -1)
            xb = torch.nn.functional.pad(bpoly[:, :-1], (1, 0))
            t_new = self.mul(bdisc[:, None], lam) ^ self.mul(delta[:, None], xb)
            if rho is None:
                upd = (delta != 0) & (2 * ell <= step)
                bpoly = torch.where(upd[:, None], lam, xb)
                lam = t_new
                ell = torch.where(upd, step + 1 - ell, ell)
            else:
                active = step >= rho
                upd = active & (delta != 0) & (2 * ell <= step + rho)
                bpoly = torch.where(upd[:, None], lam, torch.where(active[:, None], xb, bpoly))
                lam = torch.where(active[:, None], t_new, lam)
                ell = torch.where(upd, step + 1 - ell + rho, ell)
            bdisc = torch.where(upd, delta, bdisc)
        return lam, ell


def windows(synd: torch.Tensor, width: int) -> torch.Tensor:
    """``w[:, r, i] = S_{r-i}`` for ``i < width`` (0 where ``r < i``) from
    syndromes ``[B, R]``: ``[B, R, width]``."""
    b, n_syn = synd.shape
    pad = torch.nn.functional.pad(synd, (width - 1, 0))
    r = np.arange(n_syn)[:, None]
    i = np.arange(width)[None, :]
    idx = torch.from_numpy((r + width - 1 - i).reshape(-1)).to(synd.device)
    return pad[:, idx].reshape(b, n_syn, width)


def gf2_power(a: np.ndarray, e: int) -> np.ndarray:
    """``a^e`` of a square 0/1 matrix over GF(2), by squaring (exact
    int64)."""
    out = np.eye(a.shape[0], dtype=np.int64)
    base = a.astype(np.int64)
    while e:
        if e & 1:
            out = (out @ base) % 2
        base = (base @ base) % 2
        e >>= 1
    return out
