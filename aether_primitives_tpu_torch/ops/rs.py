"""Reed-Solomon codes over GF(2^8) (PyTorch).

Counterpart of ``aether_primitives_tpu/ops/rs.py``: the same codes, the
same decoder steps and the same outputs, bit for bit (``msg``, ``ok`` and
``n_errors`` alike). Symbols are uint8, index 0 = highest-degree
coefficient = transmitted first, systematic ``[message | parity]``.

Field arithmetic. Maps by a constant (the encoder, the syndromes, the
Chien and Forney evaluations) stay GF(2)-linear maps of the symbols' bit
planes: one float32 matmul mod 2 against a host-built matrix (exact: 0/1
operands and integer sums below 2^24, with or without TF32). Products and
quotients of two variables (the Berlekamp-Massey discrepancies and
updates, the locator products, Forney's quotient) are log/antilog table
lookups on integer symbols, and an XOR over terms is a sum of bit planes
mod 2. The JAX package does those as bilinear bit-plane einsums and
inverts by Fermat's theorem, because table lookups are slow on its TPU;
on a GPU a gather is cheap, so the tables take their place.

- :class:`ReedSolomon` with :meth:`~ReedSolomon.encode`,
  :meth:`~ReedSolomon.decode` (errors) and
  :meth:`~ReedSolomon.decode_erasures` (errors and erasures); every step
  batched over leading axes. Berlekamp-Massey is inversionless and runs a
  fixed ``n - k`` iterations with ``torch.where`` updates, as the
  reference does; the erasure locator is a product tree of the
  positions' factors, truncated as the reference's scan truncates it.
- :func:`rs_255_223`, :func:`bits_to_symbols`, :func:`symbols_to_bits`.

The host table builders (``_field_tables``, ``_mul_matrix``,
``_gf_mul_int``, ``_poly_mod`` and the matrices of ``__init__`` and
``_erasure_tables``) are copies of the JAX package's numpy code.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ._gf import Field, linear, symbols_of, windows

__all__ = ["ReedSolomon", "rs_255_223", "symbols_to_bits", "bits_to_symbols"]


# ---------------------------------------------------------------- host field math


def _field_tables(primitive_poly: int) -> Tuple[np.ndarray, np.ndarray]:
    """exp/log tables for GF(2^8) (``exp`` doubled to 510 entries)."""
    exp = np.zeros(510, np.int64)
    log = np.zeros(256, np.int64)
    v = 1
    for i in range(255):
        exp[i] = v
        log[v] = i
        v <<= 1
        if v & 0x100:
            v ^= primitive_poly
    exp[255:510] = exp[:255]
    return exp, log


def _mul_matrix(c: int, primitive_poly: int) -> np.ndarray:
    """8x8 GF(2) matrix of multiplication by the constant ``c``:
    column i = bits of ``c * x^i``."""
    m = np.zeros((8, 8), np.uint8)
    for i in range(8):
        v = c
        for _ in range(i):  # multiply by x, reduce
            v <<= 1
            if v & 0x100:
                v ^= primitive_poly
        for j in range(8):
            m[j, i] = (v >> j) & 1
    return m


def _gf_mul_int(a: int, b: int, exp: np.ndarray, log: np.ndarray) -> int:
    if a == 0 or b == 0:
        return 0
    return int(exp[log[a] + log[b]])


def _poly_mod(num: list, den: list, exp, log) -> list:
    """Remainder of polynomial division over GF(2^8); coefficient lists are
    highest-degree-first, ``den`` monic."""
    out = list(num)
    for i in range(len(num) - len(den) + 1):
        c = out[i]
        if c:
            for j in range(1, len(den)):
                out[i + j] ^= _gf_mul_int(c, den[j], exp, log)
    return out[-(len(den) - 1):]


def _eval_matrices(n: int, deg: int, nsym: int, fcr: int, primitive_poly: int, exp, log):
    """Chien/Forney evaluation matrices at locator degree ``deg``: rows of
    the locator's (``el``, ``eld`` for its formal derivative) and of
    Omega's (``eo``, with the ``X^{1-fcr}`` Forney factor) bit planes,
    columns of the ``n`` positions' values at the inverse locators."""
    el = np.zeros(((deg + 1) * 8, n * 8), np.uint8)
    eld = np.zeros(((deg + 1) * 8, n * 8), np.uint8)
    eo = np.zeros((nsym * 8, n * 8), np.uint8)
    for j in range(n):
        d = n - 1 - j
        inv = (-d) % 255  # alpha^{-d} exponent
        for l in range(deg + 1):
            c = int(exp[(inv * l) % 255])
            el[l * 8: l * 8 + 8, j * 8: j * 8 + 8] = _mul_matrix(c, primitive_poly).T
            if l % 2 == 1:  # derivative term Lam_l x^{l-1}
                cd = int(exp[(inv * (l - 1)) % 255])
                eld[l * 8: l * 8 + 8, j * 8: j * 8 + 8] = _mul_matrix(cd, primitive_poly).T
        forney = int(exp[(d * (1 - fcr)) % 255])
        for i in range(nsym):
            c = _gf_mul_int(int(exp[(inv * i) % 255]), forney, exp, log)
            eo[i * 8: i * 8 + 8, j * 8: j * 8 + 8] = _mul_matrix(c, primitive_poly).T
    return el.astype(np.float32), eld.astype(np.float32), eo.astype(np.float32)


class ReedSolomon:
    """RS(n, k) over GF(2^8): ``t = (n-k)//2`` correctable symbol errors.

    ``n, k``: code and message length in symbols, ``k < n <= 255`` (``n <
    255`` is the shortened code); ``fcr``: first consecutive root exponent
    of ``g(x) = prod_i (x - alpha^(fcr+i))``; ``primitive_poly``: the field
    polynomial (default ``0x11D``). Host matrices are built in ``__init__``
    with exact integers; device constants are made once per device.
    """

    def __init__(self, n: int, k: int, fcr: int = 1, primitive_poly: int = 0x11D):
        n, k = int(n), int(k)
        if not (0 < k < n <= 255):
            raise ValueError(f"need 0 < k < n <= 255, got n={n} k={k}")
        self.n, self.k, self.fcr = n, k, int(fcr)
        self.nsym = n - k
        self.t = self.nsym // 2
        self.primitive_poly = int(primitive_poly)
        exp, log = _field_tables(self.primitive_poly)
        self._exp, self._log = exp, log

        # generator polynomial, monic, highest-degree-first
        g = [1]
        for i in range(self.nsym):
            root = int(exp[(self.fcr + i) % 255])
            new = [0] * (len(g) + 1)
            for d, c in enumerate(g):
                new[d] ^= c
                new[d + 1] ^= _gf_mul_int(c, root, exp, log)
            g = new
        self.generator = np.array(g, np.int64)

        bits8 = np.arange(8)

        def elem_bits(v: int) -> np.ndarray:
            return ((v >> bits8) & 1).astype(np.uint8)

        # encoder: parity_bits = msg_bits @ A (mod 2)
        rems = []
        r = _poly_mod([1] + [0] * self.nsym, list(self.generator), exp, log)
        rems.append(list(r))
        for _ in range(1, k):
            r = _poly_mod(list(r) + [0], list(self.generator), exp, log)
            rems.append(list(r))
        a = np.zeros((k * 8, self.nsym * 8), np.uint8)
        for j in range(k):
            rm = rems[k - 1 - j]
            for b in range(8):
                ab = 1 << b
                for s in range(self.nsym):
                    prod = _gf_mul_int(ab, rm[s], exp, log)
                    a[j * 8 + b, s * 8: s * 8 + 8] = elem_bits(prod)
        self._enc = a.astype(np.float32)

        # syndromes: synd_bits = cw_bits @ B (mod 2), S_i = r(alpha^(fcr+i))
        b = np.zeros((n * 8, self.nsym * 8), np.uint8)
        for j in range(n):
            d = n - 1 - j
            for i in range(self.nsym):
                c = int(exp[((self.fcr + i) * d) % 255])
                b[j * 8: j * 8 + 8, i * 8: i * 8 + 8] = _mul_matrix(c, self.primitive_poly).T
        self._synd = b.astype(np.float32)

        # Chien/Forney evaluation matrices at locator degree t
        self._ev_lam, self._ev_lamd, self._ev_omg = _eval_matrices(
            n, self.t, self.nsym, self.fcr, self.primitive_poly, exp, log)
        self._era = None
        self._dev = {}

    # ------------------------------------------------------------------ utils

    def _erasure_tables(self):
        """Host tables of errors-and-erasures decoding (made at first use):
        the positions' locators ``X_j = alpha^(n-1-j)`` as bit planes and
        the evaluation matrices at locator degree ``n - k``."""
        if self._era is None:
            exp, n = self._exp, self.n
            bits8 = np.arange(8)
            xloc = np.zeros((n, 8), np.float32)
            for j in range(n):
                v = int(exp[(n - 1 - j) % 255])
                xloc[j] = ((v >> bits8) & 1).astype(np.float32)
            el, eld, eo = _eval_matrices(n, self.nsym, self.nsym, self.fcr,
                                         self.primitive_poly, exp, self._log)
            self._era = (xloc, el, eld, eo)
        return self._era

    def _on(self, device) -> dict:
        """The device constants: the field's tables and the matrices."""
        device = torch.device(device)
        c = self._dev.get(device)
        if c is None:
            f32 = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
            c = {"field": Field(self._exp, self._log, 8, device), "enc": f32(self._enc),
                 "synd": f32(self._synd), "ev": tuple(f32(m) for m in (
                     self._ev_lam, self._ev_lamd, self._ev_omg))}
            self._dev[device] = c
        if "era" not in c and self._era is not None:
            xloc, el, eld, eo = self._era
            c["era"] = (symbols_of(torch.from_numpy(xloc)).to(device),
                        tuple(torch.from_numpy(m).to(device) for m in (el, eld, eo)))
        return c

    # ------------------------------------------------------------------ encode

    def encode(self, msg) -> torch.Tensor:
        """Systematic encode: uint8 ``[..., k]`` -> uint8 ``[..., n]``
        (``[message | parity]``)."""
        msg = torch.as_tensor(msg)
        if msg.shape[-1] != self.k:
            raise ValueError(f"expected {self.k} message symbols, got {msg.shape[-1]}")
        lead = tuple(msg.shape[:-1])
        m = msg.to(torch.int64).reshape(-1, self.k)
        par = linear(m, self._on(msg.device)["enc"])
        out = torch.cat([m, par], dim=-1).to(torch.uint8)
        return out.reshape(lead + (self.n,))

    # ------------------------------------------------------------------ decode

    def _syndromes(self, rx: torch.Tensor, c: dict) -> torch.Tensor:
        return linear(rx, c["synd"])  # [B, nsym]

    def _chien_forney(self, synd, lam, rx, ev, c):
        """Chien search and Forney correction for ``[B]`` codewords with
        locators ``lam [B, deg + 1]``: ``(corrected [B, n], ok, n_roots)``."""
        f = c["field"]
        deg_max = lam.shape[-1] - 1
        omega = f.poly_mul(synd, lam, self.nsym)  # S * Lam mod x^nsym
        val_lam = linear(lam, ev[0])
        val_lamd = linear(lam, ev[1])
        val_omg = linear(omega, ev[2])
        is_root = val_lam == 0  # [B, n]
        e = f.mul(val_omg, f.inv(val_lamd)) * is_root
        corrected = rx ^ e
        n_roots = is_root.sum(dim=-1).to(torch.int32)
        ar = torch.arange(deg_max + 1, device=lam.device)
        deg = torch.where(lam != 0, ar, -1).amax(dim=-1).to(torch.int32)
        resyn_ok = (self._syndromes(corrected, c) == 0).all(dim=-1)
        return corrected, (n_roots == deg) & resyn_ok, n_roots

    def decode(self, rx) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Correct up to ``t`` symbol errors in uint8 ``[..., n]``.

        Returns ``(msg, ok, n_errors)``: uint8 ``[..., k]``; bool, the
        corrected word re-syndromes to zero and the locator's root count
        equals its degree; int32, the symbols corrected (-1 where not ok).
        """
        rx = torch.as_tensor(rx)
        if rx.shape[-1] != self.n:
            raise ValueError(f"expected {self.n} received symbols, got {rx.shape[-1]}")
        lead = tuple(rx.shape[:-1])
        c = self._on(rx.device)
        f = c["field"]
        r = rx.to(torch.int64).reshape(-1, self.n)
        synd = self._syndromes(r, c)
        tt, b_sz = self.t, r.shape[0]
        lam = torch.zeros((b_sz, tt + 1), dtype=torch.int64, device=r.device)
        lam[:, 0] = 1
        ell = torch.zeros(b_sz, dtype=torch.int64, device=r.device)
        lam, _ = f.berlekamp_massey(windows(synd, tt + 1), lam, ell)
        corrected, ok, n_roots = self._chien_forney(synd, lam, r, c["ev"], c)
        nerr = torch.where(ok, n_roots, torch.full_like(n_roots, -1))
        msg = corrected[:, : self.k].to(torch.uint8)
        return msg.reshape(lead + (self.k,)), ok.reshape(lead), nerr.reshape(lead)

    def _erasure_locator(self, mask: torch.Tensor, xloc: torch.Tensor, f: Field):
        """``Gamma(x) = prod_{erased j} (1 + X_j x)`` mod ``x^(n-k+1)``, as a
        product tree over the positions' factors: ``[B, n - k + 1]``."""
        b_sz = mask.shape[0]
        one = torch.ones((b_sz, self.n), dtype=torch.int64, device=mask.device)
        fac = torch.stack([one, xloc[None, :] * mask], dim=-1)  # [B, n, 2]
        cap = self.nsym + 1
        while fac.shape[1] > 1:
            if fac.shape[1] % 2:
                unit = torch.zeros((b_sz, 1, fac.shape[2]), dtype=torch.int64,
                                   device=mask.device)
                unit[..., 0] = 1
                fac = torch.cat([fac, unit], dim=1)
            fac = f.poly_mul(fac[:, 0::2], fac[:, 1::2], min(2 * fac.shape[2] - 1, cap))
        gamma = fac[:, 0]
        return torch.nn.functional.pad(gamma, (0, cap - gamma.shape[-1]))

    def decode_erasures(self, rx, erased) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Errors-and-erasures decode: corrects ``nu`` errors plus ``rho``
        flagged erasures whenever ``2 nu + rho <= n - k``. ``erased``: mask
        ``[..., n]``, nonzero = an erasure (its value is ignored). Returns
        ``(msg, ok, n_corrected)`` as :meth:`decode`."""
        rx = torch.as_tensor(rx)
        if rx.shape[-1] != self.n:
            raise ValueError(f"expected {self.n} received symbols, got {rx.shape[-1]}")
        mask = torch.as_tensor(erased, device=rx.device)
        if mask.shape[-1] != self.n:
            raise ValueError("erasure mask must match the codeword length")
        lead = tuple(rx.shape[:-1])
        self._erasure_tables()
        c = self._on(rx.device)
        f = c["field"]
        xloc, ev = c["era"]
        nsym = self.nsym
        m = (mask != 0).reshape(-1, self.n).to(torch.int64)
        r = rx.to(torch.int64).reshape(-1, self.n) * (1 - m)
        synd = self._syndromes(r, c)
        rho = m.sum(dim=-1)
        gamma = self._erasure_locator(m, xloc, f)
        # Berlekamp-Massey from Lam = B = Gamma, L = rho, enabled for r >= rho
        lam, _ = f.berlekamp_massey(windows(synd, nsym + 1), gamma, rho, rho)
        corrected, ok, n_roots = self._chien_forney(synd, lam, r, ev, c)
        ok = ok & (rho <= nsym)
        nerr = torch.where(ok, n_roots, torch.full_like(n_roots, -1))
        msg = corrected[:, : self.k].to(torch.uint8)
        return msg.reshape(lead + (self.k,)), ok.reshape(lead), nerr.reshape(lead)


def rs_255_223(fcr: int = 1) -> ReedSolomon:
    """The CCSDS-style RS(255, 223), t = 16."""
    return ReedSolomon(255, 223, fcr=fcr)


def symbols_to_bits(sym) -> torch.Tensor:
    """uint8 symbols ``[..., m]`` -> LSB-first {0, 1} bits ``[..., m * 8]``."""
    s = torch.as_tensor(sym).to(torch.int64)
    bits = ((s[..., None] >> torch.arange(8, device=s.device)) & 1).to(torch.uint8)
    return bits.reshape(bits.shape[:-2] + (bits.shape[-2] * 8,))


def bits_to_symbols(bits) -> torch.Tensor:
    """Inverse of :func:`symbols_to_bits`: ``[..., m * 8]`` -> uint8 ``[..., m]``."""
    b = torch.as_tensor(bits)
    if b.shape[-1] % 8:
        raise ValueError("bit count must be a multiple of 8")
    b = b.reshape(b.shape[:-1] + (b.shape[-1] // 8, 8)).to(torch.int64) % 2
    return (b << torch.arange(8, device=b.device)).sum(dim=-1).to(torch.uint8)
