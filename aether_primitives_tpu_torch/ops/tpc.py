"""Turbo product codes: iterative Chase-Pyndiah decoding (PyTorch).

Counterpart of ``aether_primitives_tpu/ops/tpc.py``: the two-dimensional
product of extended BCH codes of length ``n = 2^m`` (extended Hamming
for ``t_component=1``, extended BCH-2 for 2), decoded by exchanging
extrinsic information between row and column soft-input soft-output
Chase decoders [Pyndiah, IEEE Trans. Comm. 46(8), 1998], with the same
half-iteration schedules. One half-iteration decodes every row (or
column) of every block in the batch as one elementary call: ``[Q, n]``
words expand to ``[Q, 2^p, n - 1]`` trials, corrected by the S1
position match for Hamming components (a perfect code: every trial lands
on a codeword) or by :class:`~.bch.BCH`'s closed form for BCH-2.

The decoders are float32: the hard decisions and ``ok`` equal the
reference's; the soft values agree to the summation order of the
candidates' metrics. The ``p`` least reliable positions are
:func:`~.bch.chase_flips`'s (a stable sort: ``jax.lax.top_k``'s order).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .bch import BCH, chase_flips

__all__ = ["TPC"]

# Pyndiah's half-iteration schedules (alpha: extrinsic weight, beta:
# no-competitor reliability), flat beyond six.
_ALPHA = (0.2, 0.3, 0.5, 0.7, 0.9, 1.0)
_BETA = (0.2, 0.4, 0.6, 0.8, 1.0, 1.0)


def _mod2(x: torch.Tensor) -> torch.Tensor:
    return torch.remainder(x, 2.0)


class TPC:
    """``(2^m, k)^2`` extended-BCH turbo product code.

    ``m``: the component length ``n = 2^m``; ``p``: Chase test-pattern
    bits (``2^p`` trials a word); ``iters``: full iterations (a row and a
    column half each); ``t_component``: 1 (extended Hamming) or 2
    (extended BCH-2). ``encode``: data ``[..., k, k]`` -> codeword bits
    ``[..., n, n]``; ``decode``: LLRs ``[..., n, n]`` (positive = bit 0)
    -> ``(data [..., k, k], ok [...])``. Batched over leading axes.
    """

    def __init__(self, m: int = 5, p: int = 4, iters: int = 4, t_component: int = 1):
        if t_component not in (1, 2):
            raise ValueError(
                "t_component must be 1 (extended Hamming) or 2 "
                "(extended BCH-2, the 802.16-class stronger squares)"
            )
        self.t_component = int(t_component)
        self.base = BCH((1 << m) - 1, t_component)
        self.n = 1 << m
        self.k = self.base.k
        self.p = int(p)
        self.iters = int(iters)
        self.rate = (self.k / self.n) ** 2
        # Hamming fast path: the S1 syndrome is the error's position vector
        s1 = self.base._synd[:, :m].astype(np.float32)  # [nb, m]
        self._s1 = s1
        self._match_w = (1.0 - 2.0 * s1.T).astype(np.float32)  # [m, nb]
        self._match_b = s1.sum(axis=1).astype(np.float32)      # [nb]
        self._dev = {}

    def _on(self, device) -> dict:
        device = torch.device(device)
        c = self._dev.get(device)
        if c is None:
            c = {name: torch.from_numpy(getattr(self, name)).to(device)
                 for name in ("_s1", "_match_w", "_match_b")}
            c["_synd"] = torch.from_numpy(self.base._synd).to(device)
            self._dev[device] = c
        return c

    # ------------------------------------------------------------------ encode

    def encode(self, data) -> torch.Tensor:
        """Systematic product encode: ``[..., k, k]`` -> uint8 ``[..., n, n]``
        (rows, then columns)."""
        data = torch.as_tensor(data)
        if tuple(data.shape[-2:]) != (self.k, self.k):
            raise ValueError(
                f"expected [..., {self.k}, {self.k}] data, got {tuple(data.shape)}"
            )

        def ext_encode(rows):  # [..., k] -> [..., n]
            cw = self.base.encode(rows).to(torch.float32)
            return torch.cat([cw, _mod2(cw.sum(dim=-1, keepdim=True))], dim=-1)

        rows = ext_encode(data)
        cols = ext_encode(rows.transpose(-1, -2))
        return cols.transpose(-1, -2).to(torch.uint8)

    # ------------------------------------------------------------ elementary

    def _siso(self, r: torch.Tensor, beta: float, rbar: torch.Tensor) -> torch.Tensor:
        """Chase-Pyndiah decode of words ``r [Q, n]`` -> soft output ``[Q,
        n]``; ``rbar [Q, 1]`` is the channel-scale anchor of the
        no-competitor reliability."""
        nb, p = self.n - 1, self.p
        q = r.shape[0]
        c = self._on(r.device)
        hard = (r < 0.0).to(torch.float32)
        rel = r.abs()
        trial = _mod2(hard[:, None, :] + chase_flips(rel, p, self.n))  # [Q, 2^p, n]
        tb = trial[..., :nb]
        if self.t_component == 1:
            s1 = _mod2(tb @ c["_s1"])
            dist = s1 @ c["_match_w"] + c["_match_b"]
            body = _mod2(tb + (dist == 0.0).to(torch.float32))
            cand_ok = torch.ones((q, 1 << p), dtype=torch.bool, device=r.device)
        else:
            body, okf, _ = self.base._decode_full(tb.reshape(-1, nb))
            body = body.reshape(q, 1 << p, nb)
            cand_ok = okf.reshape(q, 1 << p)
        cand = torch.cat([body, _mod2(body.sum(dim=-1, keepdim=True))], dim=-1)
        metric = (_mod2(cand + hard[:, None, :]) * rel[:, None, :]).sum(dim=-1)  # [Q, 2^p]
        # failed trials (t=2) leave the pool through a large finite penalty
        metric = torch.where(cand_ok, metric, torch.full_like(metric, 1e9))
        best = metric.argmin(dim=-1)
        bm = metric.gather(1, best[:, None])  # [Q, 1]
        d = cand.gather(1, best[:, None, None].expand(-1, 1, self.n))[:, 0]  # [Q, n]
        differs = cand != d[:, None, :]
        comp = torch.where(differs, metric[:, :, None],
                           torch.full_like(cand, float("inf"))).amin(dim=1)  # [Q, n]
        has = comp < 1e8
        d_sign = 1.0 - 2.0 * d
        return torch.where(has, (comp - bm) * d_sign, d_sign * (rel + beta * rbar))

    # ------------------------------------------------------------------ decode

    def decode(self, llr) -> Tuple[torch.Tensor, torch.Tensor]:
        """Iterative Chase-Pyndiah decode of LLRs ``[..., n, n]`` -> ``(data
        [..., k, k] uint8, ok [...])``; ``ok``: every row and column of the
        final hard decision is an extended codeword."""
        llr = torch.as_tensor(llr).to(torch.float32)
        n = self.n
        if tuple(llr.shape[-2:]) != (n, n):
            raise ValueError(f"expected [..., {n}, {n}] LLRs, got {tuple(llr.shape)}")
        lead = tuple(llr.shape[:-2])
        r = llr.reshape(-1, n, n)
        b = r.shape[0]
        rbar = r.abs().mean(dim=(-1, -2), keepdim=True)  # [b, 1, 1]
        rbar_words = rbar.expand(b, n, 1).reshape(-1, 1)

        def half_step(w_other, alpha, beta, axis):
            rin = r + alpha * w_other
            words = rin if axis == 1 else rin.transpose(-1, -2)
            lam = self._siso(words.reshape(-1, n), beta, rbar_words).reshape(b, n, n)
            w = lam - words
            if axis == 0:
                w, lam = w.transpose(-1, -2), lam.transpose(-1, -2)
            return w, lam

        w_row = w_col = final = torch.zeros_like(r)
        for it in range(self.iters):
            for half in range(2):
                hi = min(2 * it + half, len(_ALPHA) - 1)
                alpha, beta = float(np.float32(_ALPHA[hi])), float(np.float32(_BETA[hi]))
                if half == 0:
                    w_row, _ = half_step(w_col, alpha, beta, axis=1)
                else:
                    w_col, final = half_step(w_row, alpha, beta, axis=0)
        hard = (final < 0.0).to(torch.float32)
        synd = self._on(r.device)["_synd"]

        def all_codewords(words):  # [b, n, n], words on the last axis
            syn = _mod2(words[..., : n - 1] @ synd)
            even = _mod2(words.sum(dim=-1)) == 0.0
            return (syn == 0.0).all(dim=-1) & even

        ok = (all_codewords(hard) & all_codewords(hard.transpose(-1, -2))).all(dim=-1)
        data = hard[..., : self.k, : self.k].to(torch.uint8)
        return data.reshape(lead + (self.k, self.k)), ok.reshape(lead)

    def sharded_decode(self, llr, mesh, axis_name: str = "channel"):
        """:meth:`decode` with the block batch sharded over ``mesh``'s
        ``axis_name``: pure data parallel (blocks are independent, nothing
        crosses shards), one :meth:`decode` a shard on its device.
        ``llr [B, n, n]`` (a tensor or array-like, or a :class:`~..parallel.
        mesh.Sharded` laid out so) with ``B`` divisible by the mesh axis;
        returns ``(data, ok)`` as :class:`~..parallel.mesh.Sharded` values
        split along ``B``, equal to the unsharded call's when gathered. On
        a mesh that spans processes each process decodes its own blocks."""
        from ..parallel import mesh as _mesh  # parallel imports ops: not at the top

        if not isinstance(llr, _mesh.Sharded):
            llr = torch.as_tensor(llr).to(torch.float32)
        if llr.ndim != 3:
            raise ValueError(f"expected [B, n, n] LLRs, got {tuple(llr.shape)}")
        n_dev = mesh.shape[axis_name]
        if llr.shape[0] % n_dev:
            raise ValueError(f"{llr.shape[0]} blocks do not divide over {n_dev} devices")
        xs = _mesh.shard(llr, mesh, (axis_name, None, None))
        return xs.map(self.decode, spec=((axis_name, None, None), (axis_name,)))
