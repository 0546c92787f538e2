"""Pseudo-random sequences and the multiplicative scrambler (PyTorch).

Counterpart of ``aether_primitives_tpu/ops/sequence.py``, burst-link subset:
:func:`expand`, :func:`lte_gold` (a host numpy constant: the preamble is
built from it once per modem) and the self-synchronising scrambler pair
:func:`scramble_multiplicative` / :func:`descramble_multiplicative`. Bits
are exact {0, 1} uint8. The JAX package's GF(2) block-matrix scans exist to
keep a TPU off bit-serial loops; here the scrambler's feedback recurrence
runs as a plain loop that advances ``min(delays)`` bits per step (every
bit in such a chunk depends only on earlier chunks), batched over leading
axes.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def expand(seed: int, length: int) -> np.ndarray:
    """LSB-first bit-unpack of ``seed`` into a {0,1} uint8 vector."""
    i = np.arange(length, dtype=np.uint64)
    return ((np.uint64(seed) >> i) & np.uint64(1)).astype(np.uint8)


def _lfsr(init: np.ndarray, delays: Sequence[int], length: int) -> np.ndarray:
    """``x(n) = sum_d x(n - d) mod 2`` from ``init`` (``max(delays)`` bits),
    ``length`` bits in all (host numpy)."""
    order = max(delays)
    x = np.zeros(max(length, order), np.uint8)
    x[:order] = init
    for n in range(order, length):
        acc = 0
        for d in delays:
            acc ^= int(x[n - d])
        x[n] = acc
    return x[:length]


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
