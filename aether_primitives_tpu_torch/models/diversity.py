"""Antenna diversity (PyTorch): receive combining (MRC / EGC / selection),
the Alamouti 2x1 space-time block code, and linear MIMO detection.

Counterpart of ``aether_primitives_tpu/models/diversity.py``. Combining is
one elementwise pass over ``[..., n_rx, n]`` blocks; channels ``h`` are
complex gains per branch, broadcastable to the samples; combiners return
unit-reference symbol estimates. The MIMO detectors are batched tiny solves
(``torch.linalg.solve_ex`` / ``inv_ex`` with ``check_errors=False``: the
checked forms read their error flag back to the host on every call, which
the JAX package's solves do not). Everything runs on the input's device.
"""

from __future__ import annotations

import torch

from ..types import as_cf32, cf32


def _norm2(h):
    return h.real ** 2 + h.imag ** 2


def mrc_combine(y, h, axis: int = -2) -> torch.Tensor:
    """Maximal-ratio combining of the branches along ``axis`` of ``y`` with
    channel gains ``h`` (broadcastable to ``y``): ``sum conj(h) y / sum
    |h|^2`` (unit-reference output)."""
    y = as_cf32(y)
    h = as_cf32(h, device=y.device)
    num = (h.conj() * y).sum(dim=axis)
    den = _norm2(h).sum(dim=axis)
    return (num / torch.clamp_min(den, 1e-30)).to(cf32)


def egc_combine(y, h, axis: int = -2) -> torch.Tensor:
    """Equal-gain combining: co-phase each branch (``e^{-j arg h}``) and
    average."""
    y = as_cf32(y)
    h = as_cf32(h, device=y.device)
    mag = torch.sqrt(torch.clamp_min(_norm2(h), 1e-30))
    phased = y * h.conj() / mag
    n_rx = y.shape[axis]
    return (phased.sum(dim=axis) / n_rx).to(cf32)


def selection_combine(y, h, axis: int = -2) -> torch.Tensor:
    """Selection diversity: the branch with the largest ``|h|`` (per
    leading-batch element; the first on a tie), channel-corrected."""
    y = as_cf32(y)
    h = as_cf32(h, device=y.device)
    hb = torch.broadcast_to(h, y.shape)
    axis = axis % y.ndim
    # branch power: reduce every axis after `axis` (the sample axes)
    red = tuple(range(axis + 1, y.ndim))
    power = _norm2(hb).sum(dim=red) if red else _norm2(hb)
    best = torch.argmax(power, dim=-1)
    idx = best.reshape(best.shape + (1,) * (y.ndim - axis))
    out = torch.take_along_dim(y, idx, dim=axis).squeeze(axis)
    hsel = torch.take_along_dim(hb, idx, dim=axis).squeeze(axis)
    return (out * hsel.conj() / torch.clamp_min(_norm2(hsel), 1e-30)).to(cf32)


def alamouti_encode(symbols) -> torch.Tensor:
    """Alamouti 2x1 STBC: ``[..., n]`` symbols (n even) -> ``[..., 2, n]``
    per-TX-antenna streams. Antenna 0 sends ``s0, -conj(s1), s2,
    -conj(s3), ...``; antenna 1 sends ``s1, conj(s0), s3, conj(s2), ...``."""
    s = as_cf32(symbols)
    if s.shape[-1] % 2:
        raise ValueError("Alamouti encodes symbol PAIRS: length must be even")
    pairs = s.reshape(s.shape[:-1] + (-1, 2))
    s0, s1 = pairs[..., 0], pairs[..., 1]
    tx0 = torch.stack([s0, -s1.conj()], dim=-1).reshape(s.shape)
    tx1 = torch.stack([s1, s0.conj()], dim=-1).reshape(s.shape)
    return torch.stack([tx0, tx1], dim=-2)


def alamouti_decode(y, h0, h1) -> torch.Tensor:
    """Alamouti combining at one RX antenna: ``[..., n]`` received (n even),
    per-burst channels ``h0``/``h1`` (scalars or ``[...]`` broadcastable) ->
    ``[..., n]`` symbol estimates::

        s0_hat = (conj(h0) r0 + h1 conj(r1)) / (|h0|^2 + |h1|^2)
        s1_hat = (conj(h1) r0 - h0 conj(r1)) / (|h0|^2 + |h1|^2)
    """
    y = as_cf32(y)
    if y.shape[-1] % 2:
        raise ValueError("Alamouti decodes symbol PAIRS: length must be even")
    h0 = as_cf32(h0, device=y.device)[..., None]
    h1 = as_cf32(h1, device=y.device)[..., None]
    pairs = y.reshape(y.shape[:-1] + (-1, 2))
    r0, r1 = pairs[..., 0], pairs[..., 1]
    den = torch.clamp_min(_norm2(h0) + _norm2(h1), 1e-30)
    s0 = (h0.conj() * r0 + h1 * r1.conj()) / den
    s1 = (h1.conj() * r0 - h0 * r1.conj()) / den
    out = torch.stack([s0, s1], dim=-1)
    return out.reshape(y.shape).to(cf32)


# ------------------------------------------------------- spatial multiplexing


def _gram(h):
    """``(H^H, H^H H)`` of ``h [..., n_rx, n_tx]``."""
    hh = h.conj().transpose(-1, -2)
    return hh, hh @ h


def mimo_detect_zf(y, h):
    """Zero-forcing detection for spatial multiplexing: per symbol time
    ``y = H s + n`` with ``y [..., n_rx]``, ``h [..., n_rx, n_tx]``
    (broadcastable). Returns ``s_hat = (H^H H)^{-1} H^H y`` by batched
    solves of the normal equations. Requires ``n_rx >= n_tx``."""
    y = as_cf32(y)
    h = as_cf32(h, device=y.device)
    hh, a = _gram(h)
    b = (hh @ y[..., None])[..., 0]
    return torch.linalg.solve_ex(a, b[..., None], check_errors=False)[0][..., 0].to(cf32)


def mimo_detect_mmse(y, h, noise_var):
    """Linear MMSE detection: ``(H^H H + sigma^2 I)^{-1} H^H y``.
    ``noise_var``: scalar or broadcastable noise power per RX antenna."""
    y = as_cf32(y)
    h = as_cf32(h, device=y.device)
    hh, a = _gram(h)
    n_tx = h.shape[-1]
    nv = torch.as_tensor(noise_var, dtype=torch.float32, device=y.device)
    a = a + nv * torch.eye(n_tx, dtype=cf32, device=y.device)
    b = (hh @ y[..., None])[..., 0]
    return torch.linalg.solve_ex(a, b[..., None], check_errors=False)[0][..., 0].to(cf32)


def mimo_stream_snr(h, noise_var):
    """Post-detection SNR per spatial stream for the ZF detector: ``1 /
    (noise_var * [(H^H H)^{-1}]_kk)``."""
    h = as_cf32(h)
    _, a = _gram(h)
    inv = torch.linalg.inv_ex(a, check_errors=False)[0]
    diag = torch.diagonal(inv, dim1=-2, dim2=-1).real
    nv = torch.as_tensor(noise_var, dtype=torch.float32, device=h.device)
    return (1.0 / (nv * diag)).to(torch.float32)
