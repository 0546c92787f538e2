"""Blind automatic modulation classification (AMC) by higher-order moments
(PyTorch).

Counterpart of ``aether_primitives_tpu/models/amc.py``. Given baseband
symbols of an unknown linear modulation (after timing recovery and coarse
CFO removal, before any carrier-phase fix), the features ``|C20|``,
``|C40|``, ``m4 = E|x|^4`` and ``m6 = E|x|^6`` (reductions batched over
bursts, on the input's device) are matched against each candidate's exact
signature: each candidate solves its signal fraction from ``m4`` and must
also predict the measured ``m6`` through the signal-plus-noise expansion
``m6 = kappa6 S^3 + 9 kappa4 S^2 N + 18 S N^2 + 6 N^3``. The signatures are
computed from the port's own constellation tables. Only the scores and the
argmin cross to the host, in one read.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from ..ops import modulation as _mod
from ..types import as_cf32


def _signature(table: np.ndarray) -> Tuple[float, float, float, float]:
    """Exact ``(|C20|, |C40|, kappa4, kappa6)`` of a constellation at
    unit power (expectation over the table)."""
    s = np.asarray(table, np.complex128).ravel()
    s = s / np.sqrt(np.mean(np.abs(s) ** 2))
    c20 = np.mean(s**2)
    c40 = np.mean(s**4) - 3.0 * c20**2
    k4 = float(np.mean(np.abs(s) ** 4))
    k6 = float(np.mean(np.abs(s) ** 6))
    return float(np.abs(c20)), float(np.abs(c40)), k4, k6


#: exact per-candidate (|C20|, |C40|, kappa4 = E|s|^4, kappa6 = E|s|^6)
SIGNATURES: Dict[str, Tuple[float, float, float, float]] = {
    "bpsk": _signature(_mod.bpsk().table),
    "qpsk": _signature(_mod.qpsk().table),
    "psk8": _signature(_mod.psk(8).table),
    "qam16": _signature(_mod.qam16().table),
    "qam64": _signature(_mod.qam(64).table),
}


def cumulant_features(x) -> torch.Tensor:
    """``[..., 4]``: ``(|C20|, |C40|, m4, m6)`` of a symbol block (mean
    removed, unit-power normalized; batched over leading axes)."""
    x = as_cf32(x)
    x = x - x.mean(dim=-1, keepdim=True)
    p = (x.real ** 2 + x.imag ** 2).mean(dim=-1, keepdim=True)
    x = x / torch.sqrt(torch.clamp_min(p, 1e-30))
    xx = x * x
    c20 = xx.mean(dim=-1)
    c40 = (xx * xx).mean(dim=-1) - 3.0 * c20 * c20
    a2 = x.real ** 2 + x.imag ** 2
    m4 = (a2 * a2).mean(dim=-1)
    m6 = (a2 * a2 * a2).mean(dim=-1)
    feats = torch.stack([c20.abs(), c40.abs(), m4, m6], dim=-1)
    return feats.to(torch.float32)


#: residual weights: (|C20|, |C40|, m6); m6 spans ~1..2 and carries the
#: QPSK/QAM split, upweighted accordingly
_WEIGHTS = np.array([1.0, 1.0, 3.0], np.float64)


def classify_modulation(
    x,
    candidates: Sequence[str] = ("bpsk", "qpsk", "psk8", "qam16", "qam64"),
):
    """Identify the modulation of a symbol block.

    Returns ``(name, scores)`` for a single block, or ``(names list,
    scores [..., n_candidates])`` for batched input; ``scores`` (numpy
    float32) are the weighted residuals of each candidate's SNR-consistent
    prediction (smaller = closer)."""
    feats = cumulant_features(x)
    dev = feats.device
    c20_m, c40_m = feats[..., 0], feats[..., 1]
    m4, m6 = feats[..., 2], feats[..., 3]
    sig = torch.from_numpy(np.array([SIGNATURES[c] for c in candidates], np.float32)).to(dev)
    k4, k6 = sig[:, 2], sig[:, 3]
    # per-candidate signal fraction from m4: m4 = k4 S^2 + 4SN + 2N^2,
    # S + N = 1  =>  S = sqrt((2 - m4)/(2 - k4))
    s = torch.sqrt(torch.clamp_min(2.0 - m4[..., None], 0.0) / (2.0 - k4))
    s = torch.clamp(s, 1e-3, 1.0)
    n = 1.0 - s
    s2, n2 = s * s, n * n
    m6_pred = k6 * (s * s2) + 9.0 * k4 * s2 * n + 18.0 * s * n2 + 6.0 * (n * n2)
    c20_pred = sig[:, 0] * s
    c40_pred = sig[:, 1] * s * s
    w = [float(np.float32(v)) for v in np.sqrt(_WEIGHTS)]
    d = torch.sqrt(
        (w[0] * (c20_m[..., None] - c20_pred)) ** 2
        + (w[1] * (c40_m[..., None] - c40_pred)) ** 2
        + (w[2] * (m6[..., None] - m6_pred)) ** 2
    )
    scores = d.cpu().numpy()
    idx = np.argmin(scores, axis=-1)
    if idx.ndim == 0:
        return candidates[int(idx)], scores
    names = [candidates[int(i)] for i in idx.ravel()]
    return names, scores
