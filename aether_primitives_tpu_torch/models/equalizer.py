"""Adaptive channel equalization (PyTorch): trained / decision-directed LMS,
blind CMA, trained RLS and the frequency-domain adaptive filter.

Counterpart of ``aether_primitives_tpu/models/equalizer.py``, whose
``lax.scan`` bodies are written out here as Python recurrences, a symbol (or
a block, for :func:`fdaf`) a step. The state (weights, the RLS inverse
correlation, the FDAF bin powers) stays a tensor on the input's device and a
step reads nothing back to the host: the decision-directed slicer is an
on-device ``argmin`` gathered with ``index_select``, and everything that
does not depend on the state (the sliding windows, their conjugates and
energies, the step constants) is made before the loop. Each float32
expression keeps the JAX package's order of operations (``mu / en`` before
``* e * conj(row)``): the recurrences compound rounding, so a reordered sum
would show up as drift. RLS keeps that order too, in complex128: its float32
recurrence turns NaN (see :func:`rls_equalize`).

Convention: equalizer output ``y[i] = sum_t w[t] * x[i - t]`` (causal
window), decisions/training aligned so ``y[i]`` estimates ``d[i]``; pick a
``delay`` roughly ``ntaps // 2`` samples into the training sequence for a
centered channel inverse.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..ops import fft as _fft
from ..types import as_cf32, cf32
from .sync import _upload


def _f32(v) -> float:
    """A constant rounded to float32, as the JAX package's ``jnp.float32``."""
    return float(np.float32(v))


def _sliding(x: torch.Tensor, ntaps: int) -> torch.Tensor:
    """``[n, ntaps]`` causal windows ``rows[i, t] = x[i - t]`` (zeros before
    the start) from ``ntaps`` stride-1 slices."""
    n = x.shape[-1]
    xp = torch.nn.functional.pad(x, (ntaps - 1, 0))
    return torch.stack([xp[..., ntaps - 1 - t:ntaps - 1 - t + n] for t in range(ntaps)], dim=-1)


def _steps(mu: float, rows: torch.Tensor) -> torch.Tensor:
    """Each window's NLMS step ``mu / en``, ``en`` its energy plus 1e-12
    (a true division: ``float / tensor`` would multiply by a reciprocal)."""
    en = (rows.real ** 2 + rows.imag ** 2).sum(dim=-1) + 1e-12
    return torch.full_like(en, _f32(mu)) / en


def _w_init(w0, ntaps: int, device) -> torch.Tensor:
    """The initial weights: a copy of ``w0``, or a unit first tap."""
    if w0 is None:
        w = torch.zeros(ntaps, dtype=cf32, device=device)
        w[:1].fill_(1.0)  # a fill kernel: item assignment would copy from the host
        return w
    return as_cf32(w0, device=device).clone()


def lms_equalize(
    x,
    training,
    ntaps: int = 11,
    mu: float = 0.01,
    delay: int = 0,
    w0=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Trained normalized LMS: adapt ``w`` over the training span, then run
    the final weights over the whole input. ``y[i]`` estimates
    ``training[i - delay]``. Returns ``(y, w, err)``: the equalized stream
    (full length, the final weights), the final ``[ntaps]`` weights and the
    per-step training error magnitudes. The update divides by the window
    energy (stable for ``0 < mu < 2``)."""
    x = as_cf32(x)
    dev = x.device
    d = as_cf32(training, device=dev)
    rows = _sliding(x, ntaps)  # [n, ntaps]
    m = min(int(d.shape[-1]), rows.shape[0] - int(delay))
    d = d[:m]
    train_rows = rows[delay:delay + m]
    w = _w_init(w0, ntaps, dev)
    step = _steps(mu, train_rows)
    conj_rows = train_rows.conj().resolve_conj()
    errs = []
    for i in range(m):
        y = (w * train_rows[i]).sum()
        e = d[i] - y
        w = w + step[i] * e * conj_rows[i]
        errs.append(e)
    err = torch.stack(errs).abs() if errs else torch.zeros(0, dtype=torch.float32, device=dev)
    y = torch.matmul(rows, w)
    return y.to(cf32), w, err


def dd_equalize(
    x,
    table,
    ntaps: int = 11,
    mu: float = 0.01,
    w0=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decision-directed LMS: the training signal is the nearest
    constellation point of the equalizer's own output (run it after
    :func:`lms_equalize` has opened the eye; pass its ``w`` as ``w0``).
    ``table``: constellation points. Returns ``(y, w)``, ``y`` the adapting
    output (each sample from the weights as of that step)."""
    x = as_cf32(x)
    dev = x.device
    pts = _upload(np.asarray(table, np.complex64), dev)
    rows = _sliding(x, ntaps)
    w = _w_init(w0, ntaps, dev)
    step = _steps(mu, rows)
    conj_rows = rows.conj().resolve_conj()
    ys = []
    for i in range(rows.shape[0]):
        y = (w * rows[i]).sum()
        d2 = (pts - y).abs() ** 2
        dec = pts.index_select(0, torch.argmin(d2).reshape(1))[0]
        e = dec - y
        w = w + step[i] * e * conj_rows[i]
        ys.append(y)
    y = torch.stack(ys) if ys else x[:0]
    return y.to(cf32), w


def fdaf(
    x,
    d,
    ntaps: int,
    mu: float = 0.5,
    forget: float = 0.9,
    eps: float = 1e-6,
    fft_backend=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Frequency-domain adaptive filter (constrained overlap-save block
    NLMS): identify/track the system mapping ``x -> d`` with one weight
    update per ``B``-sample block, every step five ``2B``-point FFTs and
    elementwise math; each bin's step is normalized by its running input
    power and the gradient is projected back to causal length-``B``
    support. ``B`` is the smallest power of two >= ``ntaps``. Returns ``(y,
    w, err)``: the adapting output (length of ``x``), the final ``[ntaps]``
    time-domain weights and the per-block RMS error."""
    x = as_cf32(x)
    dev = x.device
    dd = as_cf32(d, device=dev)
    n = x.shape[-1]
    if dd.shape[-1] != n:
        raise ValueError("x and d must have equal lengths")
    b = 1
    while b < ntaps:
        b *= 2
    nfft = 2 * b
    nb = -(-n // b)
    npad = nb * b
    if npad != n:
        x = torch.nn.functional.pad(x, (0, npad - n))
        dd = torch.nn.functional.pad(dd, (0, npad - n))
    xb = x.reshape(nb, b)
    db = dd.reshape(nb, b)
    plan = _fft.plan(nfft, fft_backend)
    scale_n, none = _fft.Scale.N, _fft.Scale.NONE
    mu, lam = _f32(mu), _f32(forget)
    one_m_lam = _f32(np.float32(1.0) - np.float32(forget))
    eps32 = _f32(eps)
    zeros_b = torch.zeros(b, dtype=cf32, device=dev)
    w = torch.zeros(nfft, dtype=cf32, device=dev)
    p = torch.full((nfft,), eps32, dtype=torch.float32, device=dev)
    prev = zeros_b
    ys, es = [], []
    for i in range(nb):
        xcur = xb[i]
        xf = plan.fwd(torch.cat([prev, xcur]), none)
        y = plan.bwd(xf * w, scale_n)[b:]
        e = db[i] - y
        ef = plan.fwd(torch.cat([zeros_b, e]), none)
        p = lam * p + one_m_lam * (xf.real ** 2 + xf.imag ** 2)
        g = xf.conj() * ef / (p + eps32)
        # gradient constraint: causal length-B support
        gt = plan.bwd(g, scale_n)
        g = plan.fwd(torch.cat([gt[:b], zeros_b]), none)
        w = w + mu * g
        ys.append(y)
        es.append(e)
        prev = xcur
    e_all = torch.stack(es)
    err = torch.sqrt((e_all.real ** 2 + e_all.imag ** 2).mean(dim=-1))
    y = torch.stack(ys).reshape(npad)[:n]
    w_time = plan.bwd(w, scale_n)[:ntaps]
    return y.to(cf32), w_time.to(cf32), err


def cma_equalize(
    x,
    ntaps: int = 11,
    mu: float = 0.005,
    r2: Optional[float] = None,
    w0=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blind constant-modulus (Godard) equalizer: drives ``|y|^2`` toward
    ``r2`` (1.0 for unit PSK, the default) with no training. Phase-blind.
    Returns ``(y, w)`` with ``y`` the adapting output."""
    x = as_cf32(x)
    dev = x.device
    rows = _sliding(x, ntaps)
    w = _w_init(w0, ntaps, dev)
    step = _steps(mu, rows)
    conj_rows = rows.conj().resolve_conj()
    r2 = _f32(1.0 if r2 is None else r2)
    ys = []
    for i in range(rows.shape[0]):
        y = (w * rows[i]).sum()
        e = y * (y.abs() ** 2 - r2)  # Godard-2 gradient term
        w = w - step[i] * e * conj_rows[i]
        ys.append(y)
    y = torch.stack(ys) if ys else x[:0]
    return y.to(cf32), w


def rls_equalize(
    x,
    training,
    ntaps: int = 11,
    lam: float = 0.99,
    delta: float = 0.01,
    delay: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Trained RLS (recursive least squares): the contract of
    :func:`lms_equalize`, converging in ~2*ntaps symbols. The state is an
    ``[ntaps, ntaps]`` inverse correlation updated a step. ``lam``:
    forgetting factor; ``delta``: initial inverse-correlation scale (P0 =
    I/delta).

    The recurrence runs in complex128 on the input's device and the results
    come back as complex64 / float32: in float32 the inverse correlation
    loses its symmetry over a few hundred steps and the weights turn NaN
    (in the JAX package's float32 form too), which float64 does not."""
    x = as_cf32(x)
    dev = x.device
    d = as_cf32(training, device=dev)
    rows = _sliding(x, ntaps).to(torch.complex128)
    m = min(int(d.shape[-1]), rows.shape[0] - int(delay))
    d = d[:m].to(torch.complex128)
    train_rows = rows[delay:delay + m]
    conj_rows = train_rows.conj().resolve_conj()
    w = torch.zeros(ntaps, dtype=torch.complex128, device=dev)
    p = torch.eye(ntaps, dtype=torch.complex128, device=dev) / float(delta)
    lam = float(lam)
    errs = []
    for i in range(m):
        u = train_rows[i]  # regression row
        pu = p @ u
        denom = lam + (conj_rows[i] * pu).sum()
        k = pu / denom
        e = d[i] - (w.conj() * u).sum()
        w = w + k * e.conj()
        p = (p - k[:, None] * pu.conj()[None, :]) / lam
        errs.append(e)
    err = (torch.stack(errs).abs().to(torch.float32) if errs
           else torch.zeros(0, dtype=torch.float32, device=dev))
    y = torch.matmul(rows, w.conj())
    return y.to(cf32), w.conj().resolve_conj().to(cf32), err
