"""Acquisition and carrier recovery for the burst receiver (PyTorch).

Counterpart of ``aether_primitives_tpu/models/sync.py``, burst-link subset,
every function batched over leading axes:

- :func:`detect_preamble`: overlap-save matched filter, argmax of ``|y|^2``;
- :func:`estimate_cfo`: Schmidl & Cox over two repeated halves;
- :func:`estimate_cfo_blind`: periodogram peak of ``x^M`` (M-PSK), with a
  parabolic refinement;
- :func:`estimate_phase_mpsk`: Viterbi & Viterbi M-th power phase;
- :func:`apply_freq_shift`: mix by ``e^{-j 2 pi f n}``.

Arithmetic follows the JAX package's order (``x^4`` as two squarings, the
angle of a float32 sum, the rotation ``-2 pi f n`` in float32), so results
agree with it to float32 rounding.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..ops import fft as _fft
from ..ops import fir as _fir
from ..types import as_cf32


def detect_preamble(x, preamble, fft_backend: Optional[str] = None):
    """``(offset, peak_metric)`` of the best preamble alignment in ``x``
    ``[..., n]``: ``offset`` (int64) is where the preamble's first sample
    sits, ``peak_metric`` is ``|correlation|^2 / energy(preamble)^2``
    (1.0 for a clean hit). ``fft_backend``: see
    :func:`~aether_primitives_tpu_torch.ops.fft.check_backend`."""
    x = as_cf32(x)
    pre = np.asarray(preamble, dtype=np.complex64)
    y = _fir.matched_filter(x, pre, fft_backend=fft_backend)
    mag2 = y.real ** 2 + y.imag ** 2
    peak_pos = torch.argmax(mag2, dim=-1)
    energy = float(np.sum(np.abs(pre) ** 2))
    peak_val = mag2.gather(-1, peak_pos[..., None])[..., 0]
    # the matched filter peaks at offset + len(pre) - 1 (causal convention)
    offset = peak_pos - (pre.shape[-1] - 1)
    return offset, peak_val / float(np.float32(energy ** 2))


def estimate_cfo(x, rep_len: int) -> torch.Tensor:
    """CFO in cycles/sample from ``x`` starting with two identical
    ``rep_len``-sample halves: ``angle(sum x[n + rep] conj x[n]) / (2 pi
    rep)``. Unambiguous for ``|f| < 1 / (2 rep)``."""
    x = as_cf32(x)
    a = x[..., :rep_len]
    b = x[..., rep_len:2 * rep_len]
    corr = (b * a.conj()).sum(dim=-1)
    return torch.angle(corr) / float(np.float32(2.0 * math.pi * rep_len))


def _pow_m(x: torch.Tensor, m: int) -> torch.Tensor:
    """``x^m`` by repeated squaring (the JAX package's integer power)."""
    acc, base = None, x
    while m:
        if m & 1:
            acc = base if acc is None else acc * base
        m >>= 1
        if m:
            base = base * base
    return acc


def _peak_refined(mag: torch.Tensor, nfft: int):
    """Argmax bin of ``mag [..., nfft]`` refined by a parabola through its
    neighbours: float32 bin position."""
    k = torch.argmax(mag, dim=-1)
    km1 = mag.gather(-1, ((k - 1) % nfft)[..., None])[..., 0]
    k0 = mag.gather(-1, k[..., None])[..., 0]
    kp1 = mag.gather(-1, ((k + 1) % nfft)[..., None])[..., 0]
    denom = km1 - 2.0 * k0 + kp1
    off = torch.where(denom.abs() > 1e-30, 0.5 * (km1 - kp1) / denom,
                      torch.zeros_like(denom))
    return k.to(torch.float32) + off


def estimate_cfo_blind(x, m: int = 4, osr: int = 4) -> torch.Tensor:
    """Blind CFO (cycles/sample) of M-PSK symbols ``[..., n]``: the
    periodogram peak of ``x^M``, zero-padded ``osr`` times past the next
    power of two, divided by ``M``. Unambiguous for ``|f| < 1 / (2 M)``."""
    x = as_cf32(x)
    z = _pow_m(x, m)
    n = z.shape[-1]
    nfft = int(osr) * int(2 ** np.ceil(np.log2(max(n, 2))))
    zp = torch.nn.functional.pad(z, (0, nfft - n))
    mag = _fft.plan(nfft).fwd(zp).abs()
    kf = _peak_refined(mag, nfft)
    kf = torch.where(kf > nfft / 2, kf - nfft, kf)  # signed frequency
    return kf / float(nfft * m)


def _mpsk_grid_ref(m: int, grid: str) -> complex:
    """M-th-power reference of the constellation grid: ``"diagonal"`` (the
    package's BPSK/QPSK tables, points at ``pi/M + 2 pi k/M``) powers to
    ``e^{j pi}``; ``"axes"`` (index-linear ``psk`` tables, points at
    ``2 pi k/M``) powers to ``e^{j 0}``."""
    if grid == "diagonal":
        return complex(np.exp(-1j * np.pi))
    if grid == "axes":
        return 1.0 + 0.0j
    raise ValueError(f"grid must be 'diagonal' or 'axes', got {grid!r}")


def estimate_phase_mpsk(x, m: int = 4, grid: str = "diagonal") -> torch.Tensor:
    """Feedforward M-PSK phase (radians, in ``[-pi/M, pi/M)``): ``angle(
    sum x^M * ref) / M`` with the reference rotation of the constellation
    grid (:func:`_mpsk_grid_ref`: the diagonal BPSK/QPSK tables by
    default, ``(e^{j pi/4})^4 = -1``; ``"axes"`` for ``psk`` tables)."""
    ref = np.complex64(_mpsk_grid_ref(m, grid))
    x = as_cf32(x)
    acc = _pow_m(x, m).sum(dim=-1)
    acc = acc * torch.tensor(ref, device=x.device)
    return torch.angle(acc) / float(m)


def apply_freq_shift(x, cycles_per_sample) -> torch.Tensor:
    """Mix ``x [..., n]`` by ``e^{-j 2 pi f n}`` (undo a +f CFO); ``f`` is
    a float or a tensor of the batch shape (one CFO per row)."""
    x = as_cf32(x)
    n = torch.arange(x.shape[-1], dtype=torch.float32, device=x.device)
    f = torch.as_tensor(cycles_per_sample, dtype=torch.float32, device=x.device)
    if f.ndim:
        f = f[..., None]  # per-row CFOs broadcast against the sample index
    ang = -2.0 * math.pi * f * n
    return x * torch.complex(torch.cos(ang), torch.sin(ang))
