"""Cross-ambiguity function (CAF): joint delay-Doppler acquisition
(PyTorch).

Counterpart of ``aether_primitives_tpu/models/caf.py``. Under a carrier
offset the signature in a capture is also rotated by an unknown Doppler, and
a plain correlator's peak collapses once the rotation winds through a cycle
over the signature. The cross-ambiguity surface::

    CAF(nu, tau) = sum_n x[n] e^{-j 2 pi nu n} conj(ref[n - tau])

over a grid of Doppler hypotheses ``nu`` (cycles/sample) and every circular
delay ``tau`` is one batched circular correlation: a ``[n_dop, N]`` forward
FFT of the derotated copies, one multiply by ``conj(FFT(ref))``, one batched
inverse (cuFFT through ``torch.fft`` on a card). The derotation angle is
built in float32 in the JAX package's order, ``(-2 pi nu) n``, so the
surfaces agree with its surfaces to float32 rounding. The peak search and
its parabolic refinement read nothing back to the host (tensor indices,
``index_select``).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops import fft as _fft
from ..ops.fft import Scale
from ..parallel import mesh as _mesh
from ..parallel.mesh import TIME_AXIS
from ..types import as_cf32
from .sync import _upload


def _doppler_grid(max_doppler: float, n_dopplers: int) -> np.ndarray:
    """The Doppler hypotheses: ``jnp.linspace(-max_doppler, max_doppler,
    n)``'s float32 arithmetic (``start * (1 - step) + stop * step``, then
    the end point) as host numpy. XLA may contract or reorder that
    expression; the grids then differ in the last place or two (~1e-10
    cycles/sample)."""
    n = int(n_dopplers)
    start, stop = np.float32(-max_doppler), np.float32(max_doppler)
    if n == 1:
        return np.array([start], np.float32)
    div = n - 1
    step = np.arange(div, dtype=np.float32) / np.float32(div)
    out = start * (np.float32(1) - step) + stop * step
    return np.concatenate([out, [stop]]).astype(np.float32)


def ambiguity(
    x, ref, dopplers, fft_backend: Optional[str] = None
) -> torch.Tensor:
    """The complex CAF surface ``[len(dopplers), N]``.

    ``x``: the received block (``[N]`` complex); ``ref``: the known
    signature (zero-padded to ``N`` if shorter); ``dopplers``: Doppler
    hypotheses in cycles/sample. Row ``i`` is the circular correlation of
    ``x`` derotated by ``dopplers[i]`` against ``ref``. On ``x``'s device.
    """
    x = as_cf32(x)
    if x.ndim != 1:
        raise ValueError("ambiguity takes a flat block (batch via vmap)")
    n = x.shape[-1]
    ref = as_cf32(ref, device=x.device)
    if ref.shape[-1] < n:
        ref = torch.nn.functional.pad(ref, (0, n - ref.shape[-1]))
    elif ref.shape[-1] > n:
        raise ValueError("Reference longer than signal")
    nu = torch.as_tensor(dopplers, dtype=torch.float32, device=x.device).reshape(-1)
    ang = -2.0 * math.pi * nu[:, None] * torch.arange(n, dtype=torch.float32, device=x.device)
    bank = x[None, :] * torch.complex(torch.cos(ang), torch.sin(ang))
    plan = _fft.plan(n, fft_backend)
    spec = plan.fwd(bank, Scale.NONE) * plan.fwd(ref, Scale.NONE).conj()
    return plan.bwd(spec, Scale.N)


def _parabolic(ym1, y0, yp1):
    """Sub-bin vertex offset of a parabola through three equally spaced
    magnitudes: 0 when the peak is exactly on-bin, in (-0.5, 0.5)."""
    denom = ym1 - 2.0 * y0 + yp1
    return torch.where(denom.abs() > 1e-30, 0.5 * (ym1 - yp1) / denom,
                       torch.zeros_like(denom))


def estimate_delay_doppler(
    x,
    ref,
    max_doppler: float,
    n_dopplers: int = 64,
    fft_backend: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Joint ``(delay, doppler, peak_metric)`` from the CAF surface over
    ``n_dopplers`` hypotheses uniformly over ``[-max_doppler,
    +max_doppler]``: the surface's peak, refined on both axes by a parabola
    through its neighbours (delay neighbours circular, Doppler neighbours
    clamped to the grid). ``delay`` in fractional samples, ``doppler`` in
    cycles/sample, ``peak_metric = |CAF|^2 / (E_x E_ref)`` (1.0 for a
    perfectly matched lone signature). Float32 tensors on ``x``'s device."""
    x = as_cf32(x)
    nu = _upload(_doppler_grid(max_doppler, n_dopplers), x.device)
    surf = ambiguity(x, ref, nu, fft_backend)
    return _refine_peak(surf, nu, x, ref)


def _pick(v: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``v[i]`` for a 0-d index tensor, on the device (no host read)."""
    return v.index_select(0, i.reshape(1))[0]


def _refine_peak(surf, nu, x, ref):
    """The peak search and parabolic refinement over a CAF surface
    ``[n_dopplers, n]``, shared by the one-device and sharded
    estimators."""
    n = surf.shape[-1]
    mag = surf.abs()
    flat = torch.argmax(mag)
    di, ti = flat // n, flat % n
    # delay refinement (circular neighbours)
    row = _pick(mag, di)
    tau_off = _parabolic(_pick(row, (ti - 1) % n), _pick(row, ti), _pick(row, (ti + 1) % n))
    # doppler refinement (clamped neighbours; off = 0 at the grid edge)
    col = mag.index_select(1, ti.reshape(1))[:, 0]
    nd = col.shape[0]
    dm1 = _pick(col, torch.clamp_min(di - 1, 0))
    dp1 = _pick(col, torch.clamp_max(di + 1, nd - 1))
    nu_off = torch.where((di > 0) & (di < nd - 1), _parabolic(dm1, _pick(col, di), dp1),
                         torch.zeros((), dtype=torch.float32, device=mag.device))
    step = nu[1] - nu[0] if nd > 1 else torch.zeros((), dtype=torch.float32, device=mag.device)
    delay = (ti.to(torch.float32) + tau_off) % n
    doppler = _pick(nu, di) + nu_off * step
    e_x = (x.abs() ** 2).sum()
    e_r = (as_cf32(ref, device=x.device).abs() ** 2).sum()
    metric = (_pick(col, di) ** 2) / (e_x * e_r)
    return delay, doppler, metric


# --------------------------------------------------------------- sharded


def sharded_ambiguity(
    x,
    ref,
    dopplers,
    mesh,
    axis_name: str = TIME_AXIS,
    fft_backend: Optional[str] = None,
):
    """:func:`ambiguity` with the Doppler axis sharded over ``mesh``'s
    ``axis_name``: ``x`` and ``ref`` are replicated to every shard, each
    shard correlates its ``n_dop / n_dev`` hypotheses, and the surface comes
    back as a :class:`~..parallel.mesh.Sharded` value split row-wise (spec
    ``(axis_name, None)``; ``.gather()`` for the tensor). The per-row math
    never crosses shards. ``len(dopplers)`` must divide by the mesh axis
    size."""
    x = as_cf32(x)
    nu = torch.as_tensor(dopplers, dtype=torch.float32).reshape(-1)
    n_dev = mesh.shape[axis_name]
    if nu.shape[0] % n_dev:
        raise ValueError(
            f"{nu.shape[0]} Doppler hypotheses do not divide over "
            f"{n_dev} devices"
        )
    xs = _mesh.shard(x, mesh, ())
    refs = _mesh.shard(as_cf32(ref, device=x.device), mesh, ())
    nus = _mesh.shard(nu, mesh, (axis_name,))
    return nus.map(lambda v, xl, rl: ambiguity(xl, rl, v, fft_backend), xs, refs,
                   spec=(axis_name, None))


def sharded_estimate_delay_doppler(
    x,
    ref,
    max_doppler: float,
    mesh,
    n_dopplers: int = 64,
    axis_name: str = TIME_AXIS,
    fft_backend: Optional[str] = None,
):
    """:func:`estimate_delay_doppler` computing its CAF surface by
    :func:`sharded_ambiguity`; the peak search and refinement run on the
    surface gathered onto the mesh's first device (on a mesh that spans
    processes, all-gathered onto each process's first device, so every
    rank returns the same estimate). Same return contract (tensors on that
    device)."""
    x = as_cf32(x)
    nu = _doppler_grid(max_doppler, n_dopplers)
    surf = _mesh.allgather(sharded_ambiguity(x, ref, nu, mesh, axis_name, fft_backend))
    dev = surf.device
    return _refine_peak(surf, _upload(nu, dev), x.to(dev), as_cf32(ref, device=dev))
