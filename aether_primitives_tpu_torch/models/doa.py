"""Direction-of-arrival estimation and beamforming for antenna arrays
(PyTorch).

Counterpart of ``aether_primitives_tpu/models/doa.py``. A multi-element
capture ``[n_elem, T]`` (with any leading window axes) yields bearings by
subspace (MUSIC) or adaptive-spectrum (Capon/MVDR) methods, and steering
weights for delay-and-sum or MVDR beamforming. Everything is small dense
linear algebra batched over an angle grid: the steering matrix ``[G, M]``
against the ``[M, M]`` covariance, ``torch.linalg.eigh`` of the covariance,
and peaks as a masked top-K over the static grid. Angles are radians from
broadside; ``d_lambda`` is the element spacing in wavelengths.

On a card the complex matmuls run in full float32 (TF32 does not apply to
them unless a caller enables it), and the solves use
``torch.linalg.solve_ex(check_errors=False)`` (no read of an error flag).
``torch.linalg.eigh`` reads its convergence flag back to the host, by
design of the library call. The eigenvectors' phases differ between
LAPACK and cuSOLVER; the MUSIC spectrum (a projection norm) does not depend
on them. The JAX package's ``lax.top_k`` puts the lower index first among
equal values (the masked ``-inf`` entries tie where there are fewer peaks
than sources); the port takes the first K of a stable descending sort,
which orders them the same way.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..parallel import mesh as _mesh
from ..types import as_cf32, cf32
from .sync import _upload

__all__ = [
    "steering_vector",
    "steering_vector_pos",
    "covariance",
    "spatial_smoothing",
    "music_spectrum",
    "music_spectrum_2d",
    "capon_spectrum",
    "estimate_doa",
    "estimate_doa_2d",
    "sharded_estimate_doa",
    "beamform",
    "mvdr_weights",
]


def _cis(phase: torch.Tensor) -> torch.Tensor:
    """``e^{j phase}`` of a float32 phase, as ``cos + j sin``."""
    return torch.complex(torch.cos(phase), torch.sin(phase))


def steering_vector(n_elem: int, theta, d_lambda: float = 0.5) -> torch.Tensor:
    """ULA steering vector(s) ``a(theta) [.., M]``: ``a_m = e^{-2 pi i m d
    sin(theta)}`` (phase reference element 0, angle from broadside). On
    ``theta``'s device."""
    th = torch.as_tensor(theta, dtype=torch.float32)
    m = torch.arange(n_elem, dtype=torch.float32, device=th.device)
    phase = -2.0 * math.pi * d_lambda * torch.sin(th)[..., None] * m
    return _cis(phase)


def steering_vector_pos(positions, az, el=0.0) -> torch.Tensor:
    """Steering vector(s) for an arbitrary array geometry: ``positions [M,
    2 or 3]`` element coordinates in wavelengths (host numpy; x = "right",
    y = boresight, z = "up"), ``az`` azimuth from boresight toward +x,
    ``el`` elevation toward +z (radians; broadcastable). ``a_m = e^{-2 pi i
    p_m . u(az, el)}`` with ``u = (sin az cos el, cos az cos el, sin el)``.
    On ``az``'s device."""
    p = np.asarray(positions, np.float32)
    if p.ndim != 2 or p.shape[1] not in (2, 3):
        raise ValueError("positions must be [M, 2] or [M, 3] (wavelengths)")
    if p.shape[1] == 2:
        p = np.concatenate([p, np.zeros((p.shape[0], 1), np.float32)], axis=1)
    az = torch.as_tensor(az, dtype=torch.float32)
    el = torch.as_tensor(el, dtype=torch.float32, device=az.device)
    u = torch.stack(
        torch.broadcast_tensors(
            torch.sin(az) * torch.cos(el),
            torch.cos(az) * torch.cos(el),
            torch.sin(el) * torch.ones_like(az),
        ),
        dim=-1,
    )  # [.., 3]
    pt = torch.from_numpy(p).to(az.device)
    phase = -2.0 * math.pi * torch.matmul(u, pt.T)
    return _cis(phase)


def covariance(x) -> torch.Tensor:
    """Sample spatial covariance ``R = X X^H / T`` from snapshots ``[.., M,
    T]`` (a full-precision complex64 matmul)."""
    x = as_cf32(x)
    t = x.shape[-1]
    return torch.matmul(x, x.conj().transpose(-1, -2)) / float(np.float32(t))


def spatial_smoothing(r, n_sub: int) -> torch.Tensor:
    """Forward spatial smoothing: the mean of the ``n_sub`` leading-diagonal
    ``[M-n_sub+1, ...]`` subarray covariances (restores rank for coherent
    sources at the cost of aperture)."""
    r = as_cf32(r)
    m = r.shape[-1]
    ms = m - n_sub + 1
    acc = None
    for s in range(n_sub):
        blk = r[..., s:s + ms, s:s + ms]
        acc = blk if acc is None else acc + blk
    return acc / float(np.float32(n_sub))


def _grid(n_grid: int) -> np.ndarray:
    # open interval: endfire angles alias for a ULA
    return np.linspace(-np.pi / 2 * 0.98, np.pi / 2 * 0.98, n_grid).astype(
        np.float32
    )


def _noise_subspace(r: torch.Tensor, n_sources: int) -> torch.Tensor:
    """The eigenvectors of the ``M - K`` smallest eigenvalues of ``r``."""
    m = r.shape[-1]
    _w, v = torch.linalg.eigh(r)  # ascending eigenvalues
    return v[..., :m - n_sources]


def _music(a: torch.Tensor, en: torch.Tensor) -> torch.Tensor:
    """``1 / ||E_n^H a||^2`` for every steering vector row of ``a``."""
    proj = torch.matmul(a.conj(), en)  # [.., G, M-K]
    denom = (proj.abs() ** 2).sum(dim=-1)
    return 1.0 / (denom + 1e-12)


def music_spectrum(
    r,
    n_sources: int,
    n_grid: int = 721,
    d_lambda: float = 0.5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """MUSIC pseudo-spectrum over a static angle grid: ``r [.., M, M]`` ->
    ``(angles [G], spectrum [.., G])`` with ``P(theta) = 1 / ||E_n^H
    a(theta)||^2``."""
    r = as_cf32(r)
    m = r.shape[-1]
    en = _noise_subspace(r, n_sources)  # [.., M, M-K]
    grid = _upload(_grid(n_grid), r.device)
    a = steering_vector(m, grid, d_lambda)  # [G, M]
    return grid, _music(a, en)


def music_spectrum_2d(
    r,
    n_sources: int,
    positions,
    n_az: int = 181,
    n_el: int = 61,
    el_max: float = np.pi / 3,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Joint azimuth/elevation MUSIC for an arbitrary (planar/3-D) array:
    ``(az_grid [Ga], el_grid [Ge], spectrum [.., Ga, Ge])``, the projection
    evaluated on the full grid as one ``[Ga*Ge, M] x [M, M-K]`` matmul."""
    r = as_cf32(r)
    en = _noise_subspace(r, n_sources)
    az = np.linspace(-np.pi / 2 * 0.98, np.pi / 2 * 0.98, n_az).astype(np.float32)
    el = np.linspace(-el_max, el_max, n_el).astype(np.float32)
    azg, elg = np.meshgrid(az, el, indexing="ij")
    a = steering_vector_pos(
        positions, _upload(azg.ravel(), r.device), _upload(elg.ravel(), r.device)
    )  # [Ga*Ge, M]
    spec = _music(a, en)
    spec = spec.reshape(spec.shape[:-1] + (n_az, n_el))
    return _upload(az, r.device), _upload(el, r.device), spec


def _top_k(v: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest entries along the last axis, the lower
    index first among equal values (``lax.top_k``'s order)."""
    return torch.sort(v, dim=-1, descending=True, stable=True)[1][..., :k]


def estimate_doa_2d(
    x,
    n_sources: int,
    positions,
    n_az: int = 181,
    n_el: int = 61,
    el_max: float = np.pi / 3,
) -> torch.Tensor:
    """``[K, 2]`` (azimuth, elevation) bearings from snapshots ``x [M, T]``
    of an arbitrary-geometry array, via 2-D MUSIC: the top-K local maxima
    of the az/el surface (3x3 neighbourhood), sorted by azimuth."""
    az, el, s = music_spectrum_2d(
        covariance(x), n_sources, positions, n_az, n_el, el_max
    )
    pad = torch.nn.functional.pad(s, (1, 1, 1, 1), value=-math.inf)
    is_peak = torch.ones_like(s, dtype=torch.bool)
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            if di == 0 and dj == 0:
                continue
            nb = pad[1 + di:1 + di + s.shape[0], 1 + dj:1 + dj + s.shape[1]]
            is_peak = is_peak & (s >= nb)
    masked = torch.where(is_peak, s, -math.inf).reshape(-1)
    idx = _top_k(masked, n_sources)
    ai = idx // el.shape[0]
    ei = idx % el.shape[0]
    pairs = torch.stack([az[ai], el[ei]], dim=-1)  # [K, 2]
    order = torch.argsort(pairs[:, 0], stable=True)
    return pairs[order]


def _loaded(r: torch.Tensor, diagonal_load: float) -> torch.Tensor:
    """``r`` plus ``diagonal_load`` times its mean diagonal on the diagonal."""
    m = r.shape[-1]
    trace = torch.diagonal(r, dim1=-2, dim2=-1).sum(dim=-1).real
    load = diagonal_load * trace / m
    return r + load[..., None, None] * torch.eye(m, dtype=cf32, device=r.device)


def capon_spectrum(
    r,
    n_grid: int = 721,
    d_lambda: float = 0.5,
    diagonal_load: float = 1e-3,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capon (MVDR) spatial spectrum ``P(theta) = 1 / (a^H R^{-1} a)``;
    ``diagonal_load`` regularizes the inverse (x mean diagonal)."""
    r = as_cf32(r)
    m = r.shape[-1]
    rl = _loaded(r, diagonal_load)
    grid = _upload(_grid(n_grid), r.device)
    a = steering_vector(m, grid, d_lambda)  # [G, M]
    # one solve of the loaded matrix against an [M, G] right-hand side (the
    # JAX package broadcasts the matrix to [.., G, M, M]: the same factors)
    ri_a = torch.linalg.solve_ex(rl, a.T, check_errors=False)[0].transpose(-1, -2)
    denom = (a.conj() * ri_a).sum(dim=-1).real
    return grid, 1.0 / (denom + 1e-12)


def _peaks(angles, spec, n_sources: int):
    """Top-``n_sources`` local maxima with parabolic refinement."""
    s = spec
    left = torch.cat([s[..., :1], s[..., :-1]], dim=-1)
    right = torch.cat([s[..., 1:], s[..., -1:]], dim=-1)
    is_peak = (s >= left) & (s > right)
    masked = torch.where(is_peak, s, -math.inf)
    idx = _top_k(masked, n_sources)  # [.., K]
    step = angles[1] - angles[0]
    i0 = torch.clamp(idx, 1, angles.shape[0] - 2)
    sm = s.gather(-1, i0 - 1)
    s0 = s.gather(-1, i0)
    sp = s.gather(-1, i0 + 1)
    delta = 0.5 * (sm - sp) / (sm - 2 * s0 + sp + 1e-20)
    return angles[i0] + torch.clamp(delta, -1.0, 1.0) * step


def estimate_doa(
    x,
    n_sources: int,
    method: str = "music",
    n_grid: int = 721,
    d_lambda: float = 0.5,
    smoothing: Optional[int] = None,
) -> torch.Tensor:
    """Bearings (radians from broadside, sorted) of ``n_sources`` from
    snapshots ``x [.., M, T]``. ``method``: "music" | "capon".
    ``smoothing``: forward spatial smoothing order for coherent sources."""
    r = covariance(x)
    if smoothing:
        r = spatial_smoothing(r, smoothing)
    if method == "music":
        ang, spec = music_spectrum(r, n_sources, n_grid, d_lambda)
    elif method == "capon":
        ang, spec = capon_spectrum(r, n_grid, d_lambda)
    else:
        raise ValueError(f"unknown DOA method {method!r}")
    return torch.sort(_peaks(ang, spec, n_sources), dim=-1)[0]


def beamform(x, theta, d_lambda: float = 0.5) -> torch.Tensor:
    """Delay-and-sum beamformer: steer ``x [.., M, T]`` to ``theta`` ->
    ``[.., T]`` (unit gain toward ``theta``)."""
    x = as_cf32(x)
    m = x.shape[-2]
    theta = torch.as_tensor(theta, dtype=torch.float32, device=x.device)
    w = steering_vector(m, theta, d_lambda) / float(np.float32(m))
    return torch.matmul(w.conj()[..., None, :], x)[..., 0, :]


def mvdr_weights(r, theta, d_lambda: float = 0.5,
                 diagonal_load: float = 1e-3) -> torch.Tensor:
    """MVDR (Capon) weights ``w = R^{-1} a / (a^H R^{-1} a)``: unit gain
    toward ``theta``, interference + noise power minimized. Apply as
    ``einsum('...m,...mt->...t', conj(w), x)``."""
    r = as_cf32(r)
    m = r.shape[-1]
    rl = _loaded(r, diagonal_load)
    theta = torch.as_tensor(theta, dtype=torch.float32, device=r.device)
    a = steering_vector(m, theta, d_lambda)
    ri_a = torch.linalg.solve_ex(rl, a[..., None], check_errors=False)[0][..., 0]
    return ri_a / (a.conj() * ri_a).sum(dim=-1, keepdim=True)


def sharded_estimate_doa(
    x,
    n_sources: int,
    mesh,
    axis_name: str = "channel",
    method: str = "music",
    n_grid: int = 721,
    d_lambda: float = 0.5,
    smoothing: Optional[int] = None,
):
    """:func:`estimate_doa` over a window batch ``x [W, M, T]`` with the
    window axis sharded over ``mesh``'s ``axis_name``: each shard runs the
    whole covariance + eigh + grid + peak pipeline on its ``W / n_dev``
    windows (no exchange between shards). Returns the ``[W, K]`` sorted
    bearings as a :class:`~..parallel.mesh.Sharded` value (``.gather()``
    for the tensor). ``W`` must divide by the mesh axis size."""
    x = x if isinstance(x, _mesh.Sharded) else as_cf32(x)
    if x.ndim != 3:
        raise ValueError(f"expected [W, M, T] windows, got shape {tuple(x.shape)}")
    n_dev = mesh.shape[axis_name]
    if x.shape[0] % n_dev:
        raise ValueError(
            f"{x.shape[0]} windows do not divide over {n_dev} devices"
        )
    xs = _mesh.shard(x, mesh, (axis_name,))
    return xs.map(lambda w: estimate_doa(w, n_sources, method, n_grid, d_lambda, smoothing))
