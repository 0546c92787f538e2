"""Detection and spectrum sensing (PyTorch): energy detectors with a
calibrated false-alarm rate, cell-averaging CFAR and the cyclostationary
detector.

Counterpart of ``aether_primitives_tpu/models/detect.py``:

- :func:`energy_detect`: block energy against a threshold calibrated to a
  false-alarm probability from the exact chi-square statistics of complex
  AWGN (:func:`energy_threshold_factor`, host scipy);
- :func:`ca_cfar`: 1-D cell-averaging CFAR, the noise level re-estimated
  per cell from training cells around a guard interval (cumulative-sum
  differences);
- :func:`burst_mask` / :func:`mask_to_segments`: a per-sample burst mask
  and its host conversion to ``(start, stop)`` segments;
- :func:`cyclostationary_detect`: the symbol-rate line of the squared
  envelope against the periodogram's median floor, for signals below the
  noise floor.

Batched over leading axes, on the input's device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..ops import fft as _fft
from ..ops._stats import median_midpoint
from ..types import as_cf32


def energy_threshold_factor(n: int, pfa: float) -> float:
    """Threshold factor ``t`` with ``P(mean|w|^2 > t sigma^2) = pfa`` for
    ``n`` complex AWGN samples: ``sum |w|^2 / sigma^2`` is Gamma(n, 1), so
    ``t = gammaincinv(n, 1 - pfa) / n`` (host, exact)."""
    from scipy.special import gammaincinv

    return float(gammaincinv(n, 1.0 - pfa) / n)


def energy_detect(x, block_len: int, noise_power: float,
                  pfa: float = 1e-3) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise energy detector: ``block_len`` blocks whose mean power
    exceeds ``noise_power * energy_threshold_factor(block_len, pfa)``.
    Returns ``(detected [..., n_blocks] bool, mean_power [..., n_blocks])``;
    the length must divide by ``block_len``."""
    x = as_cf32(x)
    n = x.shape[-1]
    if n % block_len:
        raise ValueError(f"length {n} not divisible by block_len {block_len}")
    p = x.real ** 2 + x.imag ** 2
    mean_p = p.reshape(p.shape[:-1] + (-1, block_len)).mean(dim=-1)
    thresh = noise_power * energy_threshold_factor(block_len, pfa)
    return mean_p > float(np.float32(thresh)), mean_p


def ca_cfar(power, train: int = 16, guard: int = 2,
            pfa: float = 1e-3) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cell-averaging CFAR over the last axis of a power series: each
    cell's noise level is the mean of the ``2 * train`` training cells
    around a ``2 * guard + 1`` guard interval (one-sided at the edges), and
    the cell fires above ``alpha * noise`` with ``alpha = N (pfa^{-1/N} -
    1)`` for its actual training count ``N``. Returns ``(detected bool,
    local_noise)``, both shaped like ``power``."""
    p = torch.as_tensor(power, dtype=torch.float32)
    n = p.shape[-1]
    w, g = int(train), int(guard)
    span = w + g
    # padded cumsum for window sums: sum p[i:j] = cs[j] - cs[i]
    # accumulated in float64, each sum rounded to float32 once (the CPU's
    # float32 cumsum; a float32 scan on the card rounds its partial sums)
    cs = torch.cumsum(torch.nn.functional.pad(p, (1, 0)), dim=-1,
                      dtype=torch.float64).to(torch.float32)
    idx = torch.arange(n, device=p.device)
    lo_a = torch.clamp(idx - span, 0, n)  # left training window [lo_a, lo_b)
    lo_b = torch.clamp(idx - g, 0, n)
    hi_a = torch.clamp(idx + g + 1, 0, n)  # right training window [hi_a, hi_b)
    hi_b = torch.clamp(idx + span + 1, 0, n)
    left = cs[..., lo_b] - cs[..., lo_a]
    right = cs[..., hi_b] - cs[..., hi_a]
    count = (lo_b - lo_a + hi_b - hi_a).to(torch.float32)
    noise = (left + right) / torch.clamp(count, min=1.0)
    # per-cell alpha for the actual training count (edges are one-sided)
    alpha = count * (torch.pow(float(pfa), -1.0 / torch.clamp(count, min=1.0)) - 1.0)
    return p > alpha * noise, noise


def burst_mask(x, block_len: int, noise_power: float, pfa: float = 1e-3) -> torch.Tensor:
    """Sample-resolution burst presence mask: :func:`energy_detect`'s block
    verdicts repeated ``block_len`` times (feed :func:`mask_to_segments`)."""
    det, _ = energy_detect(x, block_len, noise_power, pfa)
    return torch.repeat_interleave(det, block_len, dim=-1)


def mask_to_segments(mask) -> np.ndarray:
    """Host: a boolean presence mask as an ``[k, 2]`` array of ``(start,
    stop)`` sample indices (stop exclusive); the size depends on the data."""
    if isinstance(mask, torch.Tensor):
        mask = mask.cpu().numpy()
    m = np.asarray(mask).astype(np.int8)
    d = np.diff(np.concatenate([[0], m, [0]]))
    starts = np.where(d == 1)[0]
    stops = np.where(d == -1)[0]
    return np.stack([starts, stops], axis=1)


def cyclostationary_detect(x, baud_min: float = 0.02,
                           osr: int = 4) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cyclostationary feature detection of a pulse-shaped digital signal,
    down to below the noise floor: the peak of the mean-removed squared
    envelope's periodogram over rates ``(baud_min, 0.5]`` divided by the
    band's median (the midpoint of the middle pair, as ``jnp.median``).
    Returns ``(statistic, rate)``: the line-to-floor ratio (pure noise
    measures ~8; threshold ~10-20) and the candidate baud (cycles/sample),
    float32."""
    x = as_cf32(x)
    env = x.real ** 2 + x.imag ** 2
    env = env - env.mean(dim=-1, keepdim=True)
    n = env.shape[-1]
    nfft = int(osr) * int(2 ** np.ceil(np.log2(max(n, 2))))
    ez = torch.nn.functional.pad(env.to(torch.complex64), (0, nfft - n))
    mag = _fft.plan(nfft).fwd(ez, _fft.Scale.NONE).abs()
    k_lo = int(np.ceil(float(baud_min) * nfft))
    band = mag[..., k_lo:nfft // 2 + 1]
    peak = band.amax(dim=-1)
    k = torch.argmax(band, dim=-1)
    floor = median_midpoint(band)
    stat = peak / torch.clamp(floor, min=1e-30)
    return stat, (k + k_lo).to(torch.float32) / float(nfft)
