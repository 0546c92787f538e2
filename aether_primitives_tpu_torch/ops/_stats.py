"""Order statistics shared by the port's modules."""

from __future__ import annotations

import torch


def median_midpoint(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """Median over the last axis: the mean of the two middle values for an
    even count, as ``jnp.median`` and ``np.median`` take it
    (``torch.median`` returns the lower one)."""
    s = x.sort(dim=-1).values
    n = x.shape[-1]
    m = (s[..., (n - 1) // 2:(n - 1) // 2 + 1] + s[..., n // 2:n // 2 + 1]) * 0.5
    return m if keepdim else m[..., 0]
