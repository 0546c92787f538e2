"""Split re/im f32 planes of a complex block.

The JAX package needs :class:`Split` because some TPU runtimes cannot move
complex arrays between host and device. PyTorch moves complex64 itself, so
here ``Split`` exists only so that code written against the JAX package's
split-plane signatures keeps working.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .types import as_cf32


class Split(NamedTuple):
    """A complex block as two float32 tensors ``(re, im)``."""

    re: torch.Tensor
    im: torch.Tensor


def split(x) -> Split:
    """Complex array-like -> :class:`Split` of contiguous float32 planes."""
    x = as_cf32(x)
    return Split(x.real.contiguous(), x.imag.contiguous())


def merge(s) -> torch.Tensor:
    """:class:`Split` (or a ``(re, im)`` pair) -> complex64 tensor; any other
    array-like passes through :func:`as_cf32`."""
    if isinstance(s, tuple):
        re, im = s
        return torch.complex(
            torch.as_tensor(re, dtype=torch.float32),
            torch.as_tensor(im, dtype=torch.float32),
        )
    return as_cf32(s)
