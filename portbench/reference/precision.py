"""Rounding that emulates a lower precision in a float64 reference.

The control of the comparison that decides ``correct`` is the reference
computed in the nearest precision below the program's (float32 -> bfloat16):
each stage's output is rounded to bfloat16 and carried on in float64.
"""

from __future__ import annotations

import torch


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` (real or complex, float64) rounded to bfloat16 per component."""
    if x.is_complex():
        return torch.complex(bf16(x.real), bf16(x.imag))
    return x.to(torch.bfloat16).to(x.dtype)

