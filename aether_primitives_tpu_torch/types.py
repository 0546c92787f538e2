"""Core sample types and block conventions (PyTorch).

``cf32`` is ``torch.complex64``: the same back-to-back ``(re: f32, im: f32)``
layout as numpy's complex64, so host buffers, sample files and device
tensors interoperate bit-for-bit. Sample vectors are the **last axis** of a
tensor; every op is batched over the leading axes.
"""

from __future__ import annotations

import torch

cf32 = torch.complex64


def as_cf32(x, device=None) -> torch.Tensor:
    """Coerce array-like input (numpy, list or tensor) to a complex64 tensor.

    A tensor keeps its device unless ``device`` is given.
    """
    return torch.as_tensor(x, dtype=cf32, device=device)
