"""Core sample types and block conventions (PyTorch).

``cf32`` is ``torch.complex64``: the same back-to-back ``(re: f32, im: f32)``
layout as numpy's complex64, so host buffers, sample files and device
tensors interoperate bit-for-bit. Sample vectors are the **last axis** of a
tensor; every op is batched over the leading axes.
"""

from __future__ import annotations

import torch

cf32 = torch.complex64

#: Double precision, for host-side golden computations (the JAX package's
#: alias of the reference's cf64).
cf64 = torch.complex128


def as_cf32(x, device=None) -> torch.Tensor:
    """Coerce array-like input (numpy, list or tensor) to a complex64 tensor.

    A tensor keeps its device unless ``device`` is given.
    """
    return torch.as_tensor(x, dtype=cf32, device=device)


def split_complex(x) -> tuple:
    """A complex array-like as an ``(re, im)`` pair of float32 tensors."""
    x = torch.as_tensor(x)
    if not x.is_complex():
        x = x.to(cf32)
    return x.real.to(torch.float32), x.imag.to(torch.float32)


def merge_complex(re, im) -> torch.Tensor:
    """Split re/im float32 planes merged into a complex64 tensor."""
    return torch.complex(torch.as_tensor(re, dtype=torch.float32),
                         torch.as_tensor(im, dtype=torch.float32))


def stage_device(device, stage: str) -> torch.device:
    """``device`` as a ``torch.device`` for a stage named ``stage``; a CUDA
    device without CUDA raises RuntimeError (the stages never fall back to
    the CPU: it runs only when asked for)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{stage} device {device!r} requested but CUDA is not available")
    return dev
