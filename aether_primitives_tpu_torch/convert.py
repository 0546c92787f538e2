"""Carry the JAX package's chain parameters and state into the port.

Both functions take numpy data only, so the port never imports the JAX
package: pass ``dataclasses.asdict(jax_config)`` and ``np.asarray(state)``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .models.modem import RxChainConfig

#: JAX config fields that select TPU machinery and have no counterpart here
#: (the port has one FFT backend, torch.fft).
_DROPPED = ("fft_backend",)


def config_from_numpy(fields: dict) -> RxChainConfig:
    """``dataclasses.asdict`` of the JAX package's ``RxChainConfig`` -> the
    port's :class:`RxChainConfig`. Taps become complex64 numpy; an unknown
    field raises."""
    fields = {k: v for k, v in fields.items() if k not in _DROPPED}
    known = {f.name for f in dataclasses.fields(RxChainConfig)}
    unknown = sorted(set(fields) - known)
    if unknown:
        raise ValueError(f"RxChainConfig has no fields {unknown}")
    if fields.get("fir_taps") is not None:
        fields["fir_taps"] = np.asarray(fields["fir_taps"], dtype=np.complex64)
    return RxChainConfig(**fields)


def state_from_numpy(state, device) -> torch.Tensor:
    """The JAX chain's carried FIR history (complex ``[..., K-1]``, or an
    ``(re, im)`` pair of float32 planes) -> a complex64 tensor on ``device``."""
    if isinstance(state, (tuple, list)):
        re, im = (np.asarray(p, dtype=np.float32) for p in state)
        arr = (re + 1j * im).astype(np.complex64)
    else:
        arr = np.array(state, dtype=np.complex64)  # a writable copy
    return torch.from_numpy(arr).to(device)
