"""FFT layer: the :class:`Scale` policy and fixed-length plans on ``torch.fft``.

Counterpart of ``aether_primitives_tpu/ops/fft.py``. Forward is the
``e^{-i 2π k n / N}`` DFT, backward the unnormalised inverse (conjugate
kernel); all normalisation comes only from the ``Scale`` argument. The JAX
package's MXU matmul FFT and its factor tables are TPU workarounds and have
no counterpart here: cuFFT, through ``torch.fft``, is the only backend. The
``backend`` / ``fft_backend`` arguments keep their place in every signature
(so a positional call written for the JAX package binds the same
arguments) and :func:`check_backend` checks them.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..types import as_cf32


@dataclass(frozen=True)
class Scale:
    """FFT scaling policy: ``NONE``, ``SN`` (1/sqrt(N)), ``N`` (1/N), ``X(f)``.

    ``apply(x)`` scales the whole block; N is the length of the last axis.
    ``factor_for`` keeps the JAX package's arithmetic (the square root and
    the reciprocal are taken of a float32 N) so both packages scale by the
    same float.
    """

    kind: str  # "none" | "sn" | "n" | "x"
    factor: Optional[float] = None

    @staticmethod
    def X(factor: float) -> "Scale":
        return Scale("x", float(factor))

    def factor_for(self, n: int) -> float:
        if self.kind == "none":
            return 1.0
        if self.kind == "sn":
            return 1.0 / float(np.sqrt(np.float32(n), dtype=np.float32))
        if self.kind == "n":
            return 1.0 / float(np.float32(n))
        if self.kind == "x":
            return float(self.factor)
        raise ValueError(f"unknown scale kind {self.kind!r}")

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        f = self.factor_for(x.shape[-1])
        if f == 1.0:
            return x
        return x * f  # the Python float rounds to x's float32 precision


Scale.NONE = Scale("none")
Scale.SN = Scale("sn")
Scale.N = Scale("n")


class Fft:
    """A fixed-length FFT plan: ``fwd``/``bwd`` with a :class:`Scale` policy.

    Both directions are unnormalised; scaling comes only from ``scale``. The
    input length must equal the plan length. Batched over leading axes.
    """

    def __init__(self, n: int):
        self.n = int(n)

    def __len__(self) -> int:
        return self.n

    def _check(self, x: torch.Tensor) -> None:
        if x.shape[-1] != self.n:
            raise ValueError(
                f"Input and FFT must be the same length ({x.shape[-1]} vs {self.n})"
            )

    def fwd(self, x, scale: Scale = Scale.NONE) -> torch.Tensor:
        x = as_cf32(x)
        self._check(x)
        return scale.apply(torch.fft.fft(x, norm="backward"))

    def bwd(self, x, scale: Scale = Scale.NONE) -> torch.Tensor:
        x = as_cf32(x)
        self._check(x)
        # norm="forward" leaves the inverse unscaled
        return scale.apply(torch.fft.ifft(x, norm="forward"))


def check_backend(backend: Optional[str]) -> None:
    """Accept the FFT backends a call may name: None and ``"xla"`` (the JAX
    package's off-TPU backend) both mean cuFFT through ``torch.fft``. The
    JAX package's ``"matmul"`` backend is the TPU's MXU FFT and raises, as
    does any other name."""
    if backend is None or backend == "xla":
        return
    if backend == "matmul":
        raise ValueError(
            "fft_backend 'matmul' is the JAX package's TPU matmul FFT; the port's only "
            "FFT backend is cuFFT through torch.fft: pass None or 'xla'"
        )
    raise ValueError(f"unknown fft_backend {backend!r} (expected None or 'xla')")


@functools.lru_cache(maxsize=None)
def _plan(n: int) -> Fft:
    return Fft(n)


def plan(n: int, backend: Optional[str] = None) -> Fft:
    """The cached FFT plan for length ``n`` (cuFFT keeps its own plan cache;
    this one keeps the JAX package's ``plan(n).fwd/bwd`` surface);
    ``backend`` as in :func:`check_backend`."""
    check_backend(backend)
    return _plan(int(n))


def fft(x, scale: Scale = Scale.NONE, backend: Optional[str] = None) -> torch.Tensor:
    """Forward FFT along the last axis."""
    x = as_cf32(x)
    return plan(x.shape[-1], backend).fwd(x, scale)


def ifft(x, scale: Scale = Scale.NONE, backend: Optional[str] = None) -> torch.Tensor:
    """Unnormalised backward FFT along the last axis."""
    x = as_cf32(x)
    return plan(x.shape[-1], backend).bwd(x, scale)


def fft_of_decimated(frames_full_rate, dec: int, scale: Scale = Scale.NONE,
                     backend: Optional[str] = None) -> torch.Tensor:
    """Forward FFT of the decimated last axis, ``fft(x[..., ::dec])``;
    ``scale`` applies at the output length."""
    x = as_cf32(frames_full_rate)
    if x.shape[-1] % dec:
        raise ValueError(
            f"length {x.shape[-1]} not divisible by decimation {dec}"
        )
    return plan(x.shape[-1] // dec, backend).fwd(x[..., ::dec], scale)
