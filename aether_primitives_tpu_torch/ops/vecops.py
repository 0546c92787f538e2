"""Element-wise complex vector ops ("VecOps") on complex64 tensors.

Counterpart of ``aether_primitives_tpu/ops/vecops.py``. Every op works on
the **last axis**, broadcasts over leading axes and returns a new tensor;
binary ops require equal trailing lengths. :class:`CVec` is the chainable
wrapper of the reference's fluent API. The JAX module registers ``CVec`` as
a pytree for ``jit``; PyTorch runs eagerly, so here it is a plain class.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..types import as_cf32


def _check_same_len(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.shape[-1] != b.shape[-1]:
        raise ValueError(
            f"Vectors must have same length (got {a.shape[-1]} and {b.shape[-1]})"
        )


def _pair(x, other):
    x = torch.as_tensor(x)
    other = torch.as_tensor(other, device=x.device)
    _check_same_len(x, other)
    return x, other


def scale(x, s) -> torch.Tensor:
    """Scale by a real scalar (reference ``vec_scale``)."""
    x = torch.as_tensor(x)
    return x * torch.tensor(s, dtype=torch.float32, device=x.device)


def mul(x, other) -> torch.Tensor:
    """Element-wise complex multiply (reference ``vec_mul``)."""
    x, other = _pair(x, other)
    return x * other


def div(x, other) -> torch.Tensor:
    """Element-wise complex divide (reference ``vec_div``)."""
    x, other = _pair(x, other)
    return x / other


def conj(x) -> torch.Tensor:
    """Conjugate each element (reference ``vec_conj``); a new tensor, not a
    lazily conjugated view."""
    return torch.conj_physical(torch.as_tensor(x))


def mirror(x) -> torch.Tensor:
    """Swap elements around the midpoint of the last axis, as the
    reference's ``vec_mirror``: with ``mid = n // 2``, element ``i`` swaps
    with ``i + mid`` for ``i < mid``. For even ``n`` that is the fftshift;
    for odd ``n`` the last element stays in place. ``[0,1,2,3] ->
    [2,3,0,1]``."""
    x = torch.as_tensor(x)
    n = x.shape[-1]
    mid = n // 2
    if n % 2 == 0:
        return torch.roll(x, mid, dims=-1)
    head = torch.roll(x[..., :2 * mid], mid, dims=-1)
    return torch.cat([head, x[..., 2 * mid:]], dim=-1)


def clone(other) -> torch.Tensor:
    """A copy of ``other`` (reference ``vec_clone``)."""
    return torch.as_tensor(other).clone()


def zero(x) -> torch.Tensor:
    """Zeros shaped like ``x`` (reference ``vec_zero``)."""
    return torch.zeros_like(torch.as_tensor(x))


def mutate(x, f: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """Apply an element-wise function to the whole tensor (reference
    ``vec_mutate``); :func:`mutate_indexed` for index-dependent ones."""
    return f(torch.as_tensor(x))


def mutate_indexed(
    x, f: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
) -> torch.Tensor:
    """Apply ``f(values, indices)`` over the last axis (the reference's
    stateful-closure uses of ``vec_mutate``, such as scaling element ``i``
    by ``i``)."""
    x = torch.as_tensor(x)
    return f(x, torch.arange(x.shape[-1], device=x.device))


def add(x, other) -> torch.Tensor:
    """Element-wise add (reference ``vec_add``)."""
    x, other = _pair(x, other)
    return x + other


def sub(x, other) -> torch.Tensor:
    """Element-wise subtract (reference ``vec_sub``)."""
    x, other = _pair(x, other)
    return x - other


class CVec:
    """Chainable complex sample vector, mirroring the reference's fluent API:
    every ``vec_*`` method returns a **new** ``CVec``. FFT methods take the
    :class:`~aether_primitives_tpu_torch.ops.fft.Scale` policy;
    ``vec_rfft``/``vec_rifft`` take a plan (:func:`..fft.plan`).

    >>> import numpy as np
    >>> twos = np.full(4, 2 + 2j, dtype=np.complex64)
    >>> ones = np.ones(4, dtype=np.complex64)
    >>> v = CVec(np.full(4, 2 + 2j, dtype=np.complex64))
    >>> v.vec_div(twos).vec_mul(twos).vec_zero().vec_add(ones).array.tolist()
    [(1+0j), (1+0j), (1+0j), (1+0j)]
    """

    __slots__ = ("array",)

    def __init__(self, array):
        self.array = as_cf32(array)

    def vec_scale(self, s) -> "CVec":
        return CVec(scale(self.array, s))

    def vec_mul(self, other) -> "CVec":
        return CVec(mul(self.array, _arr(other)))

    def vec_div(self, other) -> "CVec":
        return CVec(div(self.array, _arr(other)))

    def vec_conj(self) -> "CVec":
        return CVec(conj(self.array))

    def vec_mirror(self) -> "CVec":
        return CVec(mirror(self.array))

    def vec_clone(self, other) -> "CVec":
        return CVec(clone(_arr(other)))

    def vec_zero(self) -> "CVec":
        return CVec(zero(self.array))

    def vec_mutate(self, f) -> "CVec":
        return CVec(mutate(self.array, f))

    def vec_add(self, other) -> "CVec":
        return CVec(add(self.array, _arr(other)))

    def vec_sub(self, other) -> "CVec":
        return CVec(sub(self.array, _arr(other)))

    def vec_fft(self, scale_policy) -> "CVec":
        from . import fft as _fft

        return CVec(_fft.fft(self.array, scale_policy))

    def vec_ifft(self, scale_policy) -> "CVec":
        from . import fft as _fft

        return CVec(_fft.ifft(self.array, scale_policy))

    def vec_rfft(self, plan, scale_policy) -> "CVec":
        return CVec(plan.fwd(self.array, scale_policy))

    def vec_rifft(self, plan, scale_policy) -> "CVec":
        return CVec(plan.bwd(self.array, scale_policy))

    def __len__(self) -> int:
        return self.array.shape[-1]

    def __repr__(self) -> str:
        return f"CVec({self.array!r})"


def _arr(x):
    return x.array if isinstance(x, CVec) else x
