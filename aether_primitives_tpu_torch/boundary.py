"""Split re/im f32 planes of a complex block.

The JAX package needs :class:`Split` because some TPU runtimes cannot move
complex arrays between host and device. PyTorch moves complex64 itself, so
here ``Split`` exists only so that code written against the JAX package's
split-plane signatures keeps working: :class:`Split` with ``shape``,
``to_complex()`` and ``numpy()``, :func:`split` / :func:`merge`,
:func:`tree_split` / :func:`tree_merge` over nested tuples, lists and
dicts, and :func:`f32_boundary`, the thin wrapper over the two.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from .types import as_cf32


class Split(NamedTuple):
    """A complex block as two float32 tensors ``(re, im)``."""

    re: torch.Tensor
    im: torch.Tensor

    @property
    def shape(self) -> tuple:
        """The block's shape (that of either plane)."""
        return tuple(np.shape(self.re))

    def to_complex(self) -> torch.Tensor:
        """The planes merged into a complex64 tensor, where they lie."""
        return merge(self)

    def numpy(self) -> np.ndarray:
        """The planes merged into a host numpy complex64 array."""
        return merge(self).cpu().numpy()


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


def _tree_map(fn, tree, is_leaf):
    if is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return type(tree)((k, _tree_map(fn, v, is_leaf)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        items = [_tree_map(fn, v, is_leaf) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)
    return fn(tree)


def _is_complex(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray)) and (
        x.is_complex() if isinstance(x, torch.Tensor) else np.iscomplexobj(x))


def tree_split(tree):
    """Replace every complex leaf (tensor or numpy array) of nested tuples,
    lists and dicts with a :class:`Split` of float32 tensors."""
    return _tree_map(lambda x: split(x) if _is_complex(x) else x, tree,
                     lambda x: isinstance(x, Split))


def tree_merge(tree):
    """Replace every :class:`Split` leaf of nested tuples, lists and dicts
    with a complex64 tensor."""
    return _tree_map(lambda x: merge(x) if isinstance(x, Split) else x, tree,
                     lambda x: isinstance(x, Split))


def f32_boundary(fn: Callable) -> Callable:
    """Wrap a complex-signature function into a split-signature one: the
    wrapped function takes and returns trees whose :class:`Split` leaves
    stand in for complex ones (:func:`tree_merge` on the arguments,
    :func:`tree_split` on the result). PyTorch needs no such boundary; it
    is kept for code written against the JAX package."""

    def wrapped(*args, **kwargs):
        return tree_split(fn(*tree_merge(args), **tree_merge(kwargs)))

    wrapped.__name__ = getattr(fn, "__name__", "wrapped") + "_f32"
    return wrapped
