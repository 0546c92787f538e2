"""Fused complex multiply ``(a * b[conj]) * scale`` in one pass.

Port of the TPU kernel ``aether_primitives_tpu/ops/pallas/cmul.py``
(``_cmul_kernel``, wrappers ``cmul`` and ``cmul_c64``): the element-wise
spectrum multiply of a correlator, where the only thing that matters is
touching device memory once.

- :func:`cmul` takes four float32 planes of one shape (any shape, any
  element count) and returns ``(out_re, out_im)``; :func:`cmul_c64` takes
  two complex64 tensors and returns one. For CUDA tensors each launches the
  hand-written kernel of ``csrc/cmul.cu`` (built at first use, see
  :mod:`.build`) or raises; for CPU tensors each runs its plain version.
- :func:`cmul_reference` and :func:`cmul_c64_reference` are the plain
  PyTorch versions, on any device: ``(ar*br - ai*bi) * s`` and ``(ar*bi +
  ai*br) * s``, ``bi`` negated first when ``conj_b`` is set, every op
  rounded to float32 on its own, which is what the kernel computes (it is
  bit-identical to them).
- :data:`launches` counts the kernel's launches, both entry points.

``cmul_c64`` hands the interleaved complex64 storage to the kernel as it
is: no plane split and no merge, unlike the TPU wrapper. The TPU wrapper's
row tiling and VMEM budget (``_row_tiles``) have no counterpart.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import build

#: Launches of the CUDA kernel in this process (the plain versions and
#: calls that raise do not count).
launches = 0


def _scale(scale: float) -> float:
    """The scale as the kernel sees it: rounded to float32."""
    return float(np.float32(scale))


def cmul_reference(a_re, a_im, b_re, b_im, conj_b: bool = False, scale: float = 1.0):
    """Plain PyTorch version of :func:`cmul` (same arguments and output),
    on any device."""
    s = _scale(scale)
    if conj_b:
        b_im = -b_im
    return (a_re * b_re - a_im * b_im) * s, (a_re * b_im + a_im * b_re) * s


def cmul_c64_reference(a, b, conj_b: bool = False, scale: float = 1.0):
    """Plain PyTorch version of :func:`cmul_c64`: :func:`cmul_reference` on
    the planes of ``a`` and ``b``, merged."""
    re, im = cmul_reference(a.real, a.imag, b.real, b.imag, conj_b, scale)
    return torch.complex(re, im)


def _on_one_card(name: str, tensors) -> torch.device:
    """The CUDA device of ``tensors``; raises unless all lie on it and are
    contiguous."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name} takes its tensors on one device")
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {dev.type}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} takes contiguous tensors")
    return dev


@functools.lru_cache(maxsize=None)
def _entries():
    lib = build.load("cmul")
    planes = lib.cmul_planes_launch
    planes.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_float]
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    planes.restype = ctypes.c_int
    c64 = lib.cmul_c64_launch
    c64.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_float]
                    + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    c64.restype = ctypes.c_int
    return planes, c64


def _outputs(shape, n: int, dev: torch.device):
    """Both output planes as slices of one allocation: ``[2, *shape]``, or,
    where ``n`` is not a multiple of 4, two rows padded to one (so that the
    second plane stays 16-byte aligned)."""
    if n % 4 == 0:
        return torch.empty((2, *shape), dtype=torch.float32, device=dev).unbind(0)
    buf = torch.empty((2, n + 4 - n % 4), dtype=torch.float32, device=dev)
    return buf[0, :n].view(shape), buf[1, :n].view(shape)


def cmul(a_re, a_im, b_re, b_im, conj_b: bool = False, scale: float = 1.0):
    """Fused ``(a * b[conj]) * scale`` on split float32 planes of one shape,
    one pass; returns ``(out_re, out_im)`` (two slices of one allocation on
    a card).

    Array-likes and tensors of another dtype are taken as float32 tensors
    (``torch.as_tensor``). On CUDA tensors this launches the kernel on the
    current stream; it raises for shapes that differ, tensors on different
    devices or not contiguous, a missing ``nvcc``, a failed build or a
    failed launch. On CPU tensors it is :func:`cmul_reference`.
    """
    f32 = torch.float32
    planes = (a_re, a_im, b_re, b_im)
    if not all(type(p) is torch.Tensor and p.dtype is f32 for p in planes):
        planes = tuple(p if isinstance(p, torch.Tensor) and p.dtype is f32
                       else torch.as_tensor(p, dtype=f32) for p in planes)
    ar, ai, br, bi = planes
    shape = ar.shape
    if not (ai.shape == shape and br.shape == shape and bi.shape == shape):
        raise ValueError(f"cmul takes four planes of one shape, got "
                         f"{[tuple(p.shape) for p in planes]}")
    index = ar.get_device()
    if not (index >= 0 and ai.get_device() == index and br.get_device() == index
            and bi.get_device() == index and ar.is_contiguous() and ai.is_contiguous()
            and br.is_contiguous() and bi.is_contiguous()):
        if all(p.device.type == "cpu" for p in planes):
            return cmul_reference(*planes, conj_b=conj_b, scale=scale)
        _on_one_card("cmul", planes)  # raises: the cases above failed
    n = ar.numel()
    out_re, out_im = _outputs(shape, n, ar.device)
    if n:
        ptrs = (ar.data_ptr(), ai.data_ptr(), br.data_ptr(), bi.data_ptr(),
                out_re.data_ptr(), out_im.data_ptr())
        _launch_planes(ptrs, index, n, scale, conj_b, not any(p % 16 for p in ptrs))
    return out_re, out_im


def cmul_c64(a, b, conj_b: bool = False, scale: float = 1.0):
    """Fused ``(a * b[conj]) * scale`` on complex64 tensors of one shape,
    one pass over their interleaved storage; returns complex64.

    Array-likes and tensors of another dtype are taken as complex64
    tensors. On CUDA tensors this launches the kernel on the current stream
    (raising as :func:`cmul` does); on CPU tensors it is
    :func:`cmul_c64_reference`.
    """
    c64 = torch.complex64
    if not (type(a) is torch.Tensor and a.dtype is c64):
        a = torch.as_tensor(a, dtype=c64)
    if not (type(b) is torch.Tensor and b.dtype is c64):
        b = torch.as_tensor(b, dtype=c64)
    if a.shape != b.shape:
        raise ValueError(f"cmul_c64 takes a and b of one shape, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    index = a.get_device()
    if not (index >= 0 and b.get_device() == index and a.is_contiguous()
            and b.is_contiguous()):
        if a.device.type == "cpu" and b.device.type == "cpu":
            return cmul_c64_reference(a, b, conj_b=conj_b, scale=scale)
        _on_one_card("cmul_c64", [a, b])  # raises: the cases above failed
    out = torch.empty(a.shape, dtype=c64, device=a.device)
    n = out.numel()
    if n:
        ptrs = (a.data_ptr(), b.data_ptr(), out.data_ptr())
        _launch_c64(ptrs, index, n, scale, conj_b, not any(p % 16 for p in ptrs))
    return out


def _launch_planes(ptrs, device: int, n: int, scale: float, conj_b: bool,
                   vec: bool) -> None:
    """One launch of the planes kernel on card ``device``'s current stream
    over ``ptrs`` (``ar, ai, br, bi, out_re, out_im``; ``vec``: all 16-byte
    aligned), counted in :data:`launches`. ctypes rounds ``scale`` to
    float32 as ``_scale`` does."""
    global launches
    rc = _entries()[0](*ptrs, n, scale, int(bool(conj_b)), int(vec), device,
                       torch._C._cuda_getCurrentRawStream(device))
    if rc != 0:
        raise RuntimeError(f"cmul kernel launch failed: CUDA error {rc}")
    launches += 1


def _launch_c64(ptrs, device: int, n: int, scale: float, conj_b: bool, vec: bool) -> None:
    """One launch of the complex64 kernel over ``ptrs`` (``a, b, out``), as
    :func:`_launch_planes`."""
    global launches
    rc = _entries()[1](*ptrs, n, scale, int(bool(conj_b)), int(vec), device,
                       torch._C._cuda_getCurrentRawStream(device))
    if rc != 0:
        raise RuntimeError(f"cmul_c64 kernel launch failed: CUDA error {rc}")
    launches += 1
