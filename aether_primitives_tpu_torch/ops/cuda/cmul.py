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


def _aligned(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


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
                       + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    planes.restype = ctypes.c_int
    c64 = lib.cmul_c64_launch
    c64.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_float]
                    + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    c64.restype = ctypes.c_int
    return planes, c64


def cmul(a_re, a_im, b_re, b_im, conj_b: bool = False, scale: float = 1.0):
    """Fused ``(a * b[conj]) * scale`` on split float32 planes of one shape,
    one pass; returns ``(out_re, out_im)``.

    Array-likes are taken as float32 tensors (``torch.as_tensor``). On CUDA
    tensors this launches the kernel on the current stream; it raises for
    shapes that differ, tensors on different devices or not contiguous, a
    missing ``nvcc``, a failed build or a failed launch. On CPU tensors it is
    :func:`cmul_reference`.
    """
    global launches
    planes = [torch.as_tensor(p, dtype=torch.float32) for p in (a_re, a_im, b_re, b_im)]
    shape = planes[0].shape
    if any(p.shape != shape for p in planes):
        raise ValueError(f"cmul takes four planes of one shape, got "
                         f"{[tuple(p.shape) for p in planes]}")
    if all(p.device.type == "cpu" for p in planes):
        return cmul_reference(*planes, conj_b=conj_b, scale=scale)
    dev = _on_one_card("cmul", planes)
    out_re = torch.empty(shape, dtype=torch.float32, device=dev)
    out_im = torch.empty_like(out_re)
    n = out_re.numel()
    if n == 0:
        return out_re, out_im
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _entries()[0](
            *(p.data_ptr() for p in planes), out_re.data_ptr(), out_im.data_ptr(),
            n, _scale(scale), int(bool(conj_b)),
            int(_aligned(*planes, out_re, out_im)), stream,
        )
    if rc != 0:
        raise RuntimeError(f"cmul kernel launch failed: CUDA error {rc}")
    launches += 1
    return out_re, out_im


def cmul_c64(a, b, conj_b: bool = False, scale: float = 1.0):
    """Fused ``(a * b[conj]) * scale`` on complex64 tensors of one shape,
    one pass over their interleaved storage; returns complex64.

    Array-likes are taken as complex64 tensors. On CUDA tensors this
    launches the kernel on the current stream (raising as :func:`cmul`
    does); on CPU tensors it is :func:`cmul_c64_reference`.
    """
    global launches
    a = torch.as_tensor(a, dtype=torch.complex64)
    b = torch.as_tensor(b, dtype=torch.complex64)
    if a.shape != b.shape:
        raise ValueError(f"cmul_c64 takes a and b of one shape, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.device.type == "cpu" and b.device.type == "cpu":
        return cmul_c64_reference(a, b, conj_b=conj_b, scale=scale)
    dev = _on_one_card("cmul_c64", [a, b])
    out = torch.empty(a.shape, dtype=torch.complex64, device=dev)
    n = out.numel()
    if n == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _entries()[1](
            a.data_ptr(), b.data_ptr(), out.data_ptr(), n, _scale(scale),
            int(bool(conj_b)), int(_aligned(a, b, out)), stream,
        )
    if rc != 0:
        raise RuntimeError(f"cmul_c64 kernel launch failed: CUDA error {rc}")
    launches += 1
    return out
