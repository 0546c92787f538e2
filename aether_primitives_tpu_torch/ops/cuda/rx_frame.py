"""The RX frame op: FIR -> decimate -> frame DFT -> wrap correction -> demod.

Port of the TPU kernel ``aether_primitives_tpu/ops/pallas/rx_frame.py``
(``_kernel``), extended to what the RX chain's fast path emits
(``models/modem.py`` ``RxChain._bits_fast``): packed LSB-first QPSK or BPSK
bytes, or the ``Scale.SN`` spectrum that the EVM gate reads.

- :func:`rx_frame` is the wrapper. For a CUDA tensor it launches the
  hand-written kernel ``csrc/rx_frame.cu`` (built at first use, see
  :mod:`.build`) or raises; for a CPU tensor it runs :func:`rx_frame_reference`.
- :func:`rx_frame_reference` is the plain PyTorch version: the staged
  two-einsum :func:`~aether_primitives_tpu_torch.ops.fir.fir_decimate_fft`
  in complex64 plus the same epilogue.
- :data:`launches` counts the kernel's launches.

Output per frame, natural bin ``k = k1 + n1*d``: ``"qpsk"`` writes
``fft_len / 4`` bytes (byte ``d*n1/4 + k1/4`` holds symbols ``k1..k1+3``,
two bits each, LSB-first); ``"bpsk"`` writes ``fft_len / 8`` bytes, one
bit ``re + im < 0`` per symbol; ``"spectrum"`` writes ``fft_len`` complex64
bins times ``Scale.SN``. Bytes come back flat per block row,
``[..., nsym * fft_len * bits / 8]``; spectra as ``[..., nsym, fft_len]``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from .. import fir as _fir
from ..fft import Scale
from . import build

#: Launches of the CUDA kernel in this process (the plain version and
#: calls that raise do not count).
launches = 0

EPILOGUES = {"qpsk": 0, "bpsk": 1, "spectrum": 2}
_THREADS = 256  # kThreads in csrc/rx_frame.cu


def _geometry(dec: int, fft_len: int, stage_n1: Optional[int]):
    n1 = _fir._fused_stage_n1(dec, fft_len, stage_n1)
    if n1 is None:
        raise ValueError(
            f"no two-stage geometry for dec {dec}, fft_len {fft_len}"
        )
    return n1, dec * fft_len // n1, fft_len // n1


def kernel_supports(dec: int, fft_len: int, stage_n1: Optional[int] = None) -> bool:
    """True when the CUDA kernel takes this geometry: a two-stage split
    exists with ``n1 % 8 == 0``, ``n2 % 8 == 0`` and one 4 x 8 stage-1 tile
    per thread (``n1 * n2 <= 8192``, so a frame fits in 64 KB of shared
    memory). Every output mode shares the condition."""
    n1 = _fir._fused_stage_n1(dec, fft_len, stage_n1)
    if n1 is None:
        return False
    n2 = dec * fft_len // n1
    return n1 % 8 == 0 and n2 % 8 == 0 and (n1 // 4) * (n2 // 8) <= _THREADS


def _check_args(x: torch.Tensor, taps, dec: int, fft_len: int, epilogue: str):
    if epilogue not in EPILOGUES:
        raise ValueError(
            f"unknown epilogue {epilogue!r} (expected one of {sorted(EPILOGUES)})"
        )
    if x.dtype != torch.complex64:
        raise TypeError(f"rx_frame takes complex64 samples, got {x.dtype}")
    taps = np.asarray(taps, dtype=np.complex64).ravel()
    span = dec * fft_len
    if x.shape[-1] % span:
        raise ValueError(
            f"length {x.shape[-1]} not divisible by dec*fft_len = {span}"
        )
    if taps.shape[-1] - 1 > span:
        raise ValueError(f"taps ({taps.shape[-1]}) longer than a frame ({span}) + 1")
    bits = {"qpsk": 2, "bpsk": 1}.get(epilogue)
    if bits and fft_len * bits % 8:
        raise ValueError(
            f"the {epilogue} epilogue writes whole bytes per frame; "
            f"fft_len {fft_len} x {bits} bits is not a multiple of 8"
        )
    return taps


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Flat per-bit ``[..., n]`` (``n % 8 == 0``) -> packed uint8 bytes
    ``[..., n / 8]``, LSB-first."""
    n = bits.shape[-1]
    w = bits.reshape(bits.shape[:-1] + (n // 8, 8)).to(torch.int32)
    byte = w[..., 0]
    for m in range(1, 8):
        byte = byte | (w[..., m] << m)
    return byte.to(torch.uint8)


def unpack_bits(packed: torch.Tensor) -> torch.Tensor:
    """Packed bytes ``[..., m]`` -> flat per-bit uint8 ``[..., 8 m]``,
    LSB-first (the inverse of :func:`pack_bits`)."""
    shifts = torch.arange(8, device=packed.device, dtype=torch.int32)
    bits = (packed.to(torch.int32)[..., None] >> shifts) & 1
    return bits.to(torch.uint8).reshape(packed.shape[:-1] + (-1,))


def rx_frame_reference(x, taps, dec: int, fft_len: int, history=None,
                       epilogue: str = "qpsk",
                       stage_n1: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`rx_frame` (same signature, same
    output), on any device."""
    taps = _check_args(x, taps, dec, fft_len, epilogue)
    batch = tuple(x.shape[:-1])
    z = _fir.fir_decimate_fft(
        x, taps, dec, fft_len, Scale.NONE, history=history,
        stage_n1=stage_n1, _staged_layout=True,
    )  # [n1, ..., nsym, r], k1 leading
    spec = z.movedim(0, -1).reshape(batch + (-1, fft_len))  # natural bin order
    if epilogue == "spectrum":
        return Scale.SN.apply(spec)
    if epilogue == "qpsk":
        bits = torch.stack([spec.real < 0, spec.imag < 0], dim=-1)
    else:
        bits = spec.real + spec.imag < 0
    return pack_bits(bits.reshape(batch + (-1,)))


@functools.lru_cache(maxsize=None)
def _kernel_constants(taps_bytes: bytes, k: int, dec: int, fft_len: int,
                      n1: int, device: str):
    """float32 planes of F1 [n1, n1], G' [r, n2, n1] and Cm [r, K-1, n1]
    (k1 minor, so the kernel reads them as coalesced float4 rows), built
    from the f64 host constants and uploaded once per device.

    This is a second layout of the constants that
    :func:`~aether_primitives_tpu_torch.ops.fir._device_constants` uploads
    for the plain einsums (complex64, ``[k1, m2, d]``, the JAX package's
    layout, pinned against it by the tests). Both stay: the einsum form is
    what the plain version contracts, and the kernel needs split planes
    with k1 minor. On the chain's main path only this set is on the card;
    the einsum set is uploaded there only when the plain version runs.
    """
    f1, gp = _fir._fused_stage_matrices(taps_bytes, k, dec, fft_len, n1)
    _, cm = _fir._fused_rx_matrices(taps_bytes, k, dec, fft_len)
    r = fft_len // n1
    g = gp.transpose(2, 1, 0)  # [k1, m2, d] -> [d, m2, k1]
    c = cm.reshape(max(k - 1, 0), r, n1).transpose(1, 0, 2)  # [d, u, k1]
    planes = []
    for a in (f1, g, c):
        for part in (a.real, a.imag):
            planes.append(
                torch.from_numpy(np.ascontiguousarray(part, np.float32)).to(device)
            )
    return tuple(planes)


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.load("rx_frame").rx_frame_launch
    fn.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 9
        + [ctypes.c_longlong] + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def rx_frame(x, taps, dec: int, fft_len: int, history=None,
             epilogue: str = "qpsk",
             stage_n1: Optional[int] = None) -> torch.Tensor:
    """Block ``[..., n]`` complex64 -> packed demod bytes or SN spectra.

    ``history``: optional ``[..., K-1]`` samples preceding each block row
    (zeros = causal start). On a CUDA tensor this launches the kernel of
    ``csrc/rx_frame.cu`` on the current stream; it raises on a geometry
    the kernel does not take (:func:`kernel_supports`), a dtype other than
    complex64, a non-contiguous block, a missing ``nvcc``, a failed build
    or a failed launch. On a CPU tensor it is :func:`rx_frame_reference`.
    """
    global launches
    if not isinstance(x, torch.Tensor):
        raise TypeError("rx_frame takes a torch.Tensor block")
    if x.device.type == "cpu":
        return rx_frame_reference(x, taps, dec, fft_len, history, epilogue,
                                  stage_n1)
    if x.device.type != "cuda":
        raise ValueError(f"rx_frame runs on cpu or cuda, not {x.device.type}")
    taps = _check_args(x, taps, dec, fft_len, epilogue)
    if not x.is_contiguous():
        raise ValueError("rx_frame takes a contiguous block")
    if not kernel_supports(dec, fft_len, stage_n1):
        raise ValueError(
            f"the CUDA rx_frame kernel does not take dec {dec}, fft_len "
            f"{fft_len}, stage_n1 {stage_n1} (see kernel_supports)"
        )
    k = taps.shape[-1]
    ku = k - 1
    n1, n2, r = _geometry(dec, fft_len, stage_n1)
    batch = tuple(x.shape[:-1])
    nsym = x.shape[-1] // (dec * fft_len)
    rows = int(np.prod(batch, dtype=np.int64))
    frames = rows * nsym
    if frames >= 1 << 31:
        raise ValueError(f"{frames} frames exceed one launch's grid")
    hist = None
    if ku > 0 and history is not None:
        hist = torch.as_tensor(history, dtype=torch.complex64, device=x.device)
        if hist.shape[-1] != ku:
            raise ValueError(f"history must have K-1 = {ku} samples")
        hist = hist.expand(batch + (ku,)).contiguous()
    if epilogue == "spectrum":
        out = torch.empty(batch + (nsym, fft_len), dtype=torch.complex64,
                          device=x.device)
    else:
        bits = 2 if epilogue == "qpsk" else 1
        out = torch.empty(batch + (nsym * fft_len * bits // 8,),
                          dtype=torch.uint8, device=x.device)
    if frames == 0:
        return out
    consts = _kernel_constants(taps.tobytes(), k, dec, fft_len, n1, str(x.device))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _entry()(
            EPILOGUES[epilogue], x.data_ptr(),
            None if hist is None else hist.data_ptr(),
            *(c.data_ptr() for c in consts), out.data_ptr(),
            frames, nsym, n1, n2, r, ku,
            Scale.SN.factor_for(fft_len), stream,
        )
    if rc != 0:
        raise RuntimeError(f"rx_frame kernel launch failed: CUDA error {rc}")
    launches += 1
    return out
