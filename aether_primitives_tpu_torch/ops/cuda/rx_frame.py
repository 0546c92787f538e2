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
- :data:`launches` counts the kernel's launches (one per call).
- :func:`kernel_plan` / :func:`kernel_supports` name the kernel's instance
  and stage split for a geometry: ``tile256`` (n1 and n2 multiples of 8, a
  frame of at most 8,192 samples: the main path's dec 4, fft_len 2048),
  ``tile512`` (the same split rules, 8,193-16,384 samples: dec 4,
  fft_len 4096), ``generic`` (any other split: fft_len 30, spans under 64;
  spectrum epilogue, its bits decided and packed in PyTorch on the card).
  Where the heuristic's split does not tile, the card takes its own
  factorisation (dec 4, fft_len 64 -> n1 32; dec 1, fft_len 128 -> n1 16),
  which agrees with the JAX package at the usual bars, not bit for bit. A
  frame beyond the opt-in shared memory (:data:`SMEM_LIMIT`) raises.

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
#: The kernel's instances (``csrc/rx_frame.cu``: 256, 512 and 256 threads a
#: CTA) by name: the most samples a frame may span, and the number the C
#: entry takes.
INSTANCES = {"tile256": (8192, 0), "tile512": (16384, 1), "generic": (None, 2)}
#: Opt-in shared memory of one CTA on sm_90 (227 KB).
SMEM_LIMIT = 232_448
_G_CAP = 64 << 20  # the largest G' tensor a stage split may imply (ops/fir.py)


def _tiled(n1: int, n2: int) -> bool:
    """The tile instances' split: 4 x 8 stage-1 tiles, whole float4 rows."""
    return n1 % 8 == 0 and n2 % 8 == 0 and n1 * n2 <= INSTANCES["tile512"][0]


def _card_n1(dec: int, fft_len: int) -> Optional[int]:
    """The card's own stage split where the heuristic's does not tile: the
    largest ``n1 | fft_len``, ``n1 <= 128``, with ``n1 % 8 == 0`` and
    ``n2 % 8 == 0`` whose frame fits the tile instances and whose G' stays
    within 64 MB; None when there is none."""
    span = dec * fft_len
    for n1 in range(min(fft_len, 128), 7, -1):
        if fft_len % n1 == 0 and _tiled(n1, span // n1) and span * (fft_len // n1) * 8 <= _G_CAP:
            return n1
    return None


def _smem_bytes(instance: str, span: int, ku: int) -> int:
    planes = 4 if instance == "generic" else 2
    return (planes * span + 2 * ku) * 4


@functools.lru_cache(maxsize=None)
def kernel_plan(dec: int, fft_len: int, stage_n1: Optional[int] = None,
                n_taps: int = 1) -> Optional[tuple]:
    """``(instance, n1)``: the kernel's instance (:data:`INSTANCES`) and
    stage split for a geometry, or None where no instance takes it.

    ``stage_n1`` given: that split (it must divide ``fft_len``). Otherwise
    the heuristic's (:func:`~aether_primitives_tpu_torch.ops.fir.
    _fused_stage_n1`, the JAX package's) where the tile instances take it,
    else the card's own factorisation (:func:`_card_n1`: e.g. dec 4,
    fft_len 64 -> n1 32, n2 8; dec 1, fft_len 128 -> n1 16, n2 8), else the
    heuristic's split through the generic instance. A split other than the
    heuristic's agrees with the JAX package at the usual bars, not bit for
    bit. None where a frame of ``n_taps``-tap history needs more shared
    memory than :data:`SMEM_LIMIT`, or where no split exists.
    """
    span = dec * fft_len
    n1 = _fir._fused_stage_n1(dec, fft_len, stage_n1)
    if stage_n1 is None and (n1 is None or not _tiled(n1, span // n1)):
        n1 = _card_n1(dec, fft_len) or n1
    if n1 is None:
        return None
    n2 = span // n1
    if _tiled(n1, n2):
        instance = "tile256" if span <= INSTANCES["tile256"][0] else "tile512"
    else:
        instance = "generic"
    if _smem_bytes(instance, span, max(n_taps - 1, 0)) > SMEM_LIMIT:
        return None
    return instance, n1


def kernel_supports(dec: int, fft_len: int, stage_n1: Optional[int] = None,
                    n_taps: int = 1) -> Optional[str]:
    """The instance of the CUDA kernel that takes this geometry
    (``"tile256"``, ``"tile512"`` or ``"generic"``, see :func:`kernel_plan`),
    or None where none does. Every output mode shares the condition."""
    plan = kernel_plan(dec, fft_len, stage_n1, n_taps)
    return None if plan is None else plan[0]


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
    return pack_bits(sign_bits(spec, epilogue))


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
        [ctypes.c_int] * 2 + [ctypes.c_void_p] * 9
        + [ctypes.c_longlong] + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def sign_bits(spec: torch.Tensor, epilogue: str) -> torch.Tensor:
    """The bit epilogues' hard decisions of ``[..., nsym, fft_len]`` spectra,
    one uint8 per bit in natural bin order: QPSK ``(re < 0, im < 0)``, BPSK
    ``re + im < 0``, flat per block row ``[..., nsym * fft_len * bits]``."""
    if epilogue == "qpsk":
        bits = torch.stack([spec.real < 0, spec.imag < 0], dim=-1)
    else:
        bits = spec.real + spec.imag < 0
    return bits.to(torch.uint8).reshape(spec.shape[:-2] + (-1,))


def rx_frame(x, taps, dec: int, fft_len: int, history=None,
             epilogue: str = "qpsk",
             stage_n1: Optional[int] = None) -> torch.Tensor:
    """Block ``[..., n]`` complex64 -> packed demod bytes or SN spectra.

    ``history``: optional ``[..., K-1]`` samples preceding each block row
    (zeros = causal start). On a CUDA tensor this launches the kernel of
    ``csrc/rx_frame.cu`` on the current stream, once, in the instance and
    stage split of :func:`kernel_plan` (the generic instance writes the
    spectrum unscaled and the bit epilogues' decisions and packing follow
    in PyTorch on the card); it raises on a geometry no instance takes (a
    frame beyond the opt-in shared memory), a dtype other than complex64,
    a non-contiguous block, a missing ``nvcc``, a failed build or a failed
    launch. On a CPU tensor it is :func:`rx_frame_reference`.
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
    k = taps.shape[-1]
    ku = k - 1
    span = dec * fft_len
    plan = kernel_plan(dec, fft_len, stage_n1, k)
    if plan is None:
        raise ValueError(
            f"the CUDA rx_frame kernel does not take dec {dec}, fft_len {fft_len}, "
            f"stage_n1 {stage_n1}, {k} taps: no instance fits a frame of {span} samples "
            f"in the {SMEM_LIMIT} bytes of opt-in shared memory a CTA has (see kernel_plan)"
        )
    instance, n1 = plan
    n2, r = span // n1, fft_len // n1
    batch = tuple(x.shape[:-1])
    nsym = x.shape[-1] // span
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
    generic_bits = instance == "generic" and epilogue != "spectrum"
    if epilogue == "spectrum" or generic_bits:
        out = torch.empty(batch + (nsym, fft_len), dtype=torch.complex64,
                          device=x.device)
    else:
        bits = 2 if epilogue == "qpsk" else 1
        out = torch.empty(batch + (nsym * fft_len * bits // 8,),
                          dtype=torch.uint8, device=x.device)
    if frames == 0:
        return pack_bits(sign_bits(out, epilogue)) if generic_bits else out
    consts = _kernel_constants(taps.tobytes(), k, dec, fft_len, n1, str(x.device))
    # the bit decisions of the generic instance read the unscaled spectrum,
    # as the tile instances' epilogues do
    scale = 1.0 if generic_bits else Scale.SN.factor_for(fft_len)
    index = x.get_device()
    rc = _entry()(
        INSTANCES[instance][1], EPILOGUES["spectrum" if generic_bits else epilogue],
        x.data_ptr(), None if hist is None else hist.data_ptr(),
        *(c.data_ptr() for c in consts), out.data_ptr(),
        frames, nsym, n1, n2, r, ku, scale, index,
        torch._C._cuda_getCurrentRawStream(index),
    )
    if rc != 0:
        raise RuntimeError(f"rx_frame kernel launch failed: CUDA error {rc}")
    launches += 1
    return pack_bits(sign_bits(out, epilogue)) if generic_bits else out
