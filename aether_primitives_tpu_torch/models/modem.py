"""The streaming receive chain (PyTorch): FIR -> decimate -> frame FFT -> demod.

Counterpart of ``aether_primitives_tpu/models/modem.py`` (``RxChainConfig``,
``RxChain``), main-path subset. The chain runs eagerly on an explicit
``device``; the FIR history carried from block to block is a plain complex64
tensor. With ``fir_mode="fused"`` and a BPSK or QPSK table, a block goes
through the hand-written RX frame kernel
(:func:`~aether_primitives_tpu_torch.ops.cuda.rx_frame.rx_frame`) on a CUDA
device, and through its plain PyTorch version on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..ops import fir as _fir
from ..ops import modulation as _mod
from ..ops.cuda import rx_frame as _rx_frame
from ..ops.fft import Scale
from ..types import as_cf32, cf32, stage_device


@dataclass
class RxChainConfig:
    """FIR -> decimate -> blocked FFT -> demod receive chain parameters.

    The fields mirror the JAX package's config (without its TPU FFT
    backend choice):

    - ``fir_taps``: None designs a Hamming-windowed sinc lowpass, cutoff
      1/(2*decimation), 16*decimation+1 taps (identity for decimation 1).
    - ``modulation``: ``"bpsk"``, ``"qpsk"``, ``"qamN"`` or ``"pskN"``.
    - ``active_bins``: occupied-subcarrier count (even; None = all bins):
      FFT indices ``[0, a/2)`` and ``[fft_len - a/2, fft_len)``.
    - ``fir_mode``: ``"fused"`` (the default, and the only mode ported:
      FIR, decimation and frame FFT in one frame op). The JAX package's
      ``"shift_add"`` and ``"os"`` modes are not ported yet.
    - ``precision``: ``"highest"`` (full float32, the only setting; None
      means it). The JAX package's ``"high"`` is a TPU bf16x3 matmul mode
      with no counterpart here.
    - ``stage_n1``: first-stage size of the fused op (must divide fft_len;
      None = heuristic).
    - ``packed_bits``: emit uint8 bytes of 8 bits, LSB-first, instead of
      one byte per bit.
    """

    fir_taps: Optional[np.ndarray] = None
    decimation: int = 4
    fft_len: int = 2048
    modulation: str = "qpsk"
    active_bins: Optional[int] = None
    fir_mode: Optional[str] = None
    precision: Optional[str] = None
    stage_n1: Optional[int] = None
    packed_bits: bool = False


def _modulation_by_name(name: str) -> _mod.Modulation:
    if name == "qpsk":
        return _mod.qpsk()
    if name == "bpsk":
        return _mod.bpsk()
    if name == "qam16":
        return _mod.qam16()
    if name.startswith("qam") and name[3:].isdigit():
        return _mod.qam(int(name[3:]))
    if name.startswith("psk") and name[3:].isdigit():
        return _mod.psk(int(name[3:]))
    raise ValueError(
        f"unknown modulation {name!r} (expected 'bpsk', 'qpsk', 'qamN' or 'pskN')"
    )


def _default_lowpass(ntaps: int, cutoff: float) -> np.ndarray:
    n = np.arange(ntaps) - (ntaps - 1) / 2.0
    h = 2 * cutoff * np.sinc(2 * cutoff * n)
    h *= np.hamming(ntaps)
    return (h / h.sum()).astype(np.complex64)


def _resolve_fir_mode(mode: Optional[str]) -> str:
    if mode is None or mode == "fused":
        return "fused"
    if mode in ("shift_add", "os"):
        raise ValueError(
            f"fir_mode {mode!r} is not ported yet (ROADMAP.md, queue 1 "
            "item 5); use 'fused'"
        )
    raise ValueError(f"unknown fir_mode {mode!r}")


def _check_precision(name: Optional[str]) -> None:
    if name in (None, "highest"):
        return
    if name == "high":
        raise ValueError(
            "precision 'high' is the TPU's bf16x3 matmul setting and has no "
            "counterpart on the GPU; the port computes in full float32 "
            "('highest')"
        )
    raise ValueError(f"precision {name!r} not allowed (expected 'highest')")


class RxChain:
    """The receive chain over blocks ``[..., n]`` of complex64 samples with
    ``n % (decimation * fft_len) == 0``: causal FIR, decimation, per-frame
    forward FFT (``Scale.SN``), hard demod of every bin to bits.

    ``device``: where the chain computes; blocks and states are moved there.
    The default is the card: ``device="cuda"`` without a CUDA device raises
    RuntimeError, and the CPU runs only when asked for (``device="cpu"``).
    On a CUDA device a BPSK or QPSK chain with all bins active launches
    the RX frame kernel, and raises for a geometry the kernel does not take
    (:func:`~aether_primitives_tpu_torch.ops.cuda.rx_frame.kernel_supports`);
    it never falls back to the plain version. Such a chain emits whole
    bytes per frame, so it needs ``fft_len % 4 == 0`` (QPSK) or
    ``fft_len % 8 == 0`` (BPSK), packed or not.
    """

    def __init__(self, config: RxChainConfig = RxChainConfig(), device="cuda"):
        self.config = config
        self.device = stage_device(device, "RxChain")
        self.modulation = _modulation_by_name(config.modulation)
        if config.fir_taps is None:
            if config.decimation > 1:
                taps = _default_lowpass(16 * config.decimation + 1,
                                        1.0 / (2 * config.decimation))
            else:
                taps = np.asarray([1.0 + 0j], dtype=np.complex64)
        else:
            taps = np.asarray(config.fir_taps, dtype=np.complex64).ravel()
        self.taps = taps
        self.fir_mode = _resolve_fir_mode(config.fir_mode)
        _check_precision(config.precision)
        if config.packed_bits:
            bpf = self.modulation.bits_per_symbol * (
                config.active_bins or config.fft_len
            )
            if bpf % 8:
                raise ValueError(
                    "packed_bits needs bits-per-frame divisible by 8, "
                    f"got {bpf}"
                )

    @property
    def frame_span(self) -> int:
        """Full-rate samples per demodulated frame (``decimation * fft_len``)."""
        return self.config.decimation * self.config.fft_len

    def _block(self, block) -> torch.Tensor:
        return as_cf32(block, device=self.device)

    def _frames_spectra(self, x, history=None) -> torch.Tensor:
        """Block -> per-frame full-bin spectra ``[..., nsym, fft_len]``."""
        cfg = self.config
        return _fir.fir_decimate_fft(
            x, self.taps, cfg.decimation, cfg.fft_len, Scale.SN,
            history=history, stage_n1=cfg.stage_n1,
        )

    def _active(self, spec) -> torch.Tensor:
        """The occupied (centre-band) subcarriers of full frames."""
        a = self.config.active_bins
        if a:
            half = a // 2
            n = spec.shape[-1]
            spec = torch.cat([spec[..., :half], spec[..., n - (a - half):]], dim=-1)
        return spec

    def _emit(self, flat_bits) -> torch.Tensor:
        return _rx_frame.pack_bits(flat_bits) if self.config.packed_bits else flat_bits

    def _demod_frames(self, spec) -> torch.Tensor:
        bits = self.modulation.demod(self._active(spec))
        return self._emit(bits.reshape(bits.shape[:-2] + (-1,)))

    def spectra(self, block) -> torch.Tensor:
        """Front half: block -> per-frame active-bin spectra
        ``[..., n_frames, active_bins]``."""
        return self._active(self._frames_spectra(self._block(block)))

    def demod_spectra(self, active_spec) -> torch.Tensor:
        """Back half: active-bin spectra -> bits (packed bytes when
        ``config.packed_bits``)."""
        bits = self.modulation.demod(self._block(active_spec))
        return self._emit(bits.reshape(bits.shape[:-2] + (-1,)))

    def _sign_fast_path_ok(self) -> bool:
        """True when blocks go through the RX frame op (the same condition
        as the JAX chain's): fused mode, all bins active, a sign-test table
        and a two-stage geometry. Whether the CUDA kernel takes that
        geometry is the op's to decide: on a card it launches or raises."""
        cfg = self.config
        return (
            self.fir_mode == "fused"
            and not cfg.active_bins
            and self.modulation._sign_fast
            and _fir._fused_stage_n1(cfg.decimation, cfg.fft_len, cfg.stage_n1)
            is not None
        )

    def _bits_fast(self, x, history=None) -> torch.Tensor:
        """Block -> bits through the RX frame kernel, which emits packed
        bytes; unpacked output is unpacked from them."""
        cfg = self.config
        packed = _rx_frame.rx_frame(
            x, self.taps, cfg.decimation, cfg.fft_len, history=history,
            epilogue=cfg.modulation, stage_n1=cfg.stage_n1,
        )
        return packed if cfg.packed_bits else _rx_frame.unpack_bits(packed)

    def _check_span(self, n: int) -> None:
        if n % self.frame_span:
            raise ValueError(
                f"block length {n} is not a multiple of frame_span "
                f"{self.frame_span} (= decimation {self.config.decimation} x "
                f"fft_len {self.config.fft_len})"
            )

    def step(self, block) -> torch.Tensor:
        """Block -> bits, with the filter starting from zeros."""
        x = self._block(block)
        self._check_span(x.shape[-1])
        if self._sign_fast_path_ok():
            return self._bits_fast(x)
        return self._demod_frames(self._frames_spectra(x))

    def init_state(self, batch_shape=()) -> torch.Tensor:
        """Zero FIR history ``[..., K-1]`` on the chain's device."""
        k = self.taps.shape[-1]
        return torch.zeros(tuple(batch_shape) + (max(k - 1, 0),), dtype=cf32,
                           device=self.device)

    def streaming_step(self, block, state):
        """``(block, state) -> (bits, new_state)``: :meth:`step` with the FIR
        history threaded from block to block. ``state`` is the previous
        block's last ``K-1`` full-rate samples (:meth:`init_state` before
        the first block); successive calls equal one contiguous
        :meth:`step`. ``new_state`` is a copy, not a view of ``block``.
        """
        x = self._block(block)
        self._check_span(x.shape[-1])
        k = self.taps.shape[-1]
        h = self._block(state) if k > 1 else None
        if self._sign_fast_path_ok():
            bits = self._bits_fast(x, history=h)
        else:
            bits = self._demod_frames(self._frames_spectra(x, history=h))
        if k > 1:
            if x.shape[-1] >= k - 1:
                new_state = x[..., x.shape[-1] - (k - 1):].clone()
            else:
                # a block shorter than the filter memory (taps fit in a
                # frame, so only an empty one) keeps the previous state
                new_state = torch.cat([h.expand(x.shape[:-1] + (k - 1,)), x],
                                      dim=-1)[..., -(k - 1):]
        else:
            new_state = self._block(state)
        return bits, new_state
