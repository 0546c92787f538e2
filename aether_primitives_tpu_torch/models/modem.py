"""Modem chains (PyTorch): the loopback modem, the streaming receive chain
(FIR -> decimate -> frame FFT -> demod) and the transmit chain.

Counterpart of ``aether_primitives_tpu/models/modem.py`` (``ModemConfig``,
``Modem``, ``RxChainConfig``, ``RxChain``, ``TxChain``, ``loopback_delay``,
``pad_to_frames``). Every class computes eagerly on an explicit ``device``
(the card by default); the FIR history carried from block to block is a
plain complex64 tensor.

``fir_mode`` None means ``"fused"`` here (the JAX package picks
``"shift_add"`` off the TPU, so cross-checks name the mode). A fused RX
chain on a CUDA device goes through the hand-written RX frame kernel
(:func:`~aether_primitives_tpu_torch.ops.cuda.rx_frame.rx_frame`, one
launch a step): its bit epilogues on the sign fast path (BPSK or QPSK, all
bins active), its ``spectrum`` epilogue for every other fused chain
(active bins, QAM and PSK tables), whose active-bin slice and table demod
follow in PyTorch on the card. On the CPU the fused chain runs the plain
versions: :func:`~aether_primitives_tpu_torch.ops.fir.fir_decimate_fft`,
or on the sign path the RX frame op's. ``"os"`` and ``"shift_add"`` filter
first (:func:`~aether_primitives_tpu_torch.ops.fir.fir_filter_os`,
:func:`~aether_primitives_tpu_torch.ops.fir.fir_filter`) and run the
decimating frame FFT after, on any device, as the JAX package does; they
launch no kernel. The fused ``TxChain`` is the TX frame op
:func:`~aether_primitives_tpu_torch.ops.fir.interp_fir_ifft` (cuFFT and
matmuls: it is XLA, not Pallas, in the JAX package).

The ``sharded_*`` methods run the chain over a device mesh
(:mod:`~aether_primitives_tpu_torch.parallel.mesh`): the block's last axis
splits into contiguous per-shard time spans whose FIR history crosses the
shard boundaries through the halo exchange
(:func:`~aether_primitives_tpu_torch.parallel.halo.left_tail`: the
peer-push kernel on CUDA shards), and independent channels split over a
second mesh axis. Each shard computes on its mesh device, whatever the
chain's own ``device``: the chain's constants are host arrays that the
frame op uploads once per device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..boundary import Split, merge
from ..ops import fir as _fir
from ..ops import modulation as _mod
from ..ops import noise as _noise
from ..ops.cuda import rx_frame as _rx_frame
from ..ops.fft import Scale, check_backend, fft_of_decimated, plan as fft_plan
from ..parallel import halo as _halo
from ..parallel.mesh import CHANNEL_AXIS, TIME_AXIS, Sharded, shard, shard_last
from ..types import as_cf32, cf32, stage_device


@dataclass
class ModemConfig:
    """``modulation``: ``"bpsk"``, ``"qpsk"``, ``"qamN"`` or ``"pskN"``;
    ``noise_power``: per-component AWGN variance of :meth:`Modem.loopback`
    (reference examples/modem.rs:25); ``seed``: its generator's seed."""

    modulation: str = "qpsk"
    noise_power: float = 0.01
    seed: int = 815


@dataclass
class RxChainConfig:
    """FIR -> decimate -> blocked FFT -> demod receive chain parameters.

    The fields mirror the JAX package's config, in its order:

    - ``fir_taps``: None designs a Hamming-windowed sinc lowpass, cutoff
      1/(2*decimation), 16*decimation+1 taps (identity for decimation 1).
    - ``modulation``: ``"bpsk"``, ``"qpsk"``, ``"qamN"`` or ``"pskN"``.
    - ``fft_backend``: None or ``"xla"`` (cuFFT through ``torch.fft``, the
      only backend); the JAX package's TPU ``"matmul"`` FFT raises.
    - ``active_bins``: occupied-subcarrier count (even; None = all bins):
      FFT indices ``[0, a/2)`` and ``[fft_len - a/2, fft_len)``.
    - ``fir_mode``: ``"fused"`` (the default: FIR, decimation and frame FFT
      in one frame op), ``"os"`` (overlap-save FIR, then the decimating
      frame FFT) or ``"shift_add"`` (time-domain FIR, then the same FFT).
      The JAX package's None is ``"shift_add"`` off the TPU.
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
    fft_backend: Optional[str] = None
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
    if mode is None:
        return "fused"
    if mode not in ("fused", "os", "shift_add"):
        raise ValueError(f"unknown fir_mode {mode!r}")
    return mode


def _chain_taps(config: RxChainConfig) -> np.ndarray:
    """The chain's host complex64 taps: the config's, else the default
    lowpass for its decimation (identity for decimation 1)."""
    if config.fir_taps is not None:
        return np.asarray(config.fir_taps, dtype=np.complex64).ravel()
    if config.decimation > 1:
        return _default_lowpass(16 * config.decimation + 1, 1.0 / (2 * config.decimation))
    return np.asarray([1.0 + 0j], dtype=np.complex64)


class Modem:
    """The reference's loopback modem (examples/modem.rs): ``tx`` maps {0,1}
    bits to symbols, ``rx`` hard-demodulates them, ``loopback`` runs tx ->
    AWGN -> rx, bit-exact at the reference's noise power. ``device``: where
    it computes (the card by default; ``"cuda"`` without CUDA raises)."""

    def __init__(self, config: ModemConfig = ModemConfig(), device="cuda"):
        self.config = config
        self.device = stage_device(device, "Modem")
        self.modulation = _modulation_by_name(config.modulation)

    def tx(self, bits) -> torch.Tensor:
        return self.modulation.modulate(torch.as_tensor(bits, device=self.device))

    def rx(self, symbols) -> torch.Tensor:
        return self.modulation.demod(as_cf32(symbols, device=self.device))

    def loopback(self, bits, generator=None) -> torch.Tensor:
        """bits -> modulate -> AWGN (``config.noise_power``) -> demod. The
        noise comes from ``generator`` (a ``torch.Generator`` on the modem's
        device, or a seed), by default a new one seeded with
        ``config.seed``."""
        if generator is None:
            generator = self.config.seed
        g = _noise.make_generator(generator, self.device)
        return self.rx(_noise.apply(g, self.tx(bits), self.config.noise_power, self.device))


class RxChain:
    """The receive chain over blocks ``[..., n]`` of complex64 samples with
    ``n % (decimation * fft_len) == 0``: causal FIR, decimation, per-frame
    forward FFT (``Scale.SN``), hard demod of every bin to bits.

    ``device``: where the chain computes; blocks and states are moved there.
    The default is the card: ``device="cuda"`` without a CUDA device raises
    RuntimeError, and the CPU runs only when asked for (``device="cpu"``).
    On a CUDA device a fused chain launches the RX frame kernel once a step
    (the bit epilogues for a BPSK or QPSK chain with all bins active, the
    spectrum epilogue otherwise), and raises for a geometry the kernel does
    not take (:func:`~aether_primitives_tpu_torch.ops.cuda.rx_frame.
    kernel_supports`); it never falls back to the plain version. The
    ``"os"`` and ``"shift_add"`` modes launch no kernel. Packed output needs whole
    bytes per frame; an unpacked chain whose frame is not whole bytes
    (QPSK ``fft_len % 4``, BPSK ``fft_len % 8``) takes the op's spectrum
    epilogue and demodulates it in PyTorch, still one kernel launch.
    """

    def __init__(self, config: RxChainConfig = RxChainConfig(), device="cuda"):
        self.config = config
        self.device = stage_device(device, "RxChain")
        self.modulation = _modulation_by_name(config.modulation)
        self.taps = _chain_taps(config)
        self.fir_mode = _resolve_fir_mode(config.fir_mode)
        check_backend(config.fft_backend)
        _fir.check_precision(config.precision)
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

    def _fir(self, x, history=None) -> torch.Tensor:
        """The ``"os"`` and ``"shift_add"`` modes' causal FIR at full rate
        (the JAX chain's: overlap-save blocks of ``min(4096, n)`` samples,
        at least ``K-1``; or the time-domain shift-and-add)."""
        if self.fir_mode == "os":
            k = self.taps.shape[-1]
            block_len = max(min(4096, x.shape[-1]), k - 1 if k > 1 else 1)
            return _fir.fir_filter_os(x, self.taps, block_len=block_len, history=history)
        return _fir.fir_filter(x, self.taps, history=history)

    def _frames_spectra(self, x, history=None) -> torch.Tensor:
        """Block -> per-frame full-bin spectra ``[..., nsym, fft_len]``
        (``Scale.SN``). Fused: on a CUDA device one launch of the RX frame
        kernel's ``spectrum`` epilogue (it raises where no instance takes the
        geometry), elsewhere the plain ``fir_decimate_fft``. The other modes
        filter, then run the decimating frame FFT."""
        cfg = self.config
        if self.fir_mode == "fused":
            if x.device.type == "cuda":
                return _rx_frame.rx_frame(
                    x.contiguous(), self.taps, cfg.decimation, cfg.fft_len,
                    history=history, epilogue="spectrum", stage_n1=cfg.stage_n1,
                )
            return _fir.fir_decimate_fft(
                x, self.taps, cfg.decimation, cfg.fft_len, Scale.SN,
                history=history, stage_n1=cfg.stage_n1,
            )
        y = self._fir(x, history=history)
        span = self.frame_span
        frames = y.reshape(y.shape[:-1] + (y.shape[-1] // span, span))
        return fft_of_decimated(frames, cfg.decimation, Scale.SN)

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
        """Block -> bits through the RX frame op, which emits packed bytes;
        unpacked output is unpacked from them. A frame that is not whole
        bytes (unpacked only: the constructor refuses it packed) goes
        through the op's spectrum epilogue and the table demod."""
        cfg = self.config
        if cfg.fft_len * self.modulation.bits_per_symbol % 8:
            return self._demod_frames(_rx_frame.rx_frame(
                x, self.taps, cfg.decimation, cfg.fft_len, history=history,
                epilogue="spectrum", stage_n1=cfg.stage_n1,
            ))
        packed = _rx_frame.rx_frame(
            x, self.taps, cfg.decimation, cfg.fft_len, history=history,
            epilogue=cfg.modulation, stage_n1=cfg.stage_n1,
        )
        return packed if cfg.packed_bits else _rx_frame.unpack_bits(packed)

    def _check_span(self, n: int, shards: int = 1) -> None:
        span = self.frame_span
        if shards > 1:
            if n % shards:
                raise ValueError(
                    f"capture length {n} must divide over {shards} "
                    f"time shards; pad with pad_to_frames(x, "
                    f"{shards * span})"
                )
            n //= shards
            what = f"per-shard span {n}"
        else:
            what = f"block length {n}"
        if n % span:
            raise ValueError(
                f"{what} is not a multiple of frame_span "
                f"{span} (= decimation {self.config.decimation} x "
                f"fft_len {self.config.fft_len}); use step_ragged (keep "
                "the remainder) or step_padded (zero-pad the tail frame)"
            )

    def step(self, block) -> torch.Tensor:
        """Block -> bits, with the filter starting from zeros."""
        x = self._block(block)
        self._check_span(x.shape[-1])
        if self._sign_fast_path_ok():
            return self._bits_fast(x)
        return self._demod_frames(self._frames_spectra(x))

    def step_ragged(self, block):
        """Drop-free ragged-capture policy: demodulate every COMPLETE frame
        and hand back the remainder, ``(bits, tail)`` with ``tail =
        block[..., -(n % frame_span):]``. ``bits`` equals :meth:`step` on
        the trimmed prefix; feed ``tail`` in front of the next capture to
        lose nothing."""
        x = self._block(block)
        n = x.shape[-1]
        whole = n - n % self.frame_span
        if whole == 0:
            return torch.zeros(x.shape[:-1] + (0,), dtype=torch.uint8, device=x.device), x
        return self.step(x[..., :whole].contiguous()), x[..., whole:]

    def step_padded(self, block) -> torch.Tensor:
        """Zero-pad ragged-capture policy (the reference waterfall's,
        reference src/util/plot.rs:50-57): the tail frame is completed with
        zeros and demodulated; the output covers ``ceil(n / frame_span)``
        frames, and tail bits past the real samples are the demod of the
        filter ring-down into zeros."""
        return self.step(pad_to_frames(self._block(block), self.frame_span))

    def step_split(self, block_split) -> torch.Tensor:
        """:meth:`step` with a :class:`~aether_primitives_tpu_torch.boundary.
        Split` input (the JAX package's boundary-safe signature; the planes
        are merged where they lie, then moved to the chain's device)."""
        if not isinstance(block_split, Split):
            raise TypeError("step_split expects a boundary.Split block")
        return self.step(merge(block_split))

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

    def streaming_step_split(self, block_split, state_split):
        """:meth:`streaming_step` over :class:`~aether_primitives_tpu_torch.
        boundary.Split` block AND state (the JAX package's boundary-safe
        streaming signature): the new state comes back as a Split of
        contiguous float32 planes."""
        if not isinstance(block_split, Split) or not isinstance(state_split, Split):
            raise TypeError("streaming_step_split expects Split block/state")
        bits, ns = self.streaming_step(merge(block_split), merge(state_split))
        return bits, Split(ns.real.contiguous(), ns.imag.contiguous())

    def init_state_split(self, batch_shape=()) -> Split:
        """:meth:`init_state` as a :class:`~aether_primitives_tpu_torch.
        boundary.Split` of float32 zeros (for :meth:`streaming_step_split`)."""
        k = self.taps.shape[-1]
        shape = tuple(batch_shape) + (max(k - 1, 0),)
        return Split(torch.zeros(shape, dtype=torch.float32, device=self.device),
                     torch.zeros(shape, dtype=torch.float32, device=self.device))

    # ------------------------------------------------------- sharded steps

    def _local_bits(self, x, history=None) -> torch.Tensor:
        """One shard's block -> bits, where the shard lies."""
        if self._sign_fast_path_ok():
            return self._bits_fast(x, history=history)
        return self._demod_frames(self._frames_spectra(x, history=history))

    def _shard_bits(self, x: Sharded, axis_name: str) -> Sharded:
        """Per-shard blocks -> bits (halo + fast path when applicable)."""
        k = self.taps.shape[-1]
        h = _halo.left_tail(x, k - 1, axis_name) if k > 1 else None
        return x.map(self._local_bits, h)

    def sharded_step(self, block, mesh, axis_name: str = TIME_AXIS) -> Sharded:
        """Time-sharded step: the capture's last axis splits into contiguous
        per-shard spans; the FIR history crosses shard boundaries through
        the halo exchange, so the output is identical to :meth:`step`.
        Returns the bits as a :class:`~aether_primitives_tpu_torch.parallel.
        mesh.Sharded` value (``.gather()`` concatenates them).

        Each shard's span must be divisible by ``decimation * fft_len``
        (:attr:`frame_span`); ragged captures must pick a tail policy
        BEFORE sharding (:meth:`step_padded` semantics via
        ``pad_to_frames(x, shards * frame_span)``, or trim the
        :meth:`step_ragged` remainder off): a precise error names the
        required multiple otherwise.
        """
        self._check_span(np.shape(block)[-1], shards=int(mesh.shape[axis_name]))
        return self._shard_bits(shard_last(block, mesh, axis_name, dtype=cf32), axis_name)

    def sharded_step_2d(self, block, mesh, channel_axis: str = CHANNEL_AXIS,
                        time_axis: str = TIME_AXIS) -> Sharded:
        """Two-axis sharding: independent channels (leading axis, pure data
        parallel) x contiguous time spans (last axis, halo exchange): the
        full production layout for a multi-stream capture."""
        self._check_span(np.shape(block)[-1], shards=int(mesh.shape[time_axis]))
        xs = shard_last(block, mesh, time_axis, leading=channel_axis, dtype=cf32)
        return self._shard_bits(xs, time_axis)

    def sharded_streaming_step_2d(self, block, state, mesh,
                                  channel_axis: str = CHANNEL_AXIS,
                                  time_axis: str = TIME_AXIS):
        """:meth:`streaming_step` on the ``(channel, time)`` mesh: a
        CONTINUOUS capture processed block by block, where each block is
        itself sharded into contiguous per-shard time spans (with the halo
        exchange) across independent channels.

        ``(block, state) -> (bits, new_state)``, both results
        :class:`~aether_primitives_tpu_torch.parallel.mesh.Sharded`:
        ``block`` is ``[channels, n]``, split ``(channel, time)``;
        ``state`` is the carried FIR history ``[channels, K-1]``, split
        over ``channel`` and replicated over ``time`` (:meth:`init_state`
        with ``batch_shape=(channels,)`` before the first block, or the
        last call's ``new_state``, which passes straight back in without a
        gather). The state hand-off and the intra-block halo compose: the
        first time shard consumes the carried state where its halo would
        be, and the new state, the block's last ``K-1`` full-rate samples
        (the LAST time shard's tail), comes back copied to every time
        shard's device (the JAX package sums a masked tail over the axis).
        N successive calls are bit-exact to one contiguous :meth:`step` of
        the concatenated capture.

        On a mesh that spans processes ``block`` is the whole capture in
        every process or a ``Sharded`` value from ``shard_process_local``,
        and ``state`` likewise: the halo's edges and the new state cross
        ranks (the last time shard's rank sends its tail to every other
        rank holding a coordinate of that channel row).
        """
        self._check_span(np.shape(block)[-1], shards=int(mesh.shape[time_axis]))
        xs = shard_last(block, mesh, time_axis, leading=channel_axis, dtype=cf32)
        state_spec = (channel_axis,) + (None,) * (xs.ndim - 1)
        s = shard(state if isinstance(state, Sharded) else as_cf32(state), mesh, state_spec)
        k = self.taps.shape[-1]
        if k <= 1:
            return xs.map(self._local_bits), s
        # left_tail already rejects per-shard spans < k-1 (the halo would
        # need to reach beyond one neighbour); the same bound makes the
        # carried state a plain slice of the last shard's block below
        halo = _halo.left_tail(xs, k - 1, time_axis)
        h = halo.map(lambda hl, sl, index: sl if index[time_axis] == 0 else hl, s,
                     with_index=True)
        bits = xs.map(self._local_bits, h)
        jt = mesh.axis(time_axis)
        last = mesh.devices.shape[jt] - 1
        new_state = _halo.take_from(xs, lambda c: c[:jt] + (last,) + c[jt + 1:],
                                    lambda xl: xl[..., xl.shape[-1] - (k - 1):], state_spec)
        return bits, new_state


class TxChain:
    """The transmit chain, the inverse structure of :class:`RxChain` (share
    one :class:`RxChainConfig` for a matched pair): bits -> modulation onto
    the active subcarriers of each ``fft_len``-bin frame (guard bands zero)
    -> backward FFT (``Scale.SN``) -> zero-stuff by ``decimation`` ->
    pulse-shaping FIR with gain ``decimation``.

    ``fir_mode`` ``"fused"`` (the default) runs the TX frame op
    :func:`~aether_primitives_tpu_torch.ops.fir.interp_fir_ifft`; ``"os"``
    and ``"shift_add"`` zero-stuff densely and filter with
    :func:`~aether_primitives_tpu_torch.ops.fir.fir_filter_os` or
    :func:`~aether_primitives_tpu_torch.ops.fir.fir_filter`. Each symmetric
    length-K filter delays by ``(K-1)/2`` samples: a TX -> RX loopback skips
    :func:`loopback_delay` samples before framing. ``device``: as
    :class:`RxChain`'s."""

    def __init__(self, config: RxChainConfig = RxChainConfig(), device="cuda"):
        self.config = config
        self.device = stage_device(device, "TxChain")
        self.modulation = _modulation_by_name(config.modulation)
        self.taps = _chain_taps(config)
        self.fir_mode = _resolve_fir_mode(config.fir_mode)
        self._plan = fft_plan(config.fft_len, config.fft_backend)

    def bits_per_frame(self) -> int:
        a = self.config.active_bins or self.config.fft_len
        return a * self.modulation.bits_per_symbol

    def step(self, bits) -> torch.Tensor:
        """``[..., n_bits]`` {0,1} -> ``[..., n_frames * fft_len * decimation]``
        complex64 samples (``n_bits`` divisible by :meth:`bits_per_frame`)."""
        cfg = self.config
        a = cfg.active_bins or cfg.fft_len
        bits = torch.as_tensor(bits, device=self.device)
        bpf = self.bits_per_frame()
        if bits.shape[-1] % bpf:
            raise ValueError(f"bit count {bits.shape[-1]} not divisible by bits/frame {bpf}")
        nframes = bits.shape[-1] // bpf
        syms = self.modulation.modulate(bits)
        syms = syms.reshape(syms.shape[:-1] + (nframes, a))
        if a != cfg.fft_len:
            half = a // 2
            guard = torch.zeros(syms.shape[:-1] + (cfg.fft_len - a,), dtype=cf32,
                                device=self.device)
            spec = torch.cat([syms[..., :half], guard, syms[..., half:]], dim=-1)
        else:
            spec = syms
        dec = cfg.decimation
        taps = self.taps * np.complex64(dec)
        if dec > 1 and self.fir_mode == "fused":
            return _fir.interp_fir_ifft(spec, taps, dec, Scale.SN)
        tf = self._plan.bwd(spec, Scale.SN)
        x = tf.reshape(tf.shape[:-2] + (nframes * cfg.fft_len,))
        if dec > 1:
            # zero-stuff by a dense reshape: [..., n] -> [..., n, dec] -> flat
            up = torch.nn.functional.pad(x[..., None], (0, dec - 1))
            up = up.reshape(x.shape[:-1] + (x.shape[-1] * dec,))
            if self.fir_mode == "os":
                x = _fir.fir_filter_os(up, taps)
            else:
                x = _fir.fir_filter(up, taps)
        return x


def loopback_delay(tx: TxChain, rx: RxChain) -> int:
    """Full-rate sample delay of a TX -> RX cascade (the sum of the two
    symmetric filters' group delays): skip this many samples before RX
    framing."""
    d = 0
    if tx.config.decimation > 1:
        d += (tx.taps.shape[-1] - 1) // 2
    d += (rx.taps.shape[-1] - 1) // 2
    return d


def pad_to_frames(block, multiple: int) -> torch.Tensor:
    """Zero-pad the last axis up to the next multiple of ``multiple`` (the
    same semantics as :meth:`RxChain.step_padded`; the JAX package applies it
    before a mesh split, with ``n_time_shards * chain.frame_span``). The
    block keeps its dtype and device."""
    x = torch.as_tensor(block)
    r = x.shape[-1] % int(multiple)
    if not r:
        return x
    pad = torch.zeros(x.shape[:-1] + (int(multiple) - r,), dtype=x.dtype, device=x.device)
    return torch.cat([x, pad], dim=-1)
