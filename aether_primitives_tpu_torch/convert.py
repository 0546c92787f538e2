"""Carry the JAX package's parameters and state into the port.

The functions take numpy data only, so the port never imports the JAX
package: pass ``dataclasses.asdict(jax_config)`` and ``np.asarray(state)``.
The burst link has no weights: what it carries is its configuration, from
which both packages build the same preamble and turbo permutation. The
streaming channelizer and DDC stages carry state (tails, oscillator phase,
filter history): :func:`stage_state_from_numpy` loads it, so that a stream
started in the JAX package continues in the port; so does
:func:`iir_states_from_numpy` for ``sosfilt_stream``'s section states.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .models.channelizer import PfbChannelizerOs, PfbSynthesizerOs
from .models.css import CssConfig
from .models.ddc import Ddc, DdcConfig
from .models.fhss import FhssConfig
from .models.fsk import FskConfig
from .models.ofdm import OfdmConfig
from .models.channel import ChannelConfig
from .models.modem import ModemConfig, RxChainConfig
from .models.packet import PacketConfig


def _carried(fields: dict) -> dict:
    """The fields as the port takes them: the JAX package's TPU FFT backend
    (``fft_backend="matmul"``, the MXU matmul FFT) carries over as None, the
    port's one FFT (cuFFT) in its place; ``"xla"`` and None carry as they
    are, and any other name raises where the config is used."""
    fields = dict(fields)
    if fields.get("fft_backend") == "matmul":
        fields["fft_backend"] = None
    return fields

def config_from_numpy(fields: dict) -> RxChainConfig:
    """``dataclasses.asdict`` of the JAX package's ``RxChainConfig`` -> the
    port's :class:`RxChainConfig` (:func:`_carried`). Taps become complex64
    numpy; an unknown field raises."""
    fields = _carried(fields)
    known = {f.name for f in dataclasses.fields(RxChainConfig)}
    unknown = sorted(set(fields) - known)
    if unknown:
        raise ValueError(f"RxChainConfig has no fields {unknown}")
    if fields.get("fir_taps") is not None:
        fields["fir_taps"] = np.asarray(fields["fir_taps"], dtype=np.complex64)
    return RxChainConfig(**fields)


def modem_config_from_numpy(fields: dict) -> ModemConfig:
    """``dataclasses.asdict`` of the JAX package's ``ModemConfig`` -> the
    port's :class:`ModemConfig` (an unknown field raises)."""
    known = {f.name for f in dataclasses.fields(ModemConfig)}
    unknown = sorted(set(fields) - known)
    if unknown:
        raise ValueError(f"ModemConfig has no fields {unknown}")
    return ModemConfig(**fields)


def channel_config_from_numpy(fields: dict) -> ChannelConfig:
    """``dataclasses.asdict`` of the JAX package's ``ChannelConfig`` -> the
    port's :class:`ChannelConfig`: taps become a tuple of Python complex
    numbers, ``dc`` a complex (an unknown field raises)."""
    known = {f.name for f in dataclasses.fields(ChannelConfig)}
    unknown = sorted(set(fields) - known)
    if unknown:
        raise ValueError(f"ChannelConfig has no fields {unknown}")
    fields = dict(fields)
    if fields.get("taps") is not None:
        fields["taps"] = tuple(complex(t) for t in np.asarray(fields["taps"]).ravel())
    if "dc" in fields:
        fields["dc"] = complex(fields["dc"])
    return ChannelConfig(**fields)


def packet_config_from_numpy(fields: dict) -> PacketConfig:
    """``dataclasses.asdict`` of the JAX package's ``PacketConfig`` -> the
    port's :class:`PacketConfig` (every field carried; an unknown field
    raises)."""
    known = {f.name for f in dataclasses.fields(PacketConfig)}
    unknown = sorted(set(fields) - known)
    if unknown:
        raise ValueError(f"PacketConfig has no fields {unknown}")
    fields = dict(fields)
    if "scrambler" in fields:
        fields["scrambler"] = tuple(int(d) for d in fields["scrambler"])
    return PacketConfig(**fields)


def ddc_config_from_numpy(fields: dict) -> DdcConfig:
    """``dataclasses.asdict`` of the JAX package's ``DdcConfig`` -> the
    port's :class:`DdcConfig` (:func:`_carried`; taps become complex64 numpy;
    an unknown field raises)."""
    fields = _carried(fields)
    known = {f.name for f in dataclasses.fields(DdcConfig)}
    unknown = sorted(set(fields) - known)
    if unknown:
        raise ValueError(f"DdcConfig has no fields {unknown}")
    if fields.get("taps") is not None:
        fields["taps"] = np.asarray(fields["taps"], dtype=np.complex64)
    return DdcConfig(**fields)


def fsk_config_from_numpy(fields: dict) -> FskConfig:
    """``dataclasses.asdict`` of the JAX package's ``FskConfig`` -> the
    port's :class:`FskConfig` (an unknown field raises)."""
    known = {f.name for f in dataclasses.fields(FskConfig)}
    unknown = sorted(set(fields) - known)
    if unknown:
        raise ValueError(f"FskConfig has no fields {unknown}")
    fields = dict(fields)
    if fields.get("bt") is not None:
        fields["bt"] = float(fields["bt"])
    return FskConfig(**fields)


def _config(cls, fields: dict):
    """``cls(**fields)`` after :func:`_carried`; an unknown field raises."""
    fields = _carried(fields)
    known = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(fields) - known)
    if unknown:
        raise ValueError(f"{cls.__name__} has no fields {unknown}")
    return cls(**fields)


def ofdm_config_from_numpy(fields: dict) -> OfdmConfig:
    """``dataclasses.asdict`` of the JAX package's ``OfdmConfig`` -> the
    port's :class:`OfdmConfig` (:func:`_carried`; an unknown field
    raises)."""
    return _config(OfdmConfig, fields)


def css_config_from_numpy(fields: dict) -> CssConfig:
    """``dataclasses.asdict`` of the JAX package's ``CssConfig`` -> the
    port's :class:`CssConfig` (:func:`_carried`; an unknown field raises)."""
    return _config(CssConfig, fields)


def fhss_config_from_numpy(fields: dict) -> FhssConfig:
    """``dataclasses.asdict`` of the JAX package's ``FhssConfig`` -> the
    port's :class:`FhssConfig` (an unknown field raises)."""
    return _config(FhssConfig, fields)


def iir_states_from_numpy(states, device) -> list:
    """The JAX package's ``sosfilt_stream`` states (a list of per-section
    complex ``[..., 2]`` arrays, or Nones at a cold start) -> the port's
    list of complex64 tensors on ``device``; the next
    ``ops.iir.sosfilt_stream`` call continues the JAX stream."""
    return [None if s is None else state_from_numpy(np.asarray(s), device) for s in states]


def stage_state_from_numpy(stage, tail=None, phase=None, history=None):
    """Continue a stream that the JAX package started: load the carried
    state of its ``PfbChannelizerOs`` or ``PfbSynthesizerOs`` (``tail``:
    ``np.asarray(jax_stage._tail)``, complex) or its ``Ddc`` (``phase``:
    ``jax_ddc._phase``, radians; ``history``: ``np.asarray(
    jax_ddc._history)``, the last ``K-1`` mixed samples) into the port's
    ``stage`` of the same kind and configuration, on the stage's device.
    None leaves a piece at the stage's cold start. Returns ``stage``; its
    next ``step`` continues the JAX stream."""
    if isinstance(stage, (PfbChannelizerOs, PfbSynthesizerOs)):
        if phase is not None or history is not None:
            raise ValueError(f"{type(stage).__name__} carries only a tail")
        stage._tail = None if tail is None else state_from_numpy(tail, stage.device)
    elif isinstance(stage, Ddc):
        if tail is not None:
            raise ValueError("Ddc carries a phase and a history, not a tail")
        k = stage.taps.shape[-1]
        h = None if history is None else state_from_numpy(history, stage.device)
        if h is not None and h.shape[-1] != k - 1:
            raise ValueError(f"Ddc history must have K-1 = {k - 1} samples")
        stage._history = h
        stage._phase = 0.0 if phase is None else float(phase)
    else:
        raise TypeError(f"no carried state to load into {type(stage).__name__}")
    return stage


def state_from_numpy(state, device) -> torch.Tensor:
    """The JAX chain's carried FIR history (complex ``[..., K-1]``, or an
    ``(re, im)`` pair of float32 planes) -> a complex64 tensor on ``device``."""
    if isinstance(state, (tuple, list)):
        re, im = (np.asarray(p, dtype=np.float32) for p in state)
        arr = (re + 1j * im).astype(np.complex64)
    else:
        arr = np.array(state, dtype=np.complex64)  # a writable copy
    return torch.from_numpy(arr).to(device)
