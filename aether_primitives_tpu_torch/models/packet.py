"""Packet transceiver: the burst link (PyTorch).

Counterpart of ``aether_primitives_tpu/models/packet.py`` for ``fec`` in
{"viterbi", "turbo", "none"}:

TX: payload -> CRC -> multiplicative scramble -> FEC -> block interleave
    -> modulate -> [preamble | symbols]
RX: capture -> preamble acquisition -> CFO off the repeated halves ->
    complex gain and noise variance off the preamble -> blind fine CFO and
    phase (BPSK/QPSK) -> soft demod -> deinterleave -> decode ->
    descramble -> CRC verdict

Everything is batched over leading axes natively: the burst offset found
per row becomes a gather, and the decoders take the batch as their lane
axis. ``fec="viterbi"`` decodes through the Viterbi kernel
(:mod:`~aether_primitives_tpu_torch.ops.cuda.viterbi`, one launch per
call), ``fec="turbo"`` through the BCJR kernel
(:mod:`~aether_primitives_tpu_torch.ops.cuda.bcjr`, two launches per
iteration) on a CUDA device; on the CPU both run their plain versions.
The other FEC families raise :class:`NotImplementedError`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops import fec as _fec
from ..ops import modulation as _mod
from ..ops import sequence as _seq
from ..ops import turbo as _turbo
from ..types import as_cf32, stage_device
from . import sync as _sync

#: FEC families the port decodes.
PORTED_FECS = ("viterbi", "turbo", "none")
#: The JAX package's other FEC families, still to be ported (ROADMAP.md,
#: queue 1 item 12).
UNPORTED_FECS = ("ldpc", "ldpc11n", "nr_ldpc", "rs", "bch", "tpc", "ccsds", "polar")


def _modulation_by_name(name: str) -> _mod.Modulation:
    named = {"bpsk": _mod.bpsk, "qpsk": _mod.qpsk, "qam16": _mod.qam16}
    if name in named:
        return named[name]()
    if name.startswith("apsk"):
        raise NotImplementedError(
            f"modulation {name!r} is not ported yet (ROADMAP.md, queue 1 item 3)"
        )
    if name.startswith("psk"):
        return _mod.psk(int(name[3:]))
    return _mod.qam(int(name[3:]))


@dataclass(frozen=True)
class PacketConfig:
    """The JAX package's packet configuration, every field kept for parity.
    Only ``fec`` in :data:`PORTED_FECS` is accepted by :class:`PacketModem`;
    the fields of the other families (``ldpc_*``, ``rs_*``, ``bch_*``,
    ``tpc_*``, ``ccsds_*``, ``polar_*``, ``nr_*``) are carried unused."""

    payload_bits: int = 960
    modulation: str = "qpsk"
    fec: str = "viterbi"
    crc: str = "crc32"
    scrambler: Tuple[int, ...] = (14, 15)
    interleave_rows: int = 0  # 0 = none; coded bits padded to a multiple
    preamble_half: int = 64  # symbols per identical half
    preamble_cinit: int = 0x1234
    ldpc_seed: int = 7
    ldpc_file: Optional[str] = None
    nr_base_graph_file: Optional[str] = None
    rs_n: int = 255
    rs_k: int = 223
    rs_erasures: bool = False
    rs_erasure_threshold: float = 0.25
    bch_n: int = 255
    bch_t: int = 8
    bch_chase: int = 0
    tpc_m: int = 5
    tpc_p: int = 4
    tpc_iters: int = 4
    tpc_t: int = 1
    ccsds_interleave_rows: int = 8
    ccsds_interleaver: str = "block"
    ccsds_interleave_cell: int = 17
    polar_n: int = 512
    polar_list: int = 8
    polar_design_snr_db: float = 1.0
    polar_decoder: str = "scl"
    nr_bg: int = 2
    nr_rate: float = 0.5
    nr_rv: int = 0

    @property
    def crc_width(self) -> int:
        return _fec.CRC_PARAMS[self.crc][1]


class PacketModem:
    """Config-driven burst packet transceiver (see the module docstring).

    ``tx(payload)`` -> complex64 burst(s); ``rx(capture)`` -> ``(payload,
    crc_ok, diag)`` with ``diag`` the offset, preamble metric, CFO, complex
    gain and noise variance; ``rx_batch`` takes ``[B, window]`` captures.

    ``device``: where the modem computes; inputs are moved there. The
    default is the card: ``device="cuda"`` without one raises
    RuntimeError. On a CUDA device the decoders launch their kernels (or
    raise); on the CPU they run their plain versions.
    """

    def __init__(self, config: PacketConfig = PacketConfig(), device="cuda"):
        self.config = c = config
        self.device = stage_device(device, "PacketModem")
        if c.fec in UNPORTED_FECS:
            raise NotImplementedError(
                f"fec {c.fec!r} is not ported yet (ROADMAP.md, queue 1 item 12); "
                f"the port decodes {PORTED_FECS}"
            )
        if c.fec not in PORTED_FECS:
            raise ValueError(f"unknown fec {c.fec!r}")
        self.modulation = _modulation_by_name(c.modulation)
        bps = self.modulation.bits_per_symbol
        self.frame_bits = c.payload_bits + c.crc_width
        if c.fec == "viterbi":
            self.coded_bits = 2 * (self.frame_bits + _fec.DEFAULT_K - 1)
        elif c.fec == "turbo":
            # [sys n | par1 n | par2 n | tail_sys 3 | tail_par 3]
            self.coded_bits = 3 * self.frame_bits + 6
        else:
            self.coded_bits = self.frame_bits
        rows = c.interleave_rows
        self.inter_pad = 0 if rows <= 1 else (-self.coded_bits) % rows
        line_bits = self.coded_bits + self.inter_pad
        self.mod_pad = (-line_bits) % bps
        self.n_data_symbols = (line_bits + self.mod_pad) // bps
        # preamble: Gold-sequence QPSK, two identical halves, host numpy
        pre_bits = _seq.lte_gold(c.preamble_cinit, 2 * c.preamble_half)
        qtab = np.asarray(_mod.qpsk().table, dtype=np.complex64)
        grouped = pre_bits.reshape(-1, 2).astype(np.int64)
        idx = grouped[:, 0] + 2 * grouped[:, 1]  # LSB-first packing
        half = qtab[idx]
        self.preamble = np.concatenate([half, half])
        self.burst_len = self.preamble.size + self.n_data_symbols
        self._pre = torch.from_numpy(self.preamble).to(self.device)

    # ------------------------------------------------------------ TX

    def tx(self, payload) -> torch.Tensor:
        """Payload bits ``[..., payload_bits]`` -> complex64 bursts
        ``[..., burst_len]`` on the modem's device."""
        c = self.config
        bits = torch.as_tensor(payload).to(self.device).to(torch.uint8) % 2
        if bits.shape[-1] != c.payload_bits:
            raise ValueError(
                f"payload must be {c.payload_bits} bits, got {bits.shape[-1]}"
            )
        frame = _fec.crc_append(bits, c.crc)
        line = _seq.scramble_multiplicative(frame, c.scrambler)
        if c.fec == "viterbi":
            coded = _fec.conv_encode(line)
        elif c.fec == "turbo":
            coded = torch.cat(_turbo.turbo_encode(line), dim=-1)
        else:
            coded = line
        if self.inter_pad or c.interleave_rows > 1:
            coded = torch.nn.functional.pad(coded, (0, self.inter_pad))
            coded = _fec.interleave(coded, c.interleave_rows)
        if self.mod_pad:
            coded = torch.nn.functional.pad(coded, (0, self.mod_pad))
        symbols = self.modulation.modulate(coded)
        pre = self._pre.expand(symbols.shape[:-1] + self._pre.shape)
        return torch.cat([pre, symbols], dim=-1)

    # ------------------------------------------------------------ RX

    def rx(self, capture):
        """Decode captures ``[..., window]``, one burst each: ``(payload,
        crc_ok, diag)``, every entry with the captures' leading shape."""
        llr, diag = self._rx_front(capture)
        line = self._decode_llr(llr)
        payload, ok = self._rx_tail(line)
        return payload, ok, diag

    def _rx_front(self, capture):
        """Acquisition -> CFO -> equalise -> soft demod -> deinterleave:
        captures ``[..., window]`` -> coded-bit LLRs ``[..., coded_bits]``
        and the diag dict."""
        c = self.config
        x = as_cf32(capture, device=self.device)
        npre = self.preamble.size
        offset, metric = _sync.detect_preamble(x, self.preamble)
        offset = offset.clamp(0, x.shape[-1] - self.burst_len)
        span = torch.arange(self.burst_len, device=x.device)
        burst = x.gather(-1, offset[..., None] + span)
        # CFO off the repeated preamble halves, then correct the burst
        cfo = _sync.estimate_cfo(burst, c.preamble_half)
        burst = _sync.apply_freq_shift(burst, cfo)
        # complex gain + noise variance off the (derotated) preamble
        pre = self._pre
        rx_pre = burst[..., :npre]
        gain = (rx_pre * pre.conj()).sum(dim=-1) / (pre.abs() ** 2).sum()
        eq = burst[..., npre:] / gain[..., None]
        resid = rx_pre / gain[..., None] - pre
        noise_var = (resid.abs() ** 2).mean(dim=-1).clamp_min(1e-6)
        fine = torch.zeros_like(cfo)
        if self.modulation.bits_per_symbol <= 2:
            m_fold = 2 ** self.modulation.bits_per_symbol
            fine = _sync.estimate_cfo_blind(eq, m_fold)
            eq = _sync.apply_freq_shift(eq, fine)
            phi = _sync.estimate_phase_mpsk(eq, m_fold)
            eq = eq * torch.complex(torch.cos(-phi), torch.sin(-phi))[..., None]
        llr = self.modulation.demod_soft(eq, noise_var[..., None])
        if self.mod_pad:
            llr = llr[..., : llr.shape[-1] - self.mod_pad]
        if self.inter_pad or c.interleave_rows > 1:
            llr = _fec.deinterleave(llr, c.interleave_rows)[..., : self.coded_bits]
        diag = {
            "offset": offset,
            "metric": metric,
            "cfo": cfo + fine,
            "gain": gain,
            "noise_var": noise_var,
        }
        return llr, diag

    def _decode_llr(self, llr):
        """Coded-bit LLRs ``[..., coded_bits]`` -> line bits ``[...,
        frame_bits]`` (uint8), batched over the leading axes."""
        c = self.config
        if c.fec == "viterbi":
            return _fec.viterbi_decode(llr)
        if c.fec == "turbo":
            nb = self.frame_bits
            line, _llr = _turbo.turbo_decode(
                llr[..., :nb],
                llr[..., nb:2 * nb],
                llr[..., 2 * nb:3 * nb],
                llr[..., 3 * nb:3 * nb + 3],
                llr[..., 3 * nb + 3:],
                iterations=8,
                window=64,
                guard=16,
            )
            return line
        return (llr < 0).to(torch.uint8)

    def _rx_tail(self, line):
        """Line bits -> descramble -> CRC verdict."""
        c = self.config
        frame = _seq.descramble_multiplicative(line, c.scrambler)
        ok = _fec.crc_check(frame, c.crc)
        return frame[..., : c.payload_bits], ok

    def rx_batch(self, captures):
        """Batched burst RX over ``[B, window]`` captures: ``(payloads [B,
        payload_bits], crc_ok [B], diag)`` with every diag entry ``[B]``.
        One front-end pass, one decoder call, one tail pass for the whole
        batch."""
        x = as_cf32(captures, device=self.device)
        if x.ndim != 2:
            raise ValueError(
                f"rx_batch takes [B, window] captures, got shape {tuple(x.shape)}"
            )
        return self.rx(x)

    def loopback(self, payload):
        """tx -> rx with no channel (sanity path)."""
        return self.rx(self.tx(payload))
