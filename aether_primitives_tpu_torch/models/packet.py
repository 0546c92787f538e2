"""Packet transceiver: the burst link (PyTorch).

Counterpart of ``aether_primitives_tpu/models/packet.py`` for ``fec`` in
:data:`PORTED_FECS`:

TX: payload -> CRC -> multiplicative scramble -> FEC -> block interleave
    -> modulate -> [preamble | symbols]
RX: capture -> preamble acquisition -> CFO off the repeated halves ->
    complex gain and noise variance off the preamble -> blind fine CFO and
    phase (BPSK/QPSK) -> soft demod -> deinterleave -> decode ->
    descramble -> CRC verdict

Everything is batched over leading axes natively: the burst offset found
per row becomes a gather, and every decoder takes the whole batch in one
call. On a CUDA device ``fec="viterbi"`` decodes through the Viterbi
kernel (:mod:`~aether_primitives_tpu_torch.ops.cuda.viterbi`, one launch
per call) and ``fec="turbo"`` through the BCJR kernel
(:mod:`~aether_primitives_tpu_torch.ops.cuda.bcjr`, two launches per
iteration). ``fec="ccsds"`` (RS outer, K=7 convolutional inner, an 8-row
block or a symbol-wise circular Forney interleaver between) decodes its
inner code windowed through the Viterbi kernel (64/48, one launch), or
with ``rs_erasures`` through the BCJR kernel's soft output (96/64, one
launch) so that the outer RS can erase its unreliable symbols. The
``rs``, ``bch`` (hard or Chase-2), ``tpc``, ``ldpc`` (the Gallager
ensemble, or a table from ``ldpc_file``: an ``.alist`` through the dense
min-sum decoder, a QC ``.npz`` through the QC one), ``ldpc11n``,
``nr_ldpc`` (NR-structured QC-LDPC with rate matching, or the shift table
of ``nr_base_graph_file``) and ``polar`` (CA-SCL with an inner CRC-8, SC
at ``polar_list`` 1, or flooding BP) decoders are plain PyTorch on every
device, as they are XLA in the JAX package. On the CPU the kernels' plain
versions run.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops import bch as _bch
from ..ops import code_io as _cio
from ..ops import fec as _fec
from ..ops import ldpc as _ldpc
from ..ops import modulation as _mod
from ..ops import nr_ldpc as _nr
from ..ops import polar as _polar
from ..ops import rs as _rs
from ..ops import sequence as _seq
from ..ops import tpc as _tpc
from ..ops._stats import median_midpoint
from ..ops import turbo as _turbo
from ..parallel.mesh import CHANNEL_AXIS, Sharded, shard
from ..types import as_cf32, stage_device
from . import sync as _sync

#: FEC families the port decodes: every family of the JAX package.
PORTED_FECS = ("viterbi", "turbo", "none", "rs", "ccsds", "bch", "tpc", "ldpc", "ldpc11n",
               "nr_ldpc", "polar")


def _modulation_by_name(name: str) -> _mod.Modulation:
    named = {"bpsk": _mod.bpsk, "qpsk": _mod.qpsk, "qam16": _mod.qam16}
    if name in named:
        return named[name]()
    if name.startswith("apsk"):
        return _mod.apsk(int(name[4:]))
    if name.startswith("psk"):
        return _mod.psk(int(name[3:]))
    return _mod.qam(int(name[3:]))


@dataclass(frozen=True)
class PacketConfig:
    """The JAX package's packet configuration, every field kept for parity.
    ``fec`` is one of :data:`PORTED_FECS`; ``ldpc_file`` (an ``.alist`` or
    a QC ``.npz``) replaces the Gallager code of ``fec="ldpc"``, and
    ``nr_base_graph_file`` (a QC ``.npz``) the built-in NR graph of
    ``fec="nr_ldpc"``."""

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
        if c.ccsds_interleaver not in ("block", "conv"):
            raise ValueError(f"unknown ccsds_interleaver {c.ccsds_interleaver!r}")
        if c.ccsds_interleaver == "conv" and c.ccsds_interleave_rows < 1:
            raise ValueError(
                "ccsds_interleaver='conv' needs ccsds_interleave_rows >= 1, "
                f"got {c.ccsds_interleave_rows}"
            )
        if c.polar_decoder not in ("scl", "bp"):
            raise ValueError(
                f"unknown polar_decoder {c.polar_decoder!r} (expected 'scl' or 'bp')"
            )
        if c.fec not in PORTED_FECS:
            raise ValueError(f"unknown fec {c.fec!r}")
        self.modulation = _modulation_by_name(c.modulation)
        bps = self.modulation.bits_per_symbol
        self.frame_bits = c.payload_bits + c.crc_width
        if c.fec == "viterbi":
            self.coded_bits = 2 * (self.frame_bits + _fec.DEFAULT_K - 1)
        elif c.fec in ("ldpc", "ldpc11n"):
            # "ldpc": the Gallager ensemble or a table from a file (a QC
            # .npz keeps the QC decoder); "ldpc11n": the 802.11n n=648 Z=27
            # rate-1/2 code through the QC decoder
            if c.fec == "ldpc11n":
                h, g, info = _ldpc.wifi_ldpc()
                self._ldpc_qc = (_ldpc._WIFI_648_R12, 27)
            elif c.ldpc_file is not None:
                h, g, info = _cio.ldpc_from_file(c.ldpc_file)
                qc = str(c.ldpc_file).endswith(".npz")
                self._ldpc_qc = _cio.load_qc_npz(c.ldpc_file) if qc else None
            else:
                h, g, info = _ldpc.make_regular_ldpc(seed=c.ldpc_seed)
                self._ldpc_qc = None
            self._ldpc = (h, g, info)
            k = g.shape[0]
            self.ldpc_frames = -(-self.frame_bits // k)
            self.ldpc_pad = self.ldpc_frames * k - self.frame_bits
            self.coded_bits = self.ldpc_frames * h.shape[1]
        elif c.fec in ("rs", "ccsds"):
            # whole GF(2^8) symbols, then whole RS(rs_n, rs_k) codewords
            self._rs = _rs.ReedSolomon(c.rs_n, c.rs_k)
            frame_bytes = -(-self.frame_bits // 8)
            self.rs_frames = -(-frame_bytes // c.rs_k)
            self.rs_pad_bits = self.rs_frames * c.rs_k * 8 - self.frame_bits
            rs_bits = self.rs_frames * c.rs_n * 8
            if c.fec == "ccsds":
                # the inner interleaver's whole rows (8-bit symbols, a
                # multiple of the branches, for "conv"), then rate 1/2
                rows = max(1, c.ccsds_interleave_rows)
                if c.ccsds_interleaver == "conv":
                    self.ccsds_pad = (-rs_bits) % (8 * rows)
                else:
                    self.ccsds_pad = (-rs_bits) % rows
                self.coded_bits = 2 * (rs_bits + self.ccsds_pad + _fec.DEFAULT_K - 1)
            else:
                self.coded_bits = rs_bits
        elif c.fec == "bch":
            self._bch = _bch.BCH(c.bch_n, c.bch_t)
            kb = self._bch.k
            self.bch_frames = -(-self.frame_bits // kb)
            self.bch_pad = self.bch_frames * kb - self.frame_bits
            self.coded_bits = self.bch_frames * c.bch_n
        elif c.fec == "tpc":
            self._tpc = _tpc.TPC(m=c.tpc_m, p=c.tpc_p, iters=c.tpc_iters, t_component=c.tpc_t)
            kb = self._tpc.k * self._tpc.k
            self.tpc_frames = -(-self.frame_bits // kb)
            self.tpc_pad = self.tpc_frames * kb - self.frame_bits
            self.coded_bits = self.tpc_frames * self._tpc.n * self._tpc.n
        elif c.fec == "nr_ldpc":
            # the smallest lifting size whose kb z holds the frame (fillers
            # take the rest); the rate by the circular buffer's selection
            kb = _nr._BG_DIMS[c.nr_bg][2]
            fits = [s for s in _nr.LIFTING_SIZES if kb * s >= self.frame_bits]
            if not fits:
                raise ValueError(
                    f"frame of {self.frame_bits} bits exceeds one BG"
                    f"{c.nr_bg} codeword (max {kb * max(_nr.LIFTING_SIZES)}); "
                    "segment the transport block first"
                )
            nr_base = None
            if c.nr_base_graph_file is not None:
                nr_base = _cio.nr_base_graph_from_file(c.nr_base_graph_file)
            self._nr = _nr.NrLdpc(z=min(fits), bg=c.nr_bg, k=self.frame_bits,
                                  base_graph=nr_base)
            self.coded_bits = int(round(self.frame_bits / c.nr_rate))
        elif c.fec == "turbo":
            # [sys n | par1 n | par2 n | tail_sys 3 | tail_par 3]
            self.coded_bits = 3 * self.frame_bits + 6
        elif c.fec == "polar":
            # rate-1/2 codewords of polar_n; a list > 1 decodes CA-SCL with
            # a CRC-8 inside each codeword
            self._polar = _polar.PolarCode(
                n=c.polar_n,
                k=c.polar_n // 2,
                design_snr_db=c.polar_design_snr_db,
                crc="crc8" if c.polar_list > 1 else "",
                list_size=c.polar_list,
            )
            bpf = self._polar.payload_bits
            self.polar_frames = -(-self.frame_bits // bpf)
            self.polar_pad = self.polar_frames * bpf - self.frame_bits
            self.coded_bits = self.polar_frames * c.polar_n
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
        self._replicas = {self.device: self}

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
        lead = tuple(line.shape[:-1])
        pad = torch.nn.functional.pad
        if c.fec == "viterbi":
            coded = _fec.conv_encode(line)
        elif c.fec in ("ldpc", "ldpc11n"):
            padded = pad(line, (0, self.ldpc_pad)).reshape(lead + (self.ldpc_frames, -1))
            coded = _ldpc.ldpc_encode(padded, self._ldpc[1]).reshape(lead + (-1,))
        elif c.fec in ("rs", "ccsds"):
            syms = _rs.bits_to_symbols(pad(line, (0, self.rs_pad_bits)))
            cw = self._rs.encode(syms.reshape(lead + (self.rs_frames, c.rs_k)))
            coded = _rs.symbols_to_bits(cw).reshape(lead + (-1,))
            if c.fec == "ccsds":
                coded = _fec.conv_encode(self._ccsds_ilv(pad(coded, (0, self.ccsds_pad))))
        elif c.fec == "bch":
            padded = pad(line, (0, self.bch_pad)).reshape(lead + (self.bch_frames, -1))
            coded = self._bch.encode(padded).reshape(lead + (-1,))
        elif c.fec == "tpc":
            kk = self._tpc.k
            padded = pad(line, (0, self.tpc_pad)).reshape(lead + (self.tpc_frames, kk, kk))
            coded = self._tpc.encode(padded).reshape(lead + (-1,))
        elif c.fec == "nr_ldpc":
            coded = self._nr.encode(line, self.coded_bits, rv=c.nr_rv)
        elif c.fec == "turbo":
            coded = torch.cat(_turbo.turbo_encode(line), dim=-1)
        elif c.fec == "polar":
            padded = pad(line, (0, self.polar_pad)).reshape(lead + (self.polar_frames, -1))
            coded = self._polar.encode(padded).reshape(lead + (-1,))
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
            # the psk tables lie on the axes (1, -1; 1, j, -1, -j), the
            # bpsk / qpsk tables on the diagonals
            grid = "axes" if self.modulation.name.startswith("psk") else "diagonal"
            phi = _sync.estimate_phase_mpsk(eq, m_fold, grid)
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

    def _ccsds_ilv(self, bits):
        """The inner interleaver, batched: the block interleaver, or
        ("conv") the circular Forney permutation of whole 8-bit symbols,
        each bit plane of the symbols permuted alike."""
        c = self.config
        if c.ccsds_interleaver == "conv":
            syms = bits.reshape(bits.shape[:-1] + (-1, 8)).transpose(-1, -2)
            out = _fec.conv_interleave_block(syms, c.ccsds_interleave_rows,
                                             c.ccsds_interleave_cell)
            return out.transpose(-1, -2).reshape(bits.shape)
        return _fec.interleave(bits, c.ccsds_interleave_rows)

    def _ccsds_dilv(self, x):
        """Inverse of :meth:`_ccsds_ilv` (bits or LLRs)."""
        c = self.config
        if c.ccsds_interleaver == "conv":
            syms = x.reshape(x.shape[:-1] + (-1, 8)).transpose(-1, -2)
            out = _fec.conv_deinterleave_block(syms, c.ccsds_interleave_rows,
                                               c.ccsds_interleave_cell)
            return out.transpose(-1, -2).reshape(x.shape)
        return _fec.deinterleave(x, c.ccsds_interleave_rows)

    def _decode_rs(self, llr):
        """``rs`` and ``ccsds``: the inner decode (``ccsds``), then the RS
        codewords, with erasures where a symbol's weakest bit falls below
        ``rs_erasure_threshold`` times its codeword's median."""
        c = self.config
        lead = tuple(llr.shape[:-1])
        if c.fec == "ccsds":
            rs_len = self.rs_frames * c.rs_n * 8
            if c.rs_erasures:
                inner = _fec.conv_decode_soft(llr, window=96, guard=64)
                llr = self._ccsds_dilv(inner)[..., :rs_len]
                hard = (llr < 0).to(torch.uint8)
            else:
                inner = _fec.viterbi_decode(llr, window=64, guard=48)
                hard = self._ccsds_dilv(inner)[..., :rs_len]
                llr = _fec.hard_to_llr(hard)
        else:
            hard = (llr < 0).to(torch.uint8)
        syms = _rs.bits_to_symbols(hard).reshape(lead + (self.rs_frames, c.rs_n))
        if c.rs_erasures:
            rel = llr.abs().reshape(lead + (self.rs_frames, c.rs_n, 8)).amin(dim=-1)
            erased = rel < c.rs_erasure_threshold * median_midpoint(rel, keepdim=True)
            dec, _ok, _ = self._rs.decode_erasures(syms, erased)
        else:
            dec, _ok, _ = self._rs.decode(syms)
        return _rs.symbols_to_bits(dec).reshape(lead + (-1,))[..., : self.frame_bits]

    def _decode_llr(self, llr):
        """Coded-bit LLRs ``[..., coded_bits]`` -> line bits ``[...,
        frame_bits]`` (uint8), batched over the leading axes: one decoder
        call for the whole batch."""
        c = self.config
        lead = tuple(llr.shape[:-1])
        if c.fec == "viterbi":
            return _fec.viterbi_decode(llr)
        if c.fec in ("rs", "ccsds"):
            return self._decode_rs(llr)
        if c.fec in ("ldpc", "ldpc11n"):
            h, _g, info = self._ldpc
            frames = llr.reshape(lead + (self.ldpc_frames, -1))
            if self._ldpc_qc is not None:
                hard, _ok = _ldpc.qc_ldpc_decode(frames, *self._ldpc_qc, iters=30)
            else:
                hard, _ok = _ldpc.ldpc_decode(frames, h, iters=30)
            line = _ldpc.extract_info(hard, info)
        elif c.fec == "bch":
            frames = llr.reshape(lead + (self.bch_frames, -1))
            if c.bch_chase > 0:
                line, _ok = self._bch.decode_soft(frames, p=c.bch_chase)
            else:
                line, _ok, _ = self._bch.decode((frames < 0).to(torch.uint8))
        elif c.fec == "tpc":
            nn = self._tpc.n
            line, _ok = self._tpc.decode(llr.reshape(lead + (self.tpc_frames, nn, nn)))
        elif c.fec == "nr_ldpc":
            line, _ok = self._nr.decode(llr, rv=c.nr_rv, iters=30)
        elif c.fec == "polar":
            frames = llr.reshape(lead + (self.polar_frames, -1))
            if c.polar_decoder == "bp":
                line, _ok = self._polar.decode_bp(frames)
            else:
                line, _ok = self._polar.decode(frames)
        elif c.fec == "turbo":
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
        else:
            return (llr < 0).to(torch.uint8)
        return line.reshape(lead + (-1,))[..., : self.frame_bits]

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

    def _on(self, device) -> "PacketModem":
        """This modem computing on ``device``: a shallow copy whose device
        constants (the preamble) lie there, made once per device. A shard
        on another card than the modem's own needs them on its card."""
        replica = self._replicas.get(device)
        if replica is None:
            replica = copy.copy(self)
            replica.device = device
            replica._pre = self._pre.to(device)
            self._replicas[device] = replica
        return replica

    def rx_batch_sharded(self, captures, mesh, axis_name: str = CHANNEL_AXIS):
        """:meth:`rx_batch` with the BURST axis sharded over ``mesh``: each
        shard decodes its ``B / n_dev`` captures on its mesh device (pure
        data parallel: bursts are independent), one decoder call per
        shard. ``B`` must divide by the mesh axis size. Returns
        ``(payloads, crc_ok, diag)`` as :class:`~aether_primitives_tpu_torch.
        parallel.mesh.Sharded` values split along the burst axis, equal to
        :meth:`rx_batch`'s when gathered. On a mesh that spans processes
        each decodes its own shards' bursts (nothing crosses ranks)."""
        x = captures if isinstance(captures, Sharded) else as_cf32(captures)
        if x.ndim != 2:
            raise ValueError(
                f"rx_batch_sharded takes [B, window] captures, got {tuple(x.shape)}"
            )
        n_dev = mesh.shape[axis_name]
        if x.shape[0] % n_dev:
            raise ValueError(
                f"{x.shape[0]} bursts do not divide over {n_dev} devices"
            )
        xs = shard(x, mesh, (axis_name, None))
        keys = ("offset", "metric", "cfo", "gain", "noise_var")

        def shard_fn(xl):
            payload, ok, diag = self._on(xl.device).rx_batch(xl)
            return (payload, ok) + tuple(diag[k] for k in keys)

        flat = xs.map(shard_fn, spec=((axis_name, None),) + ((axis_name,),) * (1 + len(keys)))
        return flat[0], flat[1], dict(zip(keys, flat[2:]))

    def loopback(self, payload):
        """tx -> rx with no channel (sanity path)."""
        return self.rx(self.tx(payload))
