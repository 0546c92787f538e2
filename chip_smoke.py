#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card (an H100).

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It drives the port's paths through their hand-written kernels:

- the streaming RX chain (``RxChain(RxChainConfig(fft_len=2048,
  decimation=4, packed_bits=True), device="cuda").streaming_step``) on
  4,194,304-sample blocks, through the RX frame kernel
  (``aether_primitives_tpu_torch/csrc/rx_frame.cu``);
- the batched burst link (``PacketModem(PacketConfig(payload_bits=600,
  fec=...), device="cuda").rx_batch``) on 256 captures of 16,384 samples,
  through the Viterbi kernel (``csrc/viterbi.cu``, ``fec="viterbi"``) and
  the windowed BCJR kernel (``csrc/bcjr.cu``, ``fec="turbo"``); and the
  families ``BURST_FAMILIES``: ``ccsds`` (RS outer, K=7 inner through the
  windowed Viterbi kernel, or with ``rs_erasures`` through the BCJR
  kernel's lanes instance), ``rs``, ``bch``, ``tpc``, ``ldpc``,
  ``ldpc11n``, ``nr_ldpc``, ``polar`` (CA-SCL and flooding BP), and ``ldpc``
  and ``nr_ldpc`` with their code tables loaded from files that the run
  writes (plain PyTorch decoders);
- the wideband channelizer (``PfbChannelizerOs(2048, os=2,
  taps_per_branch=16, device="cuda")`` feeding ``PfbSynthesizerOs`` with the
  same configuration) on 4,194,304-sample blocks, with a real and a complex
  prototype, through the PFB fold kernel (``csrc/pfb_fold.cu``), and the
  DDC (``Ddc(DdcConfig(freq=0.1375, decimation=8), device="cuda")``) on
  the same blocks;
- the host-fed stream: the RX chain above fed from host memory through
  ``parallel.streaming.StatefulExecutor`` (pinned ``BlockPool`` buffers,
  pageable numpy blocks, a capture file through ``utils.file.stream_blocks``
  into ``streaming_step_split``) at depths 1-4, and a ``StreamExecutor``
  pipeline;
- the elementwise kernels through their own entry points: ``cmul`` and
  ``cmul_c64`` (``csrc/cmul.cu``) and ``streamed_cmul`` (``csrc/stream.cu``);
- the sharded receiver: the RX chain above on a ``{channel: 2, time: 4}``
  mesh of eight shards (``RxChain.sharded_streaming_step_2d`` on ``[2,
  4,194,304]`` blocks), every shard on the one card, its FIR history crossing
  the shard boundaries through the peer-push halo kernel (``csrc/halo.cu``);
  and the other sharded entry points (``sharded_pfb_os``, ``sharded_pfb``,
  ``sharded_ddc``, ``rx_batch_sharded``);
- the link simulation: ``TxChain(RxChainConfig(fft_len=2048, decimation=4,
  active_bins=1024), device="cuda").step`` on 1,048,576 bits (512 frames,
  4,194,304 samples) -> ``noise.Awgn(1e-6, 815, device="cuda").apply`` ->
  the shift by ``loopback_delay`` -> ``RxChain`` of the same configuration,
  whose active-bin step goes through the RX frame kernel's spectrum
  epilogue; the other FIR modes, QAM16 with an ``OfdmEqualizer`` pilot,
  ``Modem.loopback``, ``simulate_ber`` and a ``Channel``;
- the receivers in plain PyTorch (no kernel of their own): the feedback
  receiver (``gardner_loop`` -> ``costas_loop``), the GNSS tracking channel
  (``code_tracking_loop`` -> ``carrier_tracking_loop`` -> ``nav_bit_sync``),
  the FM receiver (``fm_mod`` -> ``Duc`` -> ``Ddc`` -> ``fm_demod``, with
  ``sosfilt``), the front end's conditioning stages on a 4M block, the MSK,
  GMSK and OQPSK loopbacks and the detectors;
- the acquisition, multicarrier, chirp and array receivers in plain PyTorch
  (no kernel of their own): GNSS cold acquisition by cross-ambiguity
  (``models.caf``), the CP-OFDM burst receiver (``models.ofdm``), the chirp
  modem (``models.css``), the modulation classifier (``models.amc``), the
  array receivers (``models.doa``), MIMO detection and diversity combining
  (``models.diversity``), the adaptive equalizers (``models.equalizer``)
  and the frequency hopper (``models.fhss``);
- the entry points (``entry()``, ``dryrun_multichip(8)`` on the card),
  the per-op microbench (the JAX package's 33 rows), two processes on one
  mesh over ``torch.distributed`` (gloo) running every sharded entry
  point, and the four ``examples/torch_*.py``,

in thirty-one phases:

1. the card's name and power limit (exits 1 without a CUDA device);
2. the seven kernels' builds from the sources in the checkout, and the PFB
   fold kernel's previous design (``benches/torch_pfb_fold_parent.cu``,
   timed in phase 13), started together, timed, with the PFB fold compiler
   report;
3. the RX frame kernel's main-path instance (``direct``: the FIR at the
   kept outputs and a hand-written FFT) against its plain PyTorch version
   and the float64 chain at the main path's shapes: QPSK and BPSK bytes and
   the spectrum epilogue, with and without carried history; then the other
   geometries (``F7_GEOMETRIES``: direct at dec 4, fft_len 4096, 64, 192,
   3072 and 131 and an unpacked chain at dec 5, fft_len 30 (the last four
   through its mixed-radix FFT); the chunked instance at dec 16, fft_len
   2048, dec 8, fft_len 4096 and dec 64, fft_len 512; the cluster instance
   at dec 4, fft_len 8192 and dec 1, fft_len 65,536; the global instance,
   one cooperative launch, at dec 4, fft_len 4,099 and 16,411 and dec 2,
   fft_len 8,198 (Bluestein, unpacked) and dec 1, fft_len 131,072, dec 4,
   fft_len 262,144 and dec 1, fft_len 4,194,304 (packed)),
   each through the chain's two-block streaming gate with one
   launch a step, against the plain twin, and timed on a 4M block beside
   its byte bound (the global instance's also beside ``torch.fft.fft`` over
   the block's decimated frames, a yardstick for the FFT alone);
4. the RX chain's two-block streaming gate, counting kernel launches;
5. CUDA-event timings of the RX frame kernel, the plain version, and the RX
   chain's kernel and plain paths; the kernel's device time
   (``torch.profiler``) and the host's time to enqueue a streaming step
   (the parent's kernel is timed beside this one by
   ``benches/torch_rx_frame_sweep.py --parent``);
6. the RX frame, Viterbi and BCJR kernels' register and spill reports,
   and the BCJR lanes instance's shared memory a CTA at Lw 96 and at the
   ``ccsds`` launch's Lw 224;
7. the Viterbi and BCJR kernels against their plain twins at the burst
   path's shapes, bit for bit (``array_equal`` / ``torch.equal``); for the
   Viterbi kernel also tie-heavy spans (integer LLRs with -0.0) at K = 3,
   5, 7 and 9, rates 1/2 and 1/3; for the BCJR kernel also Lw 1, 2, 95,
   97, N 1, 77, 1,000, 2,570, exact ties with -0.0, random tables of every
   state count it takes, shift-register codes at K = 3-6 (S 4-32) with a
   ragged last CTA, spans at the lanes instance's limit and one step past
   it (the block instance, at S 64 and S 4), RSC-8 past the meet and the
   lanes instances' limits, 300 states (the block instance's multi-warp
   form) and 1,500 (its cluster route), and the meet instance at both its CTA
   widths (16 and 8 columns); and the
   ``ccsds`` link's inner code at its shapes: the windowed Viterbi 64/48 and
   the BCJR kernel's lanes instance on the K=7 tables at Lw 224 (the
   windowed soft decode 96/64), ``torch.equal``; and a K=7 full block of
   65,536 steps, past the shared-memory history (the device scratch), one
   launch, ``torch.equal`` to the twin; then the codes past the decoders'
   earlier instances (``decoder_reach_phase``): Viterbi at K 2, 10, 12, 15,
   17 and 19 (K 19 the block instance's grid route, past the cluster
   route's 131,072 states) and K 7 with 9 and 16 generators, full block and
   windowed, and
   the windowed BCJR's block instance at S 2, 3, 128, 256 and 1,024
   (``conv_decode_soft`` where S is a conv code's) and at S 64 and 4 one
   step past the lanes instance's span limit, each ``torch.equal`` to its
   twin with one launch a call, and each timed beside its bound (Viterbi's
   grid route at K 19 and the BCJR's cluster route at S 1,500, Lw 96 x N
   7, by device time too, each beside its chain floor: an empty kernel
   making the same grid or cluster barriers); then two routes at
   full-card shapes (Viterbi K 19 over 16 trellises of 1,024 steps, the
   BCJR's shared route at the K 12 code's S 2,048 over Lw 224 x N 512),
   each
   ``torch.equal`` to its twin once, the kernel alone timed beside its
   bound and chain floor;
8. the burst path: 256 bursts built by the port's own ``tx`` through a
   numpy channel from a fixed seed, decoded by ``rx_batch`` for viterbi,
   turbo and each of ``BURST_FAMILIES``; every payload exact and CRC-ok,
   exactly 1 Viterbi and 16 BCJR launches per call (``ccsds``: 1 Viterbi;
   with erasures 1 BCJR; the other families none), and the first 8 bursts
   equal to the port's CPU run; 32 bursts each of ``psk2`` and ``psk4``
   through the viterbi link (ROADMAP §3 F17), every payload exact and
   CRC-ok, one Viterbi launch a call; the code tables of the file-loaded
   families (an ``.alist`` of the Gallager code, a QC ``.npz`` of the
   802.11n base, an ``.npz`` NR BG2 graph) written into a temporary
   directory by the port's ``code_io``; then the NR transport-block chain
   (``NrTransportBlock`` of 3 code blocks, 64 blocks' worth) encoded and
   decoded on the card, and two redundancy versions' de-rate-matched
   buffers at 4 passes of the circular buffer summed, each ``torch.equal``
   to the CPU run;
9. CUDA-event timings of each burst kernel (and the BCJR kernel at K=7)
   against its plain twin and of ``rx_batch`` end to end for every family,
   the Viterbi and BCJR kernels' device times (``torch.profiler``) beside
   its chain floor (an estimate from assumed operation counts, on a line of
   its own) and at the ``ccsds`` shapes beside their bounds and, for the
   BCJR, beside its block instance (forced through ``bk._launch_block``)
   in turns, and a
   ``torch.profiler`` split of ``rx_batch`` into front end, decoder kernels
   and the rest, with the device's idle share;
10. every layout of the PFB fold kernel against its plain twin, bit for
    bit (``torch.equal``), at the channelizer's shapes: the planes layout
    (the TPU wrapper's), the complex64 analysis from a step's two sources
    (the carried tail and the block) with real and complex taps, the
    synthesis with the stage's tail and divisor and raw with complex taps,
    the critically sampled synthesis, and ragged batched cases (M 1,000, a
    seam inside a row at an odd sample, os 4); the path's plan unchanged
    (two slabs, every weight staged); the ranged instance at P 295, 512
    and 1,024 in all five layout and tap-type pairs and a synthesis of
    more class frames than branches with the stage's epilogue, and 70,000
    rows (the grid folded past 65,535); every case one launch;
11. the channelizer path: three consecutive blocks through analysis and
    synthesis, exactly 1 analysis + 1 synthesis fold launch per step and no
    other kernel, the first 64 frames against a float64 golden (<= -80 dB),
    the streamed analysis against one-shot ``pfb_channelize_os`` (<= -120
    dB), the reconstructed interior against the input (<= -70 dB), and the
    first frames against the port's CPU run (<= -110 dB); then the same
    blocks with a complex prototype (the root-Nyquist one moved by a
    quarter channel): the same launches, analysis and synthesis against
    float64 goldens (<= -80 dB) and the CPU run (<= -110 dB); and a
    64-channel ``PfbChannelizerOs`` of P 512 (the ranged instance) against
    its CPU run (<= -110 dB), one launch;
12. the DDC path over two blocks: against the float64 composed golden on a
    prefix (<= -80 dB) and block by block against one-shot (<= -115 dB);
13. timings of the fold kernel's analysis and synthesis layouts (CUDA
    events and ``torch.profiler`` device time with its record count), their
    plain twins, the previous design's kernel launched as its callers
    launched it (in turns), the complex-tap and planes layouts, the one-call
    ``conv1d`` yardstick and both floors, and the ranged instance's analysis
    and synthesis at P 512 (device time, one-call depthwise ``conv1d``
    yardsticks for class 0's fold, ``conv_transpose1d`` once) beside their
    bounds, and both stages' 4M-block steps at P 512 (one launch a step,
    the fold's device time); of the analysis, synthesis and DDC
    steps (CUDA events and the host's enqueue time) and of
    ``pfb_synthesize`` (slice-sum and kernel); a ``torch.profiler`` split of
    each channelizer step;
14. the cmul and stream kernels' compiler reports; ``cmul``, ``cmul_c64``
    and ``streamed_cmul`` once each at [2048, 2048] (chunk_rows 128),
    exactly 2 cmul and 1 stream launches, each ``torch.equal`` to its plain
    twin there and at ragged cases (an element count not a multiple of 4,
    inputs at an odd element offset, an odd chunk), and the refusal of rows
    that chunk_rows does not divide;
15. the host-fed stream: 16 consecutive 4M blocks of one capture through
    ``StatefulExecutor(chain.streaming_step, ...)`` at depths 1-4 from
    pinned buffers, pageable numpy blocks and the capture file, each
    ``torch.equal`` to device-resident stepping with the state and the
    stage counters exact and 16 RX frame launches; the two-block gate on
    the first two blocks; a two-buffer pinned ring released after each
    ``send``; a ``StreamExecutor`` Abs -> Mul 20 pipeline equal to eager;
16. the soak: 512 blocks (2.1 G samples) cycling 8 pinned captures with the
    true history carried, every 64th block against a float64 chain
    (agreement >= 0.9999), device memory after block 16 and at the end
    within 64 MB, the carried state exact;
17. CUDA-event timings of cmul, cmul_c64 and streamed_cmul against their
    twins and one ``torch.mul`` each, and of each kernel launched straight
    on outputs made once (``launch_ms``: its time without the wrapper's
    host time); the host-fed sustained rates per
    depth and source against the resident step and the pinned and pageable
    copy times (medians of four runs); a ``torch.profiler`` split of one
    depth-2 pinned run into copy, kernel and idle;
18. the halo kernel's compiler report; the kernel against its plain twin,
    bit for bit (``torch.equal``), at the sharded paths' shapes (complex64
    ``[1, 1,048,576]`` shards, overlap 64, on ``{channel: 2, time: 4}``;
    ``[1,048,576]`` shards, overlap 14,336, on ``{time: 4}``) and at ragged
    ones (float32 overlap 4, misaligned strided rows, overlap equal to the
    span, a ring of one, the exchanged axis first in a two-axis mesh, uint8
    and complex128), exactly one launch per sending card;
19. the sharded receiver: three consecutive ``[2, 4,194,304]`` blocks through
    ``sharded_streaming_step_2d``, exactly 8 RX frame and 1 halo launches
    per call (one halo launch per sending card); the concatenated bytes
    ``torch.equal`` to one ``step`` of the ``[2, 12,582,912]`` capture,
    every block's bytes and state ``torch.equal`` to resident
    ``streaming_step``, the final state the capture's last 64 samples,
    phase 4's float64 two-block gate on channel 0; and ``sharded_step`` on
    ``{time: 8}``;
20. the other sharded paths on one 4M block over ``{time: 4}``:
    ``sharded_pfb_os`` (phase 11's configuration) against one-shot
    ``pfb_channelize_os`` (<= -120 dB) with 4 fold launches, ``sharded_pfb``
    against ``pfb_channelize`` (<= -120 dB) and ``sharded_ddc`` (phase 12's
    configuration) against ``Ddc.step`` (<= -100 dB) with 1 halo launch
    each; ``rx_batch_sharded`` on phase 8's 256 captures over ``{channel:
    8}``: payloads, CRC and offsets equal to ``rx_batch``, 8 Viterbi or 128
    BCJR launches;
21. CUDA-event timings (medians of four runs) of the halo exchange, kernel
    against twin against ``Tensor.copy_``, at phase 18's two path shapes,
    and of the sharded streaming step against the resident step on the same
    ``[2, 4M]`` block;
22. where there are two cards or more: phases 18 and 19 again with the
    shards spread over the cards, the same gates, and host-clock timings of
    the sharded step and the halo exchange across the cards; with one card
    the line ``cards: 1, cross-card phase not run``;
23. the link gate (``link_phases``): every interior frame's bits equal to
    the sent bits, exactly 1 RX frame launch (instance ``direct``, epilogue
    ``spectrum``) and no other kernel in the TX -> AWGN -> RX run, the TX
    samples against the port's CPU run (<= -120 dB) and a float64 golden
    on the first 64 frames (<= -80 dB), the RX active-bin spectra against
    ``rx_frame_reference`` (<= -120 dB); the same link with ``fir_mode``
    ``"os"`` and ``"shift_add"`` on both chains (interior bits exact, no
    kernel launch); QAM16 with an ``OfdmEqualizer`` pilot frame (data frames
    exact, 1 RX frame launch); ``Modem(ModemConfig("qpsk")).loopback`` on
    1,048,576 bits (exact); ``simulate_ber("qpsk", (0.25, 0.5, 1.0),
    1 << 20)`` (each point within 5 sigma of theory); a ``Channel``
    (multipath, CFO, IQ imbalance, DC) against the port's CPU run (<= -120
    dB);
24. CUDA-event times (medians of four runs of 10 calls) and the host's
    enqueue time of ``TxChain.step``, the active-bin ``RxChain.step`` (and
    the same step through the plain ``fir_decimate_fft``, its route on the
    card before it went through the kernel) and the loopback end to end,
    in Msa/s; a ``torch.profiler`` split of the TX
    step (cuFFT, matmul, elementwise, the rest) and of the RX step (the RX
    frame kernel against the rest);
25. the receivers (``analog_tracking_phases``), each at its example's full
    size, on the card and again on the CPU from the same inputs, none
    launching any of the seven kernels: the feedback receiver
    (``examples/feedback_rx.py``: 6,000 QPSK symbols, +800 ppm, CFO 1.1e-4
    and a phase-noise walk; agreement > 0.999 after a 600-symbol settle,
    the decisions equal to the CPU run's, each loop's traces within
    ``tests/test_torch_sync_loops.py``'s bars of its CPU run on the same
    input), the GNSS channel (``examples/gnss_track.py``: 620 dwells; nav
    bits 1.0 up to polarity, bits and edge equal to the CPU run), the FM
    receiver (``examples/fm_radio.py``: NMSE < 5%; ``sosfilt`` of the
    de-emphasis <= -100 dB against the float64 recursion and of
    ``butter_sos(4, 0.05)`` against the float64 truncated-kernel cascade,
    -85 dB against the exact recursion (the truncation's floor), 8 blocks
    of ``sosfilt_stream`` <= -100 dB against one-shot), the front end
    (``examples/receiver.py:65-83``'s impairments on a 4M block: IQ
    estimates within 1%, image rejection gain >= 40 dB, ``agc`` over 4,096
    blocks, both blankers, squelch on [64, 65,536], M2M4), MSK, GMSK and
    OQPSK loopbacks of 65,536 bits (exact), the detectors on five
    131,072-sample captures; every output <= -100 dB (estimates rtol 1e-5,
    flags and masks exact) against the CPU run;
26. each of phase 25's paths timed (CUDA events, median of 3 runs) and
    profiled (``torch.profiler``, device activity: kernels a call, busy
    time, the device's idle share);
27. the acquisition, multicarrier, chirp and array receivers
    (``acquisition_array_phases``), each at the width its users run, on the
    card and again on the CPU from the same inputs, none launching any of
    the seven kernels: GNSS cold acquisition (4 ms of GPS L1 C/A at 4.092
    Msps, three satellites at -20 dB a sample, all 32 PRNs through
    ``estimate_delay_doppler`` over +-1.25e-3 cycles/sample in 64
    hypotheses: exactly the three found, code phase within 0.5 sample,
    Doppler within 2e-5; again through ``sharded_estimate_delay_doppler`` on
    ``{time: 4}``, equal to the one-device estimates); the CP-OFDM receiver
    (LTE 20 MHz numerology, 64QAM, a Schmidl-Cox preamble, one pilot and 139
    data symbols, ``examples/ofdm.py``'s channel, a batch of 8 captures:
    ``cp_sync`` timing, ``sc_sync`` frame and CFO, one-tap equalization,
    bits exact); CSS at SF 12 (-15 dB a chip) and SF 7 (-5 dB), 4M chips
    each, bits exact; AMC on 320 bursts of 16,384 symbols at 18 dB (BPSK,
    QPSK and 8PSK all right, the names equal to the CPU run's); a 16-element
    scan of 256 windows with MUSIC and Capon, a coherent pair with
    smoothing 4, the scan through ``sharded_estimate_doa`` on ``{channel:
    4}``, 2-D MUSIC on a 4x4 planar array, ``examples/beamform_rx.py``'s
    MVDR receiver (payload exact through a jammer 12 dB stronger); 4x4 ZF /
    MMSE / stream SNR over 1M symbol times; MRC, EGC and selection over 4 x
    4M samples; Alamouti over 4M symbols; LMS, decision-directed LMS, CMA,
    RLS and FDAF (decisions after the settle exact); the hopper over 4M
    samples; each against the CPU run at the bars of its
    ``tests/test_torch_*.py`` (outputs <= -100 dB, MIMO <= -80 dB, bearings
    1e-4 rad, CAF delay 1e-3 and Doppler 1e-7, CFOs 1e-7, AMC scores rtol
    1e-4);
28. each of phase 27's paths timed (CUDA events, median of 3 runs) and
    profiled as in phase 26, and RLS a training step beside its complex64
    form from before ROADMAP.md §3.17's repair;
29. the entry points (``aether_primitives_tpu_torch/entry.py``):
    ``entry()``'s step on the card against its CPU run (1 RX frame launch),
    ``dryrun_multichip(8)`` with all eight shards on the card against its
    CPU run (every sharded path: the ``(channel, time)`` chain at fft_len
    128 and 2048, one step and three streaming steps each, ``sharded_ddc``,
    ``sharded_pfb_os``, the CAF, the DOA scan, ``rx_batch_sharded`` and
    ``TPC.sharded_decode``; 68 RX frame, 9 halo and 9 PFB fold launches;
    the DOA bearings of both runs, and of 20 more draws of the scene and of
    a copy with independent waveforms, against a float64 MUSIC), across
    the cards where there are two or more, and the four
    ``examples/torch_*.py`` on the card, each printing its verdict;
30. the per-op microbench (``cli.microbench_main --batch 1024 --iters
    20``): the JAX package's 33 rows, each with its time (CUDA events,
    median of 3 rounds),
    Msa/s, kernels a call and idle share (``torch.profiler``); its Viterbi
    row 1 Viterbi launch a call and its turbo row 16 BCJR launches; the
    CRC-32 row's device time, and ``crc_compute`` of 2^20 bits on the card
    equal to ``zlib.crc32``;
31. two processes on the card over gloo (``init_distributed``, a
    ``{time: 8}`` mesh that spans them, four shards of the flagship chain
    each on its 4,194,304-sample part of one capture): their bytes joined
    equal to one process's ``sharded_step`` and through the float64 gate,
    ``sharded_ddc`` against ``Ddc.step`` (<= -100 dB), 4 RX frame + 1 halo
    launches a step in each; the step and the halo exchange timed in both
    (the edge between the ranks apart), beside one process's step; then
    three ``[2, 4,194,304]`` blocks of the flagship chain through
    ``sharded_streaming_step_2d`` on a ``{time: 4, channel: 2}`` mesh whose
    halo and carried state cross the ranks (bytes equal to one process's
    eight-shard calls and to one contiguous ``step``, the float64 gate, 4 RX
    frame + 1 halo launches a rank and step) and through a
    ``StatefulExecutor`` with ``sharding=`` (equal to the direct calls), and
    ``rx_batch_sharded`` (viterbi, turbo), ``sharded_pfb``,
    ``sharded_pfb_os``, ``sharded_waterfall``, ``sharded_duc``,
    ``sharded_ambiguity``, ``sharded_estimate_delay_doppler`` and
    ``sharded_estimate_doa`` at the dry run's shapes, each equal to one
    process's run on eight shards with its launches a rank; each path timed
    a rank, with the edge of its exchange between the ranks.

Any failed phase prints its cause and exits 1. The last four lines are
the kernels' JSON summary, one line of the BCJR and CRC-32 figures with
their bounds, the card's name and power limit, and
``{"ok": true, "device": {...}}``.
"""

import ctypes
import json
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from aether_primitives_tpu_torch.cli import KERNELS, kernel_launches, profile_call, time_host

# tolerances, stated once
AGREEMENT = 0.99999  # hard bits vs the float64 chain, and kernel vs plain
EVM_DB = -80.0  # RMS EVM of spectra vs float64, and kernel vs plain
STREAM_DB, ROUNDTRIP_DB = -120.0, -70.0  # tests/test_pfb.py's bars
CPU_DB, DDC_STREAM_DB = -110.0, -115.0  # card vs CPU run; tests/test_ddc.py


NO_LAUNCHES = {k: 0 for k in KERNELS}  # a path's launch counts are read against this
# the burst path: benches/burst_bench.py's configuration at full width
PAYLOAD, CAPTURE, BURSTS = 600, 16384, 256
K7, K5 = ((0o171, 0o133), 7), ((0o25, 0o33, 0o37), 5)
# H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor cores, HBM3
PEAK_FP32, PEAK_BYTES = 67e12, 3.35e12
# the BCJR chain floor: dependent FP32 operations a step and their latency in
# cycles (the clock is nvidia-smi's clocks.max.sm: cli.max_sm_clock_hz)
CHAIN_OPS, OP_CYCLES = 6, 4
NVLINK_BYTES = 450e9  # one way between two cards of a host
# the fold kernel's previous design, timed beside the shipped one (phase 13)
PARENT_FOLD = Path(__file__).resolve().parent / "benches" / "torch_pfb_fold_parent.cu"
# empty kernels that make the decoders' grid, cluster and named barriers
# (phase 7's chain floors)
CHAIN_FLOOR = Path(__file__).resolve().parent / "benches" / "torch_chain_floor.cu"
# phase 7's full-card shapes: Viterbi K 19 at 16 trellises of 1,024 steps
# (the grid route), the BCJR at VITERBI_REACH's K 12 code (S 2,048, the
# shared route) over Lw 224 x N 512
VITERBI_FULL = (16, 1024)
BCJR_FULL = (224, 512)
SHARDED_DDC_DB = -100.0  # sharded DDC vs the one-device step (__graft_entry__.py's bar)
LINK_DB = -120.0  # the link: card vs CPU run, and the RX kernel vs its plain twin
# phases 25-26: outputs card vs CPU run (RMS EVM) and estimates (relative);
# each loop against its CPU run on the same input at
# tests/test_torch_sync_loops.py's bars; CFAR noise levels within CFAR_EPS
# float32 epsilons of the row's sum per training cell (tests/test_torch_detect.py)
LOOP_DB, RTOL, TIMING_ATOL, CFAR_EPS = -100.0, 1e-5, 3e-6, 8
COSTAS_Y_ATOL, COSTAS_ATOL, COSTAS_FREQ_ATOL = 4e-6, 3e-6, 2e-7
GARDNER_ATOL, GARDNER_ULPS = 3e-3, 10
DLL_PROMPT_ATOL, DLL_TAU_ATOL = 2e-5, 1e-3
CARRIER_ATOL, CARRIER_PHASE_ATOL, CARRIER_FREQ_ATOL = 4e-4, 4e-5, 2e-5
# phases 27-28: the bars of tests/test_torch_{caf,ofdm,doa,amc,diversity,equalizer}.py
# (card vs CPU run): CAF delay (samples), Doppler (cycles/sample), metric
# (relative); sync CFOs (cycles/sample); bearings (rad); MUSIC spectra
# (relative); AMC scores (relative, and absolute for the winner's residual
# near zero, a difference of features ~1.5 that float32 means round ~1e-6
# apart in another summation order); the MIMO solves at channel condition numbers under
# 100 (dB); RLS (a complex128 recurrence since ROADMAP.md §3.17's repair)
# against float64
CAF_DELAY_ATOL, CAF_DOPPLER_ATOL, CAF_METRIC_RTOL = 1e-3, 1e-7, 1e-4
CFO_ATOL, BEARING_ATOL, SPEC_RTOL, AMC_RTOL, AMC_ATOL = 1e-7, 1e-4, 1e-3, 1e-4, 1e-5
MIMO_DB, RLS_DB = -80.0, -100.0
# MVDR weights of examples/beamform_rx.py's scene: its loaded covariance's
# condition number is ~6e3 (a jammer 12 dB over the packet, 40 dB over the
# noise), and float32 solves sit at -72 to -76 dB from float64 on the CPU
MVDR_DB = -60.0
CROSS_SEED, CROSS_RUNS = 3131, 3  # phase 31's capture, and its timed runs
# phase 29's DOA bearings. The dry run's scene (entry.doa_windows) gives both
# sources one waveform: its covariance has one signal eigenvalue, and MUSIC
# with two sources takes its second "signal" vector from the noise subspace,
# whose eigenvalues lie close together, so float32 rounding of the
# covariance moves a bearing far more than in a well-posed scene. Each side
# (card, CPU) is held against a float64 MUSIC of the same windows, at a bar
# set from the readings of COHERENT_DRAWS draws of the scene (16 windows a
# draw) on the CPU and an H100 (PERF.md, PR 15); the same scene with
# independent waveforms is held at BEARING_ATOL, card against CPU and both
# against float64.
COHERENT_BEARING_ATOL = 1e-3
COHERENT_DRAWS = 20
# GNSS acquisition: +-1.25e-3 cycles/sample (+-5.1 kHz at 4.092 Msps) in 64
# hypotheses; a PRN is present where metric * N exceeds 25 (noise alone:
# ~1 on average, ~14 at the largest of the 1M cells of a surface)
ACQ_MAX_DOPPLER, ACQ_DOPPLERS, ACQ_THRESHOLD = 1.25e-3, 64, 25.0
# butter(4, 0.05) against the exact float64 recursion: the truncated
# kernel's floor (-89 dB on the CPU, in both packages; ROADMAP.md §3.15)
IIR_TRUNC_DB = -85.0
IRR_DB_APART = 0.01  # the corrected tone's image rejection, card vs CPU run (dB)
# (dec, fft_len, packed): the RX frame kernel's direct instance at 4,096 points
# (one CTA an SM) and at 64 (32 frames a CTA), and with its mixed-radix FFT at
# 192, 3072, a prime 131 and an unpacked chain at 30 (frames not whole bytes);
# the chunked instance past the direct instance's frames (a 32,768-sample span
# at dec 8) and taps (257 at dec 16, 1,025 at dec 64); the cluster instance at
# 8,192 points (2 CTAs) and 65,536 (8 CTAs). Before the chunked and cluster
# instances the card raised at dec 16 / 2048, 4 / 8192, 8 / 4096, 64 / 512 and
# 1 / 65536.
# phase 7's tie cases: a rate-1/2 code a constraint length (a third generator
# makes the rate-1/3 case)
VITERBI_TIE_CODES = {3: (0o5, 0o7), 5: (0o23, 0o35), 7: (0o171, 0o133), 9: (0o561, 0o753)}
F7_GEOMETRIES = ((4, 4096, True), (4, 64, True), (4, 192, True), (4, 3072, True),
                 (5, 30, False), (4, 131, False), (16, 2048, True), (4, 8192, True),
                 (8, 4096, True), (64, 512, True), (1, 65536, True),
                 (4, 4099, False), (4, 16411, False), (2, 8198, False), (1, 131072, True),
                 (4, 262144, True), (1, 4194304, True))
# ... and the global instance (one cooperative launch, frames in a device
# scratch): frames past 4,096 points with no cluster split (4,099 and 16,411
# are primes, 8,198 = 2 x 4,099: Bluestein), and past 65,536 points up to one
# 4M-point frame at dec 1. Before it the card raised at all six.
# phase 7's codes past the warp instance of the Viterbi kernel (K, generators)
# and the state counts past the BCJR's 4-64 (conv codes through
# conv_decode_soft; S 3 by random tables)
VITERBI_REACH = {(2, 2): (0o3, 0o1), (10, 2): (0o1171, 0o1233), (12, 2): (0o4335, 0o5723),
                 (15, 2): (0o46321, 0o51271), (17, 2): (0o234567, 0o312345),
                 (19, 2): (0o1351753, 0o1746321),
                 (7, 9): (0o171, 0o133, 0o165, 0o117, 0o127, 0o155, 0o135, 0o147, 0o173),
                 (7, 16): tuple(range(0o101, 0o101 + 32, 2))}
BCJR_REACH = {2: (0o3, 0o1), 128: (0o247, 0o371), 256: (0o561, 0o753),
              1024: (0o2467, 0o3565)}
# phase 7's full block past the shared-memory history: K = 7, rate 1/2
VITERBI_LONG_STEPS = 65_536
# the burst families beside viterbi and turbo: (label, PacketConfig fields,
# the kernel launches an rx_batch makes)
BURST_FAMILIES = (
    ("rs", {"fec": "rs"}, {}),
    ("ccsds", {"fec": "ccsds"}, {"viterbi": 1}),
    ("ccsds conv", {"fec": "ccsds", "ccsds_interleaver": "conv"}, {"viterbi": 1}),
    ("ccsds erasures", {"fec": "ccsds", "rs_erasures": True}, {"bcjr": 1}),
    ("bch", {"fec": "bch"}, {}),
    ("bch chase 4", {"fec": "bch", "bch_chase": 4}, {}),
    ("tpc", {"fec": "tpc"}, {}),
    ("ldpc", {"fec": "ldpc"}, {}),
    ("ldpc11n", {"fec": "ldpc11n"}, {}),
    ("nr_ldpc", {"fec": "nr_ldpc"}, {}),
    ("polar", {"fec": "polar"}, {}),
    ("polar bp", {"fec": "polar", "polar_decoder": "bp"}, {}),
    ("ldpc alist", {"fec": "ldpc", "ldpc_file": "regular.alist"}, {}),
    ("ldpc npz", {"fec": "ldpc", "ldpc_file": "wifi_qc.npz"}, {}),
    ("nr_ldpc file", {"fec": "nr_ldpc", "nr_base_graph_file": "bg2_z64.npz"}, {}),
)
CCSDS_VITERBI, CCSDS_SOFT = (64, 48), (96, 64)  # the ccsds inner decoders' (window, guard)
# phase 7's shift-register codes for the BCJR's lanes instance, K = 3..6 (S 4..32)
BCJR_SR_CODES = {3: (0o5, 0o7), 4: (0o13, 0o17), 5: (0o23, 0o35), 6: (0o53, 0o75)}
CRC_SEED = 1717  # phase 30's bytes for the CRC on the card against zlib


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def print_ptxas(build, kernel: str) -> None:
    log = build.library_path(kernel).with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  ptxas {kernel}: {line.strip()}")


def bound(ops: float, nbytes: float) -> dict:
    """Roofline bound: the larger of ops / FP32 peak and bytes / HBM rate."""
    t_ops, t_bytes = ops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def bcjr_bound_of(lw: int, n: int, s_count: int, classes: bool) -> dict:
    """The BCJR kernel's bound: the FP32 operations its function needs a
    step and column (csrc/bcjr.cu), 28 S - 3 for any tables and 16 S + 21
    where every transition's coefficients are those of one of four classes,
    none an FMA, so each an FMA's issue slot (twice the data sheet's count
    at its FP32 peak); the bytes: two spans in, the LLRs out."""
    ops = 16 * s_count + 21 if classes else 28 * s_count - 3
    return bound(2 * lw * n * ops, 3 * lw * n * 4)


def viterbi_bound_of(n_tr: int, lw: int, n: int, s_count: int, npat: int) -> dict:
    """The Viterbi kernel's bound: a step of a trellis needs the metric of
    each of the code's ``npat`` distinct output patterns (``n`` FMAs each)
    and 6 FP32 operations a state (the two candidates' sums, their
    comparison, the select, the subtraction of the step's minimum and the
    running minimum), none an FMA, so each an FMA's issue slot (twice the
    data sheet's count at its FP32 peak); the bytes: the LLRs in, a uint8
    bit a step out."""
    return bound(2 * n_tr * lw * (npat * n + 6 * s_count), n_tr * lw * (4 * n + 1))


def paired_device_ms(run_a, run_b, calls: int = 20):
    """Device ms a launch (``kernel_device_ms``, kernels named
    ``bcjr_kernel*``) of ``run_a`` and ``run_b`` in turns, a, b, b, a:
    the medians of their two windows."""
    from aether_primitives_tpu_torch.cli import kernel_device_ms

    got = {0: [], 1: []}
    for which in (0, 1, 1, 0):
        got[which].append(kernel_device_ms((run_a, run_b)[which], "bcjr_kernel", calls))
    return sum(got[0]) / 2, sum(got[1]) / 2  # the median of two


def burst_channel(burst, rng, delay, cfo, sigma=0.05):
    """benches/burst_bench.py's channel: delay, gain 0.5 e^{j0.8}, CFO,
    complex Gaussian noise of std ``sigma`` per component."""
    import numpy as np

    x = np.zeros(CAPTURE, np.complex64)
    x[delay:delay + burst.size] = burst
    n = np.arange(CAPTURE)
    x = x * (0.5 * np.exp(1j * 0.8)) * np.exp(2j * np.pi * cfo * n)
    x += sigma * (rng.normal(size=CAPTURE) + 1j * rng.normal(size=CAPTURE))
    return x.astype(np.complex64)


def write_code_tables(folder: Path) -> None:
    """The file-loaded families' code tables, by the port's ``code_io``:
    the Gallager code's H as an ``.alist``, the 802.11n 648/Z27 base and an
    NR BG2 graph for z 64 (seed 99, not the built-in seed 1) as QC ``.npz``."""
    from aether_primitives_tpu_torch.ops import code_io, ldpc, nr_ldpc

    code_io.save_alist(ldpc.make_regular_ldpc()[0], folder / "regular.alist")
    code_io.save_qc_npz(ldpc._WIFI_648_R12, 27, folder / "wifi_qc.npz")
    code_io.save_qc_npz(nr_ldpc.make_nr_base_graph(2, 64, seed=99), 64, folder / "bg2_z64.npz")


def nr_chain_phase(card: str, device: str = "cuda", frames: int = 64, host: int = 8) -> None:
    """The NR transport-block chain and soft combining on ``device``
    against the CPU run of the first ``host`` frames:
    ``NrTransportBlock(9000)`` (3 code blocks of BG2 at z 320) over
    ``frames`` payloads, encoded and decoded (sigma 0.7, every block
    decodes); and two redundancy versions (rv 0 and 2) of a shortened BG2
    code at z 64 sent at 3.03 times the circular buffer (a position hit up
    to 4 times; sigma 1.5), their de-rate-matched buffers summed and
    decoded. Every output ``torch.equal`` to the CPU's; no kernel of
    ``KERNELS`` launches."""
    import numpy as np
    import torch

    from aether_primitives_tpu_torch.cli import time_cuda
    from aether_primitives_tpu_torch.ops.nr_ldpc import NrLdpc, NrTransportBlock

    def noisy(tx, rng, sigma):
        y = (1.0 - 2.0 * tx.cpu().numpy()) + sigma * rng.normal(size=tuple(tx.shape))
        return torch.from_numpy((2.0 / sigma ** 2 * y).astype(np.float32))

    rng = np.random.default_rng(2024)
    tb = NrTransportBlock(tb_bits=9000)
    payload = torch.from_numpy(rng.integers(0, 2, (frames, 9000)).astype(np.uint8))
    e = 2 * tb.k_per_block
    reset_counts()
    tx = tb.encode(payload.to(device), e)
    llr = noisy(tx, rng, 0.7)
    got = tb.decode(llr.to(device))
    sync(device)
    counts = kernel_launches()
    tx_cpu, want = tb.encode(payload, e), tb.decode(llr[:host])
    same = (torch.equal(tx.cpu(), tx_cpu) and torch.equal(got[0][:host].cpu(), want[0])
            and torch.equal(got[1][:host].cpu(), want[1]))
    exact = bool(torch.equal(got[0].cpu(), payload)) and bool(got[1].all())
    dec_ms = time_cuda(lambda: tb.decode(llr.to(device)), 3) if device == "cuda" else None
    print(f"nr transport block: {tb.n_blocks} code blocks of {tb.k_per_block} bits (BG2, z "
          f"{tb.code.z}) x {frames}, e {e} a block: payloads exact and CRC24A ok {exact}, "
          f"encode (all) and decode (first {host}) equal to the CPU run {same}, launches "
          f"{counts} (need none); "
          f"decode {fmt_ms(dec_ms)} ms a call (CUDA events, mean of 3) [{card}]", flush=True)
    if not (same and exact) or counts != NO_LAUNCHES:
        fail("nr transport block: card and CPU disagree, a payload failed, or a kernel launched")

    code = NrLdpc(z=64, bg=2, k=500)
    e = 3 * (code.ncb - code.n_filler) + 77  # 4 passes of the circular buffer
    bits = torch.from_numpy(rng.integers(0, 2, (frames, 500)).astype(np.uint8))
    llrs = {rv: noisy(code.encode(bits, e, rv), np.random.default_rng(rv), 1.5) for rv in (0, 2)}
    bufs = {}
    for dev in (device, "cpu"):
        buf = code.dematch(llrs[0].to(dev), 0) + code.dematch(llrs[2].to(dev), 2)
        bufs[dev] = (buf, code.decode_buffer(buf))
    (buf, (dec, ok)), (buf_h, (dec_h, ok_h)) = bufs[device], bufs["cpu"]
    same = (torch.equal(buf.cpu(), buf_h) and torch.equal(dec.cpu(), dec_h)
            and torch.equal(ok.cpu(), ok_h))
    print(f"nr soft combining: rv 0 + rv 2 at e {e} ({e / (code.ncb - code.n_filler):.2f} "
          f"times the buffer), {frames} frames: buffers torch.equal to the CPU's "
          f"{torch.equal(buf.cpu(), buf_h)}, decode equal {same}, decoded "
          f"{int(ok.sum())}/{frames} [{card}]", flush=True)
    if not same:
        fail("nr soft combining: the card's buffers or decode differ from the CPU's")


def burst_captures(pm, bursts: int = BURSTS, seed: int = 4242):
    """``bursts`` random payloads sent by ``pm.tx`` through
    :func:`burst_channel`, from ``seed``: ``(payloads, captures)`` as numpy."""
    import numpy as np
    import torch

    brng = np.random.default_rng(seed)
    payloads = brng.integers(0, 2, (bursts, pm.config.payload_bits)).astype(np.uint8)
    sent = pm.tx(torch.from_numpy(payloads)).cpu().numpy()
    caps = np.stack([
        burst_channel(sent[i], brng, delay=64 + (i * 53) % 2048, cfo=((i % 7) - 3) * 3e-4)
        for i in range(bursts)
    ])
    return payloads, caps


def random_tables(s_count: int, seed: int, pattern=None):
    """A random valid binary trellis of ``s_count`` states (two successors
    and two predecessors each) with random coefficients, as hashable tables;
    ``pattern`` keeps that ``(nxt, prev_s)`` (tests/test_torch_bcjr.py's)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    if pattern is None:
        nxt = rng.permutation(np.repeat(np.arange(s_count), 2)).reshape(s_count, 2)
        prev_s = np.zeros((s_count, 2), np.int64)
        fill = np.zeros(s_count, np.int64)
        for s in range(s_count):
            for u in (0, 1):
                prev_s[nxt[s, u], fill[nxt[s, u]]] = s
                fill[nxt[s, u]] += 1
    else:
        nxt, prev_s = (np.asarray(p) for p in pattern)
    coef = [np.round(rng.normal(size=(s_count, 2)), 3) for _ in range(4)]
    return tuple(tuple(map(tuple, a.tolist())) for a in (nxt, prev_s, *coef))


def bcjr_cases(bk, spans, lw: int, cols: int, seed: int = 77):
    """Phase 7's BCJR cases, ``(label, tables, (ls, lp), Lw)``: the path's
    shape for RSC-8 and K=7; Lw 1, 2, 95 and 97; N 1, 77, 1,000 and 2,570
    (the last CTA not full); integer-valued LLRs with -0.0 (exact ties);
    random valid tables for every state count the kernel takes, and random
    coefficients on the RSC-8 pattern (not through its branch-metric
    classes: the lanes instance); shift-register codes at K = 3-6; the lanes
    instance's short spans (Lw 1-3, 97) in both its forms; its span limit at
    S 64 and one step past it (the block instance); RSC-8 past the meet
    instance's limit (the lanes instance); the block instance past the lanes
    limit at S 4 and for RSC-8, at 300 states and past 1,024 (the cluster
    route)."""
    import numpy as np
    import torch

    from aether_primitives_tpu_torch.ops import fec

    rng = np.random.default_rng(seed)
    dev = spans[0].device

    def normal(lw_c, n):
        return tuple(torch.from_numpy((rng.normal(size=(lw_c, n)) * 3).astype(np.float32))
                     .to(dev) for _ in range(2))

    k7 = fec._conv_soft_coeffs(*K7)
    cases = [("RSC-8", None, spans, lw), ("K=7 conv", k7, spans, lw)]
    cases += [("RSC-8", None, normal(lw_c, cols), lw_c) for lw_c in (1, 2, 95, 97)]
    cases += [("RSC-8", None, normal(lw, n), lw) for n in (1, 77, 1000, 2570)]
    ties = [rng.integers(-2, 3, (lw, cols)).astype(np.float32) for _ in range(2)]
    for t in ties:
        t[(t == 0) & (rng.random(t.shape) < 0.5)] = -0.0
    ties = tuple(torch.from_numpy(t).to(dev) for t in ties)
    cases += [("RSC-8 ties and -0.0", None, ties, lw), ("K=7 conv ties and -0.0", k7, ties, lw)]
    cases += [(f"random S {s_count}", random_tables(s_count, seed + s_count), spans, lw)
              for s_count in bk.KERNEL_STATES]
    cases.append(("random coefficients on the RSC-8 pattern",
                  random_tables(8, seed, pattern=bk.rsc8_tables()[:2]), spans, lw))
    # the lanes instance's shift-register codes with a ragged last CTA, its
    # short spans in both forms, its span limit and one step past it (the
    # block instance), and RSC-8 past the meet instance's limit
    for k, polys in BCJR_SR_CODES.items():
        cases.append((f"K={k} conv (S {1 << (k - 1)})", fec._conv_soft_coeffs(polys, k),
                      normal(lw, 2570), lw))
    cases += [("K=7 conv", k7, normal(lw_c, 77), lw_c) for lw_c in (1, 2, 3, 97)]
    s8 = random_tables(8, seed + 1)
    cases += [("random S 8", s8, normal(lw_c, 77), lw_c) for lw_c in (1, 2, 3)]
    lim = bk.lanes_span_limit(64)
    cases += [("K=7 conv at the lanes limit", k7, normal(lim, 77), lim),
              ("K=7 conv one step past the lanes limit", k7, normal(lim + 1, 77), lim + 1),
              ("RSC-8 past the meet limit", None, normal(727, 1000), 727)]
    # the block instance past the lanes limit at S 4 and for RSC-8, in its
    # multi-warp form (S 300: 2 warps a direction) and past it (the
    # cluster route)
    k3 = fec._conv_soft_coeffs(BCJR_SR_CODES[3], 3)
    lim4, lim8 = bk.lanes_span_limit(4), bk.lanes_span_limit(8)
    cases += [("K=3 conv one step past the lanes limit", k3, normal(lim4 + 1, 77), lim4 + 1),
              ("RSC-8 past the lanes limit", None, normal(lim8 + 1, 77), lim8 + 1),
              ("random S 300", random_tables(300, seed + 300), normal(lw, 77), lw),
              ("random S 1,500 (the cluster route)", random_tables(1500, seed + 1500),
               normal(lw, 7), lw)]
    return cases


def viterbi_floor(n_tr: int, lw: int, k: int, polys, end_state0: bool) -> dict:
    """The chain floor of a launch of the Viterbi kernel's grid route: its
    geometry (``csrc/viterbi.cu viterbi_grid_geometry``: CTAs, threads, grid
    barriers) and the device ms of an empty cooperative kernel that makes
    the same barriers on the same grid (``benches/torch_chain_floor.cu``)."""
    import torch

    from aether_primitives_tpu_torch.cli import kernel_device_ms
    from aether_primitives_tpu_torch.ops.cuda import build
    from aether_primitives_tpu_torch.ops.cuda import viterbi as vk

    geometry = build.load("viterbi").viterbi_grid_geometry
    geometry.argtypes = ([ctypes.c_longlong] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    geometry.restype = ctypes.c_int
    out = (ctypes.c_longlong * 4)()
    npat = vk.patterns(tuple(polys), k)[0]
    rc = geometry(n_tr, vk.GRID_BATCH, lw, 1 << (k - 1), npat, int(end_state0), out)
    if rc:
        fail(f"viterbi_grid_geometry: CUDA error {rc}")
    grid, threads, _, syncs = (int(v) for v in out)
    launch = build.load_source(CHAIN_FLOOR).grid_floor_launch
    launch.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
    launch.restype = ctypes.c_int

    def run():
        if launch(grid, threads, syncs, torch.cuda.current_stream().cuda_stream):
            fail("the grid floor kernel did not launch")
    ms = kernel_device_ms(run, "grid_floor_kernel", 10)
    return {"floor_ms": ms, "ctas": grid, "threads": threads, "barriers": syncs}


def bcjr_floor(s_count: int, lw: int, n: int) -> dict:
    """The chain floor of a launch of the BCJR kernel past 1,024 states at
    ``s_count`` states, ``Lw`` x ``N``, in the geometry of
    ``bk.cluster_layout``: the device ms of an
    empty kernel of the same CTAs and threads whose directions make the
    same ``Lw`` steps of barriers (``benches/torch_chain_floor.cu``). The
    cluster route (registers placement): clusters of the same size, a step
    the mbarrier's wait, one st.async key to every other CTA and the
    arrival, and the same three cluster barriers. The shared route: a
    step the direction's named barrier, and the CTA barrier at the
    meet."""
    import torch

    from aether_primitives_tpu_torch.cli import kernel_device_ms
    from aether_primitives_tpu_torch.ops.cuda import bcjr as bk
    from aether_primitives_tpu_torch.ops.cuda import build

    q, _, w, place, _ = bk.cluster_layout(s_count, n)
    if place == "shared":
        launch = build.load_source(CHAIN_FLOOR).block_floor_launch
        launch.argtypes = [ctypes.c_longlong] + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        launch.restype = ctypes.c_int

        def run_block():
            if launch(n, w, lw, torch.cuda.current_stream().cuda_stream):
                fail("the block floor kernel did not launch")
        ms = kernel_device_ms(run_block, "block_floor_kernel", 10)
        return {"floor_ms": ms, "ctas": n, "cluster": 1, "threads": 64 * w, "barriers": lw}
    ctas = n * q
    launch = build.load_source(CHAIN_FLOOR).cluster_floor_launch
    launch.argtypes = ([ctypes.c_longlong] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    launch.restype = ctypes.c_int

    def run():
        if launch(ctas, q, w, lw, torch.cuda.current_stream().cuda_stream):
            fail("the cluster floor kernel did not launch")
    ms = kernel_device_ms(run, "cluster_floor_kernel", 10)
    return {"floor_ms": ms, "ctas": ctas, "cluster": q, "threads": 64 * w, "barriers": lw}


def decoder_reach_phase(card: str, device: str = "cuda") -> dict:
    """Phase 7's codes past the decoders' earlier instances: Viterbi at
    K 2 (the warp instance, lanes idle), K 10, 12, 15 and 17 and K 7 with 9
    and 16 generators (the block instance: a CTA or, K 17 over 4 spans, a
    cluster of 8 a trellis), full block and windowed; the windowed BCJR's
    block instance at S 2, 3 (random tables), 128, 256 and 1,024, through
    ``conv_decode_soft`` where S is a conv code's, and at S 64 and 4 one step
    past the lanes instance's span limit (K=7 and K=3 tables). Each
    ``torch.equal`` to its twin with one launch a call, then timed (CUDA
    events; twin beside it; Viterbi K 2, 10, 15 and 16 generators at 256 x
    112, K 17 at 4 x 112) beside its bound. The routes past the earlier
    designs' reach, Viterbi's grid route (K 19 full block, the check's 2
    trellises of 78 steps) and the BCJR's cluster route (S 1,500 at phase
    7's Lw 96 x N 7), are timed by device time (``torch.profiler``) beside
    their bounds and their chain floors (an empty kernel making the same
    grid or cluster barriers: ``viterbi_floor``, ``bcjr_floor``); then a
    full-card shape each (``VITERBI_FULL``: K 19, 16 trellises of 1,024
    steps, the grid route; ``BCJR_FULL``: the K 12 code, Lw 224 x N 512,
    the BCJR's shared route, its floor the same named barriers),
    ``torch.equal`` to its twin once with one launch, the kernel alone
    timed. Returns the entries of the viterbi and bcjr kernels'
    ``instances``."""
    import numpy as np
    import torch

    from aether_primitives_tpu_torch.cli import kernel_device_ms, time_cuda
    from aether_primitives_tpu_torch.ops import fec
    from aether_primitives_tpu_torch.ops.cuda import bcjr as bk
    from aether_primitives_tpu_torch.ops.cuda import viterbi as vk

    dev = torch.device(device)
    kl = 1 if dev.type == "cuda" else 0
    rng = np.random.default_rng(1919)

    def llrs(polys, k, b, n_bits):
        bits = rng.integers(0, 2, (b, n_bits)).astype(np.uint8)
        enc = fec.conv_encode(torch.from_numpy(bits), polys, k).numpy()
        return torch.from_numpy(((1 - 2.0 * enc) * 2 + rng.normal(size=enc.shape))
                                .astype(np.float32)).to(dev)

    def once(label, what, run, plain):
        reset_counts()
        got = run()
        sync(dev)
        counts = kernel_launches()
        want = plain()
        sync(dev)
        same = torch.equal(got, want)
        print(f"compare {label}: kernel vs plain torch.equal {same}, launches {counts} "
              f"(need {what} {kl})")
        if not same or counts != {**NO_LAUNCHES, what: kl}:
            fail(f"{label}: kernel and plain twin disagree, or not one launch")

    def timed(label, run, plain, b, ops_bytes, kernel=None):
        t, runs = timed_pair(run, plain, iters=(10, 2), runs=2)
        dev_ms = None
        if kernel and dev.type == "cuda":
            dev_ms = float(np.median([kernel_device_ms(run, kernel, 10) for _ in range(3)]))
        print(f"time: {label}: kernel median {t['kernel']:.4f} ms (runs "
              f"{', '.join(f'{v:.4f}' for v in runs['kernel'])})"
              + ("" if kernel is None else f", device {fmt_ms(dev_ms)} ms ({kernel}, "
                 "torch.profiler, median of 3 windows of 10 calls; "
                 f"{fmt_ms(dev_ms and dev_ms / b['bound_ms'])}x the bound)")
              + f", plain twin median {t['plain']:.4f} ms; CUDA events; bound "
              f"{b['bound_ms']:.5f} ms ({b['bound_by']}: {ops_bytes}) [{card}]", flush=True)
        return {**t, **b, **({} if kernel is None else {"device_ms": dev_ms})}

    def alone(label, run, b, kernel, floor):  # a full-card shape: the kernel alone
        ms = time_cuda(run, 3, warmup=1) if dev.type == "cuda" else None
        dev_ms = None
        if dev.type == "cuda":
            try:  # the profiler drops whole windows of these long launches at times
                dev_ms = kernel_device_ms(run, kernel, 5, tries=5)
            except RuntimeError:
                print(f"time: {label}: the profiler recorded no window; the CUDA events' "
                      f"time of the launch stands alone [{card}]", flush=True)
        print(f"time: {label}: kernel {fmt_ms(ms)} ms a call (CUDA events, 3 calls), device "
              f"{fmt_ms(dev_ms)} ms ({kernel}, torch.profiler, 5 calls a window; "
              f"{fmt_ms(dev_ms and dev_ms / b['bound_ms'])}x the bound); bound "
              f"{b['bound_ms']:.5f} ms ({b['bound_by']})[{card}]", flush=True)
        print(f"chain floor: {label}: {floor['floor_ms']:.5f} ms device for "
              f"{floor['barriers']} barriers of {floor['ctas']} CTAs x {floor['threads']} "
              f"threads (an empty kernel, torch.profiler) [{card}]", flush=True)
        return {"kernel": ms, "device_ms": dev_ms, **b, **floor}

    out = {"viterbi": {}, "bcjr": {}}
    full = {}  # the grid route's code, timed at the full-card shape below
    for (k, n), polys in VITERBI_REACH.items():
        inst = vk.instance(n, k)
        b_sz, n_bits = (16, 300) if k < 15 else (2, 60)
        if inst == "block" and (vk.block_plan(n_bits + k - 1, n, k, b_sz) is None) != (k > 18):
            fail(f"viterbi K={k} rate 1/{n}: the block instance's route is not the one "
                 "phase 7 checks (the cluster route to K 18, the grid route past it)")
        x = llrs(polys, k, b_sz, n_bits)
        for kw in ({}, {"window": 64, "guard": 48}):
            once(f"viterbi K={k} rate 1/{n} ({inst} instance) "
                 f"{'windowed 64/48' if kw else 'full block'} {tuple(x.shape)}", "viterbi",
                 lambda: fec.viterbi_decode(x, polys, k, **kw),
                 lambda: fec.viterbi_decode(x, polys, k, backend="reference", **kw))
        if k == 19:  # the grid route at the shape checked above, and its floor
            s_count = 1 << (k - 1)
            npat = vk.patterns(polys, k)[0]
            lw_v = n_bits + k - 1
            entry = timed(
                f"viterbi K={k} rate 1/{n} ({inst} instance, the grid route), full block "
                f"{tuple(x.shape)}",
                lambda: fec.viterbi_decode(x, polys, k),
                lambda: fec.viterbi_decode(x, polys, k, backend="reference"),
                viterbi_bound_of(b_sz, lw_v, n, s_count, npat),
                f"{npat} patterns x n FMAs and {s_count} states x 6 FP32 operations a "
                "step, LLRs in, bits out", kernel="viterbi_grid_kernel")
            floor = viterbi_floor(b_sz, lw_v, k, polys, True)
            print(f"chain floor: viterbi K={k} grid route, {b_sz} x {lw_v} steps: "
                  f"{floor['floor_ms']:.5f} ms device for {floor['barriers']} grid barriers of "
                  f"{floor['ctas']} CTAs x {floor['threads']} threads (an empty cooperative "
                  f"kernel, torch.profiler) [{card}]", flush=True)
            out["viterbi"][f"K={k} n={n} {inst} grid"] = {**entry, **floor}
            full[k] = polys
        if k in (2, 10, 15, 17) or n == 16:  # one timed shape an instance and state range
            lw, n_tr = (112, 4) if k == 17 else (112, 256)
            sym = torch.from_numpy(np.round(rng.normal(size=(n_tr, lw, n)) * 2)
                                   .astype(np.float32)).to(dev)
            s_count = 1 << (k - 1)
            npat = vk.patterns(polys, k)[0]
            b = viterbi_bound_of(n_tr, lw, n, s_count, npat)
            out["viterbi"][f"K={k} n={n} {inst}"] = timed(
                f"viterbi K={k} rate 1/{n} ({inst} instance), {n_tr} spans of {lw} steps",
                lambda: vk.viterbi_lanes(sym, lw, n, polys, k, False, False),
                lambda: vk.viterbi_lanes_reference(sym, lw, n, polys, k, False, False), b,
                f"{npat} patterns x n FMAs and {s_count} states x 6 FP32 operations a "
                "step, LLRs in, bits out")
    # the grid route at a full-card shape: 16 K 19 trellises of 1,024 steps
    # (4.2 M states a step, 537 MB of decisions), once against the twin,
    # then the kernel alone
    (k_f, polys_f), = full.items()
    n_tr_f, lw_f = VITERBI_FULL
    sym_f = torch.from_numpy(np.round(rng.normal(size=(n_tr_f, lw_f, 2)) * 2)
                             .astype(np.float32)).to(dev)
    once(f"viterbi K={k_f} rate 1/2 (block instance, the grid route), full block "
         f"{n_tr_f} x {lw_f} steps", "viterbi",
         lambda: vk.viterbi_lanes(sym_f, lw_f, 2, polys_f, k_f, True, True),
         lambda: vk.viterbi_lanes_reference(sym_f, lw_f, 2, polys_f, k_f, True, True))
    out["viterbi"][f"K={k_f} n=2 block grid {n_tr_f} x {lw_f}"] = alone(
        f"viterbi K={k_f} rate 1/2 (the grid route), full block {n_tr_f} x {lw_f} steps",
        lambda: vk.viterbi_lanes(sym_f, lw_f, 2, polys_f, k_f, True, True),
        viterbi_bound_of(n_tr_f, lw_f, 2, 1 << (k_f - 1), vk.patterns(polys_f, k_f)[0]),
        "viterbi_grid_kernel", viterbi_floor(n_tr_f, lw_f, k_f, polys_f, True))
    del sym_f
    torch.cuda.empty_cache()
    window, guard = CCSDS_SOFT
    lw_b = window + 2 * guard
    # (S, Lw, N): the state counts outside 4-64 at the ccsds span, and the
    # K=7 and K=3 codes one step past the lanes instance's span limit
    shapes = [(s_count, lw_b, 2048 if s_count <= 256 else 256)
              for s_count in (2, 3, 128, 256, 1024)]
    shapes += [(s_count, bk.lanes_span_limit(s_count) + 1, 2048) for s_count in (64, 4)]
    for s_count, lw_r, n_cols in shapes:
        if s_count in (64, 4):
            k = s_count.bit_length()
            tables = fec._conv_soft_coeffs(*(K7 if k == 7 else (BCJR_SR_CODES[k], k)))
        elif s_count in BCJR_REACH:
            polys = BCJR_REACH[s_count]
            k = s_count.bit_length()
            tables = fec._conv_soft_coeffs(polys, k)
            x = llrs(polys, k, 8, 400)
            once(f"conv_decode_soft K={k} (S {s_count}, {bk.kernel_plan(tables, lw_b)[0]} "
                 f"instance) windowed {window}/{guard} {tuple(x.shape)}", "bcjr",
                 lambda: fec.conv_decode_soft(x, polys, k, window=window, guard=guard),
                 lambda: fec.conv_decode_soft(x, polys, k, window=window, guard=guard,
                                              backend="reference"))
        else:
            tables = random_tables(s_count, 1900 + s_count)
        ls, lp = (torch.from_numpy((rng.normal(size=(lw_r, n_cols)) * 3).astype(np.float32))
                  .to(dev) for _ in range(2))
        inst = bk.kernel_plan(tables, lw_r)[0]
        once(f"bcjr S {s_count} ({inst} instance) Lw {lw_r} x N {n_cols}", "bcjr",
             lambda: bk.bcjr_windowed_llr(ls, lp, lw_r, tables),
             lambda: bk.bcjr_windowed_llr_reference(ls, lp, lw_r, tables))
        out["bcjr"][f"S {s_count} Lw {lw_r} {inst}"] = timed(
            f"bcjr S {s_count} ({inst} instance), Lw {lw_r} x N {n_cols}",
            lambda: bk.bcjr_windowed_llr(ls, lp, lw_r, tables),
            lambda: bk.bcjr_windowed_llr_reference(ls, lp, lw_r, tables),
            bcjr_bound_of(lw_r, n_cols, s_count, classes=False),
            "28 S - 3 FP32 operations a step and column, each an FMA's slot")
    # the cluster route past 1,024 states at phase 7's shape (bcjr_cases'
    # "random S 1,500": Lw 96 x N 7), and its floor
    lw_w, n_w, s_w = 16 + 64 + 16, 7, 1500
    tables = random_tables(s_w, 1900 + s_w)
    ls, lp = (torch.from_numpy((rng.normal(size=(lw_w, n_w)) * 3).astype(np.float32)).to(dev)
              for _ in range(2))
    inst = bk.kernel_plan(tables, lw_w)[0]
    route = bk.block_layout(s_w, n_w)
    once(f"bcjr S {s_w} ({inst} instance, the cluster route {route}) Lw {lw_w} x N {n_w}",
         "bcjr",
         lambda: bk.bcjr_windowed_llr(ls, lp, lw_w, tables),
         lambda: bk.bcjr_windowed_llr_reference(ls, lp, lw_w, tables))
    entry = timed(
        f"bcjr S {s_w} ({inst} instance, the cluster route), Lw {lw_w} x N {n_w}",
        lambda: bk.bcjr_windowed_llr(ls, lp, lw_w, tables),
        lambda: bk.bcjr_windowed_llr_reference(ls, lp, lw_w, tables),
        bcjr_bound_of(lw_w, n_w, s_w, classes=False),
        "28 S - 3 FP32 operations a step and column, each an FMA's slot",
        kernel="bcjr_kernel_cluster")
    floor = bcjr_floor(s_w, lw_w, n_w)
    print(f"chain floor: bcjr S {s_w} cluster route, Lw {lw_w} x N {n_w}: "
          f"{floor['floor_ms']:.5f} ms device for {floor['barriers']} steps of exchange "
          f"(mbarrier and st.async) of {floor['ctas']} CTAs in clusters of {floor['cluster']} "
          f"x {floor['threads']} threads (an empty kernel, torch.profiler) [{card}]", flush=True)
    out["bcjr"][f"S {s_w} Lw {lw_w} {inst} cluster"] = {**entry, **floor}
    # the shared route at a full-card shape: VITERBI_REACH's K 12 code (S
    # 2,048), Lw 224 x N 512 (0.94 GB of half-histories), once against the
    # twin, then the kernel alone (its bound with the four branch-metric
    # classes its tables factor through)
    lw_f, n_f = BCJR_FULL
    k_b = 12
    tables = fec._conv_soft_coeffs(VITERBI_REACH[(k_b, 2)], k_b)
    s_f = 1 << (k_b - 1)
    ls, lp = (torch.from_numpy((rng.normal(size=(lw_f, n_f)) * 3).astype(np.float32)).to(dev)
              for _ in range(2))
    route = bk.block_layout(s_f, n_f)
    if route[0] != "shared":
        fail(f"bcjr K={k_b} over {n_f} columns does not take the shared route: {route}")
    once(f"bcjr K={k_b} conv (S {s_f}, the shared route {route}) Lw {lw_f} x N {n_f}", "bcjr",
         lambda: bk.bcjr_windowed_llr(ls, lp, lw_f, tables),
         lambda: bk.bcjr_windowed_llr_reference(ls, lp, lw_f, tables))
    out["bcjr"][f"S {s_f} Lw {lw_f} x N {n_f} shared"] = alone(
        f"bcjr K={k_b} conv (S {s_f}, the shared route), Lw {lw_f} x N {n_f}",
        lambda: bk.bcjr_windowed_llr(ls, lp, lw_f, tables),
        bcjr_bound_of(lw_f, n_f, s_f, classes=True), "bcjr_kernel_block",
        bcjr_floor(s_f, lw_f, n_f))
    return out


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a CUDA card")
    from aether_primitives_tpu_torch.cli import (
        BLOCK, capture, card_label, gate, kernel_device_ms, max_sm_clock_hz,
        numpy_reference_spectra, resident_streaming, stream_blocks, time_cuda,
    )
    from aether_primitives_tpu_torch.models import (
        PacketConfig, PacketModem, RxChain, RxChainConfig,
    )
    from aether_primitives_tpu_torch.ops import fec
    from aether_primitives_tpu_torch.ops.cuda import bcjr as bk
    from aether_primitives_tpu_torch.ops.cuda import build, rx_frame as rf
    from aether_primitives_tpu_torch.ops.cuda import viterbi as vk

    # ---- phase 1: the card --------------------------------------------
    name = torch.cuda.get_device_name(0)
    card = card_label()
    print(f"device: {name} (count {torch.cuda.device_count()})")
    print(f"card (nvidia-smi name, power.limit): {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32: torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    # ---- phase 2: build --------------------------------------------------
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS) + 2) as pool:  # one nvcc per source, together
        builds = {k: pool.submit(build.load, k) for k in KERNELS}
        builds["the fold kernel's previous design"] = pool.submit(build.load_source, PARENT_FOLD)
        builds["the chain floors' empty kernels"] = pool.submit(build.load_source, CHAIN_FLOOR)
        for kernel, fut in builds.items():
            try:
                fut.result()
            except Exception as e:  # the build's own message names the cause
                fail(f"{kernel} kernel build: {e}")
    print(f"build: {', '.join(f'{k}.cu -> {build.library_path(k).name}' for k in KERNELS)}, "
          f"{PARENT_FOLD.name} (timed in phase 13) and {CHAIN_FLOOR.name} (phase 7) in "
          f"{time.perf_counter() - t0:.2f} s "
          f"(parallel) [{card}]")
    print_ptxas(build, "pfb_fold")
    sys.stdout.flush()

    # ---- phase 3: kernel vs plain vs float64 at the main path's shapes --
    chain = RxChain(RxChainConfig(fft_len=2048, decimation=4, packed_bits=True),
                    device="cuda")
    taps, dec, fft_len = chain.taps, 4, 2048
    ku = taps.shape[-1] - 1
    x_full = capture(2 * BLOCK)
    t0 = time.perf_counter()
    ref_spec = numpy_reference_spectra(x_full, taps, dec, fft_len)
    print(f"float64 reference chain over {2 * BLOCK} samples: "
          f"{time.perf_counter() - t0:.1f} s (host) [{card}]")
    half = ref_spec.shape[0] // 2
    x_dev = torch.from_numpy(x_full).cuda()
    cases = {
        "block 1, zero history": (x_dev[:BLOCK], None, ref_spec[:half]),
        "block 2, carried history": (x_dev[BLOCK:].contiguous(),
                                     x_dev[BLOCK - ku:BLOCK], ref_spec[half:]),
    }
    unpack = rf.unpack_bits
    main_plan = rf.kernel_plan(dec, fft_len, None, taps.shape[-1])
    print(f"rx_frame main path: instance {main_plan[0]} (kernel_plan)")
    if main_plan[0] != "direct":
        fail(f"the main path's geometry took the {main_plan[0]} instance, not direct")
    worst_err = 0.0
    for label, (xb, hist, rs) in cases.items():
        ref_bits = {
            "qpsk": np.stack([rs.real < 0, rs.imag < 0], -1).astype(np.uint8).reshape(-1),
            "bpsk": (rs.real + rs.imag < 0).astype(np.uint8).reshape(-1),
        }
        for epi, want in ref_bits.items():
            got = unpack(rf.rx_frame(xb, taps, dec, fft_len, hist, epi)).cpu().numpy()
            plain = unpack(rf.rx_frame_reference(xb, taps, dec, fft_len, hist, epi)).cpu().numpy()
            torch.cuda.synchronize()
            a_ref = float((got == want).mean())
            a_plain = float((got == plain).mean())
            p_ref = float((plain == want).mean())
            print(f"compare {epi} {label}: kernel vs f64 {a_ref:.7f}, "
                  f"plain vs f64 {p_ref:.7f}, kernel vs plain {a_plain:.7f} "
                  f"(need >= {AGREEMENT})")
            if min(a_ref, a_plain) < AGREEMENT:
                fail(f"{epi} bytes, {label}: agreement below {AGREEMENT}")
        spec = rf.rx_frame(xb, taps, dec, fft_len, hist, "spectrum")
        spec_plain = rf.rx_frame_reference(xb, taps, dec, fft_len, hist, "spectrum")
        err = (spec - spec_plain).abs()
        worst_err = max(worst_err, float(err.max()))
        kp_db = float(10 * torch.log10((err.double() ** 2).mean()
                                       / (spec_plain.abs().double() ** 2).mean()))
        s = spec.cpu().numpy().astype(np.complex128)
        k_db = float(10 * np.log10((np.abs(s - rs) ** 2).mean() / (np.abs(rs) ** 2).mean()))
        print(f"compare spectrum {label}: kernel vs f64 {k_db:.2f} dB, "
              f"kernel vs plain {kp_db:.2f} dB RMS EVM, max |kernel - plain| "
              f"{float(err.max()):.3e} (need <= {EVM_DB} dB)")
        if k_db > EVM_DB or kp_db > EVM_DB or not np.isfinite(s).all():
            fail(f"spectrum epilogue, {label}: EVM above {EVM_DB} dB")
    sys.stdout.flush()

    instances = rx_frame_instances(card)

    # ---- phase 4: the main path's two-block streaming gate -----------------
    reset_counts()
    bits, states = stream_blocks(chain, x_full, BLOCK)
    torch.cuda.synchronize()
    counts = kernel_launches()
    main_launches = counts["rx_frame"]
    print(f"main path: {len(bits)} streaming steps, launches {counts}")
    if counts != {**NO_LAUNCHES, "rx_frame": len(bits)}:
        fail(f"rx_frame.launches {main_launches} != {len(bits)} streaming steps "
             "(or another kernel launched)")
    if any(b.shape != (BLOCK // 16,) or b.dtype != torch.uint8 for b in bits):
        fail(f"unexpected output blocks {[(b.shape, b.dtype) for b in bits]}")
    g = gate(chain, x_full, BLOCK, bits, states)
    print(f"gate: bit agreement {g['bit_agreement']:.7f} (need >= {AGREEMENT}), "
          f"block-2 spectrum via the kernel's spectrum epilogue "
          f"{g['evm_rms_db']:.2f} dB RMS EVM (need <= {EVM_DB}), "
          f"carried state exact {g['state_exact']}", flush=True)
    if not g["ok"]:
        fail(f"streaming gate: {g}")

    # ---- phase 5: timing -------------------------------------------------
    step_kernel = resident_streaming(chain)
    blocks = [torch.from_numpy(capture(BLOCK, 900 + i)).cuda() for i in range(4)]
    box = {"state": chain.init_state(), "i": 0}

    def step_plain():
        # the chain's streaming step with the plain frame op in place of the kernel
        xb = blocks[box["i"] % 4]
        box["i"] += 1
        out = rf.rx_frame_reference(xb, taps, dec, fft_len, box["state"], "qpsk")
        box["state"] = xb[BLOCK - ku:].clone()
        return out

    xb, hist = blocks[0], blocks[1][BLOCK - ku:]
    iters, runs = 40, 4
    ms = {"plain": [], "kernel": [], "chain_kernel": [], "chain_plain": []}
    for run in range(runs):  # alternate which side runs first
        for which in (("plain", "kernel"), ("kernel", "plain"))[run % 2]:
            if which == "kernel":
                ms["kernel"].append(time_cuda(
                    lambda: rf.rx_frame(xb, taps, dec, fft_len, hist, "qpsk"), iters))
                ms["chain_kernel"].append(time_cuda(step_kernel, iters))
            else:
                ms["plain"].append(time_cuda(
                    lambda: rf.rx_frame_reference(xb, taps, dec, fft_len, hist, "qpsk"),
                    iters))
                ms["chain_plain"].append(time_cuda(step_plain, iters))
    t = {k: float(np.median(v)) for k, v in ms.items()}
    msa = lambda m: BLOCK / (m * 1e-3) / 1e6  # noqa: E731
    for key, what in (
        ("kernel", "rx_frame kernel (direct), qpsk bytes"),
        ("plain", "rx_frame plain PyTorch, qpsk bytes"),
        ("chain_kernel", "streaming step, kernel path"),
        ("chain_plain", "streaming step, plain path"),
    ):
        print(f"time: {what}: median {t[key]:.4f} ms/block = {msa(t[key]):.1f} Msa/s "
              f"(runs {', '.join(f'{v:.4f}' for v in ms[key])} ms; CUDA events, "
              f"mean of {iters} calls per run, blocks resident) [{card}]")
    # the kernels' own device time, and the host's time to enqueue a step
    dev_ms = {
        "kernel": kernel_device_ms(lambda: rf.rx_frame(xb, taps, dec, fft_len, hist, "qpsk"),
                                   "rx_frame"),
        "step": kernel_device_ms(step_kernel, "rx_frame"),
    }
    enqueue = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            step_kernel()
        enqueue.append((time.perf_counter() - t0) / 10 * 1e3)
        torch.cuda.synchronize()
    t["enqueue"] = float(np.median(enqueue))
    print(f"device: rx_frame direct {dev_ms['kernel']:.4f} ms a launch, the kernel inside "
          f"a streaming step "
          f"{dev_ms['step']:.4f} ms (torch.profiler, mean over the launches of 20 calls); "
          f"host enqueue of a streaming step median {t['enqueue']:.4f} ms (runs "
          f"{', '.join(f'{v:.4f}' for v in enqueue)}; host clock, 10 steps, no synchronise): "
          f"the step is {'host' if t['enqueue'] > dev_ms['step'] else 'device'}-bound [{card}]")

    host = capture(BLOCK, 950)
    pinned = torch.from_numpy(host).pin_memory()
    dev = torch.empty(BLOCK, dtype=torch.complex64, device="cuda")
    h2d_pinned = time_cuda(lambda: dev.copy_(pinned, non_blocking=True), 20)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        torch.from_numpy(host).to("cuda")
    torch.cuda.synchronize()
    h2d_pageable = (time.perf_counter() - t0) / 10 * 1e3
    print(f"time: host->device copy of one block ({BLOCK * 8} bytes): pinned "
          f"{h2d_pinned:.4f} ms (CUDA events), pageable {h2d_pageable:.4f} ms "
          f"(host clock) [{card}]")

    # the bound of the timed call, the function's own: one 4M block with history
    # in, QPSK bytes out; operations of the FIR at the kept outputs with real
    # taps (2 FMAs a tap) and of a 5 N log2 N FFT per frame
    frames = BLOCK // (dec * fft_len)
    rx_frame_bound = bound(
        4.0 * frames * fft_len * (ku + 1) + 5.0 * frames * fft_len * np.log2(fft_len),
        BLOCK * 8 + BLOCK // 16 + ku * 8,
    )
    sys.stdout.flush()

    # ---- phase 6: the redesigned kernels' and the BCJR's compiler reports ----
    for kernel in ("rx_frame", "viterbi", "bcjr"):
        print_ptxas(build, kernel)
    for lw_o in (16 + 64 + 16, CCSDS_SOFT[0] + 2 * CCSDS_SOFT[1]):
        print(f"  bcjr lanes instance, K=7 (S 64) at Lw {lw_o}: {bk.lanes_smem(64, lw_o)} "
              f"bytes of shared memory a CTA (2 warps, 1 column) [{card}]")

    # ---- phase 7: burst kernels vs plain twins at the path's shapes ------
    rng = np.random.default_rng(2026)

    def coded_llrs(code, b, n_bits):
        polys, k = code
        bits = rng.integers(0, 2, (b, n_bits)).astype(np.uint8)
        enc = fec.conv_encode(torch.from_numpy(bits), polys, k).numpy()
        llr = (1 - 2.0 * enc) * 2 + 1.5 * rng.normal(size=enc.shape)
        return torch.from_numpy(llr.astype(np.float32)).cuda()

    frame_bits = PAYLOAD + 32
    llr_v = coded_llrs(K7, BURSTS, frame_bits)  # [256, 1276], the path's shape
    viterbi_cases = (
        (f"K=7 r1/2 full block {tuple(llr_v.shape)}", K7, {}, llr_v),
        (f"K=7 r1/2 windowed 64/48 {tuple(llr_v.shape)}", K7,
         {"window": 64, "guard": 48}, llr_v),
        ("K=5 r1/3 full block (64, 912)", K5, {}, coded_llrs(K5, 64, 300)),
    )
    vit_err = 0
    for label, (polys, k), kw, llr in viterbi_cases:
        got = fec.viterbi_decode(llr, polys, k, **kw)
        plain = fec.viterbi_decode(llr, polys, k, backend="reference", **kw)
        torch.cuda.synchronize()
        err = int((got.int() - plain.int()).abs().max())
        vit_err = max(vit_err, err)
        print(f"compare viterbi {label}: kernel vs plain array_equal "
              f"{torch.equal(got, plain)}, max |diff| {err}")
        if not torch.equal(got, plain):
            fail(f"viterbi {label}: kernel and plain twin disagree")
    # tie-heavy spans: integer LLRs (many exact ties, repeated values) with half
    # of the zeros -0.0, at K = 3, 5, 7, 9, rates 1/2 and 1/3, both starts/ends
    for k in (3, 5, 7, 9):
        for polys in (VITERBI_TIE_CODES[k], VITERBI_TIE_CODES[k] + (VITERBI_TIE_CODES[k][0] | 1,)):
            n = len(polys)
            ties = np.round(rng.normal(size=(BURSTS, 160, n)) * 1.5).astype(np.float32)
            ties[(ties == 0) & (rng.random(ties.shape) < 0.5)] = -0.0
            sym_t = torch.from_numpy(ties).cuda()
            for ends in ((True, True), (False, False)):
                got = vk.viterbi_lanes(sym_t, 160, n, polys, k, *ends)
                plain = vk.viterbi_lanes_reference(sym_t, 160, n, polys, k, *ends)
                torch.cuda.synchronize()
                same = torch.equal(got, plain)
                vit_err = max(vit_err, int((got.int() - plain.int()).abs().max()))
                print(f"compare viterbi ties and -0.0, K={k} rate 1/{n} {tuple(sym_t.shape)} "
                      f"ends {ends}: kernel vs plain torch.equal {same}")
                if not same:
                    fail(f"viterbi ties K={k} rate 1/{n}: kernel and plain twin disagree")
    # spans at the shared-memory route's limit (one trellis a block, the
    # decision history alone in shared memory): the plain twin runs on the
    # CPU copy
    for (polys, k) in (((0o23, 0o35), 5), ((0o133, 0o145, 0o175), 7)):
        n, lw_l = len(polys), vk.MAX_SMEM // (4 * max(1, (1 << (k - 1)) // 32))
        if vk.scratch_words(lw_l, k, 1) or not vk.scratch_words(lw_l + 1, k, 1):
            fail(f"viterbi K={k} rate 1/{n}: the shared route's limit is not {lw_l} steps")
        sym_l = torch.from_numpy(np.round(rng.normal(size=(2, lw_l, n)) * 2)
                                 .astype(np.float32)).cuda()
        got = vk.viterbi_lanes(sym_l, lw_l, n, polys, k, True, False).cpu()
        plain = vk.viterbi_lanes_reference(sym_l.cpu(), lw_l, n, polys, k, True, False)
        same = torch.equal(got, plain)
        vit_err = max(vit_err, int((got.int() - plain.int()).abs().max()))
        print(f"compare viterbi at the span limit, K={k} rate 1/{n} {tuple(sym_l.shape)}: "
              f"kernel vs plain (CPU) torch.equal {same}")
        if not same:
            fail(f"viterbi K={k} rate 1/{n} at {lw_l} steps: kernel and plain twin disagree")
    # a full block past shared memory: the histories in the device scratch,
    # one launch, equal to the twin (on the CPU copy)
    lw_v = VITERBI_LONG_STEPS
    llr_l = coded_llrs(K7, 2, lw_v - 6)  # [2, 2 x 65,536] with the K-1 flush steps
    reset_counts()
    got = fec.viterbi_decode(llr_l, *K7)
    torch.cuda.synchronize()
    long_counts = kernel_launches()
    plain = fec.viterbi_decode(llr_l.cpu(), *K7, backend="reference")
    same = torch.equal(got.cpu(), plain)
    vit_err = max(vit_err, int((got.cpu().int() - plain.int()).abs().max()))
    print(f"compare viterbi K=7 r1/2 full block of {lw_v} steps {tuple(llr_l.shape)} "
          f"({vk.scratch_words(lw_v, 7, 2)} scratch words): kernel vs plain (CPU) "
          f"torch.equal {same}, launches {long_counts}")
    if not same or long_counts != {**NO_LAUNCHES, "viterbi": 1}:
        fail(f"viterbi full block of {lw_v} steps: kernel and plain twin disagree, "
             "or not one launch")
    lw_t, cols_t = 16 + 64 + 16, BURSTS * 10  # turbo: window 64, guard 16, 10 windows
    spans = [torch.from_numpy((rng.normal(size=(lw_t, cols_t)) * 3).astype(np.float32)).cuda()
             for _ in range(2)]
    bcjr_err = 0.0
    for label, tables, (ls_c, lp_c), lw_c in bcjr_cases(bk, spans, lw_t, cols_t):
        got = bk.bcjr_windowed_llr(ls_c, lp_c, lw_c, tables)
        plain = bk.bcjr_windowed_llr_reference(ls_c, lp_c, lw_c, tables)
        torch.cuda.synchronize()
        err = float((got - plain).abs().max()) if got.numel() else 0.0
        bcjr_err = max(bcjr_err, err)
        form = ", shuffle form" if bk.shift_register(tables) else ""
        print(f"compare bcjr {label} Lw {lw_c} x N {ls_c.shape[1]} "
              f"({bk.kernel_plan(tables, lw_c)}{form}): kernel vs plain torch.equal "
              f"{torch.equal(got, plain)}, max |diff| {err}")
        if not torch.equal(got, plain):
            fail(f"bcjr {label}: kernel and plain twin disagree")
    rsc8_cls = bk._host_tables(bk.rsc8_tables())[3]
    want = bk.bcjr_windowed_llr_reference(spans[0], spans[1], lw_t)
    for cols in bk.MEET_COLS:  # both CTA widths the meet instance ships
        got = torch.empty_like(want)
        bk._launch_meet(spans[0], spans[1], got, lw_t, cols, rsc8_cls)
        torch.cuda.synchronize()
        print(f"compare bcjr RSC-8 meet instance at {cols} columns a CTA: kernel vs plain "
              f"torch.equal {torch.equal(got, want)}")
        if not torch.equal(got, want):
            fail(f"bcjr meet instance at {cols} columns a CTA disagrees with the twin")
    # the ccsds link's inner code at its shapes: the RS(255, 223) codeword's
    # 2,040 bits and the flush, rate 1/2 -> [256, 4,092] LLRs
    ccsds_pm = PacketModem(PacketConfig(payload_bits=PAYLOAD, fec="ccsds"), device="cuda")
    llr_c = coded_llrs(K7, BURSTS, ccsds_pm.coded_bits // 2 - 6)
    got = fec.viterbi_decode(llr_c, window=CCSDS_VITERBI[0], guard=CCSDS_VITERBI[1])
    plain = fec.viterbi_decode(llr_c, window=CCSDS_VITERBI[0], guard=CCSDS_VITERBI[1],
                               backend="reference")
    torch.cuda.synchronize()
    vit_err = max(vit_err, int((got.int() - plain.int()).abs().max()))
    print(f"compare viterbi ccsds K=7 r1/2 windowed {CCSDS_VITERBI[0]}/{CCSDS_VITERBI[1]} "
          f"{tuple(llr_c.shape)}: kernel vs plain torch.equal {torch.equal(got, plain)}")
    if not torch.equal(got, plain):
        fail("viterbi at the ccsds shape: kernel and plain twin disagree")
    k7_tables = fec._conv_soft_coeffs(*K7)
    lw_c = CCSDS_SOFT[0] + 2 * CCSDS_SOFT[1]
    spans_c = fec.conv_soft_spans(llr_c, K7[0], 7, True, *CCSDS_SOFT)
    got = bk.bcjr_windowed_llr(*spans_c, lw_c, k7_tables)
    plain = bk.bcjr_windowed_llr_reference(*spans_c, lw_c, k7_tables)
    soft = fec.conv_decode_soft(llr_c, window=CCSDS_SOFT[0], guard=CCSDS_SOFT[1])
    soft_plain = fec.conv_decode_soft(llr_c, window=CCSDS_SOFT[0], guard=CCSDS_SOFT[1],
                                      backend="reference")
    torch.cuda.synchronize()
    err = float((got - plain).abs().max())
    bcjr_err = max(bcjr_err, err)
    print(f"compare bcjr ccsds K=7 conv Lw {lw_c} x N {spans_c[0].shape[1]} "
          f"({bk.kernel_plan(k7_tables, lw_c)}): kernel vs plain torch.equal "
          f"{torch.equal(got, plain)}, max |diff| {err}; conv_decode_soft "
          f"{CCSDS_SOFT[0]}/{CCSDS_SOFT[1]} {tuple(soft.shape)} kernel vs plain torch.equal "
          f"{torch.equal(soft, soft_plain)}")
    if not (torch.equal(got, plain) and torch.equal(soft, soft_plain)):
        fail("bcjr at the ccsds shape: kernel and plain twin disagree")
    reach = decoder_reach_phase(card)
    sys.stdout.flush()

    # ---- phase 8: the burst path, rx_batch on [256, 16384] ----------------
    burst_counts, modems, caps_dev, burst_set = {}, {}, {}, {}
    tables = tempfile.TemporaryDirectory(prefix="chip_smoke_tables_")
    write_code_tables(Path(tables.name))
    for label, fields, launches in ((("viterbi", {"fec": "viterbi"}, {"viterbi": 1}),
                                     ("turbo", {"fec": "turbo"}, {"bcjr": 16}))
                                    + BURST_FAMILIES):
        fields = {k: str(Path(tables.name) / v) if k.endswith("_file") else v
                  for k, v in fields.items()}
        cfg = PacketConfig(payload_bits=PAYLOAD, **fields)
        pm = PacketModem(cfg, device="cuda")
        payloads, caps = burst_captures(pm)
        x = torch.from_numpy(caps).cuda()
        torch.cuda.synchronize()
        reset_counts()
        bits_b, ok_b, diag_b = pm.rx_batch(x)
        torch.cuda.synchronize()
        counts = kernel_launches()
        want = {**NO_LAUNCHES, **launches}
        exact = (bits_b.cpu().numpy() == payloads).all(axis=1)
        ok = ok_b.cpu().numpy()
        host_bits, host_ok, host_diag = PacketModem(cfg, device="cpu").rx_batch(
            torch.from_numpy(caps[:8]))
        same_host = (np.array_equal(host_bits.numpy(), bits_b[:8].cpu().numpy())
                     and np.array_equal(host_ok.numpy(), ok[:8])
                     and np.array_equal(host_diag["offset"].numpy(),
                                        diag_b["offset"][:8].cpu().numpy()))
        print(f"burst path {label}: rx_batch {tuple(x.shape)} ({pm.coded_bits} coded bits) -> "
              f"payloads exact {int(exact.sum())}/{BURSTS}, crc ok {int(ok.sum())}/{BURSTS}, "
              f"launches {counts} (need {want}), first 8 equal to the CPU run {same_host}, "
              f"noise_var median {float(diag_b['noise_var'].median()):.3e}", flush=True)
        if not (exact.all() and ok.all()) or counts != want or not same_host:
            fail(f"burst path {label}: payloads/CRC/launches/CPU agreement wrong")
        burst_counts[label] = counts
        modems[label], caps_dev[label] = pm, x
        if label in ("viterbi", "turbo"):
            burst_set[label] = (pm, x, payloads)
    tables.cleanup()  # the modems read their tables when they were made
    # F17 (ROADMAP §3): the axis psk tables through the viterbi link
    for mod in ("psk2", "psk4"):
        pm = PacketModem(PacketConfig(payload_bits=PAYLOAD, fec="viterbi", modulation=mod),
                         device="cuda")
        payloads, caps = burst_captures(pm, bursts=32, seed=1717)
        x = torch.from_numpy(caps).cuda()
        torch.cuda.synchronize()
        reset_counts()
        bits_b, ok_b, _ = pm.rx_batch(x)
        torch.cuda.synchronize()
        counts = kernel_launches()
        exact = (bits_b.cpu().numpy() == payloads).all(axis=1)
        ok = ok_b.cpu().numpy()
        print(f"burst path {mod} viterbi (F17): rx_batch {tuple(x.shape)} -> payloads exact "
              f"{int(exact.sum())}/32, crc ok {int(ok.sum())}/32, launches {counts}", flush=True)
        if not (exact.all() and ok.all()) or counts != {**NO_LAUNCHES, "viterbi": 1}:
            fail(f"burst path {mod} viterbi: payloads/CRC/launches wrong")
    nr_chain_phase(card)

    # ---- phase 9: burst timings --------------------------------------------
    sym_v = llr_v.reshape(BURSTS, -1, 2).contiguous()
    lw_v = sym_v.shape[1]
    kernel_calls = {
        "viterbi": (lambda: vk.viterbi_lanes(sym_v, lw_v, 2, K7[0], 7, True, True),
                    lambda: vk.viterbi_lanes_reference(sym_v, lw_v, 2, K7[0], 7, True, True)),
        "bcjr": (lambda: bk.bcjr_windowed_llr(spans[0], spans[1], lw_t),
                 lambda: bk.bcjr_windowed_llr_reference(spans[0], spans[1], lw_t)),
        "bcjr K=7 (S 64, lanes instance)": (
            lambda: bk.bcjr_windowed_llr(spans[0], spans[1], lw_t, k7_tables),
            lambda: bk.bcjr_windowed_llr_reference(spans[0], spans[1], lw_t, k7_tables)),
    }
    kt = {}
    for kernel, (run_kernel, run_plain) in kernel_calls.items():
        runs = {"kernel": [], "plain": []}
        for run in range(4):  # plain, kernel, kernel, plain, ...
            for which in (("plain", "kernel"), ("kernel", "plain"))[run % 2]:
                if which == "kernel":
                    runs["kernel"].append(time_cuda(run_kernel, 50))
                elif run < 2:
                    runs["plain"].append(time_cuda(run_plain, 2, warmup=1))
        kt[kernel] = {k: float(np.median(v)) for k, v in runs.items()}
        print(f"time: {kernel} kernel median {kt[kernel]['kernel']:.5f} ms (runs "
              f"{', '.join(f'{v:.5f}' for v in runs['kernel'])}; mean of 50 calls), plain "
              f"twin median {kt[kernel]['plain']:.2f} ms (runs "
              f"{', '.join(f'{v:.2f}' for v in runs['plain'])}; mean of 2 calls), same "
              f"spans, CUDA events [{card}]")
    vit_bound = viterbi_bound_of(BURSTS, lw_v, 2, 64, vk.patterns(K7[0], 7)[0])
    bcjr_bound = bcjr_bound_of(lw_t, cols_t, 8, classes=True)
    # The chain floor of the meet instance, an estimate and not a
    # measurement: each warp walks Lw dependent steps (forward and backward
    # side by side), and a step's chain is taken as 6 dependent FP32
    # operations (add the branch metric, the max of two candidates, a
    # three-level max tree over 8 states, the subtraction) of an assumed 4
    # cycles of latency each, at the card's maximum SM clock as nvidia-smi
    # reports it: Lw x 6 x 4 / f.
    clock_hz = max_sm_clock_hz()
    chain_floor = lw_t * CHAIN_OPS * OP_CYCLES / clock_hz * 1e3
    # the kernels' own device time (torch.profiler): a loop of calls above is
    # bound by the wrapper's host time where a launch is shorter than it
    bcjr_dev = kernel_device_ms(kernel_calls["bcjr"][0], "bcjr_kernel")
    vit_dev = kernel_device_ms(kernel_calls["viterbi"][0], "viterbi_kernel")
    print(f"device: viterbi kernel {vit_dev:.5f} ms a launch at {BURSTS} x {lw_v} steps "
          f"(torch.profiler, mean over 20 launches), {vk.warps_per_block(lw_v, 7)} "
          f"trellises a block; bound {vit_bound['bound_ms']:.5f} ms by "
          f"{vit_bound['bound_by']} [{card}]")
    k7_out = torch.empty((lw_t, cols_t), device="cuda")
    k7_dev, k7_block_dev = paired_device_ms(
        kernel_calls["bcjr K=7 (S 64, lanes instance)"][0],
        lambda: bk._launch_block(spans[0], spans[1], k7_out, lw_t, k7_tables))
    k7_bound = bcjr_bound_of(lw_t, cols_t, 64, classes=False)
    print(f"bound: bcjr {bcjr_bound['bound_ms']:.5f} ms by {bcjr_bound['bound_by']}; kernel "
          f"device time {bcjr_dev:.5f} ms a launch (torch.profiler, mean over 20 launches), "
          f"instance {bk.kernel_plan(None, lw_t)}; K=7 (S 64) lanes instance device time "
          f"{k7_dev:.5f} ms a launch against the block instance's (forced through "
          f"bk._launch_block) {k7_block_dev:.5f} ms, in turns (median of 2 x 20 launches "
          f"each); K=7 bound {k7_bound['bound_ms']:.5f} ms by {k7_bound['bound_by']} "
          f"[{card}]")
    print(f"chain floor (estimate, not measured): bcjr {chain_floor:.5f} ms = {lw_t} steps x "
          f"{CHAIN_OPS} dependent FP32 ops a step (assumed) x {OP_CYCLES} cycles each "
          f"(assumed) at {clock_hz / 1e6:.0f} MHz (nvidia-smi clocks.max.sm); the kernel's "
          f"measured device time is {bcjr_dev / chain_floor:.1f}x it [{card}]")

    # the ccsds inner decoders' launches at their path shapes: CUDA events of
    # the windowed calls, the kernels' device time, the bounds by the same
    # rules (the Viterbi spans: 32 windows x 256 of 160 steps)
    n_vit = BURSTS * (-(-(llr_c.shape[1] // 2) // CCSDS_VITERBI[0]))
    lw_cv = CCSDS_VITERBI[0] + 2 * CCSDS_VITERBI[1]
    ccsds_runs = {
        "viterbi": lambda: fec.viterbi_decode(llr_c, window=CCSDS_VITERBI[0],
                                              guard=CCSDS_VITERBI[1]),
        "bcjr": lambda: bk.bcjr_windowed_llr(*spans_c, lw_c, k7_tables),
    }
    ccsds_bounds = {
        "viterbi": viterbi_bound_of(n_vit, lw_cv, 2, 64, vk.patterns(K7[0], 7)[0]),
        "bcjr": bcjr_bound_of(lw_c, spans_c[0].shape[1], 64, classes=False),
    }
    # the same function with four branch-metric classes, as the conv tables factor
    ccsds_class_bound = bcjr_bound_of(lw_c, spans_c[0].shape[1], 64, classes=True)
    ccsds_t = {}
    for kernel, run in ccsds_runs.items():
        call_ms = float(np.median([time_cuda(run, 10) for _ in range(3)]))
        launch_ms = kernel_device_ms(run, f"{kernel}_kernel", calls=10)
        ccsds_t[kernel] = {"call_ms": call_ms, "device_ms": launch_ms}
        shape = (f"{n_vit} spans x {lw_cv} steps" if kernel == "viterbi"
                 else f"Lw {lw_c} x N {spans_c[0].shape[1]}, K=7 (S 64), instance "
                      f"{bk.kernel_plan(k7_tables, lw_c)[0]}")
        print(f"time: {kernel} at the ccsds shape ({shape}): device {launch_ms:.5f} ms a launch "
              f"(torch.profiler, mean over 10 launches), the call {call_ms:.5f} ms (CUDA "
              f"events, median of 3 runs of 10 calls); bound {ccsds_bounds[kernel]['bound_ms']:.5f}"
              f" ms by {ccsds_bounds[kernel]['bound_by']} [{card}]")
    # the lanes instance against the block instance (forced) at the ccsds
    # launch, in turns, one output each
    n_c = spans_c[0].shape[1]
    c_out = torch.empty((lw_c, n_c), device="cuda")
    k7_block = lambda: bk._launch_block(*spans_c, c_out, lw_c, k7_tables)  # noqa: E731
    k7_block()
    want_c = bk.bcjr_windowed_llr(*spans_c, lw_c, k7_tables)
    torch.cuda.synchronize()
    if not torch.equal(c_out, want_c):
        fail("bcjr at the ccsds shape: the block instance and the lanes instance disagree")
    lanes_c, block_c = paired_device_ms(ccsds_runs["bcjr"], k7_block)
    ccsds_t["bcjr"].update(lanes_ms=lanes_c, block_ms=block_c)
    print(f"time: bcjr at the ccsds launch, device ms a launch in turns (median of 2 x 20 "
          f"launches each): lanes instance {lanes_c:.5f}, block instance (forced, torch.equal "
          f"to it) {block_c:.5f}: {block_c / lanes_c:.2f}x; the "
          f"lanes instance {lanes_c / ccsds_bounds['bcjr']['bound_ms']:.1f}x its bound "
          f"{ccsds_bounds['bcjr']['bound_ms']:.5f} ms for any tables, "
          f"{lanes_c / ccsds_class_bound['bound_ms']:.1f}x the "
          f"{ccsds_class_bound['bound_ms']:.5f} ms of four branch-metric classes [{card}]",
          flush=True)

    e2e = {}
    for fec_name, pm in modems.items():
        x = caps_dev[fec_name]
        runs = [time_cuda(lambda: pm.rx_batch(x), 10) for _ in range(3)]
        e2e[fec_name] = float(np.median(runs))
        print(f"time: rx_batch {fec_name} [{BURSTS}, {CAPTURE}]: median "
              f"{e2e[fec_name]:.4f} ms/call = {BURSTS / (e2e[fec_name] * 1e-3):.1f} bursts/s "
              f"(runs {', '.join(f'{v:.4f}' for v in runs)} ms; CUDA events, mean of 10 "
              f"calls, captures resident) [{card}]")
        profile_burst(torch, pm, x, fec_name, card)

    pfb_entry = channelizer_phases(card)
    ew = elementwise_phase()
    host_fed_phases(card)
    cmul_entry, stream_entry = elementwise_timing(card, ew)
    halo_entry = sharded_phases(card, burst=burst_set)
    link = link_phases(card)
    analog_tracking_phases(card)
    acquisition_array_phases(card)
    entry_counts = entry_phase(card)
    micro = microbench_phase(card)
    cross = cross_process_phase(card)
    nfr = max(1024 // 16, 1)  # the microbench's coding rows at --batch 1024
    micro_vit = micro[f"viterbi K=7 decode [{nfr} x 1024 bits]"]["launches"]
    micro_turbo = micro[f"turbo decode 8 iters win64 [{nfr} x 1024 bits]"]["launches"]
    pfb_entry["dryrun_launches"] = entry_counts["dryrun"]["pfb_fold"]
    halo_entry["dryrun_launches"] = entry_counts["dryrun"]["halo"]
    halo_entry["cross_process_launches"] = cross["ranks"][0]["launches"]["halo"]
    halo_entry["cross_process_2d_launches"] = cross["entries"]["sharded_streaming_step_2d"]["halo"]
    pfb_entry["cross_process_launches"] = cross["entries"]["sharded_pfb_os"]["pfb_fold"]

    print(json.dumps({"kernels": [
        {
            "name": "rx_frame",
            "route": "cuda",
            "source": "aether_primitives_tpu_torch/csrc/rx_frame.cu",
            "replaces": "aether_primitives_tpu/ops/pallas/rx_frame.py:49",
            "launches": main_launches,
            "link_launches": link["launches"],
            "max_abs_err": worst_err,
            "ms": t["kernel"],
            "plain_ms": t["plain"],
            **rx_frame_bound,
            "library_ms": None,
            "instance": main_plan[0],
            "device_ms": dev_ms["kernel"],
            "step_ms": t["chain_kernel"],
            "step_host_enqueue_ms": t["enqueue"],
            "instances": instances,
            "entry_launches": entry_counts["entry"]["rx_frame"],
            "dryrun_launches": entry_counts["dryrun"]["rx_frame"],
            "cross_process_launches": cross["ranks"][0]["launches"]["rx_frame"],
            "cross_process_2d_launches":
                cross["entries"]["sharded_streaming_step_2d"]["rx_frame"],
        },
        {
            "name": "viterbi",
            "route": "cuda",
            "source": "aether_primitives_tpu_torch/csrc/viterbi.cu",
            "replaces": "aether_primitives_tpu/ops/pallas/viterbi.py:64",
            "launches": burst_counts["viterbi"]["viterbi"],
            "max_abs_err": vit_err,
            "ms": kt["viterbi"]["kernel"],
            "plain_ms": kt["viterbi"]["plain"],
            **vit_bound,
            "library_ms": None,
            "device_ms": vit_dev,
            "ccsds_launches": burst_counts["ccsds"]["viterbi"],
            "ccsds_ms": ccsds_t["viterbi"]["device_ms"],
            "ccsds_call_ms": ccsds_t["viterbi"]["call_ms"],
            "ccsds_bound_ms": ccsds_bounds["viterbi"]["bound_ms"],
            "microbench_launches": micro_vit.get("viterbi", 0),
            "cross_process_launches": cross["entries"]["rx_batch_sharded (viterbi)"]["viterbi"],
            "instances": reach["viterbi"],
        },
        {
            "name": "bcjr",
            "route": "cuda",
            "source": "aether_primitives_tpu_torch/csrc/bcjr.cu",
            "replaces": "aether_primitives_tpu/ops/pallas/bcjr.py:37",
            "launches": burst_counts["turbo"]["bcjr"],
            "max_abs_err": bcjr_err,
            "ms": kt["bcjr"]["kernel"],
            "plain_ms": kt["bcjr"]["plain"],
            **bcjr_bound,
            "library_ms": None,
            "device_ms": bcjr_dev,
            "instance": bk.kernel_plan(None, lw_t)[0],
            "k7_ms": kt["bcjr K=7 (S 64, lanes instance)"]["kernel"],
            "k7_device_ms": k7_dev,
            "k7_block_device_ms": k7_block_dev,
            "k7_bound_ms": k7_bound["bound_ms"],
            "ccsds_launches": burst_counts["ccsds erasures"]["bcjr"],
            "ccsds_ms": ccsds_t["bcjr"]["device_ms"],
            "ccsds_lanes_ms": ccsds_t["bcjr"]["lanes_ms"],
            "ccsds_block_ms": ccsds_t["bcjr"]["block_ms"],
            "ccsds_call_ms": ccsds_t["bcjr"]["call_ms"],
            "ccsds_bound_ms": ccsds_bounds["bcjr"]["bound_ms"],
            "ccsds_class_bound_ms": ccsds_class_bound["bound_ms"],
            "ccsds_instance": bk.kernel_plan(k7_tables, lw_c)[0],
            "microbench_launches": micro_turbo.get("bcjr", 0),
            "cross_process_launches": cross["entries"]["rx_batch_sharded (turbo)"]["bcjr"],
            "instances": reach["bcjr"],
        },
        pfb_entry,
        cmul_entry,
        stream_entry,
        halo_entry,
    ]}))
    crc = micro["crc32 2^20 bits"]
    print(f"summary: bcjr rsc8 (turbo, Lw {lw_t} x N {cols_t}) {bcjr_dev:.5f} ms device, "
          f"bound {bcjr_bound['bound_ms']:.5f}; K=7 Lw {lw_t} lanes {k7_dev:.5f} against the "
          f"block instance {k7_block_dev:.5f}, bound {k7_bound['bound_ms']:.5f}; ccsds launch "
          f"lanes {ccsds_t['bcjr']['lanes_ms']:.5f} against {ccsds_t['bcjr']['block_ms']:.5f}, "
          f"bound {ccsds_bounds['bcjr']['bound_ms']:.5f} (four classes "
          f"{ccsds_class_bound['bound_ms']:.5f}); crc32 2^20 bits {crc['us_per_call']:.1f} us "
          f"a call, device busy {crc['device_busy_ms']} ms, {crc['kernels_per_call']} kernels")
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}), flush=True)


def evm_db(got, ref) -> float:
    """RMS EVM in dB of ``got`` against ``ref``, in float64 (tensors on the
    card stay there; numpy on the host)."""
    import numpy as np
    import torch

    if isinstance(got, torch.Tensor) and isinstance(ref, torch.Tensor):
        g = got.to(torch.complex128)
        r = ref.to(device=got.device, dtype=torch.complex128)
        return float(10 * torch.log10((g - r).abs().pow(2).mean() / r.abs().pow(2).mean()))
    g = np.asarray(got.cpu() if isinstance(got, torch.Tensor) else got, np.complex128)
    r = np.asarray(ref.cpu() if isinstance(ref, torch.Tensor) else ref, np.complex128)
    return float(10 * np.log10(np.mean(np.abs(g - r) ** 2) / np.mean(np.abs(r) ** 2)))


def f64_os_frames(x, h, m: int, os: int, n_frames: int):
    """Float64 golden of the oversampled analysis: frame t is the direct
    fold of ``x[t*hop : t*hop + P*M]`` with the prototype (real or
    complex), rolled by ``(t*hop) mod M``, then ``np.fft.fft``."""
    import numpy as np

    hop = m // os
    p = -(-len(h) // m)
    hh = np.zeros(p * m, np.result_type(h, np.float64))
    hh[:len(h)] = h
    out = np.empty((n_frames, m), np.complex128)
    for t in range(n_frames):
        u = (x[t * hop:t * hop + p * m].astype(np.complex128) * hh).reshape(p, m).sum(0)
        out[t] = np.fft.fft(np.roll(u, (t * hop) % m))
    return out


def reset_counts() -> None:
    """Set every kernel's launch count to 0 (just before a path runs; read
    them with ``kernel_launches()`` just after)."""
    import importlib

    for k in KERNELS:
        importlib.import_module(f"aether_primitives_tpu_torch.ops.cuda.{k}").launches = 0


def rx_frame_instances(card: str, device: str = "cuda", n_check: int = 1 << 18,
                       n_time: int = 1 << 22) -> dict:
    """Phase 3, the geometries beside the main path (the RX frame kernel's
    direct instance at other sizes, its chunked and cluster instances):
    for each of :data:`F7_GEOMETRIES`, the chain's two-block streaming gate
    on two blocks of ``~n_check`` samples or two frames (one RX frame launch
    a step, bits against the float64 chain, the block-2 spectrum, the
    state); the kernel against its plain twin (spectrum EVM and, where
    frames are whole bytes, QPSK and BPSK bytes); and both timed on a
    ``~n_time``-sample block, the kernel also by ``torch.profiler``, beside
    the block's byte bound. Returns the kernels' JSON line's ``instances``
    entry of the rx_frame kernel."""
    import numpy as np
    import torch

    from aether_primitives_tpu_torch import cli
    from aether_primitives_tpu_torch.cli import capture, gate, kernel_device_ms, stream_blocks
    from aether_primitives_tpu_torch.models import RxChain, RxChainConfig
    from aether_primitives_tpu_torch.ops.cuda import rx_frame as rf

    dev = torch.device(device)
    kl = 1 if dev.type == "cuda" else 0
    out = {}
    for dec, fft_len, packed in F7_GEOMETRIES:
        chain = RxChain(RxChainConfig(fft_len=fft_len, decimation=dec, packed_bits=packed),
                        device=dev)
        taps = chain.taps
        k = taps.shape[-1]
        instance, n1 = rf.kernel_plan(dec, fft_len, None, k)
        span = dec * fft_len
        n = span * max(2, n_check // span)
        x_full = capture(2 * n, 3300 + fft_len)
        reset_counts()
        bits, states = stream_blocks(chain, x_full, n)
        sync(dev)
        counts = kernel_launches()
        g = gate(chain, x_full, n, bits, states)
        if instance == "direct":
            shape = "whole frames staged"
        elif instance == "global":
            glay = rf.global_layout(dec, fft_len, k)
            shape = (f"one cooperative launch, {'Bluestein over ' if glay['bluestein'] else ''}"
                     f"a {glay['m']}-point FFT, "
                     + ("whole frames a tile" if len(glay["lp"]) == 1 else
                        f"levels of 2^{glay['lp']} points through a scratch"))
        else:
            lay = rf.general_layout(dec, fft_len, k)
            shape = (f"{lay['threads']} threads, {lay['fpc']} frame(s) a CTA, radices "
                     f"{lay['rad1']}" if lay["q"] == 1 else
                     f"clusters of {lay['q']} x {lay['threads']} threads, {lay['a']} x "
                     f"{lay['b']} four-step")
        label = (f"{instance}, dec {dec}, fft_len {fft_len}, {k} taps ({shape}), "
                 f"{'packed' if packed else 'unpacked'}")
        print(f"rx_frame {label}: two-block streaming gate: bit agreement "
              f"{g['bit_agreement']:.7f} (need >= {AGREEMENT}), block-2 spectrum "
              f"{g['evm_rms_db']:.2f} dB (need <= {EVM_DB}), state exact {g['state_exact']}, "
              f"launches {counts} (need rx_frame {2 * kl})")
        if not g["ok"] or counts != {**NO_LAUNCHES, "rx_frame": 2 * kl}:
            fail(f"rx_frame {label}: the streaming gate or its launch count")
        x_dev = torch.from_numpy(x_full).to(dev)
        blocks = [(x_dev[:n], None), (x_dev[n:].contiguous(), x_dev[n - (k - 1):n])]
        worst, k_db = 0.0, -np.inf
        for epi in ("spectrum", "qpsk", "bpsk"):
            bits_per = {"qpsk": 2, "bpsk": 1}.get(epi)
            if bits_per and fft_len * bits_per % 8:
                continue  # not whole bytes per frame: the spectrum path serves the chain
            for xb, h in blocks:
                got = rf.rx_frame(xb, taps, dec, fft_len, h, epi)
                plain = rf.rx_frame_reference(xb, taps, dec, fft_len, h, epi, n1)
                sync(dev)
                if epi == "spectrum":
                    d = evm_db(got, plain)
                    k_db = max(k_db, d)
                    worst = max(worst, float((got - plain).abs().max()))
                    ok = d <= EVM_DB and bool(torch.isfinite(got.abs()).all())
                else:
                    a = float((rf.unpack_bits(got) == rf.unpack_bits(plain)).float().mean())
                    ok = a >= AGREEMENT
                if not ok:
                    fail(f"rx_frame {label}, {epi}: kernel and plain twin (n1 {n1}) disagree")
        print(f"compare rx_frame {label}: kernel vs plain twin (split {n1}): spectrum "
              f"{k_db:.2f} dB RMS EVM (need <= {EVM_DB}), max |kernel - plain| {worst:.3e}; "
              f"whole-byte epilogues agree >= {AGREEMENT}")
        xt = torch.from_numpy(capture(span * (n_time // span), 3400)).to(dev)
        epi = "qpsk" if fft_len * 2 % 8 == 0 else "spectrum"
        run = lambda: rf.rx_frame(xt, taps, dec, fft_len, None, epi)  # noqa: E731
        t, runs = timed_pair(run,
                             lambda: rf.rx_frame_reference(xt, taps, dec, fft_len, None, epi,
                                                           n1),
                             iters=(20, 3), runs=2)
        dev_ms = kernel_device_ms(run, "rx_frame") if dev.type == "cuda" else None
        lib_ms = None
        if instance == "global":  # a yardstick for the FFT alone: cuFFT over the frames
            frames_in = torch.from_numpy(capture(xt.shape[0] // dec, 3500)).to(dev).reshape(
                -1, fft_len)
            lib_ms = float(np.median([cli.time_cuda(lambda: torch.fft.fft(frames_in), 20)
                                      for _ in range(2)]))
        out_bytes = (xt.shape[0] // span) * (fft_len * 8 if epi == "spectrum" else
                                             fft_len // 4)
        b = bound(4.0 * (xt.shape[0] // dec) * k + 5.0 * (xt.shape[0] // dec)
                  * np.log2(fft_len), xt.shape[0] * 8 + out_bytes)
        print(f"time: rx_frame {label}, {epi} on [{xt.shape[0]}]: kernel median "
              f"{t['kernel']:.4f} ms (runs {', '.join(f'{v:.4f}' for v in runs['kernel'])}), "
              f"device {fmt_ms(dev_ms)} ms a launch (torch.profiler), "
              f"plain twin median {t['plain']:.4f} ms (runs "
              f"{', '.join(f'{v:.4f}' for v in runs['plain'])}); CUDA events; bound "
              f"{b['bound_ms']:.4f} ms ({b['bound_by']})"
              + ("" if lib_ms is None else f"; torch.fft.fft over the {xt.shape[0] // span} "
                 f"decimated frames (cuFFT, a yardstick for the FFT alone) {lib_ms:.4f} ms")
              + f" [{card}]", flush=True)
        out[f"{instance} dec {dec} fft_len {fft_len}"] = {
            "n1": n1, "launches": counts["rx_frame"], "max_abs_err": worst,
            "ms": t["kernel"], "device_ms": dev_ms, "plain_ms": t["plain"],
            "library_ms": lib_ms, "samples": int(xt.shape[0]), **b,
        }
    return out


def sync(dev) -> None:
    """Wait for ``dev``'s work (nothing to wait for on the CPU)."""
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def timed_pair(run_kernel, run_plain, iters=(50, 5), runs: int = 4):
    """Medians (ms per call) of ``run_kernel`` and ``run_plain`` by CUDA
    events, in turns plain, kernel, kernel, plain; returns the medians and
    the runs."""
    import numpy as np

    from aether_primitives_tpu_torch.cli import time_cuda

    got = {"kernel": [], "plain": []}
    for run in range(runs):
        for which in (("plain", "kernel"), ("kernel", "plain"))[run % 2]:
            fn, n = (run_kernel, iters[0]) if which == "kernel" else (run_plain, iters[1])
            got[which].append(time_cuda(fn, n, warmup=2))
    return {k: float(np.median(v)) for k, v in got.items()}, got


def complex_prototype(m: int, tpb: int):
    """Phase 11's complex prototype: the root-Nyquist prototype moved by a
    quarter of a channel (``h[n] e^{2 pi i n / (4M)}``), a channel grid
    offset as a complex-baseband front end designs it."""
    import numpy as np

    from aether_primitives_tpu_torch.models import channelizer as ch

    h = ch.pfb_prototype_nyquist(m, tpb).astype(np.float64)
    return (h * np.exp(2j * np.pi * np.arange(h.size) / (4 * m))).astype(np.complex64)


def f64_synthesis(frames, h, m: int, os: int, n_out: int):
    """Float64 golden of the raw synthesis overlap-add over ``frames [T,
    M]`` (the card's analysis output): frame t adds ``h[n] v_t[(n + t*hop)
    mod M]`` at sample ``t*hop + n``, ``v_t`` the inverse DFT (1/M); the
    first ``n_out`` samples, which frames past T do not reach."""
    import numpy as np

    hop = m // os
    p = -(-len(h) // m)
    hh = np.zeros(p * m, np.complex128)
    hh[:len(h)] = h
    v = np.fft.ifft(np.asarray(frames, np.complex128), axis=-1)
    out = np.zeros(n_out + p * m, np.complex128)
    n = np.arange(p * m)
    for t in range(min(v.shape[0], -(-n_out // hop))):
        out[t * hop:t * hop + p * m] += hh * v[t][(n + t * hop) % m]
    return out[:n_out]


def fold_case(pf, label: str, run_kernel, run_plain) -> float:
    """One phase-10 case: the kernel's output(s) against the twin's, bit
    for bit, in one launch (none on the CPU); returns the largest absolute
    difference (0.0 when equal)."""
    import torch

    before = pf.launches
    got = run_kernel()
    launched = pf.launches - before
    plain = run_plain()
    dev = plain[0].device if isinstance(plain, tuple) else plain.device
    sync(dev)
    got = got if isinstance(got, tuple) else (got,)
    plain = plain if isinstance(plain, tuple) else (plain,)
    same = all(torch.equal(g, q) for g, q in zip(got, plain))
    err = max(float((g - q).abs().max()) if g.numel() else 0.0 for g, q in zip(got, plain))
    want = 1 if dev.type == "cuda" else 0
    print(f"compare pfb_fold {label}: kernel vs plain twin torch.equal {same}, "
          f"max |diff| {err}, launches {launched} (need {want})")
    if not same or launched != want:
        fail(f"pfb_fold {label}: kernel and plain twin disagree, or not one launch")
    return err


def channelizer_phases(card: str, device: str = "cuda", m: int = 2048, os: int = 2,
                       tpb: int = 16, block: int = 1 << 22) -> dict:
    """Phases 10-13: every layout of the PFB fold kernel against its twin,
    the channelizer path with a real and a complex prototype, the DDC path
    and their timings, at ``M = m``, ``os`` and ``taps_per_branch = tpb`` on
    ``block``-sample blocks (the defaults are the path's; a smaller size on
    ``device="cpu"`` rehearses the phases, with the CUDA calls stubbed).
    Returns the fold kernel's entry of the kernels' JSON line."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from aether_primitives_tpu_torch.cli import capture, time_cuda
    from aether_primitives_tpu_torch.models import Ddc, DdcConfig
    from aether_primitives_tpu_torch.models import channelizer as ch
    from aether_primitives_tpu_torch.ops.cuda import pfb_fold as pf

    dev = torch.device(device)
    hop = m // os
    h = ch.pfb_prototype_nyquist(m, tpb)
    hb = ch._branches(h, m)
    p = hb.shape[0]
    w = ch._fold_branches(hb, dev)
    w_rev = ch._fold_branches(hb, dev, reverse=True)
    h_c = complex_prototype(m, tpb)
    hb_c = ch._branches(h_c, m)
    w_c, w_c_rev = ch._fold_branches(hb_c, dev), ch._fold_branches(hb_c, dev, reverse=True)
    rng = np.random.default_rng(3030)

    def c64(shape):
        return torch.from_numpy((rng.normal(size=shape) + 1j * rng.normal(size=shape))
                                .astype(np.complex64)).to(dev)

    # ---- phase 10: every layout of the fold kernel vs its twin ------------
    t_frames = 2 * (block // m)  # frames of a steady analysis step
    t_cls = t_frames // os
    tail_n = p * m - hop  # a steady step's carried tail
    head, body = c64((tail_n,)), c64((block,))
    x_planes = torch.cat([head, body])
    xr, xi = x_planes.real.contiguous(), x_planes.imag.contiguous()
    v = c64((t_frames, m))  # backward-FFT frames of a steady synthesis step
    syn_tail = c64((tail_n,))
    dper = torch.from_numpy(rng.uniform(0.5, 2.0, hop).astype(np.float32)).to(dev)
    emit = t_frames * hop
    g = ch.pfb_synthesis_taps(ch.pfb_prototype(m, 8), m, taps_per_branch=16)
    gb = ch._branches(g, m)
    q = gb.shape[0]
    g_rev = ch._fold_branches(gb, dev, reverse=True)
    y_cs = c64((block // m, m))
    m_r = 1000 if m >= 1000 else m - 8  # not a multiple of the 64-column strip
    wr_r = torch.from_numpy(rng.normal(size=(7, m_r)).astype(np.float32)).to(dev)
    wr_c = torch.complex(wr_r, torch.from_numpy(rng.normal(size=(7, m_r)).astype(np.float32))
                         .to(dev))
    xr_b = c64((3, (1001 - 1 + 7) * m_r + m_r + 333))  # past the planes' span
    v_r = c64((2, 301, m_r))
    cut = 2 * m_r + 333  # a seam inside a row, at an odd sample
    # where the weights of every class do not fit in shared memory beside a
    # slab, they are staged a chunk of branches at a time: os 8 at the
    # previous kernel's limit (P 260), and os 32 at the path's width and P
    m_l, p_l = 256, 260
    w_l = torch.from_numpy(rng.normal(size=(p_l, m_l)).astype(np.float32)).to(dev)
    w_lc = torch.complex(w_l, torch.from_numpy(rng.normal(size=(p_l, m_l)).astype(np.float32))
                         .to(dev))
    x_l = c64((2, (75 - 1 + p_l) * m_l + 7 * (m_l // 8) + 5))
    v_l = c64((40, m_l))
    x_32 = c64(((64 - 1 + p) * m + 31 * (m // 32),))

    def plan(mode, p_, os_, cplx=False):
        stages, staged = pf.launch_plan(mode, p_, os_, cplx)
        return (f"{stages} stage(s), weights "
                f"{'staged all at once' if staged else 'staged a chunk at a time'}")
    fold_err = max(
        fold_case(pf, f"planes (the TPU wrapper's layout), os {os}, M {m}, P {p}, t_cls {t_cls}",
                  lambda: pf.pfb_fold_os(xr, xi, w, os, t_cls),
                  lambda: pf.pfb_fold_os_reference(xr, xi, w, os, t_cls)),
        fold_case(pf, f"analysis, complex64, tail {tail_n} + block {block}, {t_frames} frames",
                  lambda: pf.pfb_analysis(head, body, w, os, t_frames),
                  lambda: pf.pfb_analysis_reference(head, body, w, os, t_frames)),
        fold_case(pf, "analysis, complex taps, the same sources",
                  lambda: pf.pfb_analysis(head, body, w_c, os, t_frames),
                  lambda: pf.pfb_analysis_reference(head, body, w_c, os, t_frames)),
        fold_case(pf, f"synthesis, {t_frames} frames, tail {tail_n} added, {emit} emitted "
                      "and divided",
                  lambda: pf.pfb_synthesis(v, w_rev, os, syn_tail, dper, emit),
                  lambda: pf.pfb_synthesis_reference(v, w_rev, os, syn_tail, dper, emit)),
        fold_case(pf, "synthesis, complex taps, raw",
                  lambda: pf.pfb_synthesis(v, w_c_rev, os),
                  lambda: pf.pfb_synthesis_reference(v, w_c_rev, os)),
        fold_case(pf, f"critically sampled synthesis (os 1), Q {q}, {y_cs.shape[0]} frames",
                  lambda: pf.pfb_synthesis(y_cs, g_rev, 1),
                  lambda: pf.pfb_synthesis_reference(y_cs, g_rev, 1)),
        fold_case(pf, f"ragged planes: M {m_r}, os 2, P 7, t_cls 1001, batch 3",
                  lambda: pf.pfb_fold_os(xr_b.real.contiguous(), xr_b.imag.contiguous(), wr_r,
                                         2, 1001),
                  lambda: pf.pfb_fold_os_reference(xr_b.real.contiguous(),
                                                   xr_b.imag.contiguous(), wr_r, 2, 1001)),
        fold_case(pf, f"ragged analysis: M {m_r}, os 4, P 7, batch 3, seam at {cut}, "
                      "complex taps, zero tail past the end",
                  lambda: pf.pfb_analysis(xr_b[:, :cut], xr_b[:, cut:], wr_c, 4, 4007),
                  lambda: pf.pfb_analysis_reference(xr_b[:, :cut], xr_b[:, cut:], wr_c, 4,
                                                    4007)),
        fold_case(pf, f"ragged synthesis: M {m_r}, os 4, P 7, 301 frames, batch 2",
                  lambda: pf.pfb_synthesis(v_r, wr_r, 4),
                  lambda: pf.pfb_synthesis_reference(v_r, wr_r, 4)),
        fold_case(pf, f"planes: M {m_l}, os 8, P {p_l}, t_cls 75, batch 2 "
                      f"({plan('planes', p_l, 8)})",
                  lambda: pf.pfb_fold_os(x_l.real.contiguous(), x_l.imag.contiguous(), w_l,
                                         8, 75),
                  lambda: pf.pfb_fold_os_reference(x_l.real.contiguous(),
                                                   x_l.imag.contiguous(), w_l, 8, 75)),
        fold_case(pf, f"analysis: M {m_l}, os 8, P {p_l}, 600 frames, batch 2, complex taps "
                      f"({plan('analysis', p_l, 8, True)})",
                  lambda: pf.pfb_analysis(x_l, None, w_lc, 8, 600),
                  lambda: pf.pfb_analysis_reference(x_l, None, w_lc, 8, 600)),
        fold_case(pf, f"synthesis: M {m_l}, os 8, P {p_l}, 40 frames "
                      f"({plan('synthesis', p_l, 8)})",
                  lambda: pf.pfb_synthesis(v_l, w_l, 8),
                  lambda: pf.pfb_synthesis_reference(v_l, w_l, 8)),
        fold_case(pf, f"analysis: M {m}, os 32, P {p}, 2048 frames ({plan('analysis', p, 32)})",
                  lambda: pf.pfb_analysis(x_32, None, w, 32, 2048),
                  lambda: pf.pfb_analysis_reference(x_32, None, w, 32, 2048)),
    )
    # the path's plan is the parent's: two slabs in the ring, every weight
    # staged, no ranges
    for mode_, cplx_ in (("analysis", False), ("analysis", True), ("synthesis", False),
                         ("synthesis", True), ("planes", False)):
        if pf.launch_plan(mode_, p, os, cplx_) != (2, True) or pf.branch_range(mode_, p, cplx_):
            fail(f"pfb_fold {mode_} at the path's P {p}: the plan changed")
    print(f"pfb_fold plan at the path's P {p}, os {os}: (2 stages, weights staged) in all "
          "five layouts, no branch ranges (unchanged)")
    # the ranged instance, past one slab beside a chunk of the weights: the
    # five layout and tap-type pairs at P 295, 512 and 1,024 (M 200: a ragged
    # strip; two tiles; a batch of 2), and 70,000 rows (grid.z folded into x)
    m_g, os_g = 200, 2
    for p_g in (295, 512, 1024):
        w_g = torch.from_numpy(rng.normal(size=(p_g, m_g)).astype(np.float32)).to(dev)
        w_gc = torch.complex(w_g, torch.from_numpy(rng.normal(size=(p_g, m_g))
                                                   .astype(np.float32)).to(dev))
        x_g = c64((2, (150 + p_g + 1) * m_g + 7))
        v_g = c64((2, 60, m_g))
        v_gl = c64((2, 2 * p_g + 37, m_g))
        tail_g = c64((2, p_g * m_g - m_g // os_g))
        div_g = torch.from_numpy(rng.uniform(0.5, 2.0, m_g // os_g).astype(np.float32)).to(dev)
        emit_g = (v_gl.shape[1] - 1) * (m_g // os_g)
        rg = {f"{md}{'-c' if c_ else ''}": (pf.branch_range(md, p_g, c_), c_) for md, c_ in
              (("analysis", False), ("analysis", True), ("synthesis", False),
               ("synthesis", True))}
        fold_err = max(
            fold_err,
            fold_case(pf, f"ranged planes: M {m_g}, os 2, P {p_g}, t_cls 150, batch 2 (ranges "
                          f"of {pf.branch_range('planes', p_g)} branches)",
                      lambda: pf.pfb_fold_os(x_g.real.contiguous(), x_g.imag.contiguous(), w_g,
                                             os_g, 150),
                      lambda: pf.pfb_fold_os_reference(x_g.real.contiguous(),
                                                       x_g.imag.contiguous(), w_g, os_g, 150)),
            fold_case(pf, f"ranged analysis: M {m_g}, os 2, P {p_g}, 300 frames, batch 2, "
                          f"seam at 333 (ranges of {rg['analysis'][0]})",
                      lambda: pf.pfb_analysis(x_g[:, :333], x_g[:, 333:], w_g, os_g, 300),
                      lambda: pf.pfb_analysis_reference(x_g[:, :333], x_g[:, 333:], w_g, os_g,
                                                        300)),
            fold_case(pf, f"ranged analysis, complex taps: P {p_g} (ranges of "
                          f"{rg['analysis-c'][0]})",
                      lambda: pf.pfb_analysis(x_g, None, w_gc, os_g, 300),
                      lambda: pf.pfb_analysis_reference(x_g, None, w_gc, os_g, 300)),
            fold_case(pf, f"synthesis: M {m_g}, os 2, P {p_g}, 60 frames, batch 2 (ranges of "
                          f"{rg['synthesis'][0]}; 0: the chunked plan)",
                      lambda: pf.pfb_synthesis(v_g, w_g, os_g),
                      lambda: pf.pfb_synthesis_reference(v_g, w_g, os_g)),
            fold_case(pf, f"synthesis, complex taps: P {p_g} (ranges of {rg['synthesis-c'][0]})",
                      lambda: pf.pfb_synthesis(v_g, w_gc, os_g),
                      lambda: pf.pfb_synthesis_reference(v_g, w_gc, os_g)),
            # more class frames than branches (the spread's two edges and a
            # full middle), with the streaming stage's epilogue
            fold_case(pf, f"synthesis: M {m_g}, os 2, P {p_g}, {v_gl.shape[1]} frames, "
                          f"batch 2, tail {tail_g.shape[1]} added, {emit_g} emitted and divided",
                      lambda: pf.pfb_synthesis(v_gl, w_g, os_g, tail_g, div_g, emit_g),
                      lambda: pf.pfb_synthesis_reference(v_gl, w_g, os_g, tail_g, div_g,
                                                         emit_g)),
        )
    w_r = torch.from_numpy(rng.normal(size=(3, 64)).astype(np.float32)).to(dev)
    x_r = c64((70_000, 7 * 64))
    fold_err = max(fold_err, fold_case(
        pf, "analysis: 70,000 rows (past grid.z's 65,535), M 64, os 2, P 3, 8 frames",
        lambda: pf.pfb_analysis(x_r, None, w_r, 2, 8),
        lambda: pf.pfb_analysis_reference(x_r, None, w_r, 2, 8)))
    del x_r
    sys.stdout.flush()

    # ---- phase 11: the channelizer path, three blocks -------------------
    n_blocks = 3
    x_full = capture(n_blocks * block, 4040)
    blocks = [torch.from_numpy(x_full[i * block:(i + 1) * block]).to(dev)
              for i in range(n_blocks)]
    ana = ch.PfbChannelizerOs(m, os=os, taps_per_branch=tpb, device=dev)
    syn = ch.PfbSynthesizerOs(m, os=os, taps_per_branch=tpb, device=dev)
    sync(dev)
    reset_counts()
    frames, recon = [], []
    for b in blocks:
        frames.append(ana.step(b))
        recon.append(syn.step(frames[-1]))
    sync(dev)
    counts = kernel_launches()
    kl = 1 if dev.type == "cuda" else 0
    want = {**NO_LAUNCHES, "pfb_fold": n_blocks * 2 * kl}
    print(f"channelizer path: {n_blocks} blocks of {block} through PfbChannelizerOs -> "
          f"PfbSynthesizerOs (M {m}, os {os}, P {p}, hop {hop}): frames per step "
          f"{[f.shape[0] for f in frames]}, samples out {[r.shape[-1] for r in recon]}, "
          f"launches {counts} (need {want}: 1 analysis + 1 synthesis per step)")
    if counts != want:
        fail(f"channelizer path launches {counts} != {want}")
    y_all = torch.cat(frames, dim=0)
    back = torch.cat(recon)
    if not (bool(torch.isfinite(y_all.real).all()) and bool(torch.isfinite(back.real).all())):
        fail("channelizer path: non-finite output")
    gold = f64_os_frames(x_full, h.astype(np.float64), m, os, 64)
    d_gold = evm_db(y_all[:64].cpu().numpy(), gold)
    one = ch.pfb_channelize_os(torch.from_numpy(x_full).to(dev), m, os=os, taps_per_branch=tpb)
    d_stream = evm_db(y_all, one[:y_all.shape[0]])
    del one
    core = slice(2 * p * m, back.shape[-1] - p * m)
    d_rt = evm_db(back[core], torch.from_numpy(x_full[core]).to(dev))
    n_pre = 255 * hop + p * m
    cpu_y = ch.PfbChannelizerOs(m, os=os, taps_per_branch=tpb, device="cpu").step(
        x_full[:n_pre])
    d_cpu = evm_db(y_all[:cpu_y.shape[0]].cpu(), cpu_y)
    print(f"channelizer gate: first 64 frames vs float64 golden {d_gold:.2f} dB "
          f"(need <= {EVM_DB}), streamed vs one-shot pfb_channelize_os over "
          f"{y_all.shape[0]} frames {d_stream:.2f} dB (need <= {STREAM_DB}), reconstructed "
          f"interior ({core.stop - core.start} samples) vs input {d_rt:.2f} dB (need <= "
          f"{ROUNDTRIP_DB}), first {cpu_y.shape[0]} frames vs the CPU run {d_cpu:.2f} dB "
          f"(need <= {CPU_DB})", flush=True)
    if d_gold > EVM_DB or d_stream > STREAM_DB or d_rt > ROUNDTRIP_DB or d_cpu > CPU_DB:
        fail("channelizer gate")

    # the complex prototype through both stages: the complex-tap layouts
    ana_c = ch.PfbChannelizerOs(m, os=os, taps=h_c, device=dev)
    syn_c = ch.PfbSynthesizerOs(m, os=os, taps=h_c, device=dev)
    sync(dev)
    reset_counts()
    fr_c, rc_c = [], []
    for b in blocks:
        fr_c.append(ana_c.step(b))
        rc_c.append(syn_c.step(fr_c[-1]))
    sync(dev)
    counts_c = kernel_launches()
    yc = torch.cat(fr_c, dim=0)
    bc = torch.cat(rc_c)
    if not (bool(torch.isfinite(yc.abs()).all()) and bool(torch.isfinite(bc.abs()).all())):
        fail("complex prototype: non-finite output")
    dc_gold = evm_db(yc[:64].cpu().numpy(), f64_os_frames(x_full, h_c, m, os, 64))
    cpu_ana = ch.PfbChannelizerOs(m, os=os, taps=h_c, device="cpu")
    cpu_yc = cpu_ana.step(x_full[:n_pre])
    dc_cpu = evm_db(yc[:cpu_yc.shape[0]].cpu(), cpu_yc)
    n_syn = 256 * hop  # samples of the first block that no later frame reaches
    syn_gold = f64_synthesis(yc[:256].cpu().numpy(), h_c, m, os, n_syn)
    dper_c = syn_c._dper.astype(np.float64)
    dc_syn_gold = evm_db(bc[:n_syn].cpu().numpy(), syn_gold / np.tile(dper_c, n_syn // hop))
    cpu_bc = ch.PfbSynthesizerOs(m, os=os, taps=h_c, device="cpu").step(yc[:256].cpu())
    dc_syn_cpu = evm_db(ch.PfbSynthesizerOs(m, os=os, taps=h_c, device=dev).step(yc[:256])
                        .cpu(), cpu_bc)
    print(f"complex prototype (the root-Nyquist prototype moved by M/4 of a channel): "
          f"launches {counts_c} (need {want}); analysis: first 64 frames vs float64 golden "
          f"{dc_gold:.2f} dB (need <= {EVM_DB}), first {cpu_yc.shape[0]} frames vs the CPU run "
          f"{dc_cpu:.2f} dB (need <= {CPU_DB}); synthesis: first {n_syn} samples vs float64 "
          f"golden {dc_syn_gold:.2f} dB (need <= {EVM_DB}), 256 frames vs the CPU run "
          f"{dc_syn_cpu:.2f} dB (need <= {CPU_DB})", flush=True)
    if (counts_c != want or dc_gold > EVM_DB or dc_cpu > CPU_DB or dc_syn_gold > EVM_DB
            or dc_syn_cpu > CPU_DB):
        fail("complex prototype gate")
    del fr_c, rc_c, yc, bc

    # a 64-channel bank of P 512 branches (the ranged instance) through the
    # model, against the CPU run
    h_w = ch.pfb_prototype(64, 512)
    x_w = x_full[:64 * 2048]
    ana_w = ch.PfbChannelizerOs(64, os=2, taps=h_w, device=dev)
    sync(dev)
    reset_counts()
    y_w = ana_w.step(torch.from_numpy(x_w).to(dev))
    sync(dev)
    counts_w = kernel_launches()
    y_wc = ch.PfbChannelizerOs(64, os=2, taps=h_w, device="cpu").step(x_w)
    d_w = evm_db(y_w.cpu(), y_wc)
    want_w = {**NO_LAUNCHES, "pfb_fold": kl}
    print(f"wide bank: PfbChannelizerOs(64, os 2, P {ch._branches(h_w, 64).shape[0]}: ranges "
          f"of {pf.branch_range('analysis', 512)} branches) on {x_w.shape[0]} samples -> "
          f"{tuple(y_w.shape)} frames, launches {counts_w} (need {want_w}); vs the CPU run "
          f"{d_w:.2f} dB (need <= {CPU_DB})", flush=True)
    if counts_w != want_w or d_w > CPU_DB or not bool(torch.isfinite(y_w.abs()).all()):
        fail("wide bank (P 512) against the CPU run")

    # ---- phase 12: the DDC path, two blocks ----------------------------
    cfg = DdcConfig(freq=0.1375, decimation=8)
    ddc = Ddc(cfg, device=dev)
    sync(dev)
    reset_counts()
    outs = [ddc.step(b) for b in blocks[:2]]
    sync(dev)
    ddc_counts = kernel_launches()
    z = torch.cat(outs)
    npre = min(1 << 16, 2 * block)
    mixed = x_full[:npre].astype(np.complex128) * np.exp(-2j * np.pi * 0.1375 * np.arange(npre))
    ref = np.convolve(mixed, ddc.taps.astype(np.complex128))[:npre][::8]
    d_ddc = evm_db(z[:npre // 8].cpu().numpy(), ref)
    whole = Ddc(cfg, device=dev).step(torch.cat(blocks[:2]))
    d_ddc_stream = evm_db(z, whole)
    print(f"DDC path: 2 blocks -> {z.shape[-1]} samples (129 taps, /8), launches "
          f"{ddc_counts} (no kernel of the port on this path); vs float64 composed golden "
          f"on {npre} samples {d_ddc:.2f} dB (need <= {EVM_DB}); block by block vs "
          f"one-shot {d_ddc_stream:.2f} dB (need <= {DDC_STREAM_DB})", flush=True)
    if d_ddc > EVM_DB or d_ddc_stream > DDC_STREAM_DB or not bool(torch.isfinite(z.real).all()):
        fail("DDC gate")

    # ---- phase 13: timings ------------------------------------------------
    from aether_primitives_tpu_torch.ops.cuda import build

    parent = build.load_source(PARENT_FOLD).pfb_fold_launch
    parent.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                        ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
    parent.restype = ctypes.c_int
    p_re = torch.empty(os, t_cls, m, device=dev)
    p_im = torch.empty_like(p_re)
    spread = t_cls + p - 1  # slabs of a class's os-1 spread in the parent's synthesis step
    s_in = c64(((spread - 1 + p) * m,))
    s_re, s_im = s_in.real.contiguous(), s_in.imag.contiguous()
    s_out_re = torch.empty(1, spread, m, device=dev)
    s_out_im = torch.empty_like(s_out_re)

    def stream_ptr():
        return torch.cuda.current_stream(dev).cuda_stream

    def parent_analysis():
        if parent(xr.data_ptr(), xi.data_ptr(), xr.shape[0], w.data_ptr(), p_re.data_ptr(),
                  p_im.data_ptr(), 1, m, p, os, hop, t_cls, stream_ptr()):
            fail("the parent's fold kernel did not launch")

    def parent_synthesis():  # the parent's synthesis step launched it once per class
        for _ in range(os):
            if parent(s_re.data_ptr(), s_im.data_ptr(), s_re.shape[0], w_rev.data_ptr(),
                      s_out_re.data_ptr(), s_out_im.data_ptr(), 1, m, p, 1, m, spread,
                      stream_ptr()):
                fail("the parent's fold kernel did not launch")

    kernels = {
        "analysis": (lambda: pf.pfb_analysis(head, body, w, os, t_frames),
                     lambda: pf.pfb_analysis_reference(head, body, w, os, t_frames)),
        "synthesis": (lambda: pf.pfb_synthesis(v, w_rev, os, syn_tail, dper, emit),
                      lambda: pf.pfb_synthesis_reference(v, w_rev, os, syn_tail, dper, emit)),
    }
    fold_t, dev_ms = {}, {}
    for name, (run_k, run_p) in kernels.items():
        fold_t[name], runs = timed_pair(run_k, run_p)
        dev_ms[name] = device_ms(run_k, "pfb_fold_kernel")
        print(f"time: pfb_fold {name} layout at the path's shape: kernel median "
              f"{fold_t[name]['kernel']:.4f} ms (runs "
              f"{', '.join(f'{x:.4f}' for x in runs['kernel'])}; CUDA events, mean of 50 "
              f"wrapper calls), device {fmt_ms(dev_ms[name][0])} ms ({dev_ms[name][1]} records of "
              f"20; torch.profiler); plain twin median {fold_t[name]['plain']:.4f} ms (runs "
              f"{', '.join(f'{x:.4f}' for x in runs['plain'])}) [{card}]", flush=True)
    par_t = {}
    for name, run_par, run_this in (
        ("analysis", parent_analysis, kernels["analysis"][0]),
        ("synthesis", parent_synthesis, kernels["synthesis"][0]),
    ):
        got = {"parent": [], "this": []}
        for r in range(4):  # parent, this, this, parent
            for who in (("parent", "this"), ("this", "parent"))[r % 2]:
                got[who].append(time_cuda(run_par if who == "parent" else run_this, 50,
                                          warmup=2))
        per = os if name == "synthesis" else 1
        pd, pn = device_ms(run_par, "pfb_fold_kernel")
        par_t[name] = {"ms": float(np.median(got["parent"])),
                       "device_ms": None if pd is None else pd * per}
        print(f"time: the parent's fold kernel for the {name} step ({per} launch(es) on "
              f"planes, as its callers made them): median {par_t[name]['ms']:.4f} ms (runs "
              f"{', '.join(f'{x:.4f}' for x in got['parent'])}; CUDA events, launched "
              f"straight), device {fmt_ms(par_t[name]['device_ms'])} ms a step ({pn} records of "
              f"{20 * per}); this tree's {name} layout in turns: median "
              f"{float(np.median(got['this'])):.4f} ms (runs "
              f"{', '.join(f'{x:.4f}' for x in got['this'])}) [{card}]", flush=True)
    dev_c = {
        "analysis": device_ms(lambda: pf.pfb_analysis(head, body, w_c, os, t_frames),
                              "pfb_fold_kernel"),
        "synthesis": device_ms(lambda: pf.pfb_synthesis(v, w_c_rev, os), "pfb_fold_kernel"),
        "planes": device_ms(lambda: pf.pfb_fold_os(xr, xi, w, os, t_cls), "pfb_fold_kernel"),
    }
    print(f"time: pfb_fold device, complex taps: analysis {fmt_ms(dev_c['analysis'][0])} ms "
          f"({dev_c['analysis'][1]} records of 20), synthesis raw "
          f"{fmt_ms(dev_c['synthesis'][0])} ms ({dev_c['synthesis'][1]} records); planes "
          f"layout {fmt_ms(dev_c['planes'][0])} ms ({dev_c['planes'][1]} records); "
          f"torch.profiler [{card}]", flush=True)
    span = (t_cls - 1 + p) * m
    lib_in = torch.stack([plane[j * hop:j * hop + span].reshape(t_cls - 1 + p, m).t()
                          for plane in (xr, xi) for j in range(os)]).contiguous()
    lib_w = w.t().contiguous()[:, None, :]
    lib = lambda: F.conv1d(lib_in, lib_w, groups=m)  # noqa: E731
    lib_out = lib()
    plain0 = pf.pfb_fold_os_reference(xr, xi, w, os, t_cls)[0][0]  # class 0: no roll
    lib_rel = float((lib_out[0].t() - plain0).norm() / plain0.norm())
    lib_runs = [time_cuda(lib, 20) for _ in range(3)]
    lib_ms = float(np.median(lib_runs))
    # bytes: the classes' input span once, the frames out, the weights; the
    # operations: a multiply and an add a real term on each plane, never an
    # FMA, so each takes an FMA's issue slot: counted as two of the data
    # sheet's FP32 operations (the instruction floor at 33.5 G a ms)
    fold_bytes = 8 * ((t_cls - 1 + p) * m + (os - 1) * hop) + 8 * t_frames * m + 4 * p * m
    fold_ins = t_frames * m * 2 * (2 * p - 1)
    fold_bound = bound(2 * fold_ins, fold_bytes)
    print(f"bound: pfb_fold analysis {fold_bound['bound_ms']:.4f} ms by "
          f"{fold_bound['bound_by']}: {fold_bytes / 1e6:.1f} MB at {PEAK_BYTES / 1e12:.2f} TB/s "
          f"= {fold_bytes / PEAK_BYTES * 1e3:.4f} ms, {fold_ins / 1e9:.3f} G FP32 instructions "
          f"(no FMA) at {PEAK_FP32 / 2e12:.1f} T/s = {2 * fold_ins / PEAK_FP32 * 1e3:.4f} ms; "
          f"conv1d library median {lib_ms:.4f} ms (runs "
          f"{', '.join(f'{x:.4f}' for x in lib_runs)}; rel. diff from the twin {lib_rel:.2e}) "
          f"[{card}]", flush=True)
    def stepper(stage, inputs):
        box = {"i": 0}

        def run():
            out = stage.step(inputs[box["i"] % len(inputs)])
            box["i"] += 1
            return out
        return run

    # the ranged instance at the path's M and os with P 512 (eight ranges of
    # 64 branches), 1,024 frames: device time, the twin, the bound, and one
    # PyTorch call computing class 0's fold (depthwise conv1d for the
    # analysis; for the synthesis's spread conv1d with P - 1 zeros padded on
    # each side and the branches flipped, and conv_transpose1d, which takes
    # seconds a call here, so it is timed once; TF32 off)
    ranged = {}
    p_w, t_w = 512, 1024
    t_wc = t_w // os
    w_w = torch.from_numpy(rng.normal(size=(p_w, m)).astype(np.float32)).to(dev)
    x_w = c64(((t_w // os + p_w) * m,))
    v_w = c64((t_w, m))
    span_w = (t_wc - 1 + p_w) * m
    lib_a_in = torch.stack([pl[:span_w].reshape(t_wc - 1 + p_w, m).t()
                            for pl in (x_w.real, x_w.imag)]).contiguous()
    lib_a_w = w_w.t().contiguous()[:, None, :]
    lib_s_in = torch.stack([pl.t() for pl in (v_w[0::os].real, v_w[0::os].imag)]).contiguous()
    lib_s_w = w_w.flip(0).t().contiguous()[:, None, :]  # w_w holds the reversed branches
    lib_s_wc = w_w.t().contiguous()[:, None, :]
    lib_ct = lambda: F.conv_transpose1d(lib_s_in, lib_s_w, groups=m)  # noqa: E731
    lib_runs = {
        "analysis": (lambda: F.conv1d(lib_a_in, lib_a_w, groups=m),
                     lambda: pf.pfb_fold_os_reference(x_w.real.contiguous(),
                                                      x_w.imag.contiguous(), w_w, os,
                                                      t_wc)[0][0]),
        "synthesis": (lambda: F.conv1d(lib_s_in, lib_s_wc, padding=p_w - 1, groups=m),
                      lambda: pf.pfb_synthesis_reference(v_w[0::os].contiguous(), w_w,
                                                         1).real.reshape(-1, m)),
    }
    for name, run_k, run_p, nbytes in (
        ("analysis", lambda: pf.pfb_analysis(x_w, None, w_w, os, t_w),
         lambda: pf.pfb_analysis_reference(x_w, None, w_w, os, t_w),
         8 * ((t_w // os - 1 + p_w) * m + (os - 1) * hop) + 8 * t_w * m + 4 * p_w * m),
        ("synthesis", lambda: pf.pfb_synthesis(v_w, w_w, os),
         lambda: pf.pfb_synthesis_reference(v_w, w_w, os),
         8 * t_w * m + 8 * pf.synthesis_length(t_w, m, p_w, os) + 4 * p_w * m),
    ):
        t, runs = timed_pair(run_k, run_p, iters=(10, 2), runs=2)
        d_ms, d_n = device_ms(run_k, "pfb_fold_ranged_kernel")
        b = bound(2 * t_w * m * 2 * (2 * p_w - 1), nbytes)
        lib, lib_plain = lib_runs[name]
        lib_out, want0 = lib(), lib_plain()
        got0 = lib_out[0].t()[:want0.shape[0]]
        lib_rel_w = float((got0 - want0).norm() / want0.norm())
        lib_ms_w = float(np.median([time_cuda(lib, 10) for _ in range(3)]))
        terms = (pf.ranged_terms(t_w, m, p_w, os) if name == "synthesis" else None)
        ct = ""
        if name == "synthesis":
            ct_out = lib_ct()  # its first call, held to the twin
            ct_rel = float((ct_out[0].t() - want0).norm() / want0.norm())
            ct_ms = time_cuda(lib_ct, 1, warmup=0)
            ct = (f"; conv_transpose1d (depthwise) one call {ct_ms:.4f} ms (rel. diff "
                  f"{ct_rel:.2e})")
        ranged[name] = {**t, **b, "device_ms": d_ms, "library_ms": lib_ms_w,
                        "branch_range": pf.branch_range(name, p_w)}
        print(f"time: pfb_fold ranged {name}, M {m}, os {os}, P {p_w} (ranges of "
              f"{pf.branch_range(name, p_w)} branches), {t_w} frames: kernel median "
              f"{t['kernel']:.4f} ms (runs {', '.join(f'{x:.4f}' for x in runs['kernel'])}), "
              f"device {fmt_ms(d_ms)} ms ({d_n} records of 20), plain twin median "
              f"{t['plain']:.4f} ms; CUDA events; bound {b['bound_ms']:.4f} ms "
              f"({b['bound_by']})"
              + ("" if terms is None else f", terms run / real {terms[0] / terms[1]:.4f}")
              + f"; library: class 0's fold by one depthwise conv1d"
              f"{'' if name == 'analysis' else ' (padded P - 1 each side)'} (TF32 off) median "
              f"{lib_ms_w:.4f} ms (rel. diff from the twin {lib_rel_w:.2e}){ct} [{card}]",
              flush=True)
    del x_w, v_w, lib_a_in, lib_s_in
    # the users' streaming step at P 512: 4M blocks through both stages, one
    # fold launch a step; the fold's device time beside its bound (as above;
    # a rehearsal's blocks shorter than two spans of the bank skip it)
    h_s = ch.pfb_prototype(m, p_w) if block >= 2 * p_w * m else None
    if h_s is None:
        print(f"ranged streaming steps at P {p_w}: not run on {block}-sample blocks")
    ana_s = ch.PfbChannelizerOs(m, os=os, taps=h_s if h_s is not None else h, device=dev)
    syn_s = ch.PfbSynthesizerOs(m, os=os, taps=h_s if h_s is not None else h, device=dev)
    fr_s = [ana_s.step(blk) for blk in blocks[:2]]
    syn_s.step(fr_s[0])
    sync(dev)
    t_s = fr_s[1].shape[0]
    stream_bytes = {
        "analysis": 8 * ((t_s // os - 1 + p_w) * m + (os - 1) * hop) + 8 * t_s * m
        + 4 * p_w * m,
        "synthesis": 8 * t_s * m + 8 * pf.synthesis_length(t_s, m, p_w, os) + 4 * p_w * m,
    }
    for name, stage, inputs in (("analysis", ana_s, blocks), ("synthesis", syn_s, [fr_s[1]])):
        if h_s is None:
            break
        run = stepper(stage, inputs)
        before = pf.launches
        run()
        sync(dev)
        per_step = pf.launches - before
        if per_step != kl:
            fail(f"ranged {name} step at P {p_w}: {per_step} fold launches, not {kl}")
        st_ms = float(np.median([time_cuda(run, 5) for _ in range(3)]))
        d_ms, d_n = device_ms(run, "pfb_fold_ranged_kernel", calls=10)
        b = bound(2 * t_s * m * 2 * (2 * p_w - 1), stream_bytes[name])
        ranged[f"{name} step"] = {"ms": st_ms, "device_ms": d_ms, **b}
        stage_name = "PfbChannelizerOs" if name == "analysis" else "PfbSynthesizerOs"
        print(f"time: ranged {name} step, {stage_name}(M {m}, os {os}, P {p_w}) on a 4M "
              f"block ({t_s} frames): {st_ms:.4f} ms a step "
              f"(CUDA events, median of 3 x 5 steps), {per_step} fold launch(es) a step, fold "
              f"device {fmt_ms(d_ms)} ms ({d_n} records of 10; torch.profiler); fold bound "
              f"{b['bound_ms']:.4f} ms ({b['bound_by']}) [{card}]", flush=True)
    del ana_s, syn_s, fr_s

    msa = lambda ms: block / (ms * 1e-3) / 1e6  # noqa: E731
    steady = frames[1]
    step_t = {}
    for name, make, inputs in (
        ("analysis step", lambda be: ch.PfbChannelizerOs(m, os=os, taps_per_branch=tpb,
                                                          device=dev, backend=be), blocks),
        ("synthesis step", lambda be: ch.PfbSynthesizerOs(m, os=os, taps_per_branch=tpb,
                                                           device=dev, backend=be), [steady]),
    ):
        t, runs = timed_pair(stepper(make("auto"), inputs), stepper(make("reference"), inputs),
                             iters=(20, 3))
        enq = host_enqueue_ms(stepper(make("auto"), inputs), dev)
        step_t[name] = {**t, "enqueue": enq}
        print(f"time: {name} ({tuple(inputs[0].shape)} in): kernel path median "
              f"{t['kernel']:.4f} ms = {msa(t['kernel']):.1f} Msa/s (runs "
              f"{', '.join(f'{x:.4f}' for x in runs['kernel'])}), plain path median "
              f"{t['plain']:.4f} ms = {msa(t['plain']):.1f} Msa/s (runs "
              f"{', '.join(f'{x:.4f}' for x in runs['plain'])}); host enqueue {enq:.4f} ms a "
              f"step (host clock, no synchronise inside 20 steps); CUDA events, blocks "
              f"resident [{card}]", flush=True)
    cs_t, cs_runs = timed_pair(lambda: ch.pfb_synthesize(y_cs, m, taps=g, backend="auto"),
                               lambda: ch.pfb_synthesize(y_cs, m, taps=g), iters=(20, 20))
    print(f"time: pfb_synthesize [{y_cs.shape[0]} x {m}], Q {q}: fold kernel median "
          f"{cs_t['kernel']:.4f} ms = {msa(cs_t['kernel']):.1f} Msa/s (runs "
          f"{', '.join(f'{x:.4f}' for x in cs_runs['kernel'])}), slice-sum (the default) "
          f"median {cs_t['plain']:.4f} ms = {msa(cs_t['plain']):.1f} Msa/s (runs "
          f"{', '.join(f'{x:.4f}' for x in cs_runs['plain'])}) [{card}]")
    ddc_t = [time_cuda(stepper(Ddc(cfg, device=dev), blocks), 10) for _ in range(3)]
    print(f"time: DDC step (freq 0.1375, /8, 129 taps): median {np.median(ddc_t):.4f} ms = "
          f"{msa(float(np.median(ddc_t))):.1f} Msa/s (runs "
          f"{', '.join(f'{x:.4f}' for x in ddc_t)}; mean of 10) [{card}]", flush=True)
    busy = {}
    for name, stage, inputs in (
        ("analysis step", ch.PfbChannelizerOs(m, os=os, taps_per_branch=tpb, device=dev),
         blocks),
        ("synthesis step", ch.PfbSynthesizerOs(m, os=os, taps_per_branch=tpb, device=dev),
         [steady]),
    ):
        busy[name] = profile_step(torch, stepper(stage, inputs), name,
                                  step_t[name]["kernel"], card)
    return {
        "name": "pfb_fold",
        "route": "cuda",
        "source": "aether_primitives_tpu_torch/csrc/pfb_fold.cu",
        "replaces": "aether_primitives_tpu/ops/pallas/pfb_fold.py:35",
        "launches": counts["pfb_fold"],
        "max_abs_err": fold_err,
        "ms": fold_t["analysis"]["kernel"],
        "plain_ms": fold_t["analysis"]["plain"],
        **fold_bound,
        "library_ms": lib_ms,
        "device_ms": dev_ms["analysis"][0],
        "parent_ms": par_t["analysis"]["ms"],
        "parent_device_ms": par_t["analysis"]["device_ms"],
        "synthesis_ms": fold_t["synthesis"]["kernel"],
        "synthesis_device_ms": dev_ms["synthesis"][0],
        "synthesis_plain_ms": fold_t["synthesis"]["plain"],
        "parent_synthesis_ms": par_t["synthesis"]["ms"],
        "parent_synthesis_device_ms": par_t["synthesis"]["device_ms"],
        "complex_device_ms": {k: dev_c[k][0] for k in ("analysis", "synthesis")},
        "planes_device_ms": dev_c["planes"][0],
        "steps": {k: {"ms": t["kernel"], "host_enqueue_ms": t["enqueue"],
                      "device_busy_ms": busy[k]} for k, t in step_t.items()},
        "ranged": ranged,
    }


def device_ms(fn, match: str, calls: int = 20, tries: int = 3):
    """``(ms, records)``: the mean device time of the kernels named
    ``match`` that ``torch.profiler`` kept over ``calls`` calls of ``fn``,
    and how many it kept. It drops some records, at times all of a
    window's: then it profiles another window, ``tries`` in all, and
    returns ``(None, 0)`` (not measured) when every one came back empty."""
    from aether_primitives_tpu_torch.cli import kernel_device_times

    for _ in range(tries):
        t = [us for _, us in kernel_device_times(fn, match, calls)]
        if t:
            return sum(t) / len(t) / 1e3, len(t)
    return None, 0


def fmt_ms(ms) -> str:
    """A time in ms, or "not measured" for None."""
    return "not measured" if ms is None else f"{ms:.4f}"


def host_enqueue_ms(step, dev, steps: int = 20) -> float:
    """The host's milliseconds to enqueue one call of ``step``: the queue
    drained, then ``steps`` calls with no synchronise between them."""
    step()
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    ms = (time.perf_counter() - t0) * 1e3 / steps
    sync(dev)
    return ms


def profile_step(torch, step, name: str, step_ms: float, card: str, steps: int = 5,
                 classes=None) -> float:
    """torch.profiler split of a step's device time into ``classes``
    (``(label, predicate on the kernel's name)`` pairs, the first that
    holds takes a kernel; by default the channelizer's fold kernel and the
    FFT kernels) and the rest, with the records kept; the device's idle
    share, of the profiled steps' wall time (profiler on) and of
    ``step_ms``, the step's CUDA-event time without the profiler. Returns
    the device's busy milliseconds a step (None: not measured)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if classes is None:
        classes = (("fold kernel", lambda k: "pfb_fold" in k),
                   ("FFT", lambda k: "fft" in k.lower()))
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        print(f"profile {name}: the profiler recorded no device time: not measured")
        return None
    per = lambda us: us / steps / 1e3  # noqa: E731
    split = {label: 0.0 for label, _ in classes}
    split["rest"] = 0.0
    names = {}
    for k in kernels:
        us = k.time_range.elapsed_us()
        label = next((lab for lab, match in classes if match(k.name)), "rest")
        split[label] += us
        t, n = names.get(k.name, (0.0, 0))
        names[k.name] = (t + us, n + 1)
    busy = per(sum(split.values()))
    parts = ", ".join(f"{label} {per(us):.4f} ms" for label, us in split.items())
    print(f"profile {name}: device busy {busy:.4f} ms/step of {wall_ms:.4f} ms wall "
          f"(idle {100 * (1 - busy / wall_ms):.1f}%, profiler on; idle "
          f"{100 * (1 - busy / step_ms):.1f}% of the {step_ms:.4f} ms un-profiled step); "
          f"{parts}; {len(kernels)} kernel records over {steps} steps "
          f"(torch.profiler, profiler on) [{card}]")
    for key, (us, n) in sorted(names.items(), key=lambda kv: -kv[1][0])[:6]:
        print(f"  {per(us):.4f} ms/step  {n:3d} records  {key[:90]}")
    return busy


def profile_burst(torch, pm, x, fec_name: str, card: str, calls: int = 5) -> None:
    """torch.profiler split of ``rx_batch``'s device time: each kernel's own
    time, attributed to the stage (front end, decode, tail) whose GPU-side
    range holds its start; the decoder kernels apart; and the device's idle
    share of the profiled calls' wall time (profiler on)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    stages = ("rx_front", "decode", "rx_tail")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            with record_function("rx_front"):
                llr, _ = pm._rx_front(x)
            with record_function("decode"):
                line = pm._decode_llr(llr)
            with record_function("rx_tail"):
                pm._rx_tail(line)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    ranges = {st: [e.time_range for e in device if e.name == st] for st in stages}
    kernels = [e for e in device if e.name not in stages]
    if not kernels:
        print(f"profile rx_batch {fec_name}: the profiler recorded no device time")
        return
    per_call = lambda us: us / calls / 1e3  # noqa: E731
    busy = per_call(sum(k.time_range.elapsed_us() for k in kernels))
    decoder = per_call(sum(k.time_range.elapsed_us() for k in kernels
                           if "viterbi_kernel" in k.name or "bcjr_kernel" in k.name))
    split = {}
    for st, spans in ranges.items():
        split[st] = per_call(sum(
            k.time_range.elapsed_us() for k in kernels
            if any(r.start <= k.time_range.start < r.end for r in spans)))
    names = {}
    for k in kernels:
        names[k.name] = names.get(k.name, 0.0) + k.time_range.elapsed_us()
    print(f"profile rx_batch {fec_name}: device busy {busy:.4f} ms/call of {wall_ms:.4f} ms "
          f"wall (idle {100 * (1 - busy / wall_ms):.1f}%); kernel time by stage: front end "
          f"{split['rx_front']:.4f} ms, decode {split['decode']:.4f} ms (hand-written decoder "
          f"kernels {decoder:.4f} ms), tail {split['rx_tail']:.4f} ms, rest of device time "
          f"(outside the decode stage) {busy - split['decode']:.4f} ms; "
          f"{len(kernels) // calls} kernels per call (torch.profiler, {calls} calls, "
          f"profiler on) [{card}]")
    for key, us in sorted(names.items(), key=lambda kv: -kv[1])[:6]:
        print(f"  {per_call(us):.4f} ms/call  {key[:90]}")



def f64_qpsk_bits(taps, block, history, dec: int, fft_len: int):
    """Float64 chain on one block given its true full-rate history (causal
    FIR, decimate, SN frame FFT, QPSK sign demod), as ``tests/test_soak.py``
    computes it; bits in the chain's order (b0, b1 per bin)."""
    import numpy as np

    k = taps.shape[-1]
    ext = np.concatenate([history.astype(np.complex128), block.astype(np.complex128)])
    y = np.convolve(ext, taps.astype(np.complex128))[k - 1:k - 1 + block.size][::dec]
    spec = np.fft.fft(y.reshape(-1, fft_len), axis=-1) / np.sqrt(fft_len)
    return np.stack([spec.real < 0, spec.imag < 0], axis=-1).astype(np.uint8).reshape(-1)


def elementwise_phase(device: str = "cuda", n: int = 2048, chunk_rows: int = 128) -> dict:
    """Phase 14: the cmul and streamed_cmul kernels through their own entry
    points (``cmul``, ``cmul_c64``, ``streamed_cmul``) at ``x [n, n]`` with
    ``chunk_rows``, counted, and each ``torch.equal`` to its plain twin
    there and at ragged cases. Returns what phase 17 times and the launch
    counts and errors for the kernels' JSON entries."""
    import numpy as np
    import torch

    from aether_primitives_tpu_torch.ops.cuda import build
    from aether_primitives_tpu_torch.ops.cuda import cmul as cm
    from aether_primitives_tpu_torch.ops.cuda import stream as sk

    dev = torch.device(device)
    sync = torch.cuda.synchronize
    print_ptxas(build, "cmul")
    print_ptxas(build, "stream")
    rng = np.random.default_rng(1414)

    def planes(shape, k=4, offset=0):
        """``k`` float32 planes on the card; with ``offset``, views that
        start ``offset`` elements into a buffer (not 16-byte aligned)."""
        out = []
        for _ in range(k):
            flat = torch.from_numpy(rng.normal(size=int(np.prod(shape)) + offset)
                                    .astype(np.float32)).to(dev)
            out.append(flat[offset:].view(shape))
        return out

    a = planes((n, n))
    ac, bc = (torch.complex(a[0], a[1]), torch.complex(a[2], a[3]))
    xr, xi = planes((n, n), 2)
    rr, ri = planes((chunk_rows, n), 2)
    sync()

    # the path: each entry point once at the chip shapes, counted
    reset_counts()
    got_p = cm.cmul(*a, conj_b=True, scale=0.5)
    got_c = cm.cmul_c64(ac, bc, conj_b=True, scale=0.5)
    got_s = sk.streamed_cmul(xr, xi, rr, ri, chunk_rows=chunk_rows)
    sync()
    counts = kernel_launches()
    want = {**NO_LAUNCHES, "cmul": 2, "stream": 1}
    print(f"elementwise path: cmul [{n}, {n}] planes and complex64, streamed_cmul x [{n}, {n}] "
          f"chunk_rows {chunk_rows}: launches {counts} (need {want})")
    if counts != want:
        fail(f"elementwise path launches {counts} != {want}")
    if not all(bool(torch.isfinite(t).all()) for t in (*got_p, got_c.real, *got_s)):
        fail("elementwise path: non-finite output")

    errs = {"cmul": 0.0, "stream": 0.0}

    def check(kernel, label, got, plain):
        got, plain = ([got] if isinstance(got, torch.Tensor) else list(got),
                      [plain] if isinstance(plain, torch.Tensor) else list(plain))
        sync()
        same = all(torch.equal(g, p) for g, p in zip(got, plain))
        err = max(float((g - p).abs().max()) if g.numel() else 0.0 for g, p in zip(got, plain))
        errs[kernel] = max(errs[kernel], err)
        print(f"compare {kernel} {label}: kernel vs plain torch.equal {same}, max |diff| {err}")
        if not same:
            fail(f"{kernel} {label}: kernel and plain twin disagree")

    check("cmul", f"planes [{n}, {n}] conj 0.5", got_p, cm.cmul_reference(*a, True, 0.5))
    check("cmul", f"complex64 [{n}, {n}] conj 0.5", got_c, cm.cmul_c64_reference(ac, bc, True, 0.5))
    check("stream", f"x [{n}, {n}] chunk {chunk_rows}", got_s,
          sk.streamed_cmul_reference(xr, xi, rr, ri))
    check("cmul", f"planes [{n}, {n}] plain 1.0", cm.cmul(*a), cm.cmul_reference(*a))
    check("cmul", f"complex64 [{n}, {n}] plain 1.0", cm.cmul_c64(ac, bc),
          cm.cmul_c64_reference(ac, bc))
    ragged = n * n - 3  # not a multiple of 4
    pr = planes((ragged,))
    check("cmul", f"planes ragged ({ragged},)", cm.cmul(*pr, conj_b=True, scale=0.25),
          cm.cmul_reference(*pr, True, 0.25))
    po = planes((n - 1, n + 1), offset=1)  # an odd element offset: scalar path
    check("cmul", f"planes [{n - 1}, {n + 1}] at offset 1", cm.cmul(*po, scale=2.0),
          cm.cmul_reference(*po, scale=2.0))
    cr = torch.complex(*planes((ragged,), 2))
    cb = torch.complex(*planes((ragged,), 2))
    check("cmul", f"complex64 ragged ({ragged},)", cm.cmul_c64(cr, cb, True),
          cm.cmul_c64_reference(cr, cb, True))
    co = torch.complex(*planes((ragged + 2,), 2))[1:1 + ragged]  # 8-byte offset
    check("cmul", f"complex64 ({ragged},) at offset 1", cm.cmul_c64(co, cb, scale=3.0),
          cm.cmul_c64_reference(co, cb, scale=3.0))
    sx = planes((3 * 129, 1001), 2)
    sr = planes((3, 1001), 2)
    check("stream", "x [387, 1001] chunk 3 (odd chunk: scalar ring)",
          sk.streamed_cmul(*sx, *sr, chunk_rows=3), sk.streamed_cmul_reference(*sx, *sr))
    ox = planes((n, n // 2), 2, offset=1)
    orr = planes((chunk_rows, n // 2), 2, offset=1)
    check("stream", f"x [{n}, {n // 2}] chunk {chunk_rows} at offset 1",
          sk.streamed_cmul(*ox, *orr, chunk_rows=chunk_rows),
          sk.streamed_cmul_reference(*ox, *orr))
    try:
        sk.streamed_cmul(xr[:n - 1], xi[:n - 1], rr, ri, chunk_rows=chunk_rows)
    except ValueError as e:
        if "divisible" not in str(e):
            fail(f"streamed_cmul on indivisible rows raised {e!r}")
        print(f"streamed_cmul on {n - 1} rows, chunk_rows {chunk_rows} on the card: "
              f"ValueError({e})")
    else:
        fail("streamed_cmul took rows that chunk_rows does not divide")
    sys.stdout.flush()
    return {"a": a, "c": (ac, bc), "s": (xr, xi, rr, ri), "counts": counts, "errs": errs,
            "n": n, "chunk_rows": chunk_rows}


def host_fed_phases(card: str, device: str = "cuda", block: int = 1 << 22,
                    n_blocks: int = 16, soak_blocks: int = 512, soak_every: int = 64,
                    runs: int = 4) -> dict:
    """Phases 15 and 16, and the streaming part of 17: the main path's chain
    fed from the host through ``StatefulExecutor`` at depths 1-4 from
    pinned ``BlockPool`` buffers, pageable numpy blocks and a capture file
    (``utils.file.stream_blocks`` into ``streaming_step_split``), each
    ``torch.equal`` to device-resident stepping; a ``StreamExecutor``
    pipeline; the soak; then the sustained rates against the resident step
    and the copy times, and a profiler split of one depth-2 pinned run.
    The defaults are the path's; a smaller size on ``device="cpu"``
    rehearses the phases with the CUDA calls stubbed."""
    import tempfile

    import numpy as np
    import torch

    from aether_primitives_tpu_torch import native
    from aether_primitives_tpu_torch.boundary import Split
    from aether_primitives_tpu_torch.cli import capture, gate, time_cuda
    from aether_primitives_tpu_torch.models import RxChain, RxChainConfig
    from aether_primitives_tpu_torch.ops.cuda import build
    from aether_primitives_tpu_torch.parallel import streaming
    from aether_primitives_tpu_torch.utils import file as file_mod
    from aether_primitives_tpu_torch.utils.profiling import device_memory_stats

    dev = torch.device(device)
    sync = torch.cuda.synchronize
    pin = (lambda t: t.pin_memory()) if dev.type == "cuda" else (lambda t: t)  # noqa: E731
    chain = RxChain(RxChainConfig(fft_len=2048, decimation=4, packed_bits=True), device=dev)
    k = chain.taps.shape[-1]
    msa = lambda sec, nb: nb * block / sec / 1e6  # noqa: E731

    # ---- phase 15: host-fed streaming on the main path ---------------------
    t0 = time.perf_counter()
    if not native.available():  # the capture feeder's compiled host loops
        fail("the native host extension (csrc/hostops.cpp, g++) did not build or load")
    x = capture(n_blocks * block, 1515)
    blocks = [x[i * block:(i + 1) * block] for i in range(n_blocks)]
    x_dev = [torch.from_numpy(b).to(dev) for b in blocks]
    ref, states, state = [], [], chain.init_state()
    for xb in x_dev:  # the resident stepping every stream is held to
        bits, state = chain.streaming_step(xb, state)
        ref.append(bits)
        states.append(state)
    sync()
    g = gate(chain, x[:2 * block], block, ref[:2], states[:2])
    print(f"host-fed capture: {n_blocks} blocks of {block} samples (seed 1515) made and "
          f"stepped resident in {time.perf_counter() - t0:.1f} s (host, native host "
          f"extension built and loaded) [{card}]; first two blocks' "
          f"gate: bit agreement {g['bit_agreement']:.7f} (need >= {AGREEMENT}), block-2 "
          f"spectrum {g['evm_rms_db']:.2f} dB (need <= {EVM_DB}), state exact "
          f"{g['state_exact']}", flush=True)
    if not g["ok"]:
        fail(f"host-fed capture gate: {g}")
    tail = torch.from_numpy(blocks[-1][block - (k - 1):])
    pool = streaming.make(n_blocks, lambda: pin(torch.empty(block, dtype=torch.complex64)))
    elems = [pool.take() for _ in range(n_blocks)]  # the capture, already in pinned memory
    for e, b in zip(elems, blocks):
        e.value.copy_(torch.from_numpy(b))
    build_dir = build.PACKAGE_DIR.parent / "build"
    build_dir.mkdir(exist_ok=True)
    tmp = tempfile.TemporaryDirectory(dir=build_dir)
    path = f"{tmp.name}/capture.cf32"
    file_mod.save(path, x)

    def feed(depth: int, source: str):
        """One pass of the capture through a StatefulExecutor; returns the
        results, the host seconds (ending in a synchronise), the executor
        and the launch counts."""
        split = source == "file"
        ex = streaming.StatefulExecutor(
            chain.streaming_step_split if split else chain.streaming_step,
            chain.init_state_split() if split else chain.init_state(),
            name=f"{source} d{depth}", depth=depth, printer=None, device=dev)
        outs = []

        def push(b):
            if len(ex._inflight) >= ex.depth:
                outs.append(ex.recv())
            ex.send(b)

        sync()
        reset_counts()
        t0 = time.perf_counter()
        if source == "pinned":
            for e in elems:
                push(e.value)
        elif source == "pageable":
            for b in blocks:
                push(b)
        elif source == "ring":  # two pinned buffers, filled per block, released after send
            ring = streaming.make(2, lambda: pin(torch.empty(block, dtype=torch.complex64)))
            for b in blocks:
                e = ring.take()
                e.value.copy_(torch.from_numpy(b))
                push(e.value)
                e.release()
        else:
            with file_mod.stream_blocks(path, block, depth=4) as feeder:
                for re, im in feeder:
                    push(Split(re, im))
        outs.extend(ex)
        sync()
        return outs, time.perf_counter() - t0, ex, kernel_launches()

    def check_stream(label, outs, ex, counts, split=False):
        same = len(outs) == n_blocks and all(torch.equal(o, r) for o, r in zip(outs, ref))
        st = ex.state
        st = torch.complex(st.re, st.im) if split else st
        state_ok = torch.equal(st.cpu(), tail)
        nsamp = (2 if split else 1) * n_blocks * block
        stats_ok = (ex.chain_stats.total_n, ex.chain_stats.total_samples) == (n_blocks, nsamp)
        want = {**NO_LAUNCHES, "rx_frame": n_blocks}
        if not (same and state_ok and stats_ok and counts == want):
            fail(f"host-fed {label}: equal to resident {same}, state {state_ok}, stats "
                 f"({ex.chain_stats.total_n}, {ex.chain_stats.total_samples}) need "
                 f"({n_blocks}, {nsamp}), launches {counts} need {want}")

    first = {}
    for depth in (1, 2, 3, 4):
        for source in ("pinned", "pageable", "file"):
            outs, sec, ex, counts = feed(depth, source)
            check_stream(f"{source} depth {depth}", outs, ex, counts, split=source == "file")
            first[(depth, source)] = sec
        print(f"host-fed depth {depth}: pinned, pageable and file streams torch.equal to the "
              f"resident stepping over {n_blocks} blocks, state exact, chain_stats exact "
              f"(file: Split blocks count 2n samples), {n_blocks} rx_frame launches each; "
              f"first-pass Msa/s pinned {msa(first[(depth, 'pinned')], n_blocks):.1f}, "
              f"pageable {msa(first[(depth, 'pageable')], n_blocks):.1f}, file "
              f"{msa(first[(depth, 'file')], n_blocks):.1f} (host clock) [{card}]", flush=True)
    outs, sec, ex, counts = feed(2, "ring")
    check_stream("two-buffer pinned ring", outs, ex, counts)
    print(f"host-fed two-buffer pinned ring (fill, send, release at once), depth 2: "
          f"torch.equal to resident, {msa(sec, n_blocks):.1f} Msa/s with the host fill "
          f"(host clock) [{card}]")
    fblocks = [np.random.default_rng(1600 + i).normal(size=block).astype(np.float32)
               for i in range(8)]
    fsrc = [b if i % 2 else pin(torch.from_numpy(b)) for i, b in enumerate(fblocks)]
    pipe = streaming.new("Abs", torch.abs).add_stage("Mul 20", lambda b: b * 20.0)
    sex = pipe.finish(depth=2, printer=None, device=dev)
    reset_counts()
    pouts = sex.run(fsrc)
    sync()
    pcounts = kernel_launches()
    eager = [torch.abs(torch.from_numpy(b).to(dev)) * 20.0 for b in fblocks]
    same = all(torch.equal(o, e) for o, e in zip(pouts, eager))
    print(f"StreamExecutor Abs -> Mul 20 on 8 float32 blocks of {block} (pageable and pinned "
          f"alternately), depth 2: torch.equal to eager {same}, chain blocks "
          f"{sex.chain_stats.total_n}, sampled stages {[s.total_n for s in sex.stats]}, "
          f"launches {pcounts} (none of the port's kernels)", flush=True)
    if not same or sex.chain_stats.total_n != 8 or pcounts != NO_LAUNCHES:
        fail("StreamExecutor pipeline")

    # ---- phase 16: soak ---------------------------------------------------
    caps = [capture(block, 1700 + i) for i in range(8)]
    caps_pin = [pin(torch.from_numpy(c)) for c in caps]
    ex = streaming.StatefulExecutor(chain.streaming_step, chain.init_state(), name="soak",
                                    depth=2, printer=None, device=dev)
    order = [(i + i // soak_every) % 8 for i in range(soak_blocks)]  # checked blocks meet all 8
    checked, worst, mem = [], 1.0, {}
    kept, received = {}, [0]  # bits of every soak_every-th block, on the host
    sync()
    t0 = time.perf_counter()

    def collect():
        j, y = received[0], ex.recv()
        received[0] += 1
        if j % soak_every == 0:
            kept[j] = y.cpu().numpy()

    for i in range(soak_blocks):
        if len(ex._inflight) >= ex.depth:
            collect()
        ex.send(caps_pin[order[i]])
        if i == min(16, soak_blocks - 1):
            mem["warm"] = device_memory_stats().get("bytes_in_use")
        if i == soak_blocks - 1:
            mem["end"] = device_memory_stats().get("bytes_in_use")
    while ex._inflight:
        collect()
    sync()
    soak_s = time.perf_counter() - t0
    for i, got in sorted(kept.items()):
        hist = caps[order[i - 1]][block - (k - 1):] if i else np.zeros(k - 1, np.complex64)
        want = f64_qpsk_bits(chain.taps, caps[order[i]], hist, 4, 2048)
        agree = float((np.unpackbits(got, bitorder="little") == want).mean())
        checked.append((i, agree))
        worst = min(worst, agree)
    st = ex.chain_stats
    state_ok = torch.equal(ex.state.cpu(), torch.from_numpy(caps[order[-1]][block - (k - 1):]))
    grow = (mem["end"] - mem["warm"]) if mem.get("warm") is not None else 0
    print(f"soak: {soak_blocks} blocks ({soak_blocks * block / 1e9:.3f} G samples), 8 pinned "
          f"captures cycled with the true history carried, depth 2, in {soak_s:.3f} s = "
          f"{msa(soak_s, soak_blocks):.1f} Msa/s (host clock); agreement vs float64 at blocks "
          f"{[i for i, _ in checked]}: worst {worst:.7f} (need >= 0.9999); device bytes in use "
          f"after block 16 {mem.get('warm')} and at the end {mem.get('end')} (differ by "
          f"{grow / 1e6:.3f} MB, need < 64 MB); state exact {state_ok}; chain_stats "
          f"({st.total_n}, {st.total_samples}) [{card}]", flush=True)
    if (worst < 0.9999 or abs(grow) >= 64 * 1024 * 1024 or not state_ok
            or (st.total_n, st.total_samples) != (soak_blocks, soak_blocks * block)):
        fail("soak")

    # ---- phase 17, streaming part: sustained rates, resident step, copies ----
    box = {"state": chain.init_state(), "i": 0}

    def resident_step():
        bits, box["state"] = chain.streaming_step(x_dev[box["i"] % n_blocks], box["state"])
        box["i"] += 1
        return bits

    host = blocks[0]
    dbuf = torch.empty(block, dtype=torch.complex64, device=dev)
    times = {"resident": [], "h2d_pinned": [], "h2d_pageable": []}
    sust = {(d, s): [] for d in (1, 2, 3, 4) for s in ("pinned", "pageable", "file")}
    for run in range(runs):
        times["resident"].append(time_cuda(resident_step, 32))
        times["h2d_pinned"].append(time_cuda(lambda: dbuf.copy_(elems[0].value,
                                                                 non_blocking=True), 20))
        sync()
        t0 = time.perf_counter()
        for _ in range(10):
            dbuf.copy_(torch.from_numpy(host))
        sync()
        times["h2d_pageable"].append((time.perf_counter() - t0) / 10 * 1e3)
        sources = ("pinned", "pageable", "file")[::1 if run % 2 == 0 else -1]
        for depth in (1, 2, 3, 4):
            for source in sources:
                outs, sec, ex, counts = feed(depth, source)
                check_stream(f"{source} depth {depth} (timed run {run})", outs, ex, counts,
                             split=source == "file")
                sust[(depth, source)].append(sec / n_blocks * 1e3)
    med = {key: float(np.median(v)) for key, v in times.items()}
    print(f"time: resident streaming step median {med['resident']:.4f} ms/block = "
          f"{block / med['resident'] / 1e3:.1f} Msa/s (runs "
          f"{', '.join(f'{v:.4f}' for v in times['resident'])}; CUDA events); host->device copy "
          f"of one block ({block * 8} bytes): pinned median {med['h2d_pinned']:.4f} ms (runs "
          f"{', '.join(f'{v:.4f}' for v in times['h2d_pinned'])}; CUDA events), pageable median "
          f"{med['h2d_pageable']:.4f} ms (runs "
          f"{', '.join(f'{v:.4f}' for v in times['h2d_pageable'])}; host clock) [{card}]")
    sustained = {}
    for (depth, source), v in sust.items():
        m = float(np.median(v))
        sustained[(depth, source)] = m
        print(f"time: host-fed sustained, depth {depth}, {source}: median {m:.4f} ms/block = "
              f"{block / m / 1e3:.1f} Msa/s (runs {', '.join(f'{t:.4f}' for t in v)} ms/block; "
              f"host clock over {n_blocks} blocks ending in a synchronise); resident step "
              f"{med['resident']:.4f}, pinned copy {med['h2d_pinned']:.4f}, pageable copy "
              f"{med['h2d_pageable']:.4f} ms/block [{card}]")
    tmp.cleanup()
    sys.stdout.flush()
    if dev.type == "cuda":
        profile_host_fed(torch, lambda: feed(2, "pinned"), n_blocks, card)
    for e in elems:
        e.release()
    return {"sustained": sustained, "times": med}


def profile_host_fed(torch, run, n_blocks: int, card: str) -> None:
    """torch.profiler split of one host-fed stream: host->device copy time,
    RX frame kernel time and other kernels on the device, the time copies
    and kernels overlap, and the device's idle share of the run's wall time
    (profiler on)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        print("profile host-fed run: the profiler recorded no device time")
        return
    spans = {"copy": [], "rx_frame": [], "other": []}
    for e in events:
        key = ("copy" if "memcpy" in e.name.lower() else
               "rx_frame" if "rx_frame" in e.name else "other")
        spans[key].append((e.time_range.start, e.time_range.end))

    def union(intervals):
        total, end = 0.0, None
        for s, t in sorted(intervals):
            if end is None or s > end:
                total += t - s
                end = t
            elif t > end:
                total += t - end
                end = t
        return total

    busy = union([iv for v in spans.values() for iv in v])
    copy_t, kern_t = union(spans["copy"]), union(spans["rx_frame"])
    overlap = copy_t + kern_t - union(spans["copy"] + spans["rx_frame"])
    ms = lambda us: us / n_blocks / 1e3  # noqa: E731
    print(f"profile host-fed depth 2 pinned run ({n_blocks} blocks): per block H2D copy "
          f"{ms(copy_t):.4f} ms ({len(spans['copy'])} copies), rx_frame kernel "
          f"{ms(kern_t):.4f} ms, other kernels {ms(union(spans['other'])):.4f} ms, copy and "
          f"kernel overlapping {ms(overlap):.4f} ms; device busy {ms(busy):.4f} of "
          f"{ms(wall_us):.4f} ms wall (idle {100 * (1 - busy / wall_us):.1f}%) "
          f"(torch.profiler, profiler on) [{card}]", flush=True)


def elementwise_timing(card: str, ew: dict) -> tuple:
    """Phase 17, kernel part: cmul (planes and complex64) and streamed_cmul
    against their plain twins and one PyTorch call each, CUDA events,
    median of four runs in alternating order. Returns the two kernels'
    JSON entries."""
    import numpy as np
    import torch

    from aether_primitives_tpu_torch.cli import time_cuda
    from aether_primitives_tpu_torch.ops.cuda import cmul as cm
    from aether_primitives_tpu_torch.ops.cuda import stream as sk

    n, c = ew["n"], ew["chunk_rows"]
    a, (ac, bc), (xr, xi, rr, ri) = ew["a"], ew["c"], ew["s"]
    xc, rc = torch.complex(xr, xi), torch.complex(rr, ri)
    cases = {
        "cmul": (lambda: cm.cmul(*a), lambda: cm.cmul_reference(*a),
                 lambda: torch.mul(ac, bc)),
        "cmul_c64": (lambda: cm.cmul_c64(ac, bc), lambda: cm.cmul_c64_reference(ac, bc),
                     lambda: torch.mul(ac, bc)),
        "streamed_cmul": (lambda: sk.streamed_cmul(xr, xi, rr, ri, chunk_rows=c),
                          lambda: sk.streamed_cmul_reference(xr, xi, rr, ri),
                          lambda: torch.mul(xc.view(n // c, c, n), rc)),
    }
    iters = {"kernel": 50, "plain": 10, "library": 50}
    med = {}
    for name, fns in cases.items():
        runs = {"kernel": [], "plain": [], "library": []}
        for run in range(4):
            order = ("plain", "kernel", "library") if run % 2 == 0 else ("library", "kernel", "plain")
            for which in order:
                fn = fns[("kernel", "plain", "library").index(which)]
                runs[which].append(time_cuda(fn, iters[which], warmup=2))
        med[name] = {k: float(np.median(v)) for k, v in runs.items()}
        print(f"time: {name} [{n}, {n}]: kernel median {med[name]['kernel']:.4f} ms (runs "
              f"{', '.join(f'{v:.4f}' for v in runs['kernel'])}; mean of 50), plain twin median "
              f"{med[name]['plain']:.4f} ms (runs {', '.join(f'{v:.4f}' for v in runs['plain'])}; "
              f"mean of 10), torch.mul complex64 median {med[name]['library']:.4f} ms (runs "
              f"{', '.join(f'{v:.4f}' for v in runs['library'])}; mean of 50); CUDA events [{card}]")
    # the cmul (planes, complex64) and stream kernels launched straight on
    # outputs made once, in turns with torch.mul: their own time, apart from
    # the wrapper's host time per call
    launch = {"cmul": None, "cmul_c64": None, "streamed_cmul": None}
    if xr.is_cuda:
        dev = xr.get_device()
        outs = (torch.empty_like(xr), torch.empty_like(xi))
        s_ptrs = tuple(t.data_ptr() for t in (xr, xi, rr, ri, *outs))
        p_ptrs = tuple(t.data_ptr() for t in (*a, *outs))
        out_c = torch.empty_like(ac)
        c_ptrs = (ac.data_ptr(), bc.data_ptr(), out_c.data_ptr())
        straight = {
            "cmul": (lambda: cm._launch_planes(p_ptrs, dev, n * n, 1.0, False, True),
                     cases["cmul"][2]),
            "cmul_c64": (lambda: cm._launch_c64(c_ptrs, dev, n * n, 1.0, False, True),
                         cases["cmul_c64"][2]),
            "streamed_cmul": (lambda: sk._launch(s_ptrs, dev, c * n, n // c, True, sk.STAGES,
                                                 sk.UNROLL, sk.CTAS_PER_SM),
                              cases["streamed_cmul"][2]),
        }
        for name, (run_launch, lib) in straight.items():
            turns = {"launch": [], "library": []}
            for which in ("launch", "library", "library", "launch", "launch", "library"):
                turns[which].append(time_cuda(run_launch if which == "launch" else lib, 50,
                                              warmup=2))
            launch[name] = float(np.median(turns["launch"]))
            print(f"time: {name} kernel launched straight (outputs made once): median "
                  f"{launch[name]:.4f} ms (runs {', '.join(f'{v:.4f}' for v in turns['launch'])}"
                  f"), torch.mul complex64 in turns {float(np.median(turns['library'])):.4f} ms "
                  f"(runs {', '.join(f'{v:.4f}' for v in turns['library'])}); mean of 50, CUDA "
                  f"events; the gap to the {name} call above is its wrapper's host time "
                  f"[{card}]")
    nn = n * n
    cmul_bound = bound(8.0 * nn, 6 * 4 * nn)  # 6 ops + 2 scale products; 4 planes in, 2 out
    stream_bound = bound(6.0 * nn, 4 * 4 * nn + 2 * 4 * c * n)  # x and out planes, r once
    for name, bd in (("cmul", cmul_bound), ("cmul_c64", cmul_bound),
                     ("streamed_cmul", stream_bound)):
        print(f"bound: {name} {bd['bound_ms']:.4f} ms by {bd['bound_by']}; kernel at "
              f"{100 * bd['bound_ms'] / med[name]['kernel']:.1f}% of it [{card}]")
    sys.stdout.flush()
    return (
        {
            "name": "cmul",
            "route": "cuda",
            "source": "aether_primitives_tpu_torch/csrc/cmul.cu",
            "replaces": "aether_primitives_tpu/ops/pallas/cmul.py:27",
            "launches": ew["counts"]["cmul"],
            "max_abs_err": ew["errs"]["cmul"],
            "ms": med["cmul"]["kernel"],
            "plain_ms": med["cmul"]["plain"],
            **cmul_bound,
            "library_ms": med["cmul"]["library"],
            "launch_ms": launch["cmul"],
            "c64_ms": med["cmul_c64"]["kernel"],
            "c64_launch_ms": launch["cmul_c64"],
        },
        {
            "name": "stream",
            "route": "cuda",
            "source": "aether_primitives_tpu_torch/csrc/stream.cu",
            "replaces": "aether_primitives_tpu/ops/pallas/stream.py:26",
            "launches": ew["counts"]["stream"],
            "max_abs_err": ew["errs"]["stream"],
            "ms": med["streamed_cmul"]["kernel"],
            "plain_ms": med["streamed_cmul"]["plain"],
            **stream_bound,
            "library_ms": med["streamed_cmul"]["library"],
            "launch_ms": launch["streamed_cmul"],
        },
    )


def sharded_phases(card: str, device: str = "cuda", fft_len: int = 2048,
                   block: int = 1 << 22, m: int = 2048, tpb: int = 16, pfb_p: int = 8,
                   burst=None, bursts: int = BURSTS, runs: int = 4) -> dict:
    """Phases 18-22: the halo kernel against its twin, the sharded receiver,
    the other sharded entry points, their timings and, with two cards or
    more, the cross-card run. Every shard lies on ``device`` (phase 22
    spreads them). ``burst``: per FEC ``(modem, captures on the device,
    payloads)``, phase 8's; None builds ``bursts`` of them here. The
    defaults are the paths' sizes; a smaller size on ``device="cpu"``
    rehearses the phases with ``cli.time_cuda`` swapped for a host timer
    (CPU shards launch no kernel, so every expected launch count is 0
    there). Returns the halo kernel's entry of the kernels' JSON line."""
    import numpy as np
    import torch

    from aether_primitives_tpu_torch.cli import capture, gate, time_cuda
    from aether_primitives_tpu_torch.models import (
        Ddc, DdcConfig, PacketConfig, PacketModem, RxChain, RxChainConfig,
    )
    from aether_primitives_tpu_torch.models import channelizer as ch
    from aether_primitives_tpu_torch.models.ddc import sharded_ddc
    from aether_primitives_tpu_torch.ops.cuda import build
    from aether_primitives_tpu_torch.ops.cuda import halo as hk
    from aether_primitives_tpu_torch.parallel import mesh as mesh_mod

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    n_cards = torch.cuda.device_count() if on_card else 0
    kl = 1 if on_card else 0  # kernel launches per wrapper launch site

    def sync_all():
        for i in range(n_cards):
            torch.cuda.synchronize(i)

    def one_card(n):
        return [dev] * n

    def cards_of(mesh):
        """The mesh's distinct devices: the halo kernel launches once on each."""
        return len({str(d) for d in mesh.devices.flat})

    def spread(n):
        return [torch.device("cuda", i % n_cards) for i in range(n)]

    def data(shape, dtype, seed):
        rng = np.random.default_rng(seed)
        if np.issubdtype(dtype, np.complexfloating):
            return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(dtype)
        if np.issubdtype(dtype, np.floating):
            return rng.normal(size=shape).astype(dtype)
        return rng.integers(0, 255, size=shape).astype(dtype)

    chain = RxChain(RxChainConfig(fft_len=fft_len, decimation=4, packed_bits=True), device=dev)
    ku = chain.taps.shape[-1] - 1
    pfb_halo = (pfb_p - 1) * m
    c2t4, t4, t8 = {"channel": 2, "time": 4}, {"time": 4}, {"time": 8}

    # ---- phase 18: the halo kernel vs its twin ------------------------------
    # (label, global shape, dtype, mesh axes, spec, overlap); the first two are the paths'
    halo_shapes = [
        (f"RX chain: complex64 shards [1, {block // 4}], overlap {ku}",
         (2, block), np.complex64, c2t4, ("channel", "time"), ku),
        (f"sharded_pfb: complex64 shards [{block // 4}], overlap {pfb_halo}",
         (block,), np.complex64, t4, ("time",), pfb_halo),
        ("float32 shards [16], overlap 4", (128,), np.float32, t8, ("time",), 4),
        ("misaligned strided rows: complex64 shards [3, 5, 1000], overlap 7",
         (3, 5, 8000), np.complex64, t8, (None, None, "time"), 7),
        ("overlap equal to the span: float32 shards [4, 64]",
         (4, 512), np.float32, t8, (None, "time"), 64),
        ("a ring of one: complex64 [3, 100], overlap 9 (zeros out)",
         (3, 100), np.complex64, {"time": 1}, (None, "time"), 9),
        ("the exchanged axis first: {time: 4, channel: 2}, complex64 shards [1, 1024], "
         "overlap 33", (2, 4096), np.complex64, {"time": 4, "channel": 2},
         ("channel", "time"), 33),
        ("uint8 shards [7, 101], overlap 13", (7, 808), np.uint8, t8, (None, "time"), 13),
        ("complex128 shards [2, 64], overlap 5", (2, 256), np.complex128, t4, (None, "time"), 5),
    ]

    def halo_cases(devices, where):
        """Every case through kernel and twin on a mesh of ``devices(n)``;
        returns the worst |diff| and the two path cases' sharded inputs."""
        worst, kept = 0.0, []
        for i, (label, shape, dtype, axes, spec, overlap) in enumerate(halo_shapes):
            mesh = mesh_mod.make_mesh(axes, devices=devices(int(np.prod(list(axes.values())))))
            xs = mesh_mod.shard(torch.from_numpy(data(shape, dtype, 1800 + i)).to(dev), mesh, spec)
            sync_all()
            reset_counts()
            got = hk.halo_left_rdma(xs, overlap, "time")
            sync_all()
            counts = kernel_launches()
            want = hk.halo_left_rdma_reference(xs, overlap, "time")
            sync_all()
            same = all(torch.equal(got.shards[c], want.shards[c])
                       and got.shards[c].device == xs.shards[c].device for c in mesh.coords())
            widen = (lambda t: t) if np.issubdtype(dtype, np.inexact) else torch.Tensor.int
            err = max(float((widen(got.shards[c]) - widen(want.shards[c])).abs().max())
                      for c in mesh.coords())
            worst = max(worst, err)
            need = {**NO_LAUNCHES, "halo": kl * cards_of(mesh)}
            print(f"compare halo {where}{label} on {dict(mesh.shape)}: kernel vs plain "
                  f"torch.equal {same}, max |diff| {err}, launches {counts['halo']} "
                  f"(need {need['halo']}: one per sending card)")
            if not same or counts != need:
                fail(f"halo {where}{label}: kernel and plain twin disagree, or launches "
                     f"{counts} != {need}")
            if i < 2:
                kept.append((label, xs, overlap))
        sys.stdout.flush()
        return worst, kept

    if on_card:
        print_ptxas(build, "halo")
    halo_err, halo_inputs = halo_cases(one_card, "")

    # ---- phase 19: the sharded receiver -----------------------------------------
    n_ch, n_blocks = 2, 3
    t0 = time.perf_counter()
    cap = np.stack([capture(n_blocks * block, 1900 + c) for c in range(n_ch)])
    x_dev = torch.from_numpy(cap).to(dev)
    blocks = [x_dev[:, i * block:(i + 1) * block].contiguous() for i in range(n_blocks)]
    ref_bits, ref_states, st = [], [], chain.init_state((n_ch,))
    for b in blocks:  # the resident stepping every sharded call is held to
        rb, st = chain.streaming_step(b, st)
        ref_bits.append(rb)
        ref_states.append(st)
    whole = chain.step(x_dev)
    sync_all()
    print(f"sharded receiver capture: [{n_ch}, {n_blocks * block}] complex64 (seeds 1900, "
          f"1901) made, stepped resident block by block and in one step in "
          f"{time.perf_counter() - t0:.1f} s (host) [{card}]", flush=True)

    def receiver(devices, where):
        """Three blocks through sharded_streaming_step_2d on a {channel: 2,
        time: 4} mesh of ``devices(8)`` with every gate; returns the mesh
        and the launch counts of the run."""
        mesh = mesh_mod.make_mesh(c2t4, devices=devices(8))
        per_call = {**NO_LAUNCHES, "rx_frame": 8 * kl, "halo": kl * cards_of(mesh)}
        sync_all()
        reset_counts()
        state, outs, states, calls = chain.init_state((n_ch,)), [], [], []
        for b in blocks:
            before = kernel_launches()
            bits, state = chain.sharded_streaming_step_2d(b, state, mesh)
            after = kernel_launches()
            calls.append({k: after[k] - before[k] for k in after})
            outs.append(bits)
            states.append(state)
        sync_all()
        counts = kernel_launches()
        got = [o.gather(dev) for o in outs]
        got_states = [s_.gather(dev) for s_ in states]
        sync_all()
        shapes_ok = all(g.shape == (n_ch, block // 16) and g.dtype == torch.uint8 for g in got)
        blocks_ok = all(torch.equal(g, r) for g, r in zip(got, ref_bits))
        states_ok = all(torch.equal(g, r) for g, r in zip(got_states, ref_states))
        whole_ok = torch.equal(torch.cat(got, dim=-1), whole)
        tail_ok = torch.equal(got_states[-1].cpu(), torch.from_numpy(cap[:, -ku:]))
        g = gate(chain, cap[0, :2 * block], block, [b[0] for b in got[:2]],
                 [s_[0] for s_ in got_states[:2]])
        print(f"sharded receiver {where}: {n_blocks} blocks [{n_ch}, {block}] through "
              f"sharded_streaming_step_2d on {dict(mesh.shape)} "
              f"({sorted({str(d) for d in mesh.devices.flat})}): launches per call "
              f"{[{k: v for k, v in c.items() if v} for c in calls]} (need rx_frame "
              f"{per_call['rx_frame']}, halo {per_call['halo']}), run total {counts}; "
              f"concatenated bytes torch.equal to one step of the whole capture {whole_ok}; "
              f"every block's bytes torch.equal to resident streaming_step {blocks_ok}, "
              f"states {states_ok}; final state the capture's last {ku} samples {tail_ok}; "
              f"channel 0 two-block gate: bit agreement {g['bit_agreement']:.7f} (need >= "
              f"{AGREEMENT}), block-2 spectrum {g['evm_rms_db']:.2f} dB (need <= {EVM_DB}), "
              f"state exact {g['state_exact']}", flush=True)
        if not (shapes_ok and blocks_ok and states_ok and whole_ok and tail_ok and g["ok"]
                and all(c == per_call for c in calls)):
            fail(f"sharded receiver {where}: a gate failed")
        return mesh, counts

    mesh, rx_counts = receiver(one_card, "on one card" if on_card else "on the CPU")
    mesh8 = mesh_mod.make_mesh(t8, devices=one_card(8))
    sync_all()
    reset_counts()
    flat = chain.sharded_step(blocks[0][0], mesh8).gather(dev)
    sync_all()
    counts = kernel_launches()
    need = {**NO_LAUNCHES, "rx_frame": 8 * kl, "halo": kl}
    same = torch.equal(flat, chain.step(blocks[0][0]))
    print(f"sharded_step [{block}] on {{time: 8}}: torch.equal to step {same}, launches "
          f"{counts} (need {need})", flush=True)
    if not same or counts != need:
        fail("sharded_step on {time: 8}")

    # ---- phase 20: the other sharded paths ------------------------------------------
    mesh4 = mesh_mod.make_mesh(t4, devices=one_card(4))
    x1 = torch.from_numpy(capture(block, 2020)).to(dev)

    def sharded_vs_one(label, run_sharded, run_one, need, bar):
        sync_all()
        reset_counts()
        y = run_sharded().gather(dev)
        sync_all()
        counts = kernel_launches()
        one = run_one()
        t = one.shape[0] if one.ndim == 2 else one.shape[-1]
        y = y[:t] if one.ndim == 2 else y[..., :t]
        d = evm_db(y, one)
        print(f"{label}: sharded {tuple(y.shape)} vs one-shot {d:.2f} dB (need <= {bar}), "
              f"torch.equal {torch.equal(y, one)}, launches {counts} (need {need})", flush=True)
        if not (d <= bar) or counts != need or not bool(torch.isfinite(y.abs()).all()):
            fail(label)

    p_os = ch._branches(ch.pfb_prototype_nyquist(m, tpb), m).shape[0]
    sharded_vs_one(
        f"sharded_pfb_os (M {m}, os 2, P {p_os}, right halo {p_os * m - m // 2}) on {{time: 4}}",
        lambda: ch.sharded_pfb_os(x1, m, mesh4, os=2, taps_per_branch=tpb),
        lambda: ch.pfb_channelize_os(x1, m, os=2, taps_per_branch=tpb),
        {**NO_LAUNCHES, "pfb_fold": 4 * kl}, STREAM_DB)
    sharded_vs_one(
        f"sharded_pfb (M {m}, P {pfb_p}, left halo {pfb_halo}) on {{time: 4}}",
        lambda: ch.sharded_pfb(x1, m, mesh4, taps_per_branch=pfb_p),
        lambda: ch.pfb_channelize(x1, m, taps_per_branch=pfb_p),
        {**NO_LAUNCHES, "halo": kl}, STREAM_DB)
    ddc_cfg = DdcConfig(freq=0.1375, decimation=8)
    sharded_vs_one(
        "sharded_ddc (freq 0.1375, /8, 129 taps, left halo 128 mixed samples) on {time: 4}",
        lambda: sharded_ddc(x1, ddc_cfg, mesh4),
        lambda: Ddc(ddc_cfg, device=dev).step(x1),
        {**NO_LAUNCHES, "halo": kl}, SHARDED_DDC_DB)
    del x1
    mesh_c8 = mesh_mod.make_mesh({"channel": 8}, devices=one_card(8))
    if burst is None:
        burst = {}
        for fec_name in ("viterbi", "turbo"):
            pm = PacketModem(PacketConfig(payload_bits=PAYLOAD, fec=fec_name), device=dev)
            payloads, caps = burst_captures(pm, bursts)
            burst[fec_name] = (pm, torch.from_numpy(caps).to(dev), payloads)
    for fec_name, (pm, xb, payloads) in burst.items():
        sync_all()
        reset_counts()
        bits_s, ok_s, diag_s = pm.rx_batch_sharded(xb, mesh_c8)
        sync_all()
        counts = kernel_launches()
        need = {**NO_LAUNCHES, **({"viterbi": 8 * kl} if fec_name == "viterbi"
                                  else {"bcjr": 128 * kl})}
        bits_u, ok_u, diag_u = pm.rx_batch(xb)
        same = (torch.equal(bits_s.gather(dev), bits_u) and torch.equal(ok_s.gather(dev), ok_u)
                and torch.equal(diag_s["offset"].gather(dev), diag_u["offset"]))
        exact = bool((bits_s.gather("cpu").numpy() == payloads).all()) and bool(ok_u.all())
        print(f"rx_batch_sharded {fec_name} {tuple(xb.shape)} on {{channel: 8}}: payloads, CRC "
              f"and offsets equal to rx_batch {same}, every payload exact and CRC-ok {exact}, "
              f"launches {counts} (need {need})", flush=True)
        if not (same and exact) or counts != need:
            fail(f"rx_batch_sharded {fec_name}")

    # ---- phase 21: timings ---------------------------------------------------------
    def host_clock(fn, iters, warmup=2):
        """ms per call by the host clock around ``iters`` calls ending in a
        synchronise of every card (work that spans cards)."""
        for _ in range(warmup):
            fn()
        sync_all()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        sync_all()
        return (time.perf_counter() - t0) / iters * 1e3

    def time_exchange(xs, overlap, peak, timer=time_cuda):
        """Medians (ms per whole exchange: one push per shard, one launch per
        card) of the kernel, its twin and Tensor.copy_ / zero_ per shard, and
        the bound."""
        msh = xs.mesh
        j = msh.axis("time")
        size = msh.devices.shape[j]
        bufs = {c: torch.empty(xs.shards[c].shape[:-1] + (overlap,), dtype=xs.shards[c].dtype,
                               device=xs.shards[c].device) for c in msh.coords()}

        def run_library():
            for c in msh.coords():
                if c[j] == 0:
                    bufs[c].zero_()
                else:
                    left = xs.shards[c[:j] + (c[j] - 1,) + c[j + 1:]]
                    bufs[c].copy_(left[..., left.shape[-1] - overlap:])

        fns = {"kernel": lambda: hk.halo_left_rdma(xs, overlap, "time"),
               "plain": lambda: hk.halo_left_rdma_reference(xs, overlap, "time"),
               "library": run_library}
        got = {k: [] for k in fns}
        for run in range(runs):
            order = ("plain", "kernel", "library") if run % 2 == 0 else ("library", "kernel",
                                                                         "plain")
            for which in order:
                got[which].append(timer(fns[which], 50, warmup=2))
        first = xs.shards.flat[0]
        push = first.numel() // first.shape[-1] * overlap * first.element_size()
        rings = msh.size // size
        # every shard's buffer written once; every tail but the last shard's read once
        nbytes = rings * (size + size - 1) * push
        t_ms = nbytes / peak * 1e3
        return {k: float(np.median(v)) for k, v in got.items()}, got, nbytes, t_ms

    halo_t = []
    for label, xs, overlap in halo_inputs:
        med, got, nbytes, t_ms = time_exchange(xs, overlap, PEAK_BYTES)
        halo_t.append((med, nbytes, t_ms))
        print(f"time: halo exchange, {label}, {xs.mesh.size} pushes on {dict(xs.mesh.shape)}: "
              f"kernel median {med['kernel']:.4f} ms (runs "
              f"{', '.join(f'{v:.4f}' for v in got['kernel'])}), plain twin median "
              f"{med['plain']:.4f} ms (runs {', '.join(f'{v:.4f}' for v in got['plain'])}), "
              f"Tensor.copy_ / zero_ per shard median {med['library']:.4f} ms (runs "
              f"{', '.join(f'{v:.4f}' for v in got['library'])}); mean of 50 exchanges, CUDA "
              f"events; bound {t_ms:.6f} ms by bytes ({nbytes} B over 3.35 TB/s): the "
              f"launches, not the bytes, are the floor at this size [{card}]", flush=True)
    box = {"s": chain.init_state((n_ch,)), "r": chain.init_state((n_ch,))}

    def sharded_call():
        bits, box["s"] = chain.sharded_streaming_step_2d(blocks[1], box["s"], mesh)
        return bits

    def resident_call():
        bits, box["r"] = chain.streaming_step(blocks[1], box["r"])
        return bits

    step_t, step_runs = timed_pair(sharded_call, resident_call, iters=(20, 20), runs=runs)
    msa = lambda ms: n_ch * block / (ms * 1e-3) / 1e6  # noqa: E731
    print(f"time: sharded streaming step, [{n_ch}, {block}] on {dict(mesh.shape)} with all 8 "
          f"shards on one device: median {step_t['kernel']:.4f} ms = "
          f"{msa(step_t['kernel']):.1f} Msa/s (runs "
          f"{', '.join(f'{v:.4f}' for v in step_runs['kernel'])}); resident streaming_step on "
          f"the same block: median {step_t['plain']:.4f} ms = {msa(step_t['plain']):.1f} Msa/s "
          f"(runs {', '.join(f'{v:.4f}' for v in step_runs['plain'])}); mean of 20 calls, CUDA "
          f"events, bits left sharded [{card}]", flush=True)

    # ---- phase 22: across cards -----------------------------------------------------
    if n_cards >= 2:
        err, inputs = halo_cases(spread, f"across {n_cards} cards: ")
        halo_err = max(halo_err, err)
        mesh_x, _ = receiver(spread, f"across {n_cards} cards")
        placed = mesh_mod.shard(blocks[1], mesh_x, ("channel", "time"))
        box.update(x=chain.init_state((n_ch,)), p=chain.init_state((n_ch,)))

        def spread_call():
            bits, box["x"] = chain.sharded_streaming_step_2d(blocks[1], box["x"], mesh_x)

        def placed_call():
            bits, box["p"] = chain.sharded_streaming_step_2d(placed, box["p"], mesh_x)

        for what, fn in (
            (f"8 shards over {n_cards} cards, the block resident on {dev}", spread_call),
            (f"8 shards over {n_cards} cards, the block laid out beforehand", placed_call),
            (f"8 shards on {dev} alone", sharded_call),
            (f"resident streaming_step on {dev}", resident_call),
        ):
            got = [host_clock(fn, 20) for _ in range(CROSS_RUNS)]
            print(f"time: streaming step on [{n_ch}, {block}], {what}: median "
                  f"{float(np.median(got)):.4f} ms = {msa(float(np.median(got))):.1f} Msa/s "
                  f"(runs {', '.join(f'{v:.4f}' for v in got)}; host clock around 20 calls "
                  f"ending in a synchronise of every card) [{card}]", flush=True)
        for label, xs, overlap in inputs:
            med, got, nbytes, t_ms = time_exchange(xs, overlap, NVLINK_BYTES, host_clock)
            print(f"time: halo exchange across {n_cards} cards, {label}: kernel median "
                  f"{med['kernel']:.4f} ms, plain twin {med['plain']:.4f} ms, Tensor.copy_ / "
                  f"zero_ per shard {med['library']:.4f} ms (host clock around 50 exchanges "
                  f"ending in a synchronise of every card); bound {t_ms:.6f} ms by bytes "
                  f"({nbytes} B over 450 GB/s NVLink one way) [{card}]", flush=True)
    else:
        print(f"cards: {n_cards}, cross-card phase not run")
    med, nbytes, t_ms = halo_t[0]
    return {
        "name": "halo",
        "route": "cuda",
        "source": "aether_primitives_tpu_torch/csrc/halo.cu",
        "replaces": "aether_primitives_tpu/ops/pallas/halo_rdma.py:42",
        "launches": rx_counts["halo"],
        "max_abs_err": halo_err,
        "ms": med["kernel"],
        "plain_ms": med["plain"],
        "bound_ms": t_ms,
        "bound_by": "bytes",
        "library_ms": med["library"],
    }


def f64_tx(bits, table, fft_len: int, dec: int, active: int, taps):
    """Float64 golden of the transmit chain: table symbols (LSB-first
    indices) on the active bins of each frame, ``ifft`` scaled ``1/sqrt(N)``
    (``Scale.SN`` of the float32 N), zero-stuffing by ``dec``, and one causal
    ``np.convolve`` with ``taps * dec`` over the flattened stream."""
    import numpy as np

    bps = int(np.log2(table.shape[0]))
    idx = (bits.reshape(-1, bps).astype(np.int64) << np.arange(bps)).sum(-1)
    syms = table.astype(np.complex128)[idx].reshape(-1, active)
    spec = np.zeros((syms.shape[0], fft_len), np.complex128)
    half = active // 2
    spec[:, :half] = syms[:, :half]
    spec[:, fft_len - (active - half):] = syms[:, half:]
    frames = np.fft.ifft(spec, axis=-1) * fft_len / np.sqrt(np.float32(fft_len))
    up = np.zeros((frames.shape[0], fft_len * dec), np.complex128)
    up[:, ::dec] = frames
    h = taps.astype(np.complex128) * dec
    return np.convolve(up.reshape(-1), h)[:up.size]


def link_phases(card: str, device: str = "cuda", fft_len: int = 2048, dec: int = 4,
                frames: int = 512, golden_frames: int = 64, modem_bits: int = 1 << 20,
                ber_bits: int = 1 << 20, runs: int = 4) -> dict:
    """Phases 23-24, the link simulation: ``TxChain`` -> ``noise.Awgn`` ->
    the shift by ``loopback_delay`` -> ``RxChain`` with ``active_bins =
    fft_len / 2`` at full width (``frames`` frames a block), its gates, the
    other FIR modes, QAM16 with an ``OfdmEqualizer`` pilot, ``Modem``,
    ``simulate_ber`` and a ``Channel``; then the timings and profiles.
    Returns ``{"launches": ...}``, the RX frame launches of the link run."""
    import dataclasses

    import numpy as np
    import torch

    from aether_primitives_tpu_torch import cli
    from aether_primitives_tpu_torch.models import (
        Channel, ChannelConfig, Modem, ModemConfig, OfdmEqualizer, RxChain, RxChainConfig,
        TxChain, loopback_delay,
    )
    from aether_primitives_tpu_torch.models.ber import simulate_ber
    from aether_primitives_tpu_torch.ops import fir, noise
    from aether_primitives_tpu_torch.ops.cuda import rx_frame as rf
    from aether_primitives_tpu_torch.ops.fft import Scale

    dev = torch.device(device)
    kl = 1 if dev.type == "cuda" else 0
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    active = fft_len // 2
    cfg = RxChainConfig(fft_len=fft_len, decimation=dec, active_bins=active)
    tx, rx = TxChain(cfg, device=dev), RxChain(cfg, device=dev)
    bpf, span = tx.bits_per_frame(), dec * fft_len
    n = frames * span
    rng = np.random.default_rng(2300)
    bits_np = rng.integers(0, 2, frames * bpf).astype(np.uint8)
    bits = torch.from_numpy(bits_np).to(dev)
    d = loopback_delay(tx, rx)
    awgn = noise.Awgn(1e-6, 815, device=dev)
    interior = slice(bpf, (frames - 1) * bpf)

    def shifted(y):
        return torch.cat([y[d:], torch.zeros(d, dtype=y.dtype, device=y.device)])

    def link(t, r):
        x = t.step(bits)
        rin = shifted(awgn.apply(x))
        return x, rin, r.step(rin)

    # ---- phase 23: the link gate, at full width -------------------------------
    plan = rf.kernel_plan(dec, fft_len, None, rx.taps.shape[-1])
    if kl and plan[0] != "direct":
        fail(f"the link's RX geometry took the {plan[0]} instance, not direct")
    epilogues, real_rx_frame = [], rf.rx_frame

    def recording(*args, **kwargs):
        epilogues.append(kwargs.get("epilogue"))
        return real_rx_frame(*args, **kwargs)

    rf.rx_frame = recording
    try:
        reset_counts()
        x, rin, out = link(tx, rx)
        sync(dev)
        counts = kernel_launches()
    finally:
        rf.rx_frame = real_rx_frame
    exact = bool(torch.equal(out[interior], bits[interior]))
    print(f"link (fft_len {fft_len}, decimation {dec}, active_bins {active}, QPSK, {frames} "
          f"frames = {frames * bpf} bits -> {n} samples, AWGN 1e-6, delay {d}): interior "
          f"frames' bits exact {exact}; launches {counts}, RX frame epilogues {epilogues} "
          f"(need rx_frame {kl}, spectrum), instance {plan[0]}")
    if not exact or counts != {**NO_LAUNCHES, "rx_frame": kl} or epilogues != ["spectrum"] * kl:
        fail("link: interior bits, the RX frame launch count or its epilogue")
    link_launches = counts["rx_frame"]
    x_cpu = TxChain(cfg, device="cpu").step(bits.cpu())
    tx_cpu_db = evm_db(x.cpu(), x_cpu)
    golden = f64_tx(bits_np[:golden_frames * bpf], tx.modulation.table, fft_len, dec, active,
                    tx.taps)
    tx_f64_db = evm_db(x[:golden_frames * span].cpu().numpy(), golden)
    spec = rx.spectra(rin)
    ref = rx._active(rf.rx_frame_reference(rin, rx.taps, dec, fft_len, epilogue="spectrum"))
    rx_db = evm_db(spec, ref)
    print(f"compare link: TX samples vs the port's CPU run {tx_cpu_db:.2f} dB (need <= "
          f"{LINK_DB}), vs float64 on the first {golden_frames} frames {tx_f64_db:.2f} dB (need "
          f"<= {EVM_DB}); RX active-bin spectra vs rx_frame_reference {rx_db:.2f} dB (need <= "
          f"{LINK_DB}) RMS EVM")
    if tx_cpu_db > LINK_DB or tx_f64_db > EVM_DB or rx_db > LINK_DB:
        fail("link: TX or RX spectra EVM")
    for mode in ("os", "shift_add"):
        mcfg = dataclasses.replace(cfg, fir_mode=mode)
        reset_counts()
        xm, _, om = link(TxChain(mcfg, device=dev), RxChain(mcfg, device=dev))
        sync(dev)
        mcounts = kernel_launches()
        ok = bool(torch.equal(om[interior], bits[interior]))
        print(f"link fir_mode {mode!r} on both chains: interior bits exact {ok}, launches "
              f"{mcounts} (need none), TX vs fused {evm_db(xm, x):.2f} dB")
        if not ok or mcounts != NO_LAUNCHES:
            fail(f"link fir_mode {mode!r}: interior bits or a kernel launch")
    qcfg = dataclasses.replace(cfg, modulation="qam16")
    qtx, qrx = TxChain(qcfg, device=dev), RxChain(qcfg, device=dev)
    qbpf = qtx.bits_per_frame()
    qbits = torch.from_numpy(rng.integers(0, 2, frames * qbpf).astype(np.uint8)).to(dev)
    pilot, data = qbits[qbpf:2 * qbpf], qbits[2 * qbpf:]
    reset_counts()
    qspec = qrx.spectra(shifted(qtx.step(qbits)))
    h = OfdmEqualizer.estimate(qspec[1], qrx.modulation.modulate(pilot))
    qout = qrx.demod_spectra(OfdmEqualizer.apply(qspec[2:], h))
    sync(dev)
    qcounts = kernel_launches()
    keep = (frames - 3) * qbpf  # the last frame holds the zero-padded tail
    qok = bool(torch.equal(qout[:keep], data[:keep]))
    print(f"link QAM16 with an OfdmEqualizer pilot (frame 1): data frames exact {qok}; "
          f"launches {qcounts} (need rx_frame {kl})")
    if not qok or qcounts != {**NO_LAUNCHES, "rx_frame": kl}:
        fail("link QAM16: data frames or the launch count")
    mbits = torch.from_numpy(rng.integers(0, 2, modem_bits).astype(np.uint8)).to(dev)
    mok = bool(torch.equal(Modem(ModemConfig("qpsk"), device=dev).loopback(mbits), mbits))
    print(f"Modem(ModemConfig('qpsk')).loopback on {modem_bits} bits (noise 0.01): exact {mok}")
    if not mok:
        fail("Modem loopback")
    for p, sim, th in simulate_ber("qpsk", (0.25, 0.5, 1.0), ber_bits, device=dev):
        sigma = float(np.sqrt(th * (1 - th) / ber_bits))
        print(f"simulate_ber qpsk power {p}: {sim:.6f} vs theory {th:.6f} ({(sim - th) / sigma:+.2f}"
              f" sigma of {ber_bits} bits; need within 5)")
        if abs(sim - th) > 5 * sigma:
            fail(f"simulate_ber at power {p}")
    ccfg = ChannelConfig(taps=(1.0, 0.2 - 0.1j, 0.05j), cfo=1e-4, phase0=0.3, iq_amp_db=0.5,
                         iq_phase_deg=2.0, dc=0.01 + 0.02j)
    ch_db = evm_db(Channel(ccfg, device=dev).apply(7, x).cpu(),
                   Channel(ccfg, device="cpu").apply(7, x.cpu()))
    print(f"compare Channel (multipath, CFO, IQ imbalance, DC, no noise) on the TX block vs the "
          f"port's CPU run: {ch_db:.2f} dB RMS EVM (need <= {LINK_DB})", flush=True)
    if ch_db > LINK_DB:
        fail("Channel: card vs CPU")

    # ---- phase 24: timings ------------------------------------------------------
    steps = {
        "TxChain.step": lambda: tx.step(bits),
        "RxChain.step (active bins)": lambda: rx.step(rin),
        # the step as it ran on the card before it went through the kernel
        "the active-bin step through the plain fir_decimate_fft": lambda: rx._demod_frames(
            fir.fir_decimate_fft(rin, rx.taps, dec, fft_len, Scale.SN)),
        "loopback (TX, AWGN, shift, RX)": lambda: link(tx, rx),
    }
    for what, fn in steps.items():
        got = [cli.time_cuda(fn, 10) for _ in range(CROSS_RUNS)]
        ms = float(np.median(got))
        enq = host_enqueue_ms(fn, dev)
        print(f"time: {what} on {n} samples ({frames * bpf} bits): median {ms:.4f} ms = "
              f"{n / ms / 1e3:.1f} Msa/s (runs {', '.join(f'{v:.4f}' for v in got)}; mean of "
              f"10 calls, CUDA events); host enqueue {enq:.4f} ms a call [{card}]", flush=True)
        if what.startswith("TxChain"):
            profile_step(torch, fn, what, ms, card, classes=(
                ("cuFFT", lambda k: "fft" in k.lower()),
                ("matmul", lambda k: any(w in k.lower() for w in ("gemm", "gemv", "cutlass",
                                                                   "xmma", "dot"))),
                ("elementwise", lambda k: any(w in k.lower() for w in ("elementwise",
                                                                        "vectorized",
                                                                        "unrolled"))),
            ))
        elif what.startswith("RxChain"):
            profile_step(torch, fn, what, ms, card,
                         classes=(("RX frame kernel", lambda k: "rx_frame" in k),))
    return {"launches": link_launches}


def _ulps(got, want) -> float:
    """Largest ``|got - want|`` in float32 ulps of ``want``."""
    import numpy as np

    w = np.asarray(want, np.float32)
    return float(np.max(np.abs(np.asarray(got, np.float64) - w) / np.spacing(np.abs(w))))


def _max_err(got, want, scale: float = 1.0) -> float:
    """Largest ``|got - want| / scale`` over two tensors or arrays (host)."""
    import numpy as np

    g = got.cpu().numpy() if hasattr(got, "cpu") else np.asarray(got)
    w = want.cpu().numpy() if hasattr(want, "cpu") else np.asarray(want)
    return float(np.max(np.abs(g.astype(np.complex128) - w.astype(np.complex128)))) / scale


def profile_calls(torch, fn, name: str, ms: float, card: str, calls: int = 1,
                  warm: bool = True) -> dict:
    """``cli.profile_call`` over ``calls`` calls of ``fn`` (a loop path makes
    ~10^5 kernels a call), printed: kernels a call, the device's busy
    milliseconds a call and its idle share of the profiled wall time
    (profiler on) and of ``ms``, the call's CUDA-event time without the
    profiler, and the four kernels that take most. Returns ``{"kernels",
    "busy_ms", "idle"}`` (None: not measured)."""
    if not torch.cuda.is_available():
        print(f"profile {name}: no CUDA device: not measured")
        return {"kernels": None, "busy_ms": None, "idle": None}
    prof = profile_call(fn, calls=calls, warm=warm)
    busy, wall_ms = prof["busy_ms"], prof["wall_ms"]
    if busy is None:
        print(f"profile {name}: the profiler recorded no device time: not measured")
        return {"kernels": None, "busy_ms": None, "idle": None}
    idle = 1 - busy / wall_ms
    print(f"profile {name}: {prof['kernels']:.0f} kernels a call, device busy {busy:.4f} "
          f"ms of {wall_ms:.4f} ms wall (idle {100 * idle:.1f}%, profiler on; idle "
          f"{100 * (1 - busy / ms):.1f}% of the {ms:.4f} ms un-profiled call) "
          f"(torch.profiler, {calls} call(s)) [{card}]")
    for key, (us, c) in sorted(prof["names"].items(), key=lambda kv: -kv[1][0])[:4]:
        print(f"  {us / calls / 1e3:.4f} ms/call  {c // calls:6d} a call  {key[:80]}")
    return {"kernels": prof["kernels"], "busy_ms": busy, "idle": idle}


def analog_tracking_phases(card: str, device: str = "cuda", nsym: int = 6000,
                           n_dwells: int = 620, n_chan: int = 1 << 15, fe_block: int = 1 << 22,
                           fsk_bits: int = 1 << 16, capture: int = 1 << 17,
                           runs: int = 3) -> dict:
    """Phases 25-26, the receivers of the tracking loops, the front end, IIR,
    the analog modes, FSK and detection, each at its example's full size:
    the feedback receiver (``examples/feedback_rx.py``: matched filter ->
    ``gardner_loop`` -> ``costas_loop`` -> decisions -> differential decode),
    the GNSS tracking channel (``examples/gnss_track.py``: ``code_tracking_loop``
    -> ``carrier_tracking_loop`` -> ``nav_bit_sync``), the FM receiver
    (``examples/fm_radio.py``, with ``sosfilt``), the front end's conditioning
    of one ``fe_block`` (``examples/receiver.py:65-83``'s impairments), the
    MSK / GMSK / OQPSK loopbacks and the detectors. Every path runs on
    ``device`` and again on the CPU from the same inputs (the gates below);
    then each is timed and profiled. Returns ``{path: {"ms", "kernels",
    "idle", "launches"}}``."""
    import numpy as np
    import scipy.signal
    import torch

    from aether_primitives_tpu_torch import cli
    from aether_primitives_tpu_torch.models import FskConfig, FskModem
    from aether_primitives_tpu_torch.models import detect, fsk
    from aether_primitives_tpu_torch.models import sync as ts
    from aether_primitives_tpu_torch.models.ddc import Ddc, DdcConfig, Duc, DucConfig, _design_lowpass
    from aether_primitives_tpu_torch.ops import analog, fir, iir, noise, sampling
    from aether_primitives_tpu_torch.ops import frontend as fe
    from aether_primitives_tpu_torch.ops import modulation as mod
    from aether_primitives_tpu_torch.ops.sequence import gps_ca_code

    dev, cpu = torch.device(device), torch.device("cpu")
    up_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    results, paths = {}, {}

    def run_path(name, fn):
        """``fn()`` once between the launch counters (every path launches
        none of the seven kernels), printed as phase 8 prints them."""
        sync(dev)
        reset_counts()
        out = fn()
        sync(dev)
        counts = kernel_launches()
        print(f"{name}: launches {counts} (need none of the seven kernels)")
        if counts != NO_LAUNCHES:
            fail(f"{name}: a kernel launch on a path that makes none")
        paths[name] = fn
        results[name] = {"launches": counts}
        return out

    # ---- phase 25: the receivers, card against the CPU run ----------------------
    # the feedback receiver: differentially coded QPSK at sps 4, RRC span 8 /
    # beta 0.35, +800 ppm clock, CFO 1.1e-4 with a phase-noise walk, AWGN 1e-4
    rng = np.random.default_rng(815)
    sps = 4
    d_idx = rng.integers(0, 4, nsym).astype(np.int32)
    table = (mod.psk_table(4) * np.exp(1j * np.pi / 4)).astype(np.complex64)
    tx_idx = mod.differential_encode(torch.from_numpy(d_idx), 4).numpy()
    up = np.zeros(nsym * sps, np.complex64)
    up[::sps] = table[tx_idx]
    rrc = fir.rrc_taps(sps, span=8, beta=0.35)
    tx = fir.fir_filter(torch.from_numpy(up), rrc)
    q = 1249  # +800 ppm receive clock
    tx = sampling.resample_poly(tx[:(tx.shape[-1] // q) * q], 1250, q).numpy()
    n = tx.size
    walk = np.cumsum(rng.normal(scale=2e-3, size=n))
    rx = (tx * np.exp(1j * (2 * np.pi * 1.1e-4 * np.arange(n) + walk))).astype(np.complex64)
    rx = noise.new(1e-4, 815, device=cpu).apply(torch.from_numpy(rx))

    def feedback(x):
        mf = fir.fir_filter(x, rrc)
        strobes, tau = ts.gardner_loop(mf, sps=sps, loop_bw=0.01)
        tracked, phase, freq = ts.costas_loop(strobes, m=4, loop_bw=0.02)
        got = mod.differential_decode(mod.nearest_index(tracked, table), 4)
        return mf, strobes, tau, tracked, phase, freq, got

    rx_d = rx.to(dev)
    fb = run_path("feedback receiver", lambda: feedback(rx_d))
    fb_cpu = feedback(rx)
    got = fb[6].cpu().numpy()
    settle = 600
    best, shift = 0.0, 0
    for s in range(-20, 20):
        lo = max(settle, -s)
        nn = min(got.size - lo, nsym - lo - s)
        if nn < 100:
            continue
        agree = float(np.mean(got[lo:lo + nn] == d_idx[lo + s:lo + s + nn]))
        if agree > best:
            best, shift = agree, s
    same = bool(np.array_equal(got[settle:], fb_cpu[6].numpy()[settle:]))
    # each loop against its CPU run on the card's own input
    g_cpu = ts.gardner_loop(fb[0].cpu(), sps=sps, loop_bw=0.01)
    c_cpu = ts.costas_loop(fb[1].cpu(), m=4, loop_bw=0.02)
    errs = {"strobes": _max_err(fb[1], g_cpu[0]), "tau ulps": _ulps(fb[2].cpu(), g_cpu[1]),
            "costas y": _max_err(fb[3], c_cpu[0]), "phase": _max_err(fb[4], c_cpu[1]),
            "freq": _max_err(fb[5], c_cpu[2])}
    bars = {"strobes": GARDNER_ATOL, "tau ulps": GARDNER_ULPS, "costas y": COSTAS_Y_ATOL,
            "phase": COSTAS_ATOL, "freq": COSTAS_FREQ_ATOL}
    period = float(np.mean(np.diff(fb[2].cpu().numpy()[nsym // 3:5 * nsym // 6])))
    print(f"feedback receiver ({nsym} symbols, sps {sps}, {n} samples): symbol agreement after "
          f"the {settle}-symbol settle {best:.6f} (need > 0.999; alignment {shift:+d}), decisions "
          f"equal to the CPU run after the settle {same}; clock {period:.5f} samples/symbol "
          f"({(period / sps - 1) * 1e6:+.0f} ppm); loops vs their CPU run on the card's input: "
          + ", ".join(f"{k} {v:.3g} (need <= {bars[k]:g})" for k, v in errs.items()))
    if best <= 0.999 or not same or any(errs[k] > bars[k] for k in errs):
        fail("feedback receiver: agreement, the CPU run or a loop trace")

    # the GNSS tracking channel: PRN 13 at sps 2, 5 ppm, CFO 4e-5, noise 0.5
    rng = np.random.default_rng(42)
    chips01 = gps_ca_code(13)
    code = 1.0 - 2.0 * chips01.astype(np.float64)
    gsps, dwell = 2, 1023 * 2
    ng = (n_dwells + 3) * dwell
    s = np.arange(ng, dtype=np.float64)
    idx = np.floor((s - gsps) * (1 + 5e-6) / gsps).astype(np.int64) % 1023
    nav = rng.integers(0, 2, n_dwells // 20 + 3).astype(np.uint8)
    bit_of_dwell = (np.floor((s - gsps) / dwell).astype(np.int64) + 7) // 20
    xg = code[idx] * (1.0 - 2.0 * nav[bit_of_dwell % nav.size]) * np.exp(2j * np.pi * 4e-5 * s)
    xg = (xg + 0.5 * (rng.normal(size=ng) + 1j * rng.normal(size=ng))).astype(np.complex64)
    gsettle = 60

    def gnss(x):
        prompt, tau = ts.code_tracking_loop(x, chips01, sps=gsps, loop_bw=0.05, n_dwells=n_dwells)
        wiped, phase, freq = ts.carrier_tracking_loop(prompt)
        bits, off, quality = ts.nav_bit_sync(wiped[gsettle:], 20)
        return prompt, tau, wiped, phase, freq, bits, off, quality

    xg_d = up_dev(xg)
    gn = run_path("GNSS tracking channel", lambda: gnss(xg_d))
    gn_cpu = gnss(torch.from_numpy(xg))
    bits = gn[5].cpu().numpy()
    expect = nav[(np.arange(bits.size) * 20 + gsettle + int(gn[6]) + 7) // 20 % nav.size]
    agree = float((bits == expect).mean())
    agree = max(agree, 1 - agree)
    same = bool(np.array_equal(bits, gn_cpu[5].numpy()) and int(gn[6]) == int(gn_cpu[6]))
    d_cpu = ts.code_tracking_loop(torch.from_numpy(xg), chips01, sps=gsps, loop_bw=0.05,
                                  n_dwells=n_dwells)
    k_cpu = ts.carrier_tracking_loop(gn[0].cpu())
    scale = float(k_cpu[0].abs().mean())
    errs = {"prompt": _max_err(gn[0], d_cpu[0], 1023), "code tau": _max_err(gn[1], d_cpu[1]),
            "wiped": _max_err(gn[2], k_cpu[0], scale), "phase": _max_err(gn[3], k_cpu[1]),
            "freq": _max_err(gn[4], k_cpu[2])}
    bars = {"prompt": DLL_PROMPT_ATOL, "code tau": DLL_TAU_ATOL, "wiped": CARRIER_ATOL,
            "phase": CARRIER_PHASE_ATOL, "freq": CARRIER_FREQ_ATOL}
    f_hat = float(gn[4][-100:].mean()) / dwell
    print(f"GNSS tracking channel (PRN 13, {n_dwells} dwells of {dwell} samples): nav bits "
          f"{bits.size}, agreement up to polarity {agree:.4f} (need 1.0), edge offset "
          f"{int(gn[6])}, coherence {float(gn[7]):.4f}, carrier {f_hat:+.3e} cycles/sample (true "
          f"+4.00e-05); bits and offset equal to the CPU run {same}; loops vs their CPU run: "
          + ", ".join(f"{k} {v:.3g} (need <= {bars[k]:g})" for k, v in errs.items()))
    if agree != 1.0 or not same or any(errs[k] > bars[k] for k in errs):
        fail("GNSS tracking channel: nav bits, the CPU run or a loop trace")

    # the FM receiver: two stations through fm_mod -> Duc(x8) -> sum -> AWGN
    # 1e-5; receive station 0 (Ddc -> discriminator -> audio low-pass), with
    # de-emphasis (50 us at a 48 kHz channel rate) and a Butterworth low-pass
    ell, fm_dev = 8, 0.08
    stations = ((-0.29, 0.0037), (0.22, 0.0059))
    t = np.arange(n_chan)
    messages = [(0.7 * np.sin(2 * np.pi * fa * t) + 0.2 * np.sin(2 * np.pi * 2.7 * fa * t))
                .astype(np.float32) for _, fa in stations]
    hiss = noise.new(1e-5, 815, device=cpu).apply(torch.zeros(n_chan * ell, dtype=torch.complex64))
    lp = np.real(_design_lowpass(193, 6 * stations[0][1])).astype(np.complex64)
    deemph, butter = iir.fm_deemphasis_sos(50e-6 * 48000), iir.butter_sos(4, 0.05)

    def fm_tx(d):
        wide = hiss.to(d)
        for (carrier, _), msg in zip(stations, messages):
            base = analog.fm_mod(torch.from_numpy(msg).to(d), fm_dev)
            wide = wide + Duc(DucConfig(freq=carrier, interpolation=ell), device=d).step(base)
        return wide

    def fm_rx(wide, d):
        chan = Ddc(DdcConfig(freq=stations[0][0], decimation=ell), device=d).step(wide)
        audio = analog.fm_demod(chan, fm_dev)
        audio_f = fir.fir_filter(audio.to(torch.complex64), lp).real
        return audio, audio_f, iir.sosfilt(deemph, audio), iir.sosfilt(butter, audio)

    wide_d = fm_tx(dev)
    fm = run_path("FM receiver", lambda: fm_rx(wide_d, dev))
    wide_c = fm_tx(cpu)
    fm_cpu = fm_rx(wide_c, cpu)
    audio_f = fm[1].cpu().numpy()
    msg = messages[0]
    d = int(np.argmax(np.correlate(audio_f[:5000], msg[:4096], "valid")))
    a = audio_f[d + 256:d + min(24000, n_chan - 2000)]
    m = msg[256:256 + a.size]
    nmse = float(np.sqrt(np.mean((a - m) ** 2) / np.mean(m ** 2)))
    audio_h = fm[0].cpu().numpy().astype(np.float64)
    f64_de = scipy.signal.sosfilt(deemph, audio_h)
    f64_bw = scipy.signal.sosfilt(butter, audio_h)
    trunc_bw = audio_h  # the truncated-kernel cascade in float64 (the algorithm's own golden)
    for row in butter:
        h = iir._biquad_kernels(tuple(float(c) for c in row))[0]
        trunc_bw = np.convolve(trunc_bw, h)[:audio_h.size]
    blocks = fm[0].reshape(8, -1)
    st, parts = None, []
    for b in blocks:
        y, st = iir.sosfilt_stream(butter, b, st)
        parts.append(y)
    # the card against the CPU run past the DDC filter's fill: its first ~16
    # outputs are below 1e-4 of the carrier, where the discriminator reads
    # rounding (a 2 pi jump there on one side), and the filters' kernels
    # carry that on for a few hundred samples (examples/fm_radio.py skips 256)
    late = slice(512, None)
    dbs = {"wide": evm_db(wide_d.cpu(), wide_c),
           **{k: evm_db(v.cpu()[late], h[late]) for k, v, h in zip(
               ("audio", "audio LP", "de-emphasis", "butter"), fm, fm_cpu)}}
    fdb = {"de-emphasis vs f64 recursion": evm_db(fm[2].cpu().numpy(), f64_de),
           "butter vs f64 truncated cascade": evm_db(fm[3].cpu().numpy(), trunc_bw),
           "butter stream of 8 vs one-shot": evm_db(torch.cat(parts), fm[3])}
    bw_exact = evm_db(fm[3].cpu().numpy(), f64_bw)
    print(f"FM receiver ({n_chan} channel samples, x{ell} -> {n_chan * ell} wideband): station 0 "
          f"NMSE {100 * nmse:.3f}% (need < 5%), delay {d}; card vs CPU run (audio from sample "
          f"512) "
          + ", ".join(f"{k} {v:.2f}" for k, v in dbs.items()) + f" dB (need <= {LOOP_DB}); "
          + ", ".join(f"{k} {v:.2f}" for k, v in fdb.items()) + f" dB (need <= {LOOP_DB}); "
          f"butter(4, 0.05) vs the exact float64 recursion {bw_exact:.2f} dB (need <= "
          f"{IIR_TRUNC_DB}: the truncated kernel's floor, both packages)")
    if (nmse >= 0.05 or any(v > LOOP_DB for v in (*dbs.values(), *fdb.values()))
            or bw_exact > IIR_TRUNC_DB):
        fail("FM receiver: NMSE, the CPU run or an IIR gate")

    # the front end on one block: a balanced QPSK stream (each group of four
    # symbols the four points in a random order: I and Q uncorrelated and
    # equal in power exactly, so the blind estimate is held at 1%) at 20 dB
    # SNR, x0.06, IQ gain 1.08 / phase 0.04 rad, DC 0.013-0.008j
    rng = np.random.default_rng(6500)
    pts = np.array([1 + 1j, 1 - 1j, -1 + 1j, -1 - 1j], np.complex64) / np.sqrt(2)
    sym = pts[np.argsort(rng.random((fe_block // 4, 4)), axis=1)].reshape(-1)
    sigma = np.sqrt(0.5 * 10 ** (-20 / 10))
    clean = (sym + sigma * (rng.normal(size=fe_block) + 1j * rng.normal(size=fe_block))).astype(
        np.complex64)
    spikes = np.arange(1000, fe_block, 4099)
    rows, closed = 64, np.arange(64) % 3 == 0
    row_level = torch.from_numpy(np.where(closed, 0.1, 1.0).astype(np.float32))
    ntone, ktone = 1 << 16, 3001
    tone = (np.exp(2j * np.pi * ktone * np.arange(ntone) / ntone)
            + 0.01 * (rng.normal(size=ntone) + 1j * rng.normal(size=ntone))).astype(np.complex64)

    def front_end(x, tn):
        xi = fe.apply_iq_imbalance(0.06 * x, 1.08, 0.04) + (0.013 - 0.008j)
        y = fe.remove_dc(xi)
        g, ph = fe.estimate_iq_imbalance(y)
        y = fe.correct_iq_imbalance(y, g, ph)
        ya, ga = fe.agc(y, block=1024, alpha=0.5)
        y = fe.normalize_rms(y)
        imp = y.clone()
        imp[spikes] *= 40.0
        blanked[imp.device.type] = imp
        zero, clip = fe.impulse_blank(imp, 5.0, "zero"), fe.impulse_blank(imp, 5.0, "clip")
        gated, open_ = fe.squelch(y.reshape(rows, -1) * row_level.to(y.device)[:, None], -10.0)
        snr = fe.estimate_snr_m2m4(y)
        # a tone through the same front end, corrected with the block's
        # estimates (its own would also cancel its noise's image bin)
        ti = fe.apply_iq_imbalance(tn, 1.08, 0.04)
        tc = fe.correct_iq_imbalance(fe.remove_dc(ti), g, ph)
        irr = (fe.image_rejection_db(ti, ktone), fe.image_rejection_db(tc, ktone))
        return y, g, ph, ya, ga, zero, clip, gated, open_, snr, tc, irr

    blanked = {}  # the blankers' input on each device
    clean_d, tone_d = up_dev(clean), up_dev(tone)
    fr = run_path("front end", lambda: front_end(clean_d, tone_d))
    imp_d = blanked[dev.type]
    fr_cpu = front_end(torch.from_numpy(clean), torch.from_numpy(tone))
    imp_h = blanked["cpu"]
    g, ph = float(fr[1]), float(fr[2])
    zeroed = fr[5] == 0
    masks = {"blanked samples": bool(torch.equal(zeroed.cpu(), fr_cpu[5] == 0)),
             "clipped samples": bool(torch.equal((fr[6] != imp_d).cpu(), fr_cpu[6] != imp_h)),
             "squelch gate": bool(torch.equal(fr[8].cpu(), fr_cpu[8])),
             "spikes blanked": bool(zeroed.sum() == spikes.size and zeroed[spikes].all()),
             "gate pattern": fr[8].cpu().numpy().tolist() == (~closed).tolist()}
    dbs = {"conditioned": evm_db(fr[0].cpu(), fr_cpu[0]), "agc": evm_db(fr[3].cpu(), fr_cpu[3]),
           "blank": evm_db(fr[5].cpu(), fr_cpu[5]), "clip": evm_db(fr[6].cpu(), fr_cpu[6]),
           "squelch": evm_db(fr[7].cpu(), fr_cpu[7]), "tone": evm_db(fr[10].cpu(), fr_cpu[10])}
    rel = {"gain": abs(g / float(fr_cpu[1]) - 1), "phase": abs(ph / float(fr_cpu[2]) - 1),
           "agc gain": abs(float(fr[4]) / float(fr_cpu[4]) - 1),
           "snr": abs(float(fr[9]) / float(fr_cpu[9]) - 1),
           "irr before": abs(float(fr[11][0]) / float(fr_cpu[11][0]) - 1)}
    # the corrected tone's image is set by the estimate's ~3e-5 rad error,
    # which the estimate's last-place rounding moves by ~1e-3 of itself
    irr_after_db = abs(float(fr[11][1]) - float(fr_cpu[11][1]))
    irr_gain = float(fr[11][1]) - float(fr[11][0])
    est_ok = abs(g - 1.08) <= 0.01 * 1.08 and abs(ph - 0.04) <= 0.01 * 0.04
    print(f"front end ({fe_block} samples): IQ estimate gain {g:.5f} phase {ph:+.6f} (applied "
          f"1.08 / 0.04, need within 1%), AGC final gain {float(fr[4]):.4f} over "
          f"{fe_block // 1024} blocks, M2M4 SNR {10 * np.log10(float(fr[9])):.2f} dB (20 dB "
          f"applied), image rejection {float(fr[11][0]):.2f} -> {float(fr[11][1]):.2f} dB "
          f"(gain {irr_gain:.2f} dB, need >= 40); card vs CPU run: "
          + ", ".join(f"{k} {v:.2f} dB" for k, v in dbs.items()) + f" (need <= {LOOP_DB}), "
          + ", ".join(f"{k} {v:.2e}" for k, v in rel.items()) + f" (need <= {RTOL:g}), "
          f"image rejection after correction {irr_after_db:.2e} dB apart (need <= "
          f"{IRR_DB_APART}); equal: " + ", ".join(f"{k} {v}" for k, v in masks.items()))
    if (not est_ok or irr_gain < 40 or any(v > LOOP_DB for v in dbs.values())
            or any(v > RTOL for v in rel.values()) or irr_after_db > IRR_DB_APART
            or not all(masks.values())):
        fail("front end: an estimate, the image rejection, the CPU run or a mask")

    # MSK, GMSK (bt 0.3) and OQPSK loopbacks through the card, and the
    # detectors on four captures of noise (power 1) with bursts
    bits = torch.from_numpy(np.random.default_rng(7000).integers(0, 2, fsk_bits).astype(np.uint8))
    bits_d = bits.to(dev)
    modems = {"MSK": FskConfig(), "GMSK": FskConfig(bt=0.3)}
    def loopback(m):
        y = m.modulate(bits_d)
        return y, m.demodulate(y)

    def oqpsk_loopback():
        y = fsk.oqpsk_modulate(bits_d)
        return y, fsk.oqpsk_demodulate(y, fsk_bits)

    for label, cfg in modems.items():
        card_m, host_m = FskModem(cfg, device=dev), FskModem(cfg, device=cpu)
        y, got = run_path(f"{label} loopback", lambda m=card_m: loopback(m))
        hy = host_m.modulate(bits)
        exact = bool(torch.equal(got[:fsk_bits].cpu(), bits))
        same = bool(torch.equal(got.cpu(), host_m.demodulate(hy)))
        e = evm_db(y.cpu(), hy)
        print(f"{label} loopback ({fsk_bits} bits, sps {cfg.sps}, {y.shape[-1]} samples): bits "
              f"exact {exact}, equal to the CPU run {same}, samples vs the CPU run {e:.2f} dB "
              f"(need <= {LOOP_DB})")
        if not exact or not same or e > LOOP_DB:
            fail(f"{label} loopback")
    oy, og = run_path("OQPSK loopback", oqpsk_loopback)
    hy = fsk.oqpsk_modulate(bits)
    ok = (bool(torch.equal(og.cpu(), bits)), bool(torch.equal(og.cpu(), fsk.oqpsk_demodulate(
        hy, fsk_bits))), evm_db(oy.cpu(), hy))
    print(f"OQPSK loopback ({fsk_bits} bits, sps 4): bits exact {ok[0]}, equal to the CPU run "
          f"{ok[1]}, samples vs the CPU run {ok[2]:.2f} dB (need <= {LOOP_DB})")
    if not (ok[0] and ok[1]) or ok[2] > LOOP_DB:
        fail("OQPSK loopback")

    rng = np.random.default_rng(7100)
    caps = ((rng.normal(size=(5, capture)) + 1j * rng.normal(size=(5, capture))) / np.sqrt(2))
    bsym = (1.0 - 2.0 * rng.integers(0, 2, capture // 4)).astype(np.complex64)
    upb = np.zeros(capture, np.complex64)
    upb[::4] = bsym
    shaped = fir.fir_filter(torch.from_numpy(upb), fir.rrc_taps(4, span=6)).numpy()
    shaped /= np.sqrt(np.mean(np.abs(shaped) ** 2))
    spans = ((0, capture // 4, capture * 3 // 4, 10 ** 0.3), (1, capture // 2, capture, 1.0),
             (2, 0, capture, 10 ** (-0.5)))  # row, start, stop, signal power over noise
    for r, a0, a1, p in spans:
        caps[r, a0:a1] += np.sqrt(p) * shaped[a0:a1]
    caps[3] += 0.12 * np.exp(2j * np.pi * 0.1234 * np.arange(capture))  # a weak narrowband tone
    caps = caps.astype(np.complex64)
    rrc_stream = sampling.fractional_delay(torch.from_numpy(shaped), 0.3).numpy()
    nfr = 1024

    def detection(x, stream):
        det, power = detect.energy_detect(x, 1024, 1.0, 1e-3)
        spec = (torch.fft.fft(x.reshape(x.shape[0], -1, nfr), dim=-1).abs() ** 2).mean(dim=-2) / nfr
        cf, cn = detect.ca_cfar(spec, train=16, guard=2, pfa=1e-3)
        stat, rate = detect.cyclostationary_detect(x)
        return {"det": det, "power": power, "spec": spec, "cfar": cf, "noise": cn, "stat": stat,
                "rate": rate, "baud": ts.estimate_baud_rate(stream),
                "timing": ts.estimate_timing(stream, 4)}

    caps_d, stream_d = up_dev(caps), up_dev(rrc_stream)
    dt = {k: v.cpu() for k, v in run_path("detection", lambda: detection(caps_d, stream_d)).items()}
    dh = detection(torch.from_numpy(caps), torch.from_numpy(rrc_stream))
    det = dt["det"].numpy()
    inside = lambda a0, a1: slice(-(-a0 // 1024), a1 // 1024)  # noqa: E731
    found = all(det[r, inside(a0, a1)].all() for r, a0, a1, p in spans[:2])
    tone_bin = int(round(0.1234 * nfr))
    eq = {k: bool(torch.equal(dt[k], dh[k])) for k in ("det", "cfar", "rate")}
    rel = {k: float(((dt[k] - dh[k]).abs() / dh[k].abs()).max())
           for k in ("power", "spec", "stat", "baud")}
    # CFAR noise levels are differences of a float32 cumulative sum: held
    # within CFAR_EPS epsilons of a row's total per training cell, its floor
    i = np.arange(nfr)
    count = (np.clip(i - 2, 0, nfr) - np.clip(i - 18, 0, nfr) + np.clip(i + 19, 0, nfr)
             - np.clip(i + 3, 0, nfr))
    unit = np.finfo(np.float32).eps * dh["spec"].double().sum(-1).numpy()[:, None] / count
    cfar_eps = float(((dt["noise"] - dh["noise"]).abs().numpy() / unit).max())
    t_err = abs(float(dt["timing"]) - float(dh["timing"]))
    stat = dt["stat"].numpy()
    tone_hit = bool(dt["cfar"][3, tone_bin])
    phys = (found and tone_hit and stat[2] > 2 * stat[4] and abs(float(dt["rate"][2]) - 0.25) < 1e-3
            and abs(float(dt["baud"]) - 0.25) < 5e-4)
    print(f"detection (5 captures of {capture}): burst blocks found {found}, false alarms in the "
          f"noise-only row {int(det[4].sum())} of {det.shape[-1]}, CFAR on the {nfr}-bin averaged "
          f"periodogram finds the tone {tone_hit} ({int(dt['cfar'].sum())} cells fire), "
          f"cyclostationary statistic {', '.join(f'{v:.2f}' for v in stat)} (the -5 dB row "
          f"needs > 2x the noise row), its rate {float(dt['rate'][2]):.5f}, baud "
          f"{float(dt['baud']):.6f} (0.25), timing {float(dt['timing']):+.5f}; card vs CPU run: "
          + ", ".join(f"{k} equal {v}" for k, v in eq.items()) + ", "
          + ", ".join(f"{k} {v:.2e}" for k, v in rel.items()) + f" (need <= {RTOL:g}), CFAR "
          f"noise {cfar_eps:.2f} epsilons of the sum (need <= {CFAR_EPS}), timing {t_err:.2e} "
          f"(need <= {TIMING_ATOL:g})", flush=True)
    if (not (phys and all(eq.values())) or any(v > RTOL for v in rel.values())
            or cfar_eps > CFAR_EPS or t_err > TIMING_ATOL):
        fail("detection: a detector, or the card against the CPU run")

    # ---- phase 26: timings ---------------------------------------------------------
    for name, fn in paths.items():
        iters = 1 if name in ("feedback receiver", "GNSS tracking channel") else 5
        got = [cli.time_cuda(fn, iters, warmup=0) for _ in range(CROSS_RUNS)]
        ms = float(np.median(got))
        print(f"time: {name}: median {ms:.4f} ms a call (runs {', '.join(f'{v:.4f}' for v in got)}; "
              f"{iters} call(s) a run, CUDA events) [{card}]", flush=True)
        results[name].update({"ms": ms, **profile_calls(torch, fn, name, ms, card)})
    return results


def _cn(rng, *shape, scale=1.0):
    """Circular complex Gaussian samples of power ``scale ** 2``, complex64."""
    import numpy as np

    return (scale * (rng.normal(size=shape) + 1j * rng.normal(size=shape)) / np.sqrt(2)).astype(
        np.complex64)


def _ula_snapshots(rng, m: int, t_snap: int, degs, snr_db: float, coherent: bool = False):
    """Snapshots ``[m, t_snap]`` of unit-power sources at ``degs`` (degrees
    from broadside) on a half-wavelength ULA, with complex noise at
    ``snr_db`` per element; coherent sources are copies of one tone."""
    import numpy as np

    t = np.arange(t_snap)
    x = np.zeros((m, t_snap), np.complex128)
    base = np.exp(2j * np.pi * 0.0137 * t)
    for i, d in enumerate(degs):
        a = np.exp(-1j * np.pi * np.arange(m) * np.sin(np.deg2rad(d)))
        s = (base * (0.9 if i else 1.0) if coherent else
             np.exp(2j * np.pi * rng.uniform(0.01, 0.45) * t + 2j * np.pi * rng.uniform()))
        x += a[:, None] * s[None, :]
    return (x + _cn(rng, m, t_snap, scale=10 ** (-snr_db / 20))).astype(np.complex64)


def rls_f64(x, d, ntaps: int, delay: int, lam: float = 0.99, delta: float = 0.01):
    """``rls_equalize``'s recurrence in float64 (numpy): ``(y, w, err)``."""
    import numpy as np

    n = x.size
    xp = np.concatenate([np.zeros(ntaps - 1), x.astype(np.complex128)])
    rows = np.stack([xp[ntaps - 1 - t:ntaps - 1 - t + n] for t in range(ntaps)], axis=-1)
    m = min(d.size, n - delay)
    w = np.zeros(ntaps, np.complex128)
    p = np.eye(ntaps, dtype=np.complex128) / delta
    errs = []
    for u, dd in zip(rows[delay:delay + m], d[:m].astype(np.complex128)):
        pu = p @ u
        k = pu / (lam + np.sum(np.conj(u) * pu))
        e = dd - np.sum(np.conj(w) * u)
        w = w + k * np.conj(e)
        p = (p - k[:, None] * np.conj(pu)[None, :]) / lam
        errs.append(abs(e))
    return rows @ np.conj(w), np.conj(w), np.array(errs)


def acquisition_array_phases(card: str, device: str = "cuda", gps_ms: int = 4, n_prn: int = 32,
                             numerology=(2048, 144, 1200), ofdm_frames: int = 140,
                             ofdm_batch: int = 8, css=((12, 1024, -15.0), (7, 32768, -5.0)),
                             amc_bursts: int = 64, amc_len: int = 16384, doa_windows: int = 256,
                             doa_snaps: int = 1024, mimo_n: int = 1 << 20,
                             mimo_host: int = 1 << 16, div_n: int = 1 << 22,
                             eq_train: int = 1000, eq_len: int = 10000, fdaf_n: int = 1 << 18,
                             fhss_hops: int = 6400, runs: int = 3) -> dict:
    """Phases 27-28, the receivers of the OFDM, CSS, CAF, DOA, AMC, FHSS,
    equalizer and diversity models, each at the full width its users run:
    GNSS cold acquisition (``examples/gps_acquire.py`` at 4 ms of GPS L1 C/A
    sampled 4x the chip rate, all 32 PRNs, one device and sharded), the
    CP-OFDM burst receiver (``examples/ofdm.py`` at the LTE 20 MHz
    numerology, a batch of ``ofdm_batch`` captures) and Schmidl-Cox sync,
    the chirp modem at SF 12 and SF 7, the modulation classifier, the array
    receivers (a 16-element scan with MUSIC and Capon, a coherent pair with
    smoothing, the sharded scan, 2-D MUSIC on a 4x4 planar array,
    ``examples/beamform_rx.py``'s MVDR scene), 4x4 MIMO detection and the
    diversity combiners, the adaptive equalizers and the frequency hopper.
    Every path runs on ``device`` and again on the CPU from the same inputs
    (the MIMO detectors' CPU run on the first ``mimo_host`` symbol times),
    each against its own gate and the bars of its ``tests/test_torch_*.py``;
    none launches any of the seven kernels. Then each is timed and
    profiled. Returns ``{path: {"ms", "kernels", "idle", "launches"}}``."""
    import numpy as np
    import torch

    from aether_primitives_tpu_torch import cli
    from aether_primitives_tpu_torch.models import (
        OfdmConfig, OfdmModem, CssConfig, CssModem, PacketConfig, PacketModem,
    )
    from aether_primitives_tpu_torch.models import amc, caf, diversity, doa, equalizer, fhss, ofdm
    from aether_primitives_tpu_torch.models.sync import OfdmEqualizer, apply_freq_shift
    from aether_primitives_tpu_torch.ops import modulation as mod
    from aether_primitives_tpu_torch.ops.sequence import gps_ca_code, lte_gold
    from aether_primitives_tpu_torch.parallel import mesh as mesh_mod

    dev, cpu = torch.device(device), torch.device("cpu")
    up_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    results, paths = {}, {}

    def run_path(name, fn):
        """``fn()`` once between the launch counters (none of the seven
        kernels may launch), as phase 25 runs its paths."""
        sync(dev)
        reset_counts()
        out = fn()
        sync(dev)
        counts = kernel_launches()
        print(f"{name}: launches {counts} (need none of the seven kernels)")
        if counts != NO_LAUNCHES:
            fail(f"{name}: a kernel launch on a path that makes none")
        paths[name] = fn
        results[name] = {"launches": counts}
        return out

    t_start = time.perf_counter()

    # ---- phase 27: the receivers, card against the CPU run ----------------------
    # GNSS cold acquisition: 4 ms of GPS L1 C/A at 4 samples a chip (4.092
    # Msps), three satellites at -20 dB per sample for the strongest
    # (examples/gps_acquire.py's scene), all 32 PRNs searched over +-1.25e-3
    # cycles/sample (+-5.1 kHz) in 64 Doppler hypotheses
    rng = np.random.default_rng(21)
    spc = 4
    n = 1023 * spc * gps_ms
    period = 1023 * spc  # the code repeats every 1 ms: delays are taken modulo it
    truth = {7: (1520, 2.4e-4, 1.0), 13: (2318, -4.4e-4, 0.8), 29: (3070, 7.8e-4, 0.6)}
    refs = {p: np.tile(np.repeat(1.0 - 2.0 * gps_ca_code(p).astype(np.float32), spc), gps_ms)
            .astype(np.complex64) for p in range(1, n_prn + 1)}
    t = np.arange(n)
    xg = np.zeros(n, np.complex128)
    for prn, (tau, fd, amp) in truth.items():
        xg += amp * np.roll(refs[prn], tau) * np.exp(2j * np.pi * fd * t)
    xg = (xg + _cn(rng, n, scale=10.0)).astype(np.complex64)
    refs_d = {p: up_dev(r) for p, r in refs.items()}
    xg_d = up_dev(xg)

    def acquire(x, rs):
        return {p: caf.estimate_delay_doppler(x, r, max_doppler=ACQ_MAX_DOPPLER,
                                              n_dopplers=ACQ_DOPPLERS) for p, r in rs.items()}

    acq = {p: tuple(v.cpu() for v in est)
           for p, est in run_path("GNSS acquisition", lambda: acquire(xg_d, refs_d)).items()}
    acq_h = acquire(torch.from_numpy(xg), {p: torch.from_numpy(r) for p, r in refs.items()})
    found = {p: e for p, e in acq.items() if float(e[2]) * n > ACQ_THRESHOLD}
    exact = set(found) == set(truth) and all(
        abs((float(found[p][0]) - truth[p][0] + period / 2) % period - period / 2) < 0.5
        and abs(float(found[p][1]) - truth[p][1]) < 2e-5 for p in truth)
    # the reference repeats the code gps_ms times, so the surface repeats
    # every code period in delay: its gps_ms peaks are equal in exact
    # arithmetic, and rounding picks one; delays compare modulo the period
    errs = {"delay": max(abs((float(acq[p][0]) - float(acq_h[p][0]) + period / 2) % period
                             - period / 2) for p in acq),
            "doppler": max(abs(float(acq[p][1]) - float(acq_h[p][1])) for p in acq),
            "metric": max(abs(float(acq[p][2]) / float(acq_h[p][2]) - 1) for p in acq)}
    bars = {"delay": CAF_DELAY_ATOL, "doppler": CAF_DOPPLER_ATOL, "metric": CAF_METRIC_RTOL}
    acq_mesh = mesh_mod.make_mesh({"time": 4}, [dev] * 4)
    acq_s = {p: tuple(v.cpu() for v in est) for p, est in run_path(
        "GNSS acquisition, sharded", lambda: {p: caf.sharded_estimate_delay_doppler(
            xg_d, r, ACQ_MAX_DOPPLER, acq_mesh, ACQ_DOPPLERS) for p, r in refs_d.items()}).items()}
    same_s = all(all(torch.equal(a, b) for a, b in zip(acq_s[p], acq[p])) for p in acq)
    nu = caf._doppler_grid(ACQ_MAX_DOPPLER, ACQ_DOPPLERS)
    surf_1 = caf.ambiguity(xg_d, refs_d[7], nu)
    surf_s = caf.sharded_ambiguity(xg_d, refs_d[7], nu, acq_mesh).gather()
    surf_eq = bool(torch.equal(surf_s, surf_1))
    print(f"GNSS acquisition ({n} samples = {gps_ms} ms at {spc} samples a chip, {n_prn} PRNs x "
          f"{ACQ_DOPPLERS} Dopplers): acquired " + ", ".join(
              f"PRN {p} delay {float(e[0]):.3f} doppler {float(e[1]):+.4e} metric*N "
              f"{float(e[2]) * n:.1f}" for p, e in sorted(found.items()))
          + f" (truth {truth}; need exactly these, delay modulo {period} within 0.5, Doppler "
          f"within 2e-5); "
          f"the strongest PRN left {max(float(e[2]) * n for p, e in acq.items() if p not in truth):.1f}"
          f" (threshold {ACQ_THRESHOLD}); card vs CPU run over all PRNs: " + ", ".join(
              f"{k} {v:.3g} (need <= {bars[k]:g})" for k, v in errs.items())
          + f"; sharded over {{time: 4}} on {acq_mesh.devices.flat[0]}: estimates equal to the "
          f"one-device run {same_s}, PRN 7's surface torch.equal {surf_eq} "
          f"({evm_db(surf_s, surf_1):.2f} dB)", flush=True)
    if not exact or any(errs[k] > bars[k] for k in errs) or not same_s:
        fail("GNSS acquisition: the acquired set, the CPU run or the sharded run")

    # CP-OFDM at the LTE 20 MHz numerology: a Schmidl-Cox preamble, a pilot
    # and ofdm_frames - 1 data symbols of 64QAM, then the transmission goes
    # on (two more symbols); examples/ofdm.py's channel (unknown delay,
    # 20-tap multipath inside the CP, CFO within +-2e-4, AWGN 1e-5); a batch
    # of ofdm_batch captures. cp_sync gives the symbol timing, sc_sync the
    # frame and the CFO: cp_sync's own CFO, whose folded CP window takes in
    # the multipath's 19 samples of ISI, is off by up to ~2e-7 cycles/sample,
    # which turns 64QAM by ~11 degrees over 139 symbols (ROADMAP.md §3.18)
    fft_len, cp_len, active = numerology
    cfg = OfdmConfig(fft_len=fft_len, cp_len=cp_len, active_bins=active, modulation="qam64")
    om, om_h = OfdmModem(cfg, device=dev), OfdmModem(cfg, device=cpu)
    sym, bpf = cfg.symbol_len, om.bits_per_frame()
    rng = np.random.default_rng(2026)
    pilot_bits = np.asarray(lte_gold(0x5A5, bpf)).astype(np.uint8)
    data = rng.integers(0, 2, (ofdm_batch, (ofdm_frames - 1) * bpf)).astype(np.uint8)
    more = rng.integers(0, 2, (ofdm_batch, 2 * bpf)).astype(np.uint8)
    tx = om_h.modulate(torch.from_numpy(np.concatenate(
        [np.broadcast_to(pilot_bits, (ofdm_batch, bpf)), data, more], axis=1))).numpy()
    tx_card = om.modulate(up_dev(np.concatenate([pilot_bits, data[0], more[0]])))
    tx_db = evm_db(tx_card.cpu(), tx[0])
    pre = ofdm.sc_preamble(cfg)
    h = np.zeros(20, np.complex64)
    h[0], h[6], h[19] = 1.0, 0.4j, -0.25 + 0.1j
    delays = rng.integers(100, 2000, ofdm_batch)
    cfos = rng.uniform(-2e-4, 2e-4, ofdm_batch)
    length = 2000 + (ofdm_frames + 1) * sym + h.size - 1 + 64
    caps = np.zeros((ofdm_batch, length), np.complex64)
    for i in range(ofdm_batch):
        rx_i = np.convolve(np.concatenate([pre, tx[i]]), h)[:length - delays[i]]
        caps[i, delays[i]:delays[i] + rx_i.size] = rx_i
    caps = (caps * np.exp(2j * np.pi * cfos[:, None] * np.arange(length))
            + _cn(rng, ofdm_batch, length, scale=np.sqrt(1e-5))).astype(np.complex64)
    pilot_syms = om_h.modulation.modulate(torch.from_numpy(pilot_bits)).reshape(1, -1)

    def ofdm_sync(x):
        off, cfo_cp = ofdm.cp_sync(x, cfg)
        pre_off, cfo = ofdm.sc_sync(x, cfg)
        return off, cfo_cp, pre_off, cfo

    def ofdm_demod(x, m, off, pre_off, cfo):
        fixed = apply_freq_shift(x, cfo)
        # the pilot: the symbol boundary (cp_sync) nearest one symbol past
        # the preamble's start (sc_sync); one host read for the batch
        o, so = torch.stack([off, pre_off]).cpu().tolist()
        starts = [a + round((b - cp_len + sym - a) / sym) * sym for a, b in zip(o, so)]
        seg = torch.stack([fixed[i, s:s + ofdm_frames * sym] for i, s in enumerate(starts)])
        spec = m.spectra(seg)
        h_hat = OfdmEqualizer.estimate(spec[:, :1], pilot_syms.to(spec.device))
        eq = OfdmEqualizer.apply(spec[:, 1:], h_hat)
        return starts, eq, m.modulation.demod(eq).reshape(x.shape[0], -1)

    def ofdm_rx(x, m):
        sy = ofdm_sync(x)
        return sy, ofdm_demod(x, m, sy[0], sy[2], sy[3])

    caps_d = up_dev(caps)
    (off, cfo_cp, pre_off, cfo), (starts, eq, got) = run_path(
        "CP-OFDM receiver", lambda: ofdm_rx(caps_d, om))
    caps_h = torch.from_numpy(caps)
    sy_h = ofdm_sync(caps_h)
    # the CPU's demodulation from the card's sync: a CFO apart in its last
    # place turns the late symbols by ~1e-4 rad, which the one pilot does
    # not take out
    dm_h = ofdm_demod(caps_h, om_h, off.cpu(), pre_off.cpu(), cfo.cpu())
    bits_ok = bool(np.array_equal(got.cpu().numpy(), data))
    offs_ok = (off.cpu().tolist() == [int(d) % sym for d in delays]
               and starts == [int(d) + sym for d in delays]
               and int((pre_off.cpu() - torch.from_numpy(delays + cp_len)).abs().max()) <= h.size)
    same = (torch.equal(off.cpu(), sy_h[0]) and torch.equal(pre_off.cpu(), sy_h[2])
            and starts == dm_h[0] and torch.equal(got.cpu(), dm_h[2]))
    cfo_err = max(float((a.cpu() - b).abs().max()) for a, b in ((cfo_cp, sy_h[1]), (cfo, sy_h[3])))
    eq_db = evm_db(eq.cpu(), dm_h[1])
    miss = {name: float(np.abs(v.cpu().numpy() - cfos).max())
            for name, v in (("cp_sync", cfo_cp), ("sc_sync", cfo))}
    print(f"CP-OFDM receiver ({ofdm_batch} captures of {length} samples: fft_len {fft_len}, cp "
          f"{cp_len}, {active} active bins, 64QAM, preamble + 1 pilot + {ofdm_frames - 1} data "
          f"symbols = {data.shape[1]} data bits each): bits exact {bits_ok}; cp_sync offsets, "
          f"frame starts and sc_sync offsets (within {h.size}) right {offs_ok}; CFO error vs "
          f"truth " + ", ".join(f"{k} {v:.2e}" for k, v in miss.items()) + f"; card vs CPU run: "
          f"offsets, starts and bits equal {same}, CFOs {cfo_err:.2e} (need <= {CFO_ATOL:g}), "
          f"equalized spectra from the card's sync {eq_db:.2f} dB (need <= {LOOP_DB}); TX on "
          f"the card vs the CPU {tx_db:.2f} dB (need <= {LOOP_DB})", flush=True)
    if not (bits_ok and offs_ok and same) or cfo_err > CFO_ATOL or max(eq_db, tx_db) > LOOP_DB:
        fail("CP-OFDM receiver: bits, offsets or the CPU run")

    # the chirp modem: SF 12 and SF 7 at 4,194,304 chips each
    for sf, nsym, snr_db in css:
        cm, cm_h = CssModem(CssConfig(sf=sf), device=dev), CssModem(CssConfig(sf=sf), device=cpu)
        rng = np.random.default_rng(sf)
        bits = rng.integers(0, 2, sf * nsym).astype(np.uint8)
        bits_d = up_dev(bits)
        chips_h = cm_h.tx(torch.from_numpy(bits))
        noise = _cn(rng, chips_h.shape[-1], scale=10 ** (-snr_db / 20))
        noisy_d = cm.tx(bits_d) + up_dev(noise)
        chips, got = run_path(f"CSS SF {sf}", lambda m=cm, b=bits_d, x=noisy_d: (m.tx(b), m.rx(x)))
        got_h = cm_h.rx(chips_h + torch.from_numpy(noise))
        c_db = evm_db(chips.cpu(), chips_h)
        ok = bool(np.array_equal(got.cpu().numpy(), bits))
        same = bool(torch.equal(got.cpu(), got_h))
        print(f"CSS SF {sf} ({nsym} symbols, {chips.shape[-1]} chips, {snr_db:+.0f} dB a chip): "
              f"bits exact {ok}; card vs CPU run: chips {c_db:.2f} dB (need <= {LOOP_DB}), bits "
              f"equal {same}")
        if not (ok and same) or c_db > LOOP_DB:
            fail(f"CSS SF {sf}")

    # the modulation classifier: amc_bursts bursts of each class at 18 dB,
    # CFO removed, a random phase each
    rng = np.random.default_rng(1800)
    mods = {"bpsk": mod.bpsk(), "qpsk": mod.qpsk(), "psk8": mod.psk(8), "qam16": mod.qam16(),
            "qam64": mod.qam(64)}
    labels = [name for name in mods for _ in range(amc_bursts)]
    rows = []
    for name in labels:
        m = mods[name]
        s = m.modulate(torch.from_numpy(
            rng.integers(0, 2, amc_len * m.bits_per_symbol).astype(np.uint8))).numpy()
        sigma = np.sqrt(np.mean(np.abs(s) ** 2) / 10 ** 1.8)
        rows.append((s + _cn(rng, amc_len, scale=sigma)) * np.exp(2j * np.pi * rng.uniform()))
    xa = np.stack(rows).astype(np.complex64)
    xa_d = up_dev(xa)
    names, scores = run_path("AMC", lambda: amc.classify_modulation(xa_d))
    names_h, scores_h = amc.classify_modulation(torch.from_numpy(xa))
    feat_err = float(np.max(np.abs(amc.cumulant_features(xa_d).cpu().numpy()
                                   - amc.cumulant_features(torch.from_numpy(xa)).numpy())))
    acc = {k: sum(g == k for g, w in zip(names, labels) if w == k) / amc_bursts for k in mods}
    score_ok = bool(np.allclose(scores, scores_h, rtol=AMC_RTOL, atol=AMC_ATOL))
    psk_ok = all(acc[k] == 1.0 for k in ("bpsk", "qpsk", "psk8"))
    print(f"AMC ([{xa.shape[0]}, {amc_len}] symbols, 18 dB): accuracy " + ", ".join(
        f"{k} {v:.4f}" for k, v in acc.items()) + f" (BPSK/QPSK/8PSK need 1.0); card vs CPU run: "
          f"names equal {names == names_h}, scores within rtol {AMC_RTOL:g} / atol {AMC_ATOL:g} "
          f"{score_ok}, features max abs difference {feat_err:.2e}", flush=True)
    if names != names_h or not score_ok or not psk_ok:
        fail("AMC: the names, the scores or a PSK class")

    # the array receivers: a 16-element ULA scan of doa_windows windows of
    # doa_snaps snapshots, two sources a window at 10 dB
    rng = np.random.default_rng(1600)
    degs = np.stack([np.linspace(-50.0, -10.0, doa_windows), np.linspace(5.0, 45.0, doa_windows)],
                    axis=1)
    xw = np.stack([_ula_snapshots(rng, 16, doa_snaps, d, 10.0) for d in degs])
    xw_d = up_dev(xw)
    scan = {}
    for method, tol in (("music", 0.5), ("capon", 1.0)):
        got = run_path(f"DOA scan, {method}", lambda m=method: doa.estimate_doa(xw_d, 2, method=m))
        want = doa.estimate_doa(torch.from_numpy(xw), 2, method=method)
        miss = float(np.abs(np.rad2deg(got.cpu().numpy()) - degs).max())
        err = float((got.cpu() - want).abs().max())
        scan[method] = got
        print(f"DOA scan {method} ({doa_windows} windows x 16 elements x {doa_snaps} snapshots): "
              f"bearings within {miss:.3f} deg of the sources (need < {tol}); card vs CPU run "
              f"{err:.2e} rad (need <= {BEARING_ATOL:g})")
        if miss >= tol or err > BEARING_ATOL:
            fail(f"DOA scan {method}")
    r8 = doa.covariance(xw_d[:8])
    sp, sp_h = doa.music_spectrum(r8, 2)[1], doa.music_spectrum(r8.cpu(), 2)[1]
    sp_err = float(((sp.cpu() - sp_h).abs() / sp_h.abs()).max())
    doa_mesh = mesh_mod.make_mesh({"channel": 4}, [dev] * 4)
    sh = run_path("DOA scan, sharded",
                  lambda: doa.sharded_estimate_doa(xw_d, 2, doa_mesh).gather())
    sh_eq = bool(torch.equal(sh, scan["music"]))
    sh_err = float((sh - scan["music"]).abs().max())
    print(f"DOA: MUSIC spectra of 8 windows on the card vs on the CPU (the same covariance) rtol "
          f"{sp_err:.2e} (need <= {SPEC_RTOL:g}); sharded over {{channel: 4}} on "
          f"{doa_mesh.devices.flat[0]}: torch.equal to the one-device scan {sh_eq} (max "
          f"{sh_err:.2e} rad)")
    if sp_err > SPEC_RTOL or sh_err > BEARING_ATOL:
        fail("DOA: the spectra or the sharded scan")
    xc = np.stack([_ula_snapshots(rng, 16, doa_snaps, (-20.0, 25.0), 20.0, coherent=True)
                   for _ in range(32)])
    xc_d = up_dev(xc)
    co = run_path("DOA coherent pair", lambda: doa.estimate_doa(xc_d, 2, smoothing=4))
    co_h = doa.estimate_doa(torch.from_numpy(xc), 2, smoothing=4)
    miss = float(np.abs(np.rad2deg(co.cpu().numpy()) - [-20.0, 25.0]).max())
    err = float((co.cpu() - co_h).abs().max())
    print(f"DOA coherent pair (32 windows, smoothing 4): within {miss:.3f} deg (need < 1.5); card "
          f"vs CPU run {err:.2e} rad (need <= {BEARING_ATOL:g})")
    if miss >= 1.5 or err > BEARING_ATOL:
        fail("DOA coherent pair")
    # 2-D MUSIC: a 4x4 planar array (x-z plane, half a wavelength apart)
    pos = np.array([[0.5 * i, 0.0, 0.5 * j] for i in range(4) for j in range(4)])
    src = [(np.deg2rad(-15.0), np.deg2rad(10.0)), (np.deg2rad(30.0), np.deg2rad(-20.0))]
    tt = np.arange(doa_snaps)
    x2 = np.zeros((16, doa_snaps), np.complex128)
    for az0, el0 in src:
        a = doa.steering_vector_pos(pos, az0, el0).numpy()
        x2 += a[:, None] * np.exp(2j * np.pi * rng.uniform(0.05, 0.45) * tt)[None, :]
    x2 = (x2 + _cn(rng, 16, doa_snaps, scale=0.2)).astype(np.complex64)
    x2_d = up_dev(x2)
    p2 = run_path("DOA 2-D MUSIC", lambda: doa.estimate_doa_2d(x2_d, 2, pos))
    p2_h = doa.estimate_doa_2d(torch.from_numpy(x2), 2, pos)
    miss = float(np.abs(np.rad2deg(p2.cpu().numpy()) - np.rad2deg(sorted(src))).max())
    err = float((p2.cpu() - p2_h).abs().max())
    print(f"DOA 2-D MUSIC (4x4 planar, 181 x 61 grid): (az, el) within {miss:.3f} deg (need < "
          f"2.5); card vs CPU run {err:.2e} rad (need <= {BEARING_ATOL:g})")
    if miss >= 2.5 or err > BEARING_ATOL:
        fail("DOA 2-D MUSIC")
    # examples/beamform_rx.py: 8 elements, a jammer 12 dB stronger; MUSIC
    # bearings, MVDR toward each, the packet decoded by the CRC's verdict
    rng = np.random.default_rng(11)
    pm, pm_h = (PacketModem(PacketConfig(payload_bits=256, fec="ldpc11n"), device=d)
                for d in (dev, cpu))
    payload = rng.integers(0, 2, 256).astype(np.uint8)
    burst = pm_h.tx(torch.from_numpy(payload)).numpy()
    nb = burst.size * 3
    s_pkt = np.zeros(nb, np.complex64)
    s_pkt[421:421 + burst.size] = burst
    jam = 4.0 * np.exp(2j * np.pi * 0.083 * np.arange(nb) + 2j * np.pi * rng.uniform())
    a_pkt = doa.steering_vector(8, np.deg2rad(18.0)).numpy()
    a_jam = doa.steering_vector(8, np.deg2rad(-30.0)).numpy()
    xb = (a_pkt[:, None] * s_pkt + a_jam[:, None] * jam
          + 0.05 * (rng.normal(size=(8, nb)) + 1j * rng.normal(size=(8, nb)))).astype(np.complex64)

    def array_rx(x, m):
        est = doa.estimate_doa(x, 2, method="music")
        r = doa.covariance(x)
        out = []
        for i in range(2):
            w = doa.mvdr_weights(r, est[i])
            y = torch.matmul(w.conj()[None, :], x)[0]
            out.append((w, *m.rx(y)))
        return est, out

    xb_d = up_dev(xb)
    bf = run_path("array receiver (MVDR + packet)", lambda: array_rx(xb_d, pm))
    bf_h = array_rx(torch.from_numpy(xb), pm_h)
    oks = [bool(o[2]) for o in bf[1]]
    decoded = [o[1].cpu().numpy() for o in bf[1] if bool(o[2])]
    exact = len(decoded) == 1 and np.array_equal(decoded[0], payload)
    same = all(bool(o[2]) == bool(oh[2]) and torch.equal(o[1].cpu(), oh[1])
               for o, oh in zip(bf[1], bf_h[1]))
    b_err = float((bf[0].cpu() - bf_h[0]).abs().max())
    w_db = max(evm_db(o[0].cpu(), oh[0]) for o, oh in zip(bf[1], bf_h[1]))
    y_db = max(evm_db(torch.matmul(o[0].cpu().conj()[None, :], torch.from_numpy(xb))[0],
                      torch.matmul(oh[0].conj()[None, :], torch.from_numpy(xb))[0])
               for o, oh in zip(bf[1], bf_h[1]))
    print(f"array receiver (8 elements, jammer +12 dB): MUSIC bearings "
          f"{np.rad2deg(bf[0].cpu().numpy()).round(2).tolist()} deg (-30, 18), CRC per bearing "
          f"{oks}, payload exact {exact}; card vs CPU run: bearings {b_err:.2e} rad (need <= "
          f"{BEARING_ATOL:g}), MVDR weights {w_db:.2f} dB (need <= {MVDR_DB}), their beams "
          f"{y_db:.2f} dB, payloads and verdicts equal {same}", flush=True)
    if not (exact and same) or b_err > BEARING_ATOL or w_db > MVDR_DB:
        fail("array receiver")

    # 4x4 spatial multiplexing of QPSK, a Rayleigh H per symbol time, 20 dB
    rng = np.random.default_rng(44)
    hm = _cn(rng, mimo_n, 4, 4)
    sm_bits = rng.integers(0, 2, (mimo_n, 8)).astype(np.uint8)
    q = mod.qpsk()
    sm = q.modulate(torch.from_numpy(sm_bits)).numpy() / np.sqrt(2)
    ym = (np.einsum("nij,nj->ni", hm, sm) + _cn(rng, mimo_n, 4, scale=0.1)).astype(np.complex64)
    hm_d, ym_d = up_dev(hm), up_dev(ym)

    def mimo(y, hh):
        return (diversity.mimo_detect_zf(y, hh), diversity.mimo_detect_mmse(y, hh, 0.01),
                diversity.mimo_stream_snr(hh, 0.01))

    zf, mm, snr = run_path("MIMO 4x4 ZF / MMSE / SNR", lambda: mimo(ym_d, hm_d))
    k = mimo_host
    zf_h, mm_h, snr_h = mimo(torch.from_numpy(ym[:k]), torch.from_numpy(hm[:k]))
    good = np.linalg.cond(hm[:k]) < 100
    g = torch.from_numpy(good)
    dbs = {"zf": evm_db(zf[:k].cpu()[g], zf_h[g]), "mmse": evm_db(mm[:k].cpu()[g], mm_h[g]),
           "snr": evm_db(snr[:k].cpu()[g], snr_h[g])}
    ber = {name: float((q.demod(v.reshape(-1)).cpu().numpy() != sm_bits.reshape(-1)).mean())
           for name, v in (("zf", zf), ("mmse", mm))}
    dec_same = bool(torch.equal(q.demod(zf[:k].cpu()[g]), q.demod(zf_h[g])))
    print(f"MIMO 4x4 ({mimo_n} symbol times, a Rayleigh H each, 20 dB): BER ZF {ber['zf']:.4e}, "
          f"MMSE {ber['mmse']:.4e} (MMSE must not exceed ZF); card vs CPU run on the first {k} "
          f"symbol times, the {int(good.sum())} with cond(H) < 100: " + ", ".join(
              f"{kk} {v:.2f} dB" for kk, v in dbs.items()) + f" (need <= {MIMO_DB}), ZF decisions "
          f"equal {dec_same}", flush=True)
    if ber["mmse"] > ber["zf"] or any(v > MIMO_DB for v in dbs.values()) or not dec_same:
        fail("MIMO detectors")

    # MRC / EGC / selection over 4 branches x div_n samples (a Rayleigh gain
    # a branch every 1,024 samples, 5 dB a branch), and Alamouti over div_n
    # symbols (a channel pair every 2,048)
    rng = np.random.default_rng(45)
    blocks = div_n // 1024
    hd = _cn(rng, blocks, 4, 1)
    sd_bits = rng.integers(0, 2, (blocks, 1, 2048)).astype(np.uint8)
    sd = q.modulate(torch.from_numpy(sd_bits)).numpy() / np.sqrt(2)
    yd = (hd * sd + _cn(rng, blocks, 4, 1024, scale=10 ** (-5 / 20))).astype(np.complex64)
    hd_d, yd_d = up_dev(hd), up_dev(yd)

    def combine(y, hh):
        return (diversity.mrc_combine(y, hh), diversity.egc_combine(y, hh),
                diversity.selection_combine(y, hh))

    comb = run_path("diversity combiners", lambda: combine(yd_d, hd_d))
    comb_h = combine(torch.from_numpy(yd), torch.from_numpy(hd))
    ref_bits = sd_bits.reshape(-1)
    ber = {name: float((q.demod(v.reshape(-1)).cpu().numpy() != ref_bits).mean())
           for name, v in zip(("mrc", "egc", "selection"), comb)}
    ber["one branch"] = float((q.demod(torch.from_numpy(yd[:, 0] / hd[:, 0])).numpy().reshape(-1)
                               != ref_bits).mean())
    dbs = {name: evm_db(v.cpu(), vh) for name, v, vh in zip(("mrc", "egc", "selection"), comb,
                                                            comb_h)}
    rng = np.random.default_rng(46)
    sa_bits = rng.integers(0, 2, (div_n // 2048, 4096)).astype(np.uint8)
    sa = q.modulate(torch.from_numpy(sa_bits)).numpy() / np.sqrt(2)
    h0, h1 = _cn(rng, div_n // 2048), _cn(rng, div_n // 2048)
    noise_a = _cn(rng, div_n // 2048, 2048, scale=0.1)
    sa_d, h0_d, h1_d, na_d = up_dev(sa), up_dev(h0), up_dev(h1), up_dev(noise_a)

    def alamouti(s, g0, g1, w):
        txa = diversity.alamouti_encode(s)
        r = g0[:, None] * txa[:, 0] + g1[:, None] * txa[:, 1] + w
        return txa, diversity.alamouti_decode(r, g0, g1)

    al = run_path("Alamouti", lambda: alamouti(sa_d, h0_d, h1_d, na_d))
    al_h = alamouti(*(torch.from_numpy(a) for a in (sa, h0, h1, noise_a)))
    ber["alamouti"] = float((q.demod(al[1].reshape(-1)).cpu().numpy()
                             != sa_bits.reshape(-1)).mean())
    dbs["alamouti tx"] = evm_db(al[0].cpu(), al_h[0])
    dbs["alamouti"] = evm_db(al[1].cpu(), al_h[1])
    print(f"diversity (4 x {div_n} samples at 5 dB a branch; Alamouti {div_n} symbols at 20 "
          f"dB): BER " + ", ".join(f"{kk} {v:.4e}" for kk, v in ber.items()) + " (MRC must beat "
          f"one branch tenfold); card vs CPU run " + ", ".join(
              f"{kk} {v:.2f} dB" for kk, v in dbs.items()) + f" (need <= {LOOP_DB})", flush=True)
    if ber["mrc"] * 10 > ber["one branch"] or any(v > LOOP_DB for v in dbs.values()):
        fail("diversity: the combiners' gain or the CPU run")

    # the adaptive equalizers: QPSK (unit modulus) through a 5-tap ISI
    # channel at noise 1e-3; LMS (11 taps) trained on eq_train symbols then
    # decision-directed over eq_len, CMA over eq_len, RLS trained on 200,
    # FDAF (64 taps) over fdaf_n samples (identifying the channel's inverse
    # at a delay of 8)
    rng = np.random.default_rng(5000)
    ch5 = np.array([0.2j, 1.0, 0.45, -0.25 + 0.15j, 0.1], np.complex64)
    ne = max(eq_train + eq_len, fdaf_n)
    e_bits = rng.integers(0, 2, 2 * ne).astype(np.uint8)
    txe = (q.modulate(torch.from_numpy(e_bits)).numpy() / np.sqrt(2)).astype(np.complex64)
    xe = (np.convolve(txe, ch5)[:ne] + _cn(rng, ne, scale=np.sqrt(1e-3))).astype(np.complex64)
    table = (q.table / np.sqrt(2)).astype(np.complex64)
    dly = 4
    spike = np.zeros(11, np.complex64)  # CMA starts from a spike ahead of the main tap
    spike[3] = 1.0

    def equalizers(x, d):
        lms = equalizer.lms_equalize(x[:eq_train], d[:eq_train], ntaps=11, mu=0.4, delay=dly)
        dd = equalizer.dd_equalize(x[eq_train:eq_train + eq_len], table, ntaps=11, mu=0.05,
                                   w0=lms[1])
        cma = equalizer.cma_equalize(x[:eq_len], ntaps=11, mu=0.02, w0=spike)
        rls = equalizer.rls_equalize(x[:eq_train + eq_len], d[:200], ntaps=11, delay=dly)
        dd8 = torch.nn.functional.pad(d[:fdaf_n - 8], (8, 0))
        fd = equalizer.fdaf(x[:fdaf_n], dd8, ntaps=64)
        return lms, dd, cma, rls, fd

    xe_d, txe_d = up_dev(xe), up_dev(txe)
    eqs = run_path("adaptive equalizers", lambda: equalizers(xe_d, txe_d))
    eqs_h = equalizers(torch.from_numpy(xe), torch.from_numpy(txe))

    def decide(y):
        return q.demod(y.cpu()).numpy()

    settle = 64
    # y[i] estimates symbol i - delay; the DD output restarts its window
    got = {"dd": decide(eqs[1][0][settle:]),
           "rls": decide(eqs[3][0][200 + dly:eq_train + eq_len]),
           "fdaf": decide(eqs[4][0][fdaf_n // 2:])}
    want = {"dd": e_bits[2 * (eq_train + settle - dly):2 * (eq_train + eq_len - dly)],
            "rls": e_bits[400:2 * (eq_train + eq_len - dly)],
            "fdaf": e_bits[2 * (fdaf_n // 2 - 8):2 * (fdaf_n - 8)]}
    exact = {k: bool(np.array_equal(got[k], want[k])) for k in got}
    # CMA is phase-blind: its combined response with the channel peaks at a
    # lag and a rotation, which the decisions after its settle are taken at
    comb = np.convolve(ch5, eqs[2][1].cpu().numpy())
    lag = int(np.argmax(np.abs(comb)))
    peak_share = float(np.abs(comb[lag]) ** 2 / np.sum(np.abs(comb) ** 2))
    rot = np.conj(comb[lag]) / np.abs(comb[lag])
    cy = eqs[2][0][eq_len // 2:].cpu() * torch.tensor(rot, dtype=torch.complex64)
    exact["cma"] = peak_share > 0.95 and bool(np.array_equal(
        decide(cy), e_bits[2 * (eq_len // 2 - lag):2 * (eq_len - lag)]))
    dbs = {}
    for name, v, vh in zip(("lms", "dd", "cma", "rls", "fdaf"), eqs, eqs_h):
        if name != "rls":
            dbs[name] = (max(evm_db(a.cpu(), b) for a, b in zip(v, vh)), LOOP_DB)
    # RLS: the card and the CPU each against float64, as tests/test_torch_
    # equalizer.py holds it (a complex128 recurrence, ROADMAP.md §3.17)
    gold = rls_f64(xe[:eq_train + eq_len], txe[:200], 11, dly)
    for name, v in (("rls (card vs float64)", eqs[3]), ("rls (CPU vs float64)", eqs_h[3])):
        dbs[name] = (max(evm_db(a.cpu(), b) for a, b in zip(v, gold)), RLS_DB)
    print(f"adaptive equalizers (5-tap ISI, QPSK): CMA's combined response at lag {lag} holds "
          f"{peak_share:.4f} of its energy (need > 0.95); decisions after the settle exact: "
          + ", ".join(f"{k} {v}" for k, v in exact.items()) + "; card vs CPU run (weights, "
          "outputs, errors): " + ", ".join(f"{k} {v:.2f} dB (need <= {b})"
                                           for k, (v, b) in dbs.items()), flush=True)
    if not all(exact.values()) or any(v > b for v, b in dbs.values()):
        fail("adaptive equalizers")

    # the frequency hopper: 79 channels, dwell 625, fhss_hops hops
    hcfg = fhss.FhssConfig(n_channels=79, dwell=625)
    rng = np.random.default_rng(79)
    xh = _cn(rng, fhss_hops * 625)
    xh_d = up_dev(xh)
    fh = run_path("FHSS", lambda: (lambda s: (s, fhss.hop_despread(s, hcfg)))(
        fhss.hop_spread(xh_d, hcfg)))
    fh_h = fhss.hop_spread(torch.from_numpy(xh), hcfg)
    dbs = {"spread vs CPU": evm_db(fh[0].cpu(), fh_h), "despread vs input": evm_db(fh[1].cpu(), xh)}
    print(f"FHSS ({fhss_hops} hops of 625 over 79 channels, {xh.size} samples): " + ", ".join(
        f"{k} {v:.2f} dB" for k, v in dbs.items()) + f" (need <= {LOOP_DB})", flush=True)
    if any(v > LOOP_DB for v in dbs.values()):
        fail("FHSS")

    print(f"phase 27: {time.perf_counter() - t_start:.1f} s (the card's runs and the CPU's)")

    # ---- phase 28: timings ---------------------------------------------------------
    t_start = time.perf_counter()
    for name, fn in paths.items():
        iters = 1 if name == "adaptive equalizers" else 5
        got = [cli.time_cuda(fn, iters, warmup=0 if iters == 1 else 1) for _ in range(CROSS_RUNS)]
        ms = float(np.median(got))
        print(f"time: {name}: median {ms:.4f} ms a call (runs {', '.join(f'{v:.4f}' for v in got)}; "
              f"{iters} call(s) a run, CUDA events) [{card}]", flush=True)
        # the paths ran warm in the timings; a short call is profiled over
        # more calls, and over another window where the profiler dropped
        # every record of one (cli.kernel_device_ms does the same)
        calls = 20 if ms < 1.0 else 5 if ms < 5.0 else 1
        for _ in range(3):
            prof = profile_calls(torch, fn, name, ms, card, calls=calls, warm=False)
            if prof["kernels"] is not None or not torch.cuda.is_available():
                break
        results[name].update({"ms": ms, **prof})
    # RLS a training step (200 steps a call) of the complex128 recurrence
    # (ROADMAP.md §3.17)
    rls_x, rls_d = xe_d[:eq_train + eq_len], txe_d[:200]
    got = [cli.time_cuda(lambda: equalizer.rls_equalize(rls_x, rls_d, ntaps=11, delay=dly), 1,
                         warmup=1) / 200 for _ in range(CROSS_RUNS)]
    ms = float(np.median(got))
    results["rls step"] = {"ms": ms}
    print(f"time: RLS a step: median {ms:.5f} ms (runs {', '.join(f'{v:.5f}' for v in got)}; "
          f"200 training steps of 11 taps a call, CUDA events) [{card}]", flush=True)
    print(f"phase 28: {time.perf_counter() - t_start:.1f} s")
    return results


def sync_cards() -> None:
    """Wait for every card's work (nothing to wait for without one)."""
    import torch

    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


def dryrun_launches(device: str) -> dict:
    """The launches one ``dryrun_multichip(8)`` makes with all eight shards
    on one card: per ``(channel, time)`` step 8 RX frame + 1 halo launches
    and 1 RX frame launch for its one-card step, at fft_len 128 and 2048
    (one step, three streaming steps and one contiguous step each); 1 halo
    launch for ``sharded_ddc``; 8 + 1 fold launches for ``sharded_pfb_os``
    and its one-card form; the CAF, DOA, ``rs`` burst and TPC paths none.
    CPU shards launch nothing."""
    if device == "cpu":
        return dict(NO_LAUNCHES)
    return {**NO_LAUNCHES, "rx_frame": 2 * ((8 + 1) + (3 * 8 + 1)),
            "halo": 2 * (1 + 3) + 1, "pfb_fold": 8 + 1}


def f64_music_doa(wins, n_sources: int, n_grid: int = 721):
    """MUSIC bearings of ``wins [W, M, T]`` in float64 on the host, the
    witness for ``doa.estimate_doa`` (a half-wavelength ULA, its float32 grid
    widened, the same peak rule and parabolic refinement). Returns the
    sorted ``[W, K]`` bearings and the covariances' eigenvalues, largest
    first."""
    import numpy as np

    x = np.asarray(wins, np.complex128)
    r = x @ x.conj().transpose(0, 2, 1) / x.shape[-1]
    lam, v = np.linalg.eigh(r)  # ascending
    en = v[..., :r.shape[-1] - n_sources]
    grid = np.linspace(-np.pi / 2 * 0.98, np.pi / 2 * 0.98, n_grid).astype(np.float32)
    grid = grid.astype(np.float64)
    a = np.exp(-2j * np.pi * 0.5 * np.sin(grid)[:, None] * np.arange(r.shape[-1]))
    spec = 1 / ((np.abs(np.einsum("gm,wmn->wgn", a.conj(), en)) ** 2).sum(-1) + 1e-12)
    left = np.concatenate([spec[:, :1], spec[:, :-1]], 1)
    right = np.concatenate([spec[:, 1:], spec[:, -1:]], 1)
    masked = np.where((spec >= left) & (spec > right), spec, -np.inf)
    i0 = np.clip(np.argsort(-masked, 1, kind="stable")[:, :n_sources], 1, n_grid - 2)
    sm, s0, sp = (np.take_along_axis(spec, i0 + d, 1) for d in (-1, 0, 1))
    delta = np.clip(0.5 * (sm - sp) / (sm - 2 * s0 + sp + 1e-20), -1.0, 1.0)
    return np.sort(grid[i0] + delta * (grid[1] - grid[0]), 1), lam[:, ::-1]


def doa_witness(device: str, card: str) -> bool:
    """Phase 29's DOA readings beside the dry run: ``COHERENT_DRAWS`` draws
    of its coherent scene and one of the same scene with independent
    waveforms, each estimated on ``device`` and on the CPU and held against
    :func:`f64_music_doa` (coherent: COHERENT_BEARING_ATOL on each side;
    independent: BEARING_ATOL, card against CPU too). Returns whether all
    held."""
    import numpy as np
    import torch

    from aether_primitives_tpu_torch.entry import doa_windows
    from aether_primitives_tpu_torch.models import doa

    def errors(wins):
        want, lam = f64_music_doa(wins, 2)
        got = doa.estimate_doa(torch.from_numpy(wins).to(device), 2).cpu().numpy()
        host = doa.estimate_doa(torch.from_numpy(wins), 2).numpy()
        return (np.abs(got - want).max(1), np.abs(host - want).max(1),
                np.abs(got - host).max(1), lam[:, 1] / lam[:, 0])

    coh = [errors(doa_windows(np.random.default_rng(seed), 16)) for seed in range(COHERENT_DRAWS)]
    c_dev, c_cpu, c_apart, c_ratio = (np.concatenate(e) for e in zip(*coh))
    i_dev, i_cpu, i_apart, i_ratio = errors(doa_windows(np.random.default_rng(1), 16, False))
    print(f"DOA witness, the dry run's coherent scene, {COHERENT_DRAWS} draws x 16 windows: "
          f"second eigenvalue / first median {np.median(c_ratio):.2e}; bearings vs float64 "
          f"MUSIC: {device} max {c_dev.max():.3e} p99 {np.percentile(c_dev, 99):.3e} median "
          f"{np.median(c_dev):.3e}, CPU max {c_cpu.max():.3e} p99 "
          f"{np.percentile(c_cpu, 99):.3e} median {np.median(c_cpu):.3e}, {device} vs CPU max "
          f"{c_apart.max():.3e} rad (need each side <= {COHERENT_BEARING_ATOL}) [{card}]",
          flush=True)
    print(f"DOA witness, the same scene with independent waveforms, 16 windows: second "
          f"eigenvalue / first median {np.median(i_ratio):.2e}; bearings vs float64 MUSIC: "
          f"{device} max {i_dev.max():.3e}, CPU max {i_cpu.max():.3e}, {device} vs CPU max "
          f"{i_apart.max():.3e} rad (need each <= {BEARING_ATOL}) [{card}]", flush=True)
    return (max(c_dev.max(), c_cpu.max()) <= COHERENT_BEARING_ATOL
            and max(i_dev.max(), i_cpu.max(), i_apart.max()) <= BEARING_ATOL)


EXAMPLES = (("torch_modem.py", [], "Modem loopback on"),
            ("torch_packet.py", [], "packet recovered exactly"),
            ("torch_stream_policies.py", [], "stream_policies: OK"),
            ("torch_pipeline.py", ["4", "65536", "1.0"], "bit-exact vs one contiguous step"))


def entry_phase(card: str, device: str = "cuda") -> dict:
    """Phase 29: ``entry()`` on ``device`` against its CPU run (1 RX frame
    launch), ``dryrun_multichip(8)`` with every shard on one card against
    its CPU run (all seven paths; the launches of the RX frame, PFB fold and
    halo kernels counted against :func:`dryrun_launches`; the DOA bearings
    of both runs against a float64 witness, with :func:`doa_witness`),
    across the cards where there are two or more, and the four
    ``examples/torch_*.py`` on the card. Returns the launch counts."""
    import numpy as np
    import subprocess

    import torch

    from aether_primitives_tpu_torch import entry as port_entry

    t_start = time.perf_counter()
    # ---- phase 29: the entry points, card against the CPU run ------------------
    reset_counts()
    fn, ex = port_entry.entry(device)
    bits = fn(*ex)
    sync(device)
    entry_counts = kernel_launches()
    need = {**NO_LAUNCHES, "rx_frame": 0 if device == "cpu" else 1}
    fn_c, ex_c = port_entry.entry("cpu")
    agree = float((bits.cpu() == fn_c(*ex_c)).to(torch.float64).mean())
    print(f"entry(): RxChain(fft_len=2048, decimation=4).step_split on a 32,768-sample block: "
          f"{tuple(bits.shape)} {bits.dtype} on {bits.device}, bits vs the CPU run {agree:.6f} "
          f"(need >= {AGREEMENT}), launches {entry_counts} (need {need}) [{card}]", flush=True)
    if agree < AGREEMENT or entry_counts != need:
        fail("entry()")

    shards = [device if device == "cpu" else "cuda:0"] * 8
    sync_cards()
    reset_counts()
    out = port_entry.dryrun_multichip(8, devices=shards)
    sync_cards()
    dry_counts = kernel_launches()
    need = dryrun_launches(device)
    ref = port_entry.dryrun_multichip(8, devices=["cpu"] * 8)
    report = {}
    for key in ("bits", "stream_bits", "flagship_bits", "flagship_stream_bits", "burst_bits",
                "tpc"):
        report[key] = float((out[key] == ref[key]).to(torch.float64).mean())
    for key in ("ddc", "pfb_os", "caf"):
        report[key] = evm_db(out[key], ref[key])
    want, _ = f64_music_doa(out["doa_windows"], 2)
    report["doa"] = float(np.abs(out["doa"].numpy() - want).max())
    report["doa_cpu"] = float(np.abs(ref["doa"].numpy() - want).max())
    report["doa_apart"] = float((out["doa"] - ref["doa"]).abs().max())
    report["caf_delay"] = abs(out["caf_delay"] - ref["caf_delay"])
    print(f"dryrun_multichip(8) on {shards[0]} x 8 against its CPU run: "
          + ", ".join(f"{k} {v:.6f}" if k in ("bits", "stream_bits", "flagship_bits",
                                              "flagship_stream_bits", "burst_bits", "tpc")
                      else f"{k} {v:.2f} dB" if k in ("ddc", "pfb_os", "caf")
                      else f"{k} {v:.2e}" for k, v in report.items())
          + f" (doa: {device} vs float64 MUSIC, doa_cpu: the CPU run vs float64, doa_apart: "
          f"the two runs; need bits >= {AGREEMENT}, outputs <= {CPU_DB} dB, bearings vs "
          f"float64 <= {COHERENT_BEARING_ATOL} rad, delay <= {CAF_DELAY_ATOL}); launches "
          f"{dry_counts} (need {need}) [{card}]", flush=True)
    bits_ok = all(report[k] >= AGREEMENT for k in ("bits", "stream_bits", "flagship_bits",
                                                   "flagship_stream_bits", "burst_bits", "tpc"))
    witness_ok = doa_witness(device, card)
    if (not bits_ok or any(report[k] > CPU_DB for k in ("ddc", "pfb_os", "caf"))
            or max(report["doa"], report["doa_cpu"]) > COHERENT_BEARING_ATOL
            or not witness_ok or report["caf_delay"] > CAF_DELAY_ATOL
            or dry_counts != need):
        fail("dryrun_multichip(8) on one card")
    cards = torch.cuda.device_count() if device != "cpu" else 0
    if cards > 1:
        sync_cards()
        reset_counts()
        port_entry.dryrun_multichip(8)
        sync_cards()
        across = kernel_launches()
        print(f"dryrun_multichip(8) across {cards} cards: launches {across} [{card}]",
              flush=True)
        if not all(across[k] > 0 for k in ("rx_frame", "pfb_fold", "halo")):
            fail("dryrun_multichip(8) across cards")
    else:
        print(f"cards: {max(cards, 1)}, across-card dry run not run", flush=True)

    # the four examples, started together, each in its own process
    folder = Path(__file__).resolve().parent / "examples"
    flag = ["--cpu"] if device == "cpu" else []
    procs = {name: subprocess.Popen([sys.executable, str(folder / name), *args, *flag],
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for name, args, _ in EXAMPLES}
    outs = {}
    try:
        for name, p in procs.items():
            outs[name] = p.communicate(timeout=300)[0]
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    for name, _, verdict in EXAMPLES:
        lines = outs[name].strip().splitlines()
        print(f"example {name} on {device}: exit {procs[name].returncode}, "
              f"{lines[-1] if lines else 'no output'}", flush=True)
        if procs[name].returncode != 0 or verdict not in outs[name]:
            print(outs[name][-3000:], flush=True)
            fail(f"example {name}")
    print(f"phase 29: {time.perf_counter() - t_start:.1f} s", flush=True)
    return {"entry": entry_counts, "dryrun": dry_counts}


def microbench_phase(card: str, device: str = "cuda", batch: int = 1024, iters: int = 20) -> dict:
    """Phase 30: ``cli.microbench_main`` at ``--batch`` on ``device`` with
    ``--iters`` calls a round (20, not the default 50: the whole script
    stays near half its time limit), every one of the JAX package's 33 rows
    with a time; its Viterbi row makes 1 Viterbi launch a call and its
    turbo row 16 BCJR launches (8 iterations x 2 constituent decoders).
    Returns the rows."""
    import math

    from aether_primitives_tpu_torch import cli

    t_start = time.perf_counter()
    # ---- phase 30: the per-op microbench ----------------------------------------
    print(f"microbench at --batch {batch} on {device} [{card}]", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "microbench.json"
        argv = ["--batch", str(batch), "--iters", str(iters), "--json", str(path)]
        cli.microbench_main(argv + (["--cpu"] if device == "cpu" else []))
        payload = json.loads(path.read_text())
    rows = {r["bench"]: r for r in payload["results"]}
    print(f"microbench head: platform {payload['platform']}, device {payload['device']}, "
          f"card {payload['card']}, timing {payload['timing']}, {len(rows)} rows", flush=True)
    if len(rows) != 33 or not all(math.isfinite(r["us_per_call"]) and r["us_per_call"] > 0
                                  for r in rows.values()):
        fail("microbench rows")
    on_card = device != "cpu"
    nfr = max(batch // 16, 1)
    checks = {f"viterbi K=7 decode [{nfr} x 1024 bits]": {"viterbi": 1} if on_card else {},
              f"turbo decode 8 iters win64 [{nfr} x 1024 bits]": {"bcjr": 16} if on_card else {}}
    for name, need in checks.items():
        got = rows[name]["launches"]
        print(f"microbench {name}: launches a call {got} (need {need})", flush=True)
        if got != need:
            fail(f"microbench {name} launches")
    # the CRC row runs on the device: its device time, and the register on
    # the card against zlib
    import zlib

    import numpy as np
    import torch

    from aether_primitives_tpu_torch.ops import fec

    row = rows["crc32 2^20 bits"]
    data = bytes(np.random.default_rng(CRC_SEED).integers(0, 256, 1 << 17, dtype=np.uint8))
    bits = torch.from_numpy(np.unpackbits(np.frombuffer(data, np.uint8), bitorder="little"))
    poly, width, init, _refin, refout, xorout = fec.CRC_PARAMS["crc32"]
    out = fec.crc_compute(bits.to(device), poly, width, init, xorout, refout)
    got = int(np.packbits(out.cpu().numpy()[::-1], bitorder="little").view(np.uint32)[0])
    busy = ("not measured" if row["device_busy_ms"] is None else
            f"device busy {row['device_busy_ms']:.4f} ms, {row['kernels_per_call']:g} kernels")
    print(f"microbench crc32 2^20 bits: {row['us_per_call']:.1f} us a call, {busy} a call "
          f"[{card}]; crc_compute of 2^20 bits on {out.device}: {got:#010x}, zlib.crc32 "
          f"{zlib.crc32(data):#010x}", flush=True)
    if got != zlib.crc32(data) or out.device.type != torch.device(device).type:
        fail("crc_compute on the device against zlib.crc32")
    print(f"phase 30: {time.perf_counter() - t_start:.1f} s", flush=True)
    return rows


def cross_process_phase(card: str, device: str = "cuda", span: int = 1 << 22) -> dict:
    """Phase 31: two processes on ``device`` over gloo, each with four
    shards of the flagship chain (fft_len 2048, decimation 4, packed bytes)
    on its ``span``-sample part of one ``2 x span`` capture
    (:func:`cross_process_worker`); their bytes joined equal to one
    process's ``sharded_step`` on eight shards and through the float64
    gate, and ``sharded_ddc`` against ``Ddc.step``; the step and its halo
    exchange timed in both processes (the median of CROSS_RUNS runs). Then
    the other entry points across the two processes
    (:func:`cross_entry_checks`): the flagship 2-D streaming step over three
    ``[2, span]`` blocks, the executor, and :func:`cross_paths`.
    Returns the workers' records and the launches a rank of each path."""
    import socket
    import subprocess

    import numpy as np
    import torch

    from aether_primitives_tpu_torch.cli import capture, numpy_reference_bits
    from aether_primitives_tpu_torch.models import RxChain, RxChainConfig
    from aether_primitives_tpu_torch.models.ddc import Ddc
    from aether_primitives_tpu_torch.ops.cuda import rx_frame as rf
    from aether_primitives_tpu_torch.parallel import mesh as mesh_mod

    t_start = time.perf_counter()
    # ---- phase 31: two processes, one mesh ----------------------------------------
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                                   "--rank-worker", str(r), "2", str(port), tmp, device,
                                   str(span)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(2)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=600)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        for r, (p, out) in enumerate(zip(procs, outs)):
            print(out.rstrip(), flush=True)
            if p.returncode != 0:
                fail(f"cross-process worker {r} exited {p.returncode}")
        got = np.concatenate([np.load(Path(tmp) / f"bytes_{r}.npy") for r in range(2)])
        got_d = np.concatenate([np.load(Path(tmp) / f"ddc_{r}.npy") for r in range(2)])
        recs = [json.loads((Path(tmp) / f"record_{r}.json").read_text()) for r in range(2)]
        entries = [json.loads((Path(tmp) / f"entries_{r}.json").read_text()) for r in range(2)]
        shards = [torch.load(Path(tmp) / f"shards_{r}.pt", weights_only=False) for r in range(2)]
    chain = RxChain(RxChainConfig(fft_len=2048, decimation=4, packed_bits=True), device=device)
    x = capture(2 * span, CROSS_SEED)
    x_dev = torch.from_numpy(x).to(device)
    mesh8 = mesh_mod.make_mesh({"time": 8}, devices=[device] * 8)
    one = chain.sharded_step(x_dev, mesh8).gather("cpu").numpy()
    same = bool(np.array_equal(got, one))
    ref = numpy_reference_bits(x, chain.taps, 4, 2048)
    agree = float((rf.unpack_bits(torch.from_numpy(got)).numpy() == ref).mean())
    ddc_cfg = _cross_ddc()
    ddc_db = evm_db(got_d, Ddc(ddc_cfg, device=device).step(x_dev))
    need = {**NO_LAUNCHES, **({} if device == "cpu" else {"rx_frame": 4, "halo": 1})}
    counts = [r["launches"] for r in recs]
    print(f"two processes (gloo) x 4 shards of [{span}] on {device}: bytes joined equal to one "
          f"process's sharded_step on 8 shards {same}, bits vs float64 {agree:.6f} (need >= "
          f"{AGREEMENT}); sharded_ddc (freq {ddc_cfg.freq}, /{ddc_cfg.decimation}) vs "
          f"Ddc.step {ddc_db:.2f} dB (need <= {SHARDED_DDC_DB}); launches a step per process "
          f"{counts} (need {need}) [{card}]", flush=True)
    if not same or agree < AGREEMENT or ddc_db > SHARDED_DDC_DB or any(c != need for c in counts):
        fail("the step across two processes")

    one_ms = [time_host(lambda: chain.sharded_step(x_dev, mesh8), 10, warmup=1,
                        sync=lambda: sync(device)) for _ in range(CROSS_RUNS)]
    for r, rec in enumerate(recs):
        print(f"time: rank {r}: step {rec['step_ms']:.4f} ms (median of {CROSS_RUNS} runs "
              f"{', '.join(f'{v:.4f}' for v in rec['step_runs'])}; host clock, 10 steps a run, "
              f"both ranks on {device} at once), halo exchange {rec['tail_ms']:.4f} ms of which "
              f"the rank's own pushes {rec['local_tail_ms']:.4f} ms, the edge between ranks "
              f"{rec['tail_ms'] - rec['local_tail_ms']:.4f} ms = "
              f"{100 * (rec['tail_ms'] - rec['local_tail_ms']) / rec['step_ms']:.1f}% of the "
              f"step [{card}]", flush=True)
    print(f"time: one process, 8 shards of [{span // 4}] on {device}: sharded_step median "
          f"{float(np.median(one_ms)):.4f} ms (runs {', '.join(f'{v:.4f}' for v in one_ms)}; "
          f"host clock, 10 steps a run) [{card}]", flush=True)
    del x_dev
    entry_counts = cross_entry_checks(card, device, span, chain, entries, shards)
    print(f"phase 31: {time.perf_counter() - t_start:.1f} s", flush=True)
    return {"ranks": recs, "one_process_ms": float(np.median(one_ms)), "entries": entry_counts}


def cross_entry_checks(card: str, device: str, block: int, chain, entries, shards) -> dict:
    """Phase 31's checks of the entry points the workers ran across the two
    processes (their ``entries`` records and saved ``shards``): the 2-D
    streaming step's joined bytes equal to one process's same calls on
    eight shards and to one contiguous ``step``, through the float64 gate
    on channel 0, its states, and 4 RX frame + 1 halo launches a rank and
    step; the executor equal to the direct calls; every path of
    :func:`cross_paths` equal to one process's run on eight shards, the CAF
    estimate the same on both ranks, each rank's launches as the code
    implies. Prints every path's ms a rank and its edge between the ranks.
    Returns the launches a rank (rank 0's)."""
    import numpy as np
    import torch

    from aether_primitives_tpu_torch.cli import gate
    from aether_primitives_tpu_torch.parallel import mesh as mesh_mod

    on_card = device != "cpu"
    cap = stream2d_capture(block)
    mesh8 = mesh_mod.make_mesh({"time": 4, "channel": 2}, devices=[device] * 8)
    state, one, one_states = chain.init_state((2,)), [], []
    for i in range(3):
        bits, state = chain.sharded_streaming_step_2d(
            torch.from_numpy(np.ascontiguousarray(cap[:, i * block:(i + 1) * block])).to(device),
            state, mesh8)
        one.append(bits.gather("cpu"))
        one_states.append(state.gather("cpu"))
    whole = chain.step(torch.from_numpy(cap).to(device)).cpu()
    rec = shards[0]["sharded_streaming_step_2d"]
    got = [joined([s_["sharded_streaming_step_2d"]["bits"][i] for s_ in shards], one[i])
           for i in range(3)]
    same = all(g is not None and torch.equal(g, o) for g, o in zip(got, one))
    contiguous = same and torch.equal(torch.cat(got, dim=-1), whole)
    states_ok = all(torch.equal(s_["sharded_streaming_step_2d"]["states"][i], one_states[i])
                    for s_ in shards for i in range(3))
    g = gate(chain, cap[0, :2 * block], block, [got[0][0], got[1][0]],
             [rec["states"][0][0].to(device), rec["states"][1][0].to(device)]) if same else None
    need = {**NO_LAUNCHES, **({"rx_frame": 4, "halo": 1} if on_card else {})}
    calls = [e["sharded_streaming_step_2d"]["calls"] for e in entries]
    need_ex = {**NO_LAUNCHES, **({"rx_frame": 12, "halo": 3} if on_card else {})}
    ex = [e["StatefulExecutor(sharding=)"] for e in entries]
    print(f"two processes (gloo), sharded_streaming_step_2d of the flagship chain on {{time: 4, "
          f"channel: 2}}, rank r holding time shards 2r-2r+1 of both channels, 3 blocks "
          f"[2, {block}]: joined bytes equal to one process's same calls on 8 shards {same}, "
          f"to one contiguous step of each channel {contiguous}; states equal {states_ok}; "
          f"channel 0 two-block float64 gate: bit agreement "
          f"{g['bit_agreement'] if g else float('nan'):.7f} (need >= {AGREEMENT}), block-2 "
          f"spectrum {g['evm_rms_db'] if g else float('nan'):.2f} dB (need <= {EVM_DB}), state "
          f"exact {g['state_exact'] if g else False}; launches a step per rank "
          f"{[[{k: v for k, v in c.items() if v} for c in cs] for cs in calls]} (need "
          f"{ {k: v for k, v in need.items() if v} }); StatefulExecutor(sharding=) over the same "
          f"blocks equal to the direct calls {[e['equal'] for e in ex]}, launches a run "
          f"{[{k: v for k, v in e['launches'].items() if v} for e in ex]} (need "
          f"{ {k: v for k, v in need_ex.items() if v} }) [{card}]", flush=True)
    if not (same and contiguous and states_ok and g is not None and g["ok"]
            and all(c == need for cs in calls for c in cs)
            and all(e["equal"] and e["launches"] == need_ex for e in ex)):
        fail("the 2-D streaming step across two processes")

    ok = True
    for name, (call, _, _) in cross_paths(device, [device] * 8).items():
        out = call()
        parts = [s_[name] for s_ in shards]
        equal = True
        for v, want in enumerate(out if isinstance(out, tuple) else (out,)):
            if isinstance(want, mesh_mod.Sharded):  # join the ranks' shards
                want = want.gather("cpu")
                got_v = joined([p[v] for p in parts], want)
                equal = equal and got_v is not None and torch.equal(got_v, want)
            else:  # the CAF estimate: the same on both ranks and in one process
                equal = equal and all(torch.equal(p[v], want.cpu()) for p in parts)
        need_p = entries[0][name]["need"]  # a rank's four shards' launches
        counts = [e[name]["launches"] for e in entries]
        print(f"two processes (gloo), {name}: joined output equal to one process's run on 8 "
              f"shards {equal}; launches a call per rank "
              f"{[{k: v for k, v in c.items() if v} for c in counts]} (need "
              f"{ {k: v for k, v in need_p.items() if v} }) [{card}]", flush=True)
        ok = ok and equal and all(c == need_p for c in counts)
    if not ok:
        fail("an entry point across two processes")
    for name in entries[0]:
        for r, e in enumerate(entries):
            rec_t = e[name]
            edge = ("no exchange between the ranks" if rec_t["edge_ms"] is None else
                    f"its edge between the ranks {rec_t['edge_ms']:.4f} ms = "
                    f"{100 * rec_t['edge_ms'] / rec_t['step_ms']:.1f}% of the call")
            print(f"time: rank {r}: {name}: {rec_t['step_ms']:.4f} ms a call (median of "
                  f"{CROSS_RUNS} runs {', '.join(f'{v:.4f}' for v in rec_t['step_runs'])}; host "
                  f"clock, 10 calls a run, both ranks on {device} at once), {edge} [{card}]",
                  flush=True)
    return {name: e.get("launches", e.get("calls", [None])[0]) for name, e in entries[0].items()}


def _cross_ddc():
    """Phase 31's DDC: phase 12's configuration."""
    from aether_primitives_tpu_torch.models.ddc import DdcConfig

    return DdcConfig(freq=0.1375, decimation=8)


STREAM2D_SEED = 3132  # phase 31's [2, 3 x block] capture for the 2-D streaming step
SPEC2 = ("channel", "time")


def stream2d_capture(block: int):
    """Phase 31's capture of the 2-D streaming step: ``[2, 3 * block]``
    complex64 from STREAM2D_SEED, made alike in every process."""
    from aether_primitives_tpu_torch.cli import capture

    return capture(2 * 3 * block, STREAM2D_SEED).reshape(2, 3 * block)


def cross_paths(device: str, devs: list) -> dict:
    """Phase 31's other entry points at ``dryrun_multichip(8)``'s shapes
    (``entry.py``; the paths it lacks at its DDC's and chain's), each on a
    mesh of ``devs`` (four a rank across two processes, eight in one):
    ``{name: (call, launches a call, exchange or None)}``, where ``call()``
    returns the path's output (a ``Sharded`` value, a tuple of them, or the
    CAF estimate) and ``exchange(local)`` runs the path's exchange between
    shards on its input (``local``: this process's part alone)."""
    import numpy as np
    import torch

    from aether_primitives_tpu_torch.entry import _cn, doa_windows
    from aether_primitives_tpu_torch.models import caf, channelizer, doa
    from aether_primitives_tpu_torch.models.ddc import DucConfig, _polyphase_branches, sharded_duc
    from aether_primitives_tpu_torch.models.packet import PacketConfig, PacketModem
    from aether_primitives_tpu_torch.parallel import halo
    from aether_primitives_tpu_torch.parallel import mesh as mesh_mod

    on_card = device != "cpu"
    tmesh = mesh_mod.make_mesh({"time": 8}, devices=devs)
    cmesh = mesh_mod.make_mesh({"channel": 8}, devices=devs)
    rng = np.random.default_rng(1)

    def on(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def placed(a, mesh, spec):
        """The process's part of host ``a`` on the mesh (shard_process_local)."""
        box = mesh.local_box()
        cut = tuple(slice(None) if name is None else
                    slice(box[mesh.axis(name)].start * (a.shape[d] // mesh.shape[name]),
                          box[mesh.axis(name)].stop * (a.shape[d] // mesh.shape[name]))
                    for d, name in enumerate(spec))
        return mesh_mod.shard_process_local(on(a[cut]), mesh, spec, a.shape)

    def per_shard(**k):  # launches a call: one set per local shard
        return {key: v * len(tmesh.local_coords()) for key, v in k.items()} if on_card else {}

    one_halo = {"halo": 1} if on_card else {}  # one launch per sending card

    paths = {}
    # bursts, data-parallel: the dry run's 8 captures of 2,048, viterbi and turbo
    for fec, need in (("viterbi", {"viterbi": 1}), ("turbo", {"bcjr": 16})):
        pm = PacketModem(PacketConfig(payload_bits=120, fec=fec, preamble_half=32), device=device)
        caps = 0.02 * _cn(rng, 8, 2048)
        for i in range(8):
            burst = pm.tx(on(rng.integers(0, 2, 120).astype(np.uint8))).cpu().numpy()
            caps[i, 40 + 16 * i:40 + 16 * i + burst.size] += burst
        caps_d = on(caps)
        paths[f"rx_batch_sharded ({fec})"] = (
            lambda pm=pm, caps_d=caps_d: pm.rx_batch_sharded(caps_d, cmesh)[:2],
            per_shard(**need), None)
    # the PFBs over the time mesh: the dry run's os-PFB (M 32, P 2, os 2)
    xp = _cn(rng, 8 * 10 * 32)
    xps = placed(xp, tmesh, ("time",))
    paths["sharded_pfb"] = (
        lambda: channelizer.sharded_pfb(xps, 32, tmesh, taps_per_branch=2),
        one_halo,
        lambda local: halo.left_tail(xps.local_view() if local else xps, 32))
    h_os = channelizer.pfb_prototype_nyquist(32, 2)
    overlap = max(1, -(-h_os.size // 32)) * 32 - 16
    paths["sharded_pfb_os"] = (
        lambda: channelizer.sharded_pfb_os(xps, 32, tmesh, os=2, taps_per_branch=2),
        per_shard(pfb_fold=1),
        lambda local: halo.right_head(xps.local_view() if local else xps, overlap))
    # the waterfall's rows over the channel mesh: 32 rows of the dry run's 128
    rows = _cn(rng, 32, 128)
    paths["sharded_waterfall"] = (
        lambda: channelizer.sharded_waterfall(placed(rows, cmesh, ("channel", None)), 128, cmesh),
        {}, None)
    # the DUC over the time mesh at the dry run's DDC size
    xd = _cn(rng, 8 * 1024)
    xds = placed(xd, tmesh, ("time",))
    dcfg = DucConfig(freq=0.21, interpolation=4)
    kb = _polyphase_branches(dcfg.resolved_taps(), 4).shape[-1]
    paths["sharded_duc"] = (lambda: sharded_duc(xds, dcfg, tmesh), one_halo,
                            lambda local: halo.left_tail(xds.local_view() if local else xds,
                                                         kb - 1))
    # CAF (the dry run's scene) and DOA (its windows)
    ref_sig = _cn(rng, 128)
    xc = 0.05 * _cn(rng, 1024)
    xc[300:428] += ref_sig * np.exp(2j * np.pi * 2e-3 * (np.arange(128) + 300))
    xc_d, ref_d = on(xc.astype(np.complex64)), on(ref_sig)
    dops = np.linspace(-4e-3, 4e-3, 64).astype(np.float32)
    paths["sharded_ambiguity"] = (lambda: caf.sharded_ambiguity(xc_d, ref_d, dops, tmesh), {},
                                  None)
    surf = caf.sharded_ambiguity(xc_d, ref_d, dops, tmesh)
    paths["sharded_estimate_delay_doppler"] = (
        lambda: caf.sharded_estimate_delay_doppler(xc_d, ref_d, 4e-3, tmesh, n_dopplers=64), {},
        lambda local: surf.gather(local=True) if local else mesh_mod.allgather(surf))
    wins = doa_windows(rng, 16)
    paths["sharded_estimate_doa"] = (
        lambda: doa.sharded_estimate_doa(placed(wins, cmesh, ("channel",)), 2, cmesh), {}, None)
    return paths


def local_shards(out) -> list:
    """A path's output as this process holds it: per ``Sharded`` value its
    ``(global index, host tensor)`` shards, per plain tensor the tensor."""
    import torch

    from aether_primitives_tpu_torch.parallel.mesh import Sharded

    outs = out if isinstance(out, tuple) else (out,)
    return [[(sh.index, sh.data.cpu()) for sh in v.addressable_shards] if isinstance(v, Sharded)
            else v.cpu() if isinstance(v, torch.Tensor) else v for v in outs]


def joined(parts, like):
    """The global tensor of ``like``'s shape from the ranks' ``(index,
    tensor)`` shards; None where they leave part of it uncovered."""
    import torch

    out = torch.zeros(like.shape, dtype=like.dtype)
    covered = torch.zeros(like.shape, dtype=torch.bool)
    for rank_parts in parts:
        for index, data in rank_parts:
            out[index] = data
            covered[index] = True
    return out if bool(covered.all()) else None


def cross_process_worker(rank: int, world: int, port: int, folder: str, device: str,
                         span: int) -> None:
    """One rank of phase 31: joins the gloo group, builds the ``{time: 4 x
    world}`` mesh from four shards of its own on ``device``, steps its part
    of the capture once with the launches counted, saves its bytes and its
    ``sharded_ddc`` output under ``folder``, and times the step and the
    halo exchange (the whole one, and its own pushes alone). Then three
    ``[2, span]`` blocks through ``sharded_streaming_step_2d`` on a
    ``{time: 4, channel: 2}`` mesh (launches counted a step) and through a
    ``StatefulExecutor`` with ``sharding=`` (held equal to the direct
    calls), and each path of :func:`cross_paths` once with its launches
    counted; it saves their shards and times each path and the edge of its
    exchange between the ranks (the exchange less this rank's part of it)."""
    import numpy as np
    import torch

    from aether_primitives_tpu_torch.cli import capture
    from aether_primitives_tpu_torch.models import RxChain, RxChainConfig
    from aether_primitives_tpu_torch.models.ddc import sharded_ddc
    from aether_primitives_tpu_torch.parallel import halo, streaming
    from aether_primitives_tpu_torch.parallel import mesh as mesh_mod

    mesh_mod.init_distributed(coordinator_address=f"127.0.0.1:{port}", num_processes=world,
                              process_id=rank, backend="gloo")
    dist = torch.distributed
    mesh = mesh_mod.make_mesh({"time": 4 * world}, devices=[device] * 4)
    x = capture(world * span, CROSS_SEED)
    local = torch.from_numpy(x[rank * span:(rank + 1) * span]).to(device)
    xg = mesh_mod.shard_process_local(local, mesh, ("time",), (world * span,))
    chain = RxChain(RxChainConfig(fft_len=2048, decimation=4, packed_bits=True), device=device)
    chain.sharded_step(xg, mesh)  # the first call's setup
    sync(device)
    reset_counts()
    out = chain.sharded_step(xg, mesh)
    sync(device)
    launches = kernel_launches()
    np.save(Path(folder) / f"bytes_{rank}.npy", out.gather(local=True).cpu().numpy())
    ddc = sharded_ddc(xg, _cross_ddc(), mesh)
    np.save(Path(folder) / f"ddc_{rank}.npy", ddc.gather(local=True).cpu().numpy())

    def host_ms(fn) -> float:  # both ranks start the clock together
        fn()
        sync(device)
        dist.barrier()
        return time_host(fn, 10, sync=lambda: sync(device))

    k = chain.taps.shape[-1]
    step_runs = [host_ms(lambda: chain.sharded_step(xg, mesh)) for _ in range(CROSS_RUNS)]
    tail_ms = float(np.median([host_ms(lambda: halo.left_tail(xg, k - 1))
                               for _ in range(CROSS_RUNS)]))
    local_view = xg.local_view()
    local_ms = float(np.median([host_ms(lambda: halo.left_tail(local_view, k - 1))
                                for _ in range(CROSS_RUNS)]))
    record = {"rank": rank, "launches": launches, "step_runs": step_runs,
              "step_ms": float(np.median(step_runs)), "tail_ms": tail_ms,
              "local_tail_ms": local_ms}
    (Path(folder) / f"record_{rank}.json").write_text(json.dumps(record))

    # the 2-D streaming step across the ranks on {time: 4, channel: 2}:
    # this rank holds two time shards of both channels, so the halo's edge
    # and the carried state cross; block 0 is the whole block in every
    # process, blocks 1-2 this rank's part (shard_process_local)
    mesh2 = mesh_mod.make_mesh({"time": 4, "channel": 2}, devices=[device] * 4)
    cap = stream2d_capture(span)
    blocks = [np.ascontiguousarray(cap[:, i * span:(i + 1) * span]) for i in range(3)]
    half = span // world
    parts = [mesh_mod.shard_process_local(
        torch.from_numpy(np.ascontiguousarray(b[:, rank * half:(rank + 1) * half])).to(device),
        mesh2, SPEC2, b.shape) for b in blocks]
    chain.sharded_streaming_step_2d(parts[1], chain.init_state((2,)), mesh2)  # setup
    sync(device)
    state, outs, states, calls = chain.init_state((2,)), [], [], []
    for i in range(3):
        reset_counts()
        bits, state = chain.sharded_streaming_step_2d(blocks[0] if i == 0 else parts[i], state,
                                                      mesh2)
        sync(device)
        calls.append(kernel_launches())
        outs.append(bits)
        states.append(state)
    ex = streaming.StatefulExecutor(lambda b, st: chain.sharded_streaming_step_2d(b, st, mesh2),
                                    chain.init_state((2,)), sharding=(mesh2, SPEC2),
                                    device=device, printer=None)
    reset_counts()
    ys = ex.run(blocks)  # host blocks: each rank stages its own pieces
    sync(device)
    ex_launches = kernel_launches()
    ex_equal = all(a.index == b.index and torch.equal(a.data, b.data)
                   for y, o in zip(ys + [ex.state], outs + [state])
                   for a, b in zip(y.addressable_shards, o.addressable_shards))

    def exchange2(v):
        """The 2-D step's exchanges: the halo and the carried state."""
        jt = v.mesh.axis("time")
        last = v.mesh.devices.shape[jt] - 1
        halo.left_tail(v, k - 1)
        halo.take_from(v, lambda c: c[:jt] + (last,) + c[jt + 1:],
                       lambda t: t[..., t.shape[-1] - (k - 1):])

    def timed(call, exchange=None) -> dict:
        runs = [host_ms(call) for _ in range(CROSS_RUNS)]
        rec = {"step_runs": runs, "step_ms": float(np.median(runs)), "edge_ms": None}
        if exchange is not None:
            rec["edge_ms"] = float(np.median([host_ms(lambda: exchange(False))
                                              for _ in range(CROSS_RUNS)])
                                   - np.median([host_ms(lambda: exchange(True))
                                                for _ in range(CROSS_RUNS)]))
        return rec

    entries = {"sharded_streaming_step_2d": {
        "calls": calls, **timed(lambda: chain.sharded_streaming_step_2d(parts[1], states[0], mesh2),
                                lambda local: exchange2(parts[1].local_view() if local
                                                        else parts[1]))}}
    entries["StatefulExecutor(sharding=)"] = {"launches": ex_launches, "equal": ex_equal,
                                             **timed(lambda: ex.run(blocks[1:2]))}
    shards = {"sharded_streaming_step_2d": {
        "bits": [[(sh.index, sh.data.cpu()) for sh in b.addressable_shards] for b in outs],
        "states": [st.gather(local=True).cpu() for st in states]}}
    for name, (call, need, exchange) in cross_paths(device, [device] * 4).items():
        call()  # setup
        sync(device)
        dist.barrier()
        reset_counts()
        out = call()
        sync(device)
        entries[name] = {"launches": kernel_launches(), "need": {**NO_LAUNCHES, **need},
                         **timed(call, exchange)}
        shards[name] = local_shards(out)
    torch.save(shards, Path(folder) / f"shards_{rank}.pt")
    (Path(folder) / f"entries_{rank}.json").write_text(json.dumps(entries))
    dist.barrier()
    dist.destroy_process_group()
    print(f"rank {rank}: mesh {mesh.shape} over {world} processes, {len(mesh.local_coords())} "
          f"shards of [{span // 4}] here, done", flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank-worker"]:  # one rank of phase 31, started by it
        rank, world, port, folder, device, span = sys.argv[2:8]
        cross_process_worker(int(rank), int(world), int(port), folder, device, int(span))
    else:
        main()
