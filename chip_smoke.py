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
  the windowed BCJR kernel (``csrc/bcjr.cu``, ``fec="turbo"``);
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
  ``sharded_ddc``, ``rx_batch_sharded``),

in twenty-two phases:

1. the card's name and power limit (exits 1 without a CUDA device);
2. the seven kernels' builds from the sources in the checkout, and the PFB
   fold kernel's previous design (``benches/torch_pfb_fold_parent.cu``,
   timed in phase 13), started together, timed, with the PFB fold compiler
   report;
3. the RX frame kernel's main-path instance (``direct``: the FIR at the
   kept outputs and a hand-written FFT) against its plain PyTorch version
   and the float64 chain at the main path's shapes: QPSK and BPSK bytes and
   the spectrum epilogue, with and without carried history; then every
   other instance (``F7_GEOMETRIES``: direct at dec 4, fft_len 4096 and 64;
   tile256 at dec 4, fft_len 192; tile512 at dec 4, fft_len 3072; generic
   for an unpacked chain at dec 5, fft_len 30), each through the chain's
   two-block streaming gate with one launch a step, against the plain twin,
   and timed;
4. the RX chain's two-block streaming gate, counting kernel launches;
5. CUDA-event timings of the RX frame kernel, the parent's main-path kernel
   (the tile256 instance, unchanged in this tree, after a bit comparison
   with the direct one), the plain version, and the RX chain's kernel and
   plain paths; the two kernels' device times (``torch.profiler``) and the
   host's time to enqueue a streaming step;
6. the RX frame, Viterbi and BCJR kernels' register and spill reports;
7. the Viterbi and BCJR kernels against their plain twins at the burst
   path's shapes, bit for bit (``array_equal`` / ``torch.equal``); for the
   Viterbi kernel also tie-heavy spans (integer LLRs with -0.0) at K = 3,
   5, 7 and 9, rates 1/2 and 1/3; for the BCJR kernel also Lw 1, 2, 95,
   97, N 1, 77, 1,000, 2,570, exact ties with -0.0, random tables of every
   state count it takes, and the meet instance at both its CTA widths (16
   and 8 columns);
8. the burst path: 256 bursts built by the port's own ``tx`` through a
   numpy channel from a fixed seed, decoded by ``rx_batch`` for both FECs;
   every payload exact and CRC-ok, exactly 1 Viterbi and 16 BCJR launches
   per call, and the first 8 bursts equal to the port's CPU run;
9. CUDA-event timings of each burst kernel (and the BCJR kernel at K=7)
   against its plain twin and of ``rx_batch`` end to end, the Viterbi and
   BCJR kernels' device times (``torch.profiler``) beside its chain floor (an
   estimate from assumed operation counts, on a line of its own), and a
   ``torch.profiler`` split of ``rx_batch`` into front end, decoder kernels
   and the rest;
10. every layout of the PFB fold kernel against its plain twin, bit for
    bit (``torch.equal``), at the channelizer's shapes: the planes layout
    (the TPU wrapper's), the complex64 analysis from a step's two sources
    (the carried tail and the block) with real and complex taps, the
    synthesis with the stage's tail and divisor and raw with complex taps,
    the critically sampled synthesis, and ragged batched cases (M 1,000, a
    seam inside a row at an odd sample, os 4);
11. the channelizer path: three consecutive blocks through analysis and
    synthesis, exactly 1 analysis + 1 synthesis fold launch per step and no
    other kernel, the first 64 frames against a float64 golden (<= -80 dB),
    the streamed analysis against one-shot ``pfb_channelize_os`` (<= -120
    dB), the reconstructed interior against the input (<= -70 dB), and the
    first frames against the port's CPU run (<= -110 dB); then the same
    blocks with a complex prototype (the root-Nyquist one moved by a
    quarter channel): the same launches, analysis and synthesis against
    float64 goldens (<= -80 dB) and the CPU run (<= -110 dB);
12. the DDC path over two blocks: against the float64 composed golden on a
    prefix (<= -80 dB) and block by block against one-shot (<= -115 dB);
13. timings of the fold kernel's analysis and synthesis layouts (CUDA
    events and ``torch.profiler`` device time with its record count), their
    plain twins, the previous design's kernel launched as its callers
    launched it (in turns), the complex-tap and planes layouts, the one-call
    ``conv1d`` yardstick and both floors; of the analysis, synthesis and DDC
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
    the line ``cards: 1, cross-card phase not run``.

Any failed phase prints its cause and exits 1. The line before the last
is the kernels' JSON summary; the last line is
``{"ok": true, "device": {...}}``.
"""

import ctypes
import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

# tolerances, stated once
AGREEMENT = 0.99999  # hard bits vs the float64 chain, and kernel vs plain
EVM_DB = -80.0  # RMS EVM of spectra vs float64, and kernel vs plain
STREAM_DB, ROUNDTRIP_DB = -120.0, -70.0  # tests/test_pfb.py's bars
CPU_DB, DDC_STREAM_DB = -110.0, -115.0  # card vs CPU run; tests/test_ddc.py


KERNELS = ("rx_frame", "viterbi", "bcjr", "pfb_fold", "cmul", "stream", "halo")
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
SHARDED_DDC_DB = -100.0  # sharded DDC vs the one-device step (__graft_entry__.py's bar)
# (dec, fft_len, packed): the RX frame kernel's direct instance at 4,096 points
# (one CTA an SM) and at 64 (32 frames a CTA), the staged tile256 and tile512
# instances (fft_len not a power of two) and the generic instance (an unpacked
# chain whose frame is not whole bytes)
# phase 7's tie cases: a rate-1/2 code a constraint length (a third generator
# makes the rate-1/3 case)
VITERBI_TIE_CODES = {3: (0o5, 0o7), 5: (0o23, 0o35), 7: (0o171, 0o133), 9: (0o561, 0o753)}
F7_GEOMETRIES = ((4, 4096, True), (4, 64, True), (4, 192, True), (4, 3072, True),
                 (5, 30, False))


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
    classes: the generic instance)."""
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
    return cases


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
    with ThreadPoolExecutor(len(KERNELS) + 1) as pool:  # one nvcc per source, together
        builds = {k: pool.submit(build.load, k) for k in KERNELS}
        builds["the fold kernel's previous design"] = pool.submit(build.load_source, PARENT_FOLD)
        for kernel, fut in builds.items():
            try:
                fut.result()
            except Exception as e:  # the build's own message names the cause
                fail(f"{kernel} kernel build: {e}")
    print(f"build: {', '.join(f'{k}.cu -> {build.library_path(k).name}' for k in KERNELS)}, "
          f"and {PARENT_FOLD.name} (timed in phase 13) in {time.perf_counter() - t0:.2f} s "
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
    print(f"rx_frame main path: instance {main_plan[0]} (kernel_plan; the parent's was "
          f"{rf.staged_plan(dec, fft_len, None, taps.shape[-1])})")
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
    counts = read_counts()
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
    # the parent's main-path kernel: the tile256 instance, unchanged in this tree
    parent_plan = rf.staged_plan(dec, fft_len, None, ku + 1)
    hist_c = hist.contiguous()

    def parent_kernel():
        return rf.launch_staged(xb, hist_c, taps, dec, fft_len, "qpsk", parent_plan)

    got_new = rf.rx_frame(xb, taps, dec, fft_len, hist, "qpsk")
    got_old = parent_kernel()
    a_old = float((unpack(got_new) == unpack(got_old)).float().mean())
    print(f"compare rx_frame direct vs the parent's kernel ({parent_plan}): qpsk bits "
          f"{a_old:.7f} (need >= {AGREEMENT})")
    if a_old < AGREEMENT:
        fail("the direct instance and the parent's kernel disagree")
    iters, runs = 40, 4
    ms = {"plain": [], "kernel": [], "parent": [], "chain_kernel": [], "chain_plain": []}
    for run in range(runs):  # alternate which side runs first
        for which in (("plain", "parent", "kernel"), ("kernel", "parent", "plain"))[run % 2]:
            if which == "kernel":
                ms["kernel"].append(time_cuda(
                    lambda: rf.rx_frame(xb, taps, dec, fft_len, hist, "qpsk"), iters))
                ms["chain_kernel"].append(time_cuda(step_kernel, iters))
            elif which == "parent":
                ms["parent"].append(time_cuda(parent_kernel, iters))
            else:
                ms["plain"].append(time_cuda(
                    lambda: rf.rx_frame_reference(xb, taps, dec, fft_len, hist, "qpsk"),
                    iters))
                ms["chain_plain"].append(time_cuda(step_plain, iters))
    t = {k: float(np.median(v)) for k, v in ms.items()}
    msa = lambda m: BLOCK / (m * 1e-3) / 1e6  # noqa: E731
    for key, what in (
        ("kernel", "rx_frame kernel (direct), qpsk bytes"),
        ("parent", f"rx_frame parent's kernel ({parent_plan[0]}), qpsk bytes"),
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
        "parent": kernel_device_ms(parent_kernel, "rx_frame"),
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
    print(f"device: rx_frame direct {dev_ms['kernel']:.4f} ms, the parent's kernel "
          f"{dev_ms['parent']:.4f} ms a launch, the kernel inside a streaming step "
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
    # spans at the kernel's limit (one trellis a block, the decision history
    # alone in shared memory): the plain twin runs on the CPU copy
    for (polys, k) in (((0o23, 0o35), 5), ((0o133, 0o145, 0o175), 7)):
        n, lw_l = len(polys), vk.MAX_SMEM // (4 * max(1, (1 << (k - 1)) // 32))
        if not vk.kernel_supports(lw_l, n, k) or vk.kernel_supports(lw_l + 1, n, k):
            fail(f"viterbi K={k} rate 1/{n}: the span limit is not {lw_l} steps")
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
        print(f"compare bcjr {label} Lw {lw_c} x N {ls_c.shape[1]} "
              f"({bk.kernel_plan(tables, lw_c)}): kernel vs plain torch.equal "
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
    sys.stdout.flush()

    # ---- phase 8: the burst path, rx_batch on [256, 16384] ----------------
    burst_launches, modems, caps_dev, burst_set = {}, {}, {}, {}
    for fec_name in ("viterbi", "turbo"):
        cfg = PacketConfig(payload_bits=PAYLOAD, fec=fec_name)
        pm = PacketModem(cfg, device="cuda")
        payloads, caps = burst_captures(pm)
        x = torch.from_numpy(caps).cuda()
        torch.cuda.synchronize()
        reset_counts()
        bits_b, ok_b, diag_b = pm.rx_batch(x)
        torch.cuda.synchronize()
        counts = read_counts()
        want = ({**NO_LAUNCHES, "viterbi": 1} if fec_name == "viterbi"
                else {**NO_LAUNCHES, "bcjr": 16})
        exact = (bits_b.cpu().numpy() == payloads).all(axis=1)
        ok = ok_b.cpu().numpy()
        host_bits, host_ok, host_diag = PacketModem(cfg, device="cpu").rx_batch(
            torch.from_numpy(caps[:8]))
        same_host = (np.array_equal(host_bits.numpy(), bits_b[:8].cpu().numpy())
                     and np.array_equal(host_diag["offset"].numpy(),
                                        diag_b["offset"][:8].cpu().numpy()))
        print(f"burst path {fec_name}: rx_batch {tuple(x.shape)} -> payloads exact "
              f"{int(exact.sum())}/{BURSTS}, crc ok {int(ok.sum())}/{BURSTS}, launches "
              f"{counts} (need {want}), first 8 equal to the CPU run {same_host}, "
              f"noise_var median {float(diag_b['noise_var'].median()):.3e}", flush=True)
        if not (exact.all() and ok.all()) or counts != want or not same_host:
            fail(f"burst path {fec_name}: payloads/CRC/launches/CPU agreement wrong")
        burst_launches[fec_name] = counts[fec_name if fec_name == "viterbi" else "bcjr"]
        modems[fec_name], caps_dev[fec_name] = pm, x
        burst_set[fec_name] = (pm, x, payloads)

    # ---- phase 9: burst timings --------------------------------------------
    sym_v = llr_v.reshape(BURSTS, -1, 2).contiguous()
    lw_v = sym_v.shape[1]
    k7_tables = fec._conv_soft_coeffs(*K7)
    kernel_calls = {
        "viterbi": (lambda: vk.viterbi_lanes(sym_v, lw_v, 2, K7[0], 7, True, True),
                    lambda: vk.viterbi_lanes_reference(sym_v, lw_v, 2, K7[0], 7, True, True)),
        "bcjr": (lambda: bk.bcjr_windowed_llr(spans[0], spans[1], lw_t),
                 lambda: bk.bcjr_windowed_llr_reference(spans[0], spans[1], lw_t)),
        "bcjr K=7 (S 64, generic instance)": (
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
    # per step and state: two candidates of 2n ops, the min, the state minimum, the
    # subtraction; bytes: the LLRs in, one uint8 bit per step out
    vit_bound = bound(BURSTS * lw_v * 64 * (4 * 2 + 3), sym_v.numel() * 4 + BURSTS * lw_v)
    # per step and column 34 S + 1 ops (csrc/bcjr.cu); bytes: two spans in, LLRs out
    bcjr_bound = bound(lw_t * cols_t * (34 * 8 + 1), 3 * lw_t * cols_t * 4)
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
    k7_dev = kernel_device_ms(kernel_calls["bcjr K=7 (S 64, generic instance)"][0],
                              "bcjr_kernel")
    print(f"bound: bcjr {bcjr_bound['bound_ms']:.5f} ms by {bcjr_bound['bound_by']}; kernel "
          f"device time {bcjr_dev:.5f} ms a launch (torch.profiler, mean over 20 launches), "
          f"instance {bk.kernel_plan(None, lw_t)}; K=7 (S 64, generic instance) device time "
          f"{k7_dev:.5f} ms a launch [{card}]")
    print(f"chain floor (estimate, not measured): bcjr {chain_floor:.5f} ms = {lw_t} steps x "
          f"{CHAIN_OPS} dependent FP32 ops a step (assumed) x {OP_CYCLES} cycles each "
          f"(assumed) at {clock_hz / 1e6:.0f} MHz (nvidia-smi clocks.max.sm); the kernel's "
          f"measured device time is {bcjr_dev / chain_floor:.1f}x it [{card}]")

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

    print(json.dumps({"kernels": [
        {
            "name": "rx_frame",
            "route": "cuda",
            "source": "aether_primitives_tpu_torch/csrc/rx_frame.cu",
            "replaces": "aether_primitives_tpu/ops/pallas/rx_frame.py:49",
            "launches": main_launches,
            "max_abs_err": worst_err,
            "ms": t["kernel"],
            "plain_ms": t["plain"],
            **rx_frame_bound,
            "library_ms": None,
            "instance": main_plan[0],
            "device_ms": dev_ms["kernel"],
            "parent_ms": t["parent"],
            "parent_device_ms": dev_ms["parent"],
            "parent_instance": parent_plan[0],
            "step_ms": t["chain_kernel"],
            "step_host_enqueue_ms": t["enqueue"],
            "instances": instances,
        },
        {
            "name": "viterbi",
            "route": "cuda",
            "source": "aether_primitives_tpu_torch/csrc/viterbi.cu",
            "replaces": "aether_primitives_tpu/ops/pallas/viterbi.py:64",
            "launches": burst_launches["viterbi"],
            "max_abs_err": vit_err,
            "ms": kt["viterbi"]["kernel"],
            "plain_ms": kt["viterbi"]["plain"],
            **vit_bound,
            "library_ms": None,
            "device_ms": vit_dev,
        },
        {
            "name": "bcjr",
            "route": "cuda",
            "source": "aether_primitives_tpu_torch/csrc/bcjr.cu",
            "replaces": "aether_primitives_tpu/ops/pallas/bcjr.py:37",
            "launches": burst_launches["turbo"],
            "max_abs_err": bcjr_err,
            "ms": kt["bcjr"]["kernel"],
            "plain_ms": kt["bcjr"]["plain"],
            **bcjr_bound,
            "library_ms": None,
            "device_ms": bcjr_dev,
            "instance": bk.kernel_plan(None, lw_t)[0],
            "k7_ms": kt["bcjr K=7 (S 64, generic instance)"]["kernel"],
            "k7_device_ms": k7_dev,
        },
        pfb_entry,
        cmul_entry,
        stream_entry,
        halo_entry,
    ]}))
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
    """Set every kernel's launch count to 0 (just before a path runs)."""
    import importlib

    for k in KERNELS:
        importlib.import_module(f"aether_primitives_tpu_torch.ops.cuda.{k}").launches = 0


def read_counts() -> dict:
    """Every kernel's launch count (read just after a path ran)."""
    import importlib

    return {k: importlib.import_module(f"aether_primitives_tpu_torch.ops.cuda.{k}").launches
            for k in KERNELS}


def rx_frame_instances(card: str, device: str = "cuda", n_check: int = 1 << 18,
                       n_time: int = 1 << 22) -> dict:
    """Phase 3, the geometries outside the main path's instance (the RX
    frame kernel's tile512 and generic instances and the card's own stage
    split): for each of :data:`F7_GEOMETRIES`, the chain's two-block
    streaming gate on two ``~n_check``-sample blocks (one RX frame launch a
    step, bits against the float64 chain, the block-2 spectrum, the state);
    the kernel against its plain twin given the same stage split (spectrum
    EVM and, where frames are whole bytes, QPSK and BPSK bytes); and both
    timed on a ``~n_time``-sample block. Returns the kernels' JSON line's
    ``instances`` entry of the rx_frame kernel."""
    import numpy as np
    import torch

    from aether_primitives_tpu_torch.cli import capture, gate, stream_blocks
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
        counts = read_counts()
        g = gate(chain, x_full, n, bits, states)
        split = "FIR + FFT" if instance == "direct" else f"n1 {n1}, n2 {span // n1}"
        label = (f"{instance}, dec {dec}, fft_len {fft_len}, {split}, "
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
        print(f"compare rx_frame {label}: kernel vs plain twin at n1 {n1}: spectrum "
              f"{k_db:.2f} dB RMS EVM (need <= {EVM_DB}), max |kernel - plain| {worst:.3e}; "
              f"whole-byte epilogues agree >= {AGREEMENT}")
        xt = torch.from_numpy(capture(span * (n_time // span), 3400)).to(dev)
        epi = "qpsk" if fft_len * 2 % 8 == 0 else "spectrum"
        t, runs = timed_pair(lambda: rf.rx_frame(xt, taps, dec, fft_len, None, epi),
                             lambda: rf.rx_frame_reference(xt, taps, dec, fft_len, None, epi,
                                                           n1),
                             iters=(20, 3), runs=2)
        print(f"time: rx_frame {label}, {epi} on [{xt.shape[0]}]: kernel median "
              f"{t['kernel']:.4f} ms (runs {', '.join(f'{v:.4f}' for v in runs['kernel'])}), "
              f"plain twin median {t['plain']:.4f} ms (runs "
              f"{', '.join(f'{v:.4f}' for v in runs['plain'])}); CUDA events [{card}]",
              flush=True)
        out[f"{instance} dec {dec} fft_len {fft_len}"] = {
            "n1": n1, "launches": counts["rx_frame"], "max_abs_err": worst,
            "ms": t["kernel"], "plain_ms": t["plain"], "samples": int(xt.shape[0]),
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
    for bit; returns the largest absolute difference (0.0 when equal)."""
    import torch

    got, plain = run_kernel(), run_plain()
    sync(plain[0].device if isinstance(plain, tuple) else plain.device)
    got = got if isinstance(got, tuple) else (got,)
    plain = plain if isinstance(plain, tuple) else (plain,)
    same = all(torch.equal(g, q) for g, q in zip(got, plain))
    err = max(float((g - q).abs().max()) if g.numel() else 0.0 for g, q in zip(got, plain))
    print(f"compare pfb_fold {label}: kernel vs plain twin torch.equal {same}, "
          f"max |diff| {err}")
    if not same:
        fail(f"pfb_fold {label}: kernel and plain twin disagree")
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
    counts = read_counts()
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
    counts_c = read_counts()
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

    # ---- phase 12: the DDC path, two blocks ----------------------------
    cfg = DdcConfig(freq=0.1375, decimation=8)
    ddc = Ddc(cfg, device=dev)
    sync(dev)
    reset_counts()
    outs = [ddc.step(b) for b in blocks[:2]]
    sync(dev)
    ddc_counts = read_counts()
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


def profile_step(torch, step, name: str, step_ms: float, card: str, steps: int = 5) -> float:
    """torch.profiler split of one of the channelizer's steps: the fold
    kernel, the FFT kernels, the rest, with the records kept; the device's
    idle share, of the profiled steps' wall time (profiler on) and of
    ``step_ms``, the step's CUDA-event time without the profiler. Returns
    the device's busy milliseconds a step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
    split = {"fold": 0.0, "fft": 0.0, "rest": 0.0}
    names = {}
    for k in kernels:
        us = k.time_range.elapsed_us()
        key = "fold" if "pfb_fold" in k.name else "fft" if "fft" in k.name.lower() else "rest"
        split[key] += us
        t, n = names.get(k.name, (0.0, 0))
        names[k.name] = (t + us, n + 1)
    busy = per(sum(split.values()))
    print(f"profile {name}: device busy {busy:.4f} ms/step of {wall_ms:.4f} ms wall "
          f"(idle {100 * (1 - busy / wall_ms):.1f}%, profiler on; idle "
          f"{100 * (1 - busy / step_ms):.1f}% of the {step_ms:.4f} ms un-profiled step); "
          f"fold kernel {per(split['fold']):.4f} ms, FFT {per(split['fft']):.4f} ms, rest "
          f"{per(split['rest']):.4f} ms; {len(kernels)} kernel records over {steps} steps "
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
          f"{split['rx_front']:.4f} ms, decode {split['decode']:.4f} ms (decoder kernels "
          f"{decoder:.4f} ms), tail {split['rx_tail']:.4f} ms; {len(kernels) // calls} "
          f"kernels per call (torch.profiler, {calls} calls, profiler on) [{card}]")
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
    counts = read_counts()
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
        return outs, time.perf_counter() - t0, ex, read_counts()

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
    pcounts = read_counts()
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
            counts = read_counts()
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
            before = read_counts()
            bits, state = chain.sharded_streaming_step_2d(b, state, mesh)
            after = read_counts()
            calls.append({k: after[k] - before[k] for k in after})
            outs.append(bits)
            states.append(state)
        sync_all()
        counts = read_counts()
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
    counts = read_counts()
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
        counts = read_counts()
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
        counts = read_counts()
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
            got = [host_clock(fn, 20) for _ in range(runs)]
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


if __name__ == "__main__":
    main()
