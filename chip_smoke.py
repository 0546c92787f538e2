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
  same configuration) on 4,194,304-sample blocks, through the PFB fold
  kernel (``csrc/pfb_fold.cu``), and the DDC (``Ddc(DdcConfig(freq=0.1375,
  decimation=8), device="cuda")``) on the same blocks,

in thirteen phases:

1. the card's name and power limit (exits 1 without a CUDA device);
2. the four kernels' builds from the sources in the checkout, started
   together, timed, with the RX frame and PFB fold compiler reports;
3. the RX frame kernel against its plain PyTorch version and the float64
   chain at the main path's shapes: QPSK and BPSK bytes and the spectrum
   epilogue, with and without carried history;
4. the RX chain's two-block streaming gate, counting kernel launches;
5. CUDA-event timings of the RX chain's kernel path and plain path;
6. the Viterbi and BCJR kernels' register and spill reports;
7. the Viterbi and BCJR kernels against their plain twins at the burst
   path's shapes, bit for bit (``array_equal``);
8. the burst path: 256 bursts built by the port's own ``tx`` through a
   numpy channel from a fixed seed, decoded by ``rx_batch`` for both FECs;
   every payload exact and CRC-ok, exactly 1 Viterbi and 16 BCJR launches
   per call, and the first 8 bursts equal to the port's CPU run;
9. CUDA-event timings of each burst kernel against its plain twin and of
   ``rx_batch`` end to end, and a ``torch.profiler`` split of ``rx_batch``
   into front end, decoder kernels and the rest;
10. the PFB fold kernel against its plain twin, bit for bit
    (``torch.equal``), at the channelizer's shapes: the analysis fold, the
    oversampled and the critically sampled synthesis spreads, and a ragged
    batched case;
11. the channelizer path: three consecutive blocks through analysis and
    synthesis, exactly 1 + os fold launches per step and no other kernel,
    the first 64 frames against a float64 golden (<= -80 dB), the streamed
    analysis against one-shot ``pfb_channelize_os`` (<= -120 dB), the
    reconstructed interior against the input (<= -70 dB), and the first
    frames against the port's CPU run (<= -110 dB);
12. the DDC path over two blocks: against the float64 composed golden on a
    prefix (<= -80 dB) and block by block against one-shot (<= -115 dB);
13. CUDA-event timings of the fold kernel, its plain twin and the one-call
    ``conv1d`` yardstick, of the analysis, synthesis and DDC steps, and of
    ``pfb_synthesize`` (slice-sum and kernel), with a ``torch.profiler``
    split of one analysis step.

Any failed phase prints its cause and exits 1. The line before the last
is the kernels' JSON summary; the last line is
``{"ok": true, "device": {...}}``.
"""

import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor

# tolerances, stated once
AGREEMENT = 0.99999  # hard bits vs the float64 chain, and kernel vs plain
EVM_DB = -80.0  # RMS EVM of spectra vs float64, and kernel vs plain
STREAM_DB, ROUNDTRIP_DB = -120.0, -70.0  # tests/test_pfb.py's bars
CPU_DB, DDC_STREAM_DB = -110.0, -115.0  # card vs CPU run; tests/test_ddc.py


KERNELS = ("rx_frame", "viterbi", "bcjr", "pfb_fold")
NO_LAUNCHES = {k: 0 for k in KERNELS}  # a path's launch counts are read against this
# the burst path: benches/burst_bench.py's configuration at full width
PAYLOAD, CAPTURE, BURSTS = 600, 16384, 256
K7, K5 = ((0o171, 0o133), 7), ((0o25, 0o33, 0o37), 5)
# H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor cores, HBM3
PEAK_FP32, PEAK_BYTES = 67e12, 3.35e12


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


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a CUDA card")
    from aether_primitives_tpu_torch.cli import (
        BLOCK, capture, card_label, gate, numpy_reference_spectra,
        resident_streaming, stream_blocks, time_cuda,
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
    with ThreadPoolExecutor(len(KERNELS)) as pool:  # one nvcc per source, together
        builds = {k: pool.submit(build.load, k) for k in KERNELS}
        for kernel, fut in builds.items():
            try:
                fut.result()
            except Exception as e:  # the build's own message names the cause
                fail(f"{kernel} kernel build: {e}")
    print(f"build: {', '.join(f'{k}.cu -> {build.library_path(k).name}' for k in KERNELS)} "
          f"in {time.perf_counter() - t0:.2f} s (parallel)")
    print_ptxas(build, "rx_frame")
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
          f"{time.perf_counter() - t0:.1f} s (host)")
    half = ref_spec.shape[0] // 2
    x_dev = torch.from_numpy(x_full).cuda()
    cases = {
        "block 1, zero history": (x_dev[:BLOCK], None, ref_spec[:half]),
        "block 2, carried history": (x_dev[BLOCK:].contiguous(),
                                     x_dev[BLOCK - ku:BLOCK], ref_spec[half:]),
    }
    unpack = rf.unpack_bits
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
        ("kernel", "rx_frame kernel, qpsk bytes"),
        ("plain", "rx_frame plain PyTorch, qpsk bytes"),
        ("chain_kernel", "streaming step, kernel path"),
        ("chain_plain", "streaming step, plain path"),
    ):
        print(f"time: {what}: median {t[key]:.4f} ms/block = {msa(t[key]):.1f} Msa/s "
              f"(runs {', '.join(f'{v:.4f}' for v in ms[key])} ms; CUDA events, "
              f"mean of {iters} calls per run, blocks resident) [{card}]")

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

    # the bound of the timed call: one 4M block with history, QPSK bytes
    n1 = 128  # the heuristic's stage split at fft_len 2048, dec 4
    n2, r, frames = dec * fft_len // n1, fft_len // n1, BLOCK // (dec * fft_len)
    rx_frame_bound = bound(
        8.0 * frames * (n1 * n1 * n2 + n1 * n2 * r + ku * fft_len),  # complex MACs
        BLOCK * 8 + BLOCK // 16 + ku * 8 + 8 * (n1 * n1 + r * n2 * n1 + r * ku * n1),
    )
    sys.stdout.flush()

    # ---- phase 6: the burst kernels' compiler reports --------------------
    for kernel in ("viterbi", "bcjr"):
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
    lw_t, cols_t = 16 + 64 + 16, BURSTS * 10  # turbo: window 64, guard 16, 10 windows
    spans = [torch.from_numpy((rng.normal(size=(lw_t, cols_t)) * 3).astype(np.float32)).cuda()
             for _ in range(2)]
    bcjr_err = 0.0
    for label, tables in (("RSC-8", None), ("K=7 conv", fec._conv_soft_coeffs(*K7))):
        got = bk.bcjr_windowed_llr(spans[0], spans[1], lw_t, tables)
        plain = bk.bcjr_windowed_llr_reference(spans[0], spans[1], lw_t, tables)
        torch.cuda.synchronize()
        err = float((got - plain).abs().max())
        bcjr_err = max(bcjr_err, err)
        print(f"compare bcjr {label} Lw {lw_t} x N {cols_t}: kernel vs plain "
              f"array_equal {torch.equal(got, plain)}, max |diff| {err}")
        if not torch.equal(got, plain):
            fail(f"bcjr {label}: kernel and plain twin disagree")
    sys.stdout.flush()

    # ---- phase 8: the burst path, rx_batch on [256, 16384] ----------------
    burst_launches, modems, caps_dev = {}, {}, {}
    for fec_name in ("viterbi", "turbo"):
        cfg = PacketConfig(payload_bits=PAYLOAD, fec=fec_name)
        pm = PacketModem(cfg, device="cuda")
        brng = np.random.default_rng(4242)
        payloads = brng.integers(0, 2, (BURSTS, PAYLOAD)).astype(np.uint8)
        bursts = pm.tx(torch.from_numpy(payloads)).cpu().numpy()
        caps = np.stack([
            burst_channel(bursts[i], brng, delay=64 + (i * 53) % 2048,
                          cfo=((i % 7) - 3) * 3e-4)
            for i in range(BURSTS)
        ])
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

    # ---- phase 9: burst timings --------------------------------------------
    sym_v = llr_v.reshape(BURSTS, -1, 2).contiguous()
    lw_v = sym_v.shape[1]
    kernel_calls = {
        "viterbi": (lambda: vk.viterbi_lanes(sym_v, lw_v, 2, K7[0], 7, True, True),
                    lambda: vk.viterbi_lanes_reference(sym_v, lw_v, 2, K7[0], 7, True, True)),
        "bcjr": (lambda: bk.bcjr_windowed_llr(spans[0], spans[1], lw_t),
                 lambda: bk.bcjr_windowed_llr_reference(spans[0], spans[1], lw_t)),
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
        print(f"time: {kernel} kernel median {kt[kernel]['kernel']:.4f} ms (runs "
              f"{', '.join(f'{v:.4f}' for v in runs['kernel'])}; mean of 50 calls), plain "
              f"twin median {kt[kernel]['plain']:.2f} ms (runs "
              f"{', '.join(f'{v:.2f}' for v in runs['plain'])}; mean of 2 calls), same "
              f"spans, CUDA events [{card}]")
    # per step and state: two candidates of 2n ops, the min, the state minimum, the
    # subtraction; bytes: the LLRs in, one uint8 bit per step out
    vit_bound = bound(BURSTS * lw_v * 64 * (4 * 2 + 3), sym_v.numel() * 4 + BURSTS * lw_v)
    # per step and column 34 S + 1 ops (csrc/bcjr.cu); bytes: two spans in, LLRs out
    bcjr_bound = bound(lw_t * cols_t * (34 * 8 + 1), 3 * lw_t * cols_t * 4)

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
        },
        pfb_entry,
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
    fold of ``x[t*hop : t*hop + P*M]`` with the prototype, rolled by
    ``(t*hop) mod M``, then ``np.fft.fft``."""
    import numpy as np

    hop = m // os
    p = -(-len(h) // m)
    hh = np.zeros(p * m)
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


def channelizer_phases(card: str, device: str = "cuda", m: int = 2048, os: int = 2,
                       tpb: int = 16, block: int = 1 << 22) -> dict:
    """Phases 10-13: the PFB fold kernel against its twin, the channelizer
    path, the DDC path and their timings, at ``M = m``, ``os`` and
    ``taps_per_branch = tpb`` on ``block``-sample blocks (the defaults are
    the path's; a smaller size on ``device="cpu"`` rehearses the phases,
    with the CUDA calls stubbed). Returns the fold kernel's entry of the
    kernels' JSON line."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from aether_primitives_tpu_torch.cli import capture, time_cuda
    from aether_primitives_tpu_torch.models import Ddc, DdcConfig
    from aether_primitives_tpu_torch.models import channelizer as ch
    from aether_primitives_tpu_torch.ops.cuda import pfb_fold as pf

    dev = torch.device(device)
    sync = torch.cuda.synchronize
    hop = m // os
    h = ch.pfb_prototype_nyquist(m, tpb)
    hb = ch._branches(h, m)
    p = hb.shape[0]
    w = torch.from_numpy(np.ascontiguousarray(hb.real)).to(dev)
    w_rev = torch.from_numpy(np.ascontiguousarray(hb.real[::-1])).to(dev)
    rng = np.random.default_rng(3030)

    def planes(n, batch=()):
        return tuple(torch.from_numpy(rng.normal(size=batch + (n,)).astype(np.float32)).to(dev)
                     for _ in range(2))

    # ---- phase 10: the fold kernel vs its twin at the path's shapes -----
    t_cls = block // m  # frames per class of a steady analysis step
    g = ch.pfb_synthesis_taps(ch.pfb_prototype(m, 8), m, taps_per_branch=16)
    gb = ch._branches(g, m)
    q, t_syn = gb.shape[0], block // m
    g_rev = torch.from_numpy(np.ascontiguousarray(gb.real[::-1], dtype=np.float32)).to(dev)
    m_r = 1000 if m >= 1000 else m - 8  # not a multiple of the 64-column strip
    w_ragged = torch.from_numpy(rng.normal(size=(7, m_r)).astype(np.float32)).to(dev)
    fold_cases = [
        (f"analysis os {os}, M {m}, P {p}, t_cls {t_cls}", os, t_cls, w, ()),
        (f"oversampled synthesis spread, os 1, reversed branches, {t_cls + p - 1} slabs",
         1, t_cls + p - 1, w_rev, ()),
        (f"critically sampled synthesis spread, Q {q}, {t_syn + q - 1} slabs",
         1, t_syn + q - 1, g_rev, ()),
        (f"ragged: M {m_r}, os 2, P 7, t_cls 1001, batch 3", 2, 1001, w_ragged, (3,)),
    ]
    fold_err, fold_in = 0.0, None
    for label, o, t, wb, batch in fold_cases:
        pp, mm = wb.shape
        xr, xi = planes((o - 1) * (mm // o) + (t - 1 + pp) * mm, batch)
        got = pf.pfb_fold_os(xr, xi, wb, o, t)
        plain = pf.pfb_fold_os_reference(xr, xi, wb, o, t)
        sync()
        same = torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])
        err = max(float((got[k] - plain[k]).abs().max()) for k in (0, 1))
        fold_err = max(fold_err, err)
        print(f"compare pfb_fold {label}: kernel vs plain torch.equal {same}, "
              f"max |diff| {err}")
        if not same:
            fail(f"pfb_fold {label}: kernel and plain twin disagree")
        if fold_in is None:
            fold_in = (xr, xi)
    sys.stdout.flush()

    # ---- phase 11: the channelizer path, three blocks -------------------
    n_blocks = 3
    x_full = capture(n_blocks * block, 4040)
    blocks = [torch.from_numpy(x_full[i * block:(i + 1) * block]).to(dev)
              for i in range(n_blocks)]
    ana = ch.PfbChannelizerOs(m, os=os, taps_per_branch=tpb, device=dev)
    syn = ch.PfbSynthesizerOs(m, os=os, taps_per_branch=tpb, device=dev)
    sync()
    reset_counts()
    frames, recon = [], []
    for b in blocks:
        frames.append(ana.step(b))
        recon.append(syn.step(frames[-1]))
    sync()
    counts = read_counts()
    want = {**NO_LAUNCHES, "pfb_fold": n_blocks * (1 + os)}
    print(f"channelizer path: {n_blocks} blocks of {block} through PfbChannelizerOs -> "
          f"PfbSynthesizerOs (M {m}, os {os}, P {p}, hop {hop}): frames per step "
          f"{[f.shape[0] for f in frames]}, samples out {[r.shape[-1] for r in recon]}, "
          f"launches {counts} (need {want}: 1 analysis + {os} synthesis per step)")
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

    # ---- phase 12: the DDC path, two blocks ----------------------------
    cfg = DdcConfig(freq=0.1375, decimation=8)
    ddc = Ddc(cfg, device=dev)
    sync()
    reset_counts()
    outs = [ddc.step(b) for b in blocks[:2]]
    sync()
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
    xr, xi = fold_in
    fold_t, fold_runs = timed_pair(lambda: pf.pfb_fold_os(xr, xi, w, os, t_cls),
                                   lambda: pf.pfb_fold_os_reference(xr, xi, w, os, t_cls))
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
    # bytes: the classes' input span once, both planes; both output planes; the taps
    fold_bytes = 8 * ((t_cls - 1 + p) * m + (os - 1) * hop) + 8 * os * t_cls * m + 4 * p * m
    fold_ops = os * t_cls * m * 2 * (2 * p - 1)  # P multiplies + P-1 adds per plane
    fold_bound = bound(fold_ops, fold_bytes)
    print(f"time: pfb_fold kernel [{os} x {t_cls} x {m}, P {p}] median {fold_t['kernel']:.4f} ms "
          f"(runs {', '.join(f'{v:.4f}' for v in fold_runs['kernel'])}; mean of 50 calls), "
          f"plain twin median {fold_t['plain']:.4f} ms (runs "
          f"{', '.join(f'{v:.4f}' for v in fold_runs['plain'])}; mean of 5 calls), conv1d "
          f"library median {lib_ms:.4f} ms (runs {', '.join(f'{v:.4f}' for v in lib_runs)}; "
          f"mean of 20; rel. diff from the twin {lib_rel:.2e}); bound {fold_bound['bound_ms']:.4f} "
          f"ms by {fold_bound['bound_by']} ({fold_bytes / 1e6:.1f} MB, {fold_ops / 1e9:.3f} G "
          f"FP32 ops); CUDA events [{card}]", flush=True)

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
        step_t[name] = t
        print(f"time: {name} ({tuple(inputs[0].shape)} in): kernel path median "
              f"{t['kernel']:.4f} ms = {msa(t['kernel']):.1f} Msa/s (runs "
              f"{', '.join(f'{v:.4f}' for v in runs['kernel'])}), plain path median "
              f"{t['plain']:.4f} ms = {msa(t['plain']):.1f} Msa/s (runs "
              f"{', '.join(f'{v:.4f}' for v in runs['plain'])}); CUDA events, blocks "
              f"resident [{card}]", flush=True)
    y_cs = blocks[0].reshape(t_syn, m)  # the capture read as channel frames
    cs_t, cs_runs = timed_pair(lambda: ch.pfb_synthesize(y_cs, m, taps=g, backend="auto"),
                               lambda: ch.pfb_synthesize(y_cs, m, taps=g), iters=(20, 20))
    print(f"time: pfb_synthesize [{t_syn} x {m}], Q {q}: fold kernel median "
          f"{cs_t['kernel']:.4f} ms = {msa(cs_t['kernel']):.1f} Msa/s (runs "
          f"{', '.join(f'{v:.4f}' for v in cs_runs['kernel'])}), slice-sum (the default) "
          f"median {cs_t['plain']:.4f} ms = {msa(cs_t['plain']):.1f} Msa/s (runs "
          f"{', '.join(f'{v:.4f}' for v in cs_runs['plain'])}) [{card}]")
    ddc_t = [time_cuda(stepper(Ddc(cfg, device=dev), blocks), 10) for _ in range(3)]
    print(f"time: DDC step (freq 0.1375, /8, 129 taps): median {np.median(ddc_t):.4f} ms = "
          f"{msa(float(np.median(ddc_t))):.1f} Msa/s (runs "
          f"{', '.join(f'{v:.4f}' for v in ddc_t)}; mean of 10) [{card}]", flush=True)
    profile_analysis(torch, stepper(ch.PfbChannelizerOs(m, os=os, taps_per_branch=tpb,
                                                        device=dev), blocks),
                     step_t["analysis step"]["kernel"], card)
    return {
        "name": "pfb_fold",
        "route": "cuda",
        "source": "aether_primitives_tpu_torch/csrc/pfb_fold.cu",
        "replaces": "aether_primitives_tpu/ops/pallas/pfb_fold.py:35",
        "launches": counts["pfb_fold"],
        "max_abs_err": fold_err,
        "ms": fold_t["kernel"],
        "plain_ms": fold_t["plain"],
        **fold_bound,
        "library_ms": lib_ms,
    }


def profile_analysis(torch, step, step_ms: float, card: str, steps: int = 5) -> None:
    """torch.profiler split of the channelizer's analysis step: the fold
    kernel, the FFT kernels, the rest; and the device's idle share, of the
    profiled steps' wall time (profiler on) and of ``step_ms``, the step's
    CUDA-event time without the profiler."""
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
        print("profile analysis step: the profiler recorded no device time")
        return
    per = lambda us: us / steps / 1e3  # noqa: E731
    split = {"fold": 0.0, "fft": 0.0, "rest": 0.0}
    names = {}
    for k in kernels:
        us = k.time_range.elapsed_us()
        key = "fold" if "pfb_fold" in k.name else "fft" if "fft" in k.name.lower() else "rest"
        split[key] += us
        names[k.name] = names.get(k.name, 0.0) + us
    busy = per(sum(split.values()))
    print(f"profile analysis step: device busy {busy:.4f} ms/step of {wall_ms:.4f} ms wall "
          f"(idle {100 * (1 - busy / wall_ms):.1f}%, profiler on; idle "
          f"{100 * (1 - busy / step_ms):.1f}% of the {step_ms:.4f} ms un-profiled step); "
          f"fold kernel {per(split['fold']):.4f} ms, "
          f"FFT {per(split['fft']):.4f} ms, rest {per(split['rest']):.4f} ms; "
          f"{len(kernels) // steps} kernels per step (torch.profiler, {steps} steps, "
          f"profiler on) [{card}]")
    for key, us in sorted(names.items(), key=lambda kv: -kv[1])[:6]:
        print(f"  {per(us):.4f} ms/step  {key[:90]}")


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

if __name__ == "__main__":
    main()
