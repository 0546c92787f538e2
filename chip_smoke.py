#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card (an H100).

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It drives the port's main path, the streaming RX chain
(``RxChain(RxChainConfig(fft_len=2048, decimation=4, packed_bits=True),
device="cuda").streaming_step``) on 4,194,304-sample blocks, through the
hand-written RX frame kernel (``aether_primitives_tpu_torch/csrc/rx_frame.cu``),
in five phases:

1. the card's name and power limit (exits 1 without a CUDA device);
2. the kernel's build from the sources in the checkout, timed;
3. the kernel against its plain PyTorch version and the float64 chain at
   the main path's shapes: QPSK and BPSK bytes and the spectrum epilogue,
   with and without carried history;
4. the main path's two-block streaming gate, counting kernel launches;
5. CUDA-event timings of the kernel path and the plain path.

Any failed phase prints its cause and exits 1. The line before the last
is the kernels' JSON summary; the last line is
``{"ok": true, "device": {...}}``.
"""

import json
import sys
import time

# tolerances, stated once
AGREEMENT = 0.99999  # hard bits vs the float64 chain, and kernel vs plain
EVM_DB = -80.0  # RMS EVM of spectra vs float64, and kernel vs plain


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a CUDA card")
    from aether_primitives_tpu_torch.cli import (
        BLOCK, capture, card_label, gate, numpy_reference_spectra,
        resident_streaming, stream_blocks, time_cuda,
    )
    from aether_primitives_tpu_torch.models import RxChain, RxChainConfig
    from aether_primitives_tpu_torch.ops.cuda import build, rx_frame as rf

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
    try:
        build.load("rx_frame")
    except Exception as e:  # the build's own message names the cause
        fail(f"rx_frame kernel build: {e}")
    print(f"build: rx_frame.cu -> {build.library_path('rx_frame').name} "
          f"in {time.perf_counter() - t0:.2f} s")
    log = build.library_path("rx_frame").with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")
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
    rf.launches = 0
    bits, states = stream_blocks(chain, x_full, BLOCK)
    torch.cuda.synchronize()
    main_launches = rf.launches
    print(f"main path: {len(bits)} streaming steps, rx_frame.launches = {main_launches}")
    if main_launches != len(bits):
        fail(f"rx_frame.launches {main_launches} != {len(bits)} streaming steps")
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

    print(json.dumps({"kernels": [{
        "name": "rx_frame",
        "route": "cuda",
        "source": "aether_primitives_tpu_torch/csrc/rx_frame.cu",
        "replaces": "aether_primitives_tpu/ops/pallas/rx_frame.py:49",
        "launches": main_launches,
        "max_abs_err": worst_err,
        "ms": t["kernel"],
        "plain_ms": t["plain"],
    }]}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
