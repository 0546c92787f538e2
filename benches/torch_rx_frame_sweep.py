#!/usr/bin/env python3
"""The RX frame kernel of the PyTorch port on one CUDA card, beside the
parent tree's kernel, at the main path's geometry and ``chip_smoke.py``'s
``F7_GEOMETRIES``.

For each geometry (dec 4 / fft_len 2048 with real and with complex taps;
``chip_smoke.py``'s phase 3 geometries: dec 4 / fft_len 4096, 64, 192,
3072, 131 and 8192, dec 5 / 30, dec 16 / 2048, dec 8 / 4096, dec 64 / 512,
dec 1 / 65536, and the global instance's dec 4 / 4,099 and 16,411, dec 2 /
8,198, dec 1 / 131,072, dec 4 / 262,144 and dec 1 / 4,194,304 (with those,
the plain twin in the same turns by CUDA events, and ``torch.fft.fft``
over the block's decimated frames as a yardstick for the FFT alone); and
off the main path, dec 1 / fft_len 2048 with 129 taps,
dec 2 / fft_len 1024, dec 8 / fft_len 512 and dec 3 / 1536 with the chain's
own lowpass) on a block of about 4,194,304 samples with carried history:
this tree's ``rx_frame`` (the instance of ``ops/cuda/rx_frame.py
kernel_plan``) and, with ``--parent DIR``, the parent tree's ``rx_frame``
(its package imported from DIR under another name, built into DIR's own
``build/``, in its own routing: the staged instances where its direct one
did not go, "raised" where it took no instance), each first held against
this tree's plain twin (bits >= 0.99999, spectrum <= -80 dB RMS EVM), then
timed in turns (parent, this, this, parent): CUDA events (median of 4 runs
of 50 calls, the wrapper's host time included) and ``torch.profiler``
(device time a launch), beside the block's byte bound. Then the direct
instance's device time against the taps' count (K = 1, 9, 33, 65, 129 of the
chain's lowpass design, QPSK and spectrum) at dec 4 / fft_len 2048, 64 and
4096, dec 1 / fft_len 2048 and dec 8 / fft_len 512: K = 1 leaves the
staging, the FFT and the epilogue, so the slope is the FIR's cost. Then the
main path's streaming step: CUDA events over resident 4M blocks, the host's
enqueue time a step (host clock, no synchronise inside the loop), and the
kernel's device time inside the step. Every line carries the card's name
and power limit.

Run from the repository root on a machine with a CUDA card:
``python3 benches/torch_rx_frame_sweep.py [--parent DIR]``, where ``DIR``
is another checkout (``git archive <commit> | tar -x -C build/parent``).
Imports the port only.
"""

import argparse
import importlib
import importlib.util
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from aether_primitives_tpu_torch.cli import (  # noqa: E402
    BLOCK, capture, card_label, kernel_device_ms, resident_streaming, time_cuda,
)
from aether_primitives_tpu_torch.evm import evm_rms_db  # noqa: E402
from aether_primitives_tpu_torch.models import RxChain, RxChainConfig  # noqa: E402
from aether_primitives_tpu_torch.models.modem import _default_lowpass  # noqa: E402
from aether_primitives_tpu_torch.ops.cuda import rx_frame as rf  # noqa: E402
from aether_primitives_tpu_torch.ops.fft import Scale  # noqa: E402

# (label, dec, fft_len, complex taps, taps: None for the chain's own)
GEOMETRIES = (
    ("main path", 4, 2048, False, None), ("main path, complex taps", 4, 2048, True, None),
    ("F7", 4, 4096, False, None), ("F7", 4, 64, False, None), ("F7", 4, 192, False, None),
    ("F7", 4, 3072, False, None), ("F7", 5, 30, False, None), ("F7", 4, 131, False, None),
    ("F7", 16, 2048, False, None), ("F7", 4, 8192, False, None),
    ("F7", 8, 4096, False, None), ("F7", 64, 512, False, None),
    ("F7", 1, 65536, False, None),
    ("F7 global", 4, 4099, False, None), ("F7 global", 4, 16411, False, None),
    ("F7 global", 2, 8198, False, None), ("F7 global", 1, 131072, False, None),
    ("F7 global", 4, 262144, False, None), ("F7 global", 1, 4194304, False, None),
    ("off path", 1, 2048, False, 129), ("off path", 2, 1024, False, None),
    ("off path", 8, 512, False, None), ("off path", 3, 1536, False, None),
)
ITERS, RUNS = 50, 4
TAP_COUNTS = (1, 9, 33, 65, 129)
TAP_GEOMETRIES = ((4, 2048), (4, 64), (4, 4096), (1, 2048), (8, 512))
PEAK_BYTES = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet


def parent_rx_frame(root: str):
    """The parent tree's ``ops/cuda/rx_frame`` module: its package imported
    from ``root`` as ``parent_port`` (its kernels build into ``root``'s
    own ``build/``)."""
    pkg = Path(root).resolve() / "aether_primitives_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        "parent_port", pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["parent_port"] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module("parent_port.ops.cuda.rx_frame")


def direct_launcher(x, hist, taps, dec, fft_len, epilogue):
    """A closure launching the direct instance straight; ``(run, out)``."""
    fpc, wp, nb = rf.direct_layout(dec, fft_len, taps.shape[-1])
    frames = x.shape[-1] // (dec * fft_len)
    if epilogue == "spectrum":
        out = torch.empty((frames, fft_len), dtype=torch.complex64, device=x.device)
    else:
        out = torch.empty(frames * fft_len * (2 if epilogue == "qpsk" else 1) // 8,
                          dtype=torch.uint8, device=x.device)
    taps_ri, real = rf._direct_taps(taps.tobytes())
    n_mixed, rads, npass = rf.direct_radices(fft_len)
    args = (rf.EPILOGUES[epilogue], x.data_ptr(), None if hist is None else hist.data_ptr(),
            rf.twiddles(fft_len, str(x.device)).data_ptr(), taps_ri.ctypes.data,
            taps.shape[-1], int(real), out.data_ptr(), frames, frames, dec,
            fft_len.bit_length() - 1, fpc, wp, nb, n_mixed,
            None if rads is None else rads.ctypes.data, npass, Scale.SN.factor_for(fft_len), 0)
    entry = rf._direct_entry()

    def run():
        if entry(*args, torch._C._cuda_getCurrentRawStream(0)):
            sys.exit("direct rx_frame launch failed")
    return run, out


def agree(out, twin, epilogue):
    """Bit agreement, or spectrum EVM in dB, of a launch's output."""
    if epilogue == "spectrum":
        return evm_rms_db(out.reshape(twin.shape).cpu().numpy(), twin.cpu().numpy())
    return float((rf.unpack_bits(out.reshape(-1)) == rf.unpack_bits(twin.reshape(-1)))
                 .float().mean())


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="a checkout of the parent tree to time beside this one")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    card = card_label()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    prf = parent_rx_frame(args.parent) if args.parent else None
    for label, dec, fft_len, cplx, n_taps in GEOMETRIES:
        if n_taps is None:
            taps = RxChain(RxChainConfig(fft_len=fft_len, decimation=dec), device="cuda").taps
        else:
            taps = _default_lowpass(n_taps, 1.0 / 8)
        if cplx:
            taps = (taps * np.exp(0.4j)).astype(np.complex64)
        span, k = dec * fft_len, taps.shape[-1]
        x = torch.from_numpy(capture(span * max(1, BLOCK // span), 4100 + fft_len)).cuda()
        hist = torch.from_numpy(capture(k - 1, 4200)).cuda() if k > 1 else None
        epi = "qpsk" if fft_len * 2 % 8 == 0 else "spectrum"
        plan = rf.kernel_plan(dec, fft_len, None, k)
        twin = rf.rx_frame_reference(x, taps, dec, fft_len, hist, epi)
        turns = {"this tree": (rf, plan[0])}
        if prf is not None:
            turns["parent"] = (prf, prf.kernel_plan(dec, fft_len, None, k))
        runs, dev = {}, {}
        for name, (mod, inst) in turns.items():
            if mod is None or inst is None:
                turns[name] = (None, f"raised (no instance: {inst})")
                continue
            run = (lambda m: lambda: m.rx_frame(x, taps, dec, fft_len, hist, epi))(mod)
            try:
                out = run()
                torch.cuda.synchronize()
            except ValueError as e:
                turns[name] = (None, f"raised: {str(e)[:80]}")
                continue
            a = agree(out, twin, epi)
            if not (a <= -80.0 if epi == "spectrum" else a >= 0.99999):
                sys.exit(f"{label} dec {dec} fft_len {fft_len}: {name} disagrees with the "
                         f"twin ({a})")
            runs[name] = run
        if plan[0] == "global":
            runs["twin"] = lambda: rf.rx_frame_reference(x, taps, dec, fft_len, hist, epi)
        times = {name: [] for name in runs}
        order = [n for n in ("parent", "this tree", "twin") if n in runs]
        for r in range(RUNS):
            for name in (order if r % 2 == 0 else order[::-1]):
                times[name].append(time_cuda(runs[name], ITERS, warmup=3))
        for name in order:
            if name != "twin":
                dev[name] = kernel_device_ms(runs[name], "rx_frame")
        out_bytes = (x.numel() // span) * (fft_len * 8 if epi == "spectrum" else fft_len // 4)
        bound = (x.numel() * 8 + out_bytes) / PEAK_BYTES * 1e3
        if "twin" in runs:
            frames_in = torch.from_numpy(capture(x.numel() // dec, 4300)).cuda().reshape(
                -1, fft_len)
            lib = float(np.median([time_cuda(lambda: torch.fft.fft(frames_in), ITERS)
                                   for _ in range(RUNS)]))
            print(f"{label}, dec {dec}, fft_len {fft_len}, {x.numel()} samples: plain twin "
                  f"median {float(np.median(times['twin'])):.4f} ms (runs "
                  f"{', '.join(f'{v:.4f}' for v in times['twin'])}; CUDA events, in the same "
                  f"turns); torch.fft.fft over the {x.numel() // span} decimated frames "
                  f"(cuFFT, the FFT alone) {lib:.4f} ms [{card}]", flush=True)
        for name in turns:
            inst = turns[name][1]
            if name not in runs:
                print(f"{label}, dec {dec}, fft_len {fft_len}, {k} taps, {epi}: {name} "
                      f"{inst} [{card}]", flush=True)
                continue
            print(f"{label}, dec {dec}, fft_len {fft_len}, {k} taps, {epi}, "
                  f"{x.numel()} samples: {name} ({inst}) median "
                  f"{float(np.median(times[name])):.4f} ms (runs "
                  f"{', '.join(f'{v:.4f}' for v in times[name])}; CUDA events, mean of "
                  f"{ITERS} calls); device {dev[name]:.4f} ms a launch (torch.profiler); "
                  f"byte bound {bound:.4f} ms ({dev[name] / bound:.1f}x) [{card}]", flush=True)
        if len(dev) == 2:
            print(f"{label}, dec {dec}, fft_len {fft_len}: device time this tree / parent "
                  f"{dev['this tree'] / dev['parent']:.3f} [{card}]", flush=True)

    x = torch.from_numpy(capture(BLOCK, 7)).cuda()
    for dec, fft_len in TAP_GEOMETRIES:
        for k in TAP_COUNTS:
            taps = (_default_lowpass(k, 1.0 / 8) if k > 1 else np.ones(1, np.complex64))
            hist = torch.from_numpy(capture(k - 1, 8)).cuda() if k > 1 else None
            line = []
            for epi in ("qpsk", "spectrum"):
                run, _ = direct_launcher(x, hist, taps, dec, fft_len, epi)
                line.append(f"{epi} {kernel_device_ms(run, 'rx_frame'):.5f}")
            print(f"taps: direct, dec {dec}, fft_len {fft_len}, K {k}, {BLOCK} samples: device "
                  f"ms a launch {', '.join(line)} (torch.profiler) [{card}]", flush=True)

    chain = RxChain(RxChainConfig(fft_len=2048, decimation=4, packed_bits=True),
                    device="cuda")
    step = resident_streaming(chain)
    ms = [time_cuda(step, ITERS) for _ in range(RUNS)]
    host = []
    for _ in range(RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            step()
        host.append((time.perf_counter() - t0) / 10 * 1e3)
        torch.cuda.synchronize()
    dev = kernel_device_ms(step, "rx_frame")
    print(f"main path streaming step: median {float(np.median(ms)):.4f} ms (runs "
          f"{', '.join(f'{v:.4f}' for v in ms)}; CUDA events, mean of {ITERS} steps); host "
          f"enqueue median {float(np.median(host)):.4f} ms a step (runs "
          f"{', '.join(f'{v:.4f}' for v in host)}; host clock, 10 steps, no synchronise); "
          f"kernel device {dev:.4f} ms a step (torch.profiler) [{card}]", flush=True)


if __name__ == "__main__":
    main()
