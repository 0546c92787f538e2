#!/usr/bin/env python3
"""Device and host time of the PyTorch port's channelizer steps on one CUDA
card: ``PfbChannelizerOs.step`` and ``PfbSynthesizerOs.step`` at the
channelizer path's shape (2,048 channels, os 2, ``taps_per_branch`` 16: P
33; 4,194,304-sample blocks resident on the card).

For each step: the step's time by CUDA events (median of 4 runs of 20
steps), the host's time to enqueue a step (host clock, no synchronise
inside the loop, the queue drained before and after), and a
``torch.profiler`` split of 5 steady steps into each kernel's device time a
step, with the number of records the profiler kept for each kernel (it
drops some: a device time is the mean over what it recorded), the fold
kernel's launches a step (the port's own count), and the device's busy
share of the profiled wall time. Every line carries the card's name and
power limit.

Run from the repository root on a machine with a CUDA card:
``python3 benches/torch_pfb_profile.py [--root DIR]``; ``--root`` imports
the package from another checkout (``git archive <commit> | tar -x -C
build/parent``) to profile that tree. Imports the port only.
"""

import argparse
import sys
import time
from pathlib import Path

M, OS, TPB, BLOCK = 2048, 2, 16, 1 << 22
STEPS, ITERS, RUNS = 5, 20, 4


def profile_step(torch, step, steps: int = STEPS):
    """``(busy_ms, wall_ms, {kernel: (ms a step, records)})`` of ``steps``
    calls of ``step`` under ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    kernels = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us, n = kernels.get(e.name, (0.0, 0))
            kernels[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    busy = sum(us for us, _ in kernels.values()) / steps / 1e3
    return busy, wall, {k: (us / steps / 1e3, n) for k, (us, n) in kernels.items()}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                    help="checkout whose package is profiled")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import numpy as np
    import torch

    from aether_primitives_tpu_torch.cli import capture, card_label, time_cuda
    from aether_primitives_tpu_torch.models import channelizer as ch
    from aether_primitives_tpu_torch.ops.cuda import pfb_fold as pf

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    card = card_label()
    print(f"tree: {Path(args.root).resolve()}; card: {card}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    blocks = [torch.from_numpy(capture(BLOCK, 4040 + i)).cuda() for i in range(3)]
    ana = ch.PfbChannelizerOs(M, os=OS, taps_per_branch=TPB, device="cuda")
    frames = [ana.step(b) for b in blocks]
    torch.cuda.synchronize()

    def stepper(stage, inputs):
        box = {"i": 0}

        def run():
            out = stage.step(inputs[box["i"] % len(inputs)])
            box["i"] += 1
            return out
        return run

    for name, stage, inputs in (
        ("analysis step", ch.PfbChannelizerOs(M, os=OS, taps_per_branch=TPB, device="cuda"),
         blocks),
        ("synthesis step", ch.PfbSynthesizerOs(M, os=OS, taps_per_branch=TPB, device="cuda"),
         frames[1:]),
    ):
        run = stepper(stage, inputs)
        ev = [time_cuda(run, ITERS) for _ in range(RUNS)]
        enq = []
        for _ in range(RUNS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(ITERS):
                run()
            enq.append((time.perf_counter() - t0) * 1e3 / ITERS)
            torch.cuda.synchronize()
        before = pf.launches
        run()
        torch.cuda.synchronize()
        per_step = pf.launches - before
        busy, wall, kernels = profile_step(torch, run)
        fold = sum(ms for k, (ms, _) in kernels.items() if "pfb_fold" in k)
        print(f"{name} ({tuple(inputs[0].shape)} in): CUDA events median "
              f"{float(np.median(ev)):.4f} ms (runs {', '.join(f'{v:.4f}' for v in ev)}; "
              f"{ITERS} steps each); host enqueue median {float(np.median(enq)):.4f} ms a step "
              f"(runs {', '.join(f'{v:.4f}' for v in enq)}); device busy {busy:.4f} ms a step "
              f"of {wall:.4f} ms wall (profiler on, {STEPS} steps), fold kernel {fold:.4f} ms "
              f"a step, {per_step} fold launch(es) a step [{card}]")
        for k, (ms, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0]):
            print(f"  {ms:.4f} ms/step  {n:3d} records  {k[:100]}")


if __name__ == "__main__":
    main()
