#!/usr/bin/env python3
"""Where the time of the PyTorch port's DDC step goes on one CUDA card.

Streams 4,194,304-sample blocks resident on the card through
``Ddc(DdcConfig(freq=0.1375, decimation=8), device="cuda").step`` (the
channelizer slice's DDC configuration, 129 taps) and prints: the step's
CUDA-event time, the same for its two halves (``nco_mix`` and
``fir_filter_os_decimate``) alone, the host time to enqueue one step, and a
``torch.profiler`` split of the step's device time by kernel with the
device's idle share. A step much longer than its device time is the host's.

Run from the repository root on a machine with a CUDA card:
``python3 benches/torch_ddc_profile.py``. Imports the port only.
"""

import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from aether_primitives_tpu_torch.cli import BLOCK, capture, card_label, time_cuda  # noqa: E402
from aether_primitives_tpu_torch.models import Ddc, DdcConfig  # noqa: E402
from aether_primitives_tpu_torch.ops import fir, frontend  # noqa: E402

ITERS, RUNS, STEPS = 20, 3, 5


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    card = card_label()
    cfg = DdcConfig(freq=0.1375, decimation=8)
    blocks = [torch.from_numpy(capture(BLOCK, 70 + i)).cuda() for i in range(3)]
    ddc = Ddc(cfg, device="cuda")
    box = {"i": 0}

    def step():
        out = ddc.step(blocks[box["i"] % 3])
        box["i"] += 1
        return out

    mixed = frontend.nco_mix(blocks[0], -cfg.freq, 0.3)
    parts = {
        "step": step,
        "nco_mix": lambda: frontend.nco_mix(blocks[0], -cfg.freq, 0.3),
        "fir_filter_os_decimate": lambda: fir.fir_filter_os_decimate(
            mixed, ddc.taps, cfg.decimation, history=ddc._history),
    }
    for name, fn in parts.items():
        runs = [time_cuda(fn, ITERS) for _ in range(RUNS)]
        print(f"time: {name}: median {np.median(runs):.4f} ms (runs "
              f"{', '.join(f'{v:.4f}' for v in runs)}; mean of {ITERS}, CUDA events) [{card}]")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        step()
    host_ms = (time.perf_counter() - t0) * 1e3 / STEPS
    torch.cuda.synchronize()
    print(f"host: {host_ms:.4f} ms to enqueue one step (host clock, no synchronise) [{card}]")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / STEPS
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    names = {}
    for k in kernels:
        names[k.name] = names.get(k.name, 0.0) + k.time_range.elapsed_us()
    busy = sum(names.values()) / STEPS / 1e3
    print(f"profile DDC step: device busy {busy:.4f} ms/step of {wall_ms:.4f} ms wall "
          f"(profiler on); {len(kernels) // STEPS} kernels per step [{card}]")
    for key, us in sorted(names.items(), key=lambda kv: -kv[1])[:8]:
        print(f"  {us / STEPS / 1e3:.4f} ms/step  {key[:90]}")


if __name__ == "__main__":
    main()
