#!/usr/bin/env python3
"""Device-time breakdown of the PyTorch port's streaming RX chain on one
CUDA card.

Runs ``RxChain(RxChainConfig(fft_len=2048, decimation=4, packed_bits=True),
device="cuda").streaming_step`` on 4,194,304-sample blocks resident on the
card under ``torch.profiler`` for ``STEPS`` steps, and prints each device
op's time per step and share of the device time. A second loop of the same
steps without the profiler is timed with CUDA events, for the step's wall
time on the device.

Run from the repository root on a machine with a CUDA card:
``python3 benches/torch_rx_frame_profile.py``. Imports the port only.
"""

import sys
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from aether_primitives_tpu_torch.cli import (  # noqa: E402
    card_label, resident_streaming, time_cuda,
)
from aether_primitives_tpu_torch.models import RxChain, RxChainConfig  # noqa: E402

STEPS = 20


def _device_us(event) -> float:
    """Device time of a kernel or copy event; 0 for host-side ops, whose
    device time repeats that of the kernels they launch."""
    if event.self_cpu_time_total:
        return 0.0
    for name in ("self_device_time_total", "self_cuda_time_total"):
        value = getattr(event, name, None)
        if value:
            return float(value)
    return 0.0


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_label()
    print(card)
    chain = RxChain(RxChainConfig(fft_len=2048, decimation=4, packed_bits=True),
                    device="cuda")
    step = resident_streaming(chain)
    for _ in range(5):
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(STEPS):
            step()
        torch.cuda.synchronize()
    rows = sorted(((_device_us(e), e.key, e.count) for e in prof.key_averages()),
                  reverse=True)
    rows = [r for r in rows if r[0] > 0]
    total = sum(r[0] for r in rows)
    if not total:
        sys.exit("the profiler recorded no device time")
    print(f"device time per step {total / STEPS / 1e3:.4f} ms (profiler, {STEPS} steps)")
    for us, key, count in rows[:10]:
        print(f"  {us / STEPS / 1e3:.4f} ms/step  {100 * us / total:.2f}%  x{count}  {key}")
    ms = time_cuda(step, 50)
    print(f"streaming step {ms:.4f} ms (CUDA events, mean of 50 steps, no profiler) "
          f"[{card}]")


if __name__ == "__main__":
    main()
