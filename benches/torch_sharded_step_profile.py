#!/usr/bin/env python3
"""Where the time of the PyTorch port's sharded streaming step goes on one
CUDA card.

Runs ``RxChain(RxChainConfig(fft_len=2048, decimation=4, packed_bits=True),
device="cuda").sharded_streaming_step_2d`` on a resident ``[2, 4,194,304]``
block over a ``{channel: 2, time: 4}`` mesh with all eight shards on the one
card, beside the resident ``streaming_step`` on the same block, and prints:
both steps' CUDA-event times; the host time to enqueue one sharded step and
its pieces (laying the block and the state out, the halo exchange, the
eight RX frame calls, the new state); and a ``torch.profiler`` split of the
sharded step's device time with the device's idle share. A step much longer
than its device time is the host's.

Run from the repository root on a machine with a CUDA card:
``python3 benches/torch_sharded_step_profile.py``. Imports the port only.
"""

import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from aether_primitives_tpu_torch.cli import BLOCK, capture, card_label, time_cuda  # noqa: E402
from aether_primitives_tpu_torch.models import RxChain, RxChainConfig  # noqa: E402
from aether_primitives_tpu_torch.parallel import halo, mesh as mesh_mod  # noqa: E402

ITERS, RUNS, STEPS = 20, 4, 10


def host_ms(fn, iters: int = 50) -> float:
    """Host milliseconds to enqueue ``fn`` (no synchronise inside the loop)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize()
    return dt


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    card = card_label()
    chain = RxChain(RxChainConfig(fft_len=2048, decimation=4, packed_bits=True), device="cuda")
    ku = chain.taps.shape[-1] - 1
    mesh = mesh_mod.make_mesh({"channel": 2, "time": 4}, devices=["cuda:0"] * 8)
    block = torch.from_numpy(np.stack([capture(BLOCK, 50 + c) for c in range(2)])).cuda()
    box = {"s": chain.init_state((2,)), "r": chain.init_state((2,))}

    def sharded():
        bits, box["s"] = chain.sharded_streaming_step_2d(block, box["s"], mesh)
        return bits

    def resident():
        bits, box["r"] = chain.streaming_step(block, box["r"])
        return bits

    for name, fn in (("sharded step", sharded), ("resident step", resident)):
        runs = [time_cuda(fn, ITERS) for _ in range(RUNS)]
        print(f"time: {name} on [2, {BLOCK}]: median {np.median(runs):.4f} ms (runs "
              f"{', '.join(f'{v:.4f}' for v in runs)}; mean of {ITERS}, CUDA events) [{card}]")

    xs = mesh_mod.shard(block, mesh, ("channel", "time"))
    state = mesh_mod.shard(chain.init_state((2,)), mesh, ("channel", None))
    h = halo.left_tail(xs, ku, "time")
    pieces = {
        "whole sharded step": sharded,
        "whole resident step": resident,
        "shard(block) + shard(state)": lambda: (
            mesh_mod.shard(block, mesh, ("channel", "time")),
            mesh_mod.shard(box["r"], mesh, ("channel", None))),
        "halo.left_tail (8 pushes)": lambda: halo.left_tail(xs, ku, "time"),
        "state into the first time shard's slot (map)": lambda: h.map(
            lambda hl, sl, index: sl if index["time"] == 0 else hl, state, with_index=True),
        "8 RX frame calls (map)": lambda: xs.map(chain._local_bits, h),
        "1 RX frame call on the whole block": lambda: chain._bits_fast(block, box["r"]),
    }
    for name, fn in pieces.items():
        runs = [host_ms(fn) for _ in range(RUNS)]
        print(f"host: {name}: median {np.median(runs):.4f} ms to enqueue (runs "
              f"{', '.join(f'{v:.4f}' for v in runs)}; host clock, mean of 50) [{card}]")

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            sharded()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / STEPS
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        print("profile: the profiler recorded no device time")
        return
    names = {}
    for k in kernels:
        names[k.name] = names.get(k.name, 0.0) + k.time_range.elapsed_us()
    busy = sum(names.values()) / STEPS / 1e3
    print(f"profile sharded step: device busy {busy:.4f} ms/step of {wall_ms:.4f} ms wall "
          f"(idle {100 * (1 - busy / wall_ms):.1f}%); {len(kernels) // STEPS} kernels and "
          f"copies per step (torch.profiler, {STEPS} steps, profiler on) [{card}]")
    for key, us in sorted(names.items(), key=lambda kv: -kv[1])[:6]:
        print(f"  {us / STEPS / 1e3:.4f} ms/step  {key[:90]}")


if __name__ == "__main__":
    main()
