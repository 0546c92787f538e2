#!/usr/bin/env python3
"""Where a host-fed block's time goes on one CUDA card.

Streams 16 blocks of 4,194,304 samples of one capture through
``StatefulExecutor(RxChain(RxChainConfig(fft_len=2048, decimation=4,
packed_bits=True), device="cuda").streaming_step, ...)`` at depth 2, from
pre-filled pinned buffers, from pageable numpy blocks and from a capture
file (``utils.file.stream_blocks`` into ``streaming_step_split``), and for
each source prints:

- the wall time per block (host clock, ending in a synchronise);
- the host time per block inside the executor's pieces (the staging of a
  block onto the copy stream, the chain's enqueue, the wait for the copy in
  ``send``, ``recv``) and, for the file, the feeder's ``next``;
- the host-side CUDA runtime and aten calls by self time per block
  (``torch.profiler``, profiler on).

Run from the repository root on a machine with a CUDA card:
``python3 benches/torch_host_fed_profile.py``. Every line carries the card's
name and power limit.
"""

import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

BLOCK, N_BLOCKS, DEPTH = 1 << 22, 16, 2


def main() -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    from aether_primitives_tpu_torch.boundary import Split
    from aether_primitives_tpu_torch.cli import capture, card_label
    from aether_primitives_tpu_torch.models import RxChain, RxChainConfig
    from aether_primitives_tpu_torch.ops.cuda import build
    from aether_primitives_tpu_torch.parallel import streaming
    from aether_primitives_tpu_torch.utils import file as file_mod

    card = card_label()
    chain = RxChain(RxChainConfig(fft_len=2048, decimation=4, packed_bits=True), device="cuda")
    x = capture(N_BLOCKS * BLOCK, 1515)
    blocks = [x[i * BLOCK:(i + 1) * BLOCK] for i in range(N_BLOCKS)]
    pinned = [torch.from_numpy(b).pin_memory() for b in blocks]
    build_dir = build.PACKAGE_DIR.parent / "build"
    build_dir.mkdir(exist_ok=True)
    tmp = tempfile.TemporaryDirectory(dir=build_dir)
    path = f"{tmp.name}/capture.cf32"
    file_mod.save(path, x)

    spent = defaultdict(float)

    def timed(name, fn):
        def wrapper(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                spent[name] += time.perf_counter() - t0
        return wrapper

    stager, executor = streaming._Stager, streaming.StatefulExecutor
    originals = (stager.leaf, stager.copied)
    stager.leaf = timed("stage block (copy enqueue)", stager.leaf)
    stager.copied = timed("copy event + compute wait", stager.copied)
    executor.recv = timed("recv", executor.recv)  # shadows the shared base's

    def run(source):
        split = source == "file"
        step = chain.streaming_step_split if split else chain.streaming_step
        ex = streaming.StatefulExecutor(
            timed("chain enqueue", step),
            chain.init_state_split() if split else chain.init_state(),
            depth=DEPTH, printer=None, device="cuda")
        outs = []

        def push(b):
            if len(ex._inflight) >= ex.depth:
                outs.append(ex.recv())
            t0 = time.perf_counter()
            ex.send(b)
            spent["send (all of it)"] += time.perf_counter() - t0

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if source == "pinned":
            for p in pinned:
                push(p)
        elif source == "pageable":
            for b in blocks:
                push(b)
        else:
            feeder = iter(file_mod.stream_blocks(path, BLOCK, depth=4))
            while True:
                t1 = time.perf_counter()
                try:
                    re, im = next(feeder)
                except StopIteration:
                    break
                spent["feeder next"] += time.perf_counter() - t1
                push(Split(re, im))
        outs.extend(ex)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    for source in ("pinned", "pageable", "file"):
        run(source)  # warm
        spent.clear()
        wall = run(source)
        parts = ", ".join(f"{k} {v / N_BLOCKS * 1e3:.4f}" for k, v in sorted(spent.items()))
        print(f"{source}, depth {DEPTH}: {wall / N_BLOCKS * 1e3:.4f} ms/block wall = "
              f"{BLOCK * N_BLOCKS / wall / 1e6:.1f} Msa/s; host ms/block: {parts} [{card}]")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run(source)
        rows = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:10]
        for e in rows:
            print(f"  {e.self_cpu_time_total / N_BLOCKS / 1e3:.4f} ms/block self CPU, "
                  f"{e.count / N_BLOCKS:.1f} calls/block  {e.key[:80]}")
        sys.stdout.flush()
    stager.leaf, stager.copied = originals
    del executor.recv
    tmp.cleanup()


if __name__ == "__main__":
    main()
