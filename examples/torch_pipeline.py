"""Streaming pipeline throughput demo on the PyTorch/CUDA port, the port's
twin of ``examples/pipeline.py``: two stages ("Abs", "Mul 20") fed for a
fixed duration in three variants (pooled bounded, pooled growing,
allocate-per-block), printing per-stage throughput/utilisation once a
second. A fourth variant feeds the pipeline from a capture file through the
native threaded feeder (``utils.file.stream_blocks``): disk read +
deinterleave overlap device work. A fifth streams one contiguous capture
through the RX chain's stateful executor, bit-exact to one step.

On the card the executors copy each host block on a side stream; ``--cpu``
asks for the CPU.

Run: python examples/torch_pipeline.py [poolsize] [buffsize] [seconds] [--cpu]
"""

import os
import sys
import time

try:  # a bare, offline clone: the package is the repo root's
    import aether_primitives_tpu_torch  # noqa: F401
except ModuleNotFoundError:
    sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def run_variant(name, seconds, buffsize, device, pool=None, grow=False):
    from aether_primitives_tpu_torch.parallel import streaming

    pipe = streaming.new("Abs", lambda b: b.abs()).add_stage("Mul 20", lambda b: b * 20.0)
    # donate=True: the executor's staged copy of a host block is its own,
    # so its memory goes back to the allocator once the stages are done
    ex = pipe.finish(depth=2, donate=True, device=device)
    print(f"--- variant: {name} ---")
    deadline = time.monotonic() + seconds
    n_blocks = 0
    while time.monotonic() < deadline:
        if pool is not None:
            elem = pool.take_or_make() if grow else pool.take()
            if elem is None:
                continue  # bounded pool empty: backpressure
            buf = elem.value
        else:
            buf = np.empty(buffsize, np.float32)  # allocate per block
            elem = None
        buf[:] = -1.0
        if len(ex._inflight) >= ex.depth:
            ex.recv()
        ex.send(buf)
        if elem is not None:
            elem.release()
        n_blocks += 1
    for _ in ex:
        pass
    print(f"{name}: {n_blocks} blocks x {buffsize} samples in {seconds}s "
          f"-> {n_blocks * buffsize / seconds / 1e6:.1f} Msamples/s")
    for st in ex.stats:  # per-stage report (sampled every profile_every-th block)
        print(f"  {st.summary()}")


def run_file_fed(buffsize, device, n_blocks=32):
    """Capture-file ingest: native threaded feeder -> 2-stage executor."""
    import tempfile

    from aether_primitives_tpu_torch import native
    from aether_primitives_tpu_torch.parallel import streaming
    from aether_primitives_tpu_torch.utils import file as file_mod

    buffsize = max(buffsize, 1 << 20)  # ingest shines on big blocks
    rng = np.random.default_rng(815)
    cap = (rng.normal(size=n_blocks * buffsize)
           + 1j * rng.normal(size=n_blocks * buffsize)).astype(np.complex64)
    fd, path = tempfile.mkstemp(suffix=".bin")
    os.close(fd)
    file_mod.save(path, cap)
    try:
        pipe = streaming.new("Power", lambda b: b[0] * b[0] + b[1] * b[1]).add_stage(
            "Mul 20", lambda b: b * 20.0)
        # blocks are host numpy planes
        ex = pipe.finish(depth=2, donate=False, device=device)
        # one block first, so the steady-state rate is what's timed
        warm = (np.zeros(buffsize, np.float32), np.zeros(buffsize, np.float32))
        ex.send(warm)
        ex.recv()
        print(f"--- variant: file-fed (native feeder: {native.available()}) ---")
        t0 = time.monotonic()
        fed = 0
        for re, im in file_mod.stream_blocks(path, buffsize, depth=4):
            if len(ex._inflight) >= ex.depth:
                ex.recv()
            ex.send((re, im))
            fed += re.size
        for _ in ex:
            pass
        dt = time.monotonic() - t0
        print(f"file-fed: {fed} samples in {dt:.2f}s "
              f"-> {fed / dt / 1e6:.1f} Msamples/s (read+deinterleave+2 stages)")
        for st in ex.stats:
            print(f"  {st.summary()}")
    finally:
        os.remove(path)


def run_stateful_rx(device, n_blocks=8):
    """Fifth variant: ONE CONTIGUOUS capture through the RxChain via the
    stateful executor: the FIR history threads block to block on the
    device (``RxChain.streaming_step``), so the decoded stream is bit-exact
    to processing the whole capture at once (the reference pipeline's
    continuous contract, src/pipeline.rs:70-79; the stateless variants
    above restart their op every block)."""
    from aether_primitives_tpu_torch.boundary import Split
    from aether_primitives_tpu_torch.models import RxChain, RxChainConfig
    from aether_primitives_tpu_torch.parallel.streaming import StatefulExecutor

    chain = RxChain(RxChainConfig(fft_len=256, decimation=4), device=device)
    nblk = 4 * 256 * 4
    rng = np.random.default_rng(0)
    x = (rng.normal(size=nblk * n_blocks)
         + 1j * rng.normal(size=nblk * n_blocks)).astype(np.complex64)
    # the f32 split boundary throughout, as the JAX demo feeds it
    ex = StatefulExecutor(chain.streaming_step_split, chain.init_state_split(),
                          name="rx stream", depth=2, device=device)
    blocks = [Split(x.real[i * nblk:(i + 1) * nblk].copy(), x.imag[i * nblk:(i + 1) * nblk].copy())
              for i in range(n_blocks)]
    t0 = time.monotonic()
    outs = ex.run(blocks)
    dt = time.monotonic() - t0
    ex.close()
    streamed = np.concatenate([o.cpu().numpy() for o in outs])
    contiguous = chain.step_split(Split(x.real.copy(), x.imag.copy())).cpu().numpy()
    assert (streamed == contiguous).all(), "stream != contiguous"
    print("--- variant: stateful RX chain (contiguous capture) ---")
    print(f"{n_blocks} blocks x {nblk} samples in {dt:.3f}s "
          f"({nblk * n_blocks / dt / 1e6:.1f} Msa/s incl. host staging and the first "
          f"call's setup, on {chain.device}); bit-exact vs one contiguous step")


def main():
    from aether_primitives_tpu_torch.parallel import streaming

    device = "cpu" if "--cpu" in sys.argv else "cuda"
    args = [a for a in sys.argv[1:] if a != "--cpu"]
    poolsize = int(args[0]) if len(args) > 0 else 4
    buffsize = int(args[1]) if len(args) > 1 else 1 << 16
    seconds = float(args[2]) if len(args) > 2 else 3.0

    def maker():
        return np.empty(buffsize, np.float32)

    run_variant("pooled bounded", seconds, buffsize, device,
                pool=streaming.make(poolsize, maker), grow=False)
    run_variant("pooled growing", seconds, buffsize, device,
                pool=streaming.make(0, maker), grow=True)
    run_variant("allocate per block", seconds, buffsize, device)
    run_file_fed(buffsize, device)
    run_stateful_rx(device)


if __name__ == "__main__":
    main()
