#!/usr/bin/env python3
"""Launch-shape sweep of the PyTorch port's streamed_cmul kernel on one
CUDA card.

Times ``csrc/stream.cu`` at x ``[2048, 2048]`` split float32 planes with
chunk_rows 128 (the shape of ``chip_smoke.py`` phase 17) over ring depth
(``stages`` 2-4) x CTAs per SM the chunk groups aim at (1-16) x bytes per
stage a CTA (``unroll`` 1, 2, 4: 8, 16, 32 KB of x a stage), each launch
shape first held ``torch.equal`` to the plain twin. Every time is printed
beside one broadcast ``torch.mul`` on complex64 (the one-call yardstick)
and the byte bound, CUDA events, median of 3 runs of 50 launches with the
outputs allocated once; the public ``streamed_cmul`` (which allocates its
outputs per call) is timed once more at the module's chosen shape.

It then prints the host time of each piece of a ``streamed_cmul`` call
(host clock, microseconds a call): where a timed loop of calls is bound by
the host rather than the kernel, these are what it waits on.

``--parent DIR``: also build ``DIR``'s ``csrc/stream.cu`` (the two-stage
ring of 256 CTAs that this kernel replaced, C entry ``stream_launch(xr, xi,
rr, ri, out_re, out_im, chunk, n_chunks, vec, stream)``) and time it the
same way, launched straight, in turns with the module's shape.

Run from the repository root on a machine with a CUDA card:
``python3 benches/torch_stream_sweep.py [--parent DIR]``. Imports the port
only.
"""

import argparse
import ctypes
import itertools
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from aether_primitives_tpu_torch.cli import card_label, time_cuda  # noqa: E402
from aether_primitives_tpu_torch.ops.cuda import build  # noqa: E402
from aether_primitives_tpu_torch.ops.cuda import stream as sk  # noqa: E402

N, CHUNK_ROWS = 2048, 128
STAGES, CTAS_PER_SM, UNROLL = (2, 3, 4), (1, 2, 4, 8, 16), (1, 2, 4)
ITERS, RUNS = 50, 3
PEAK_BYTES = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet


def median_ms(fn) -> float:
    return float(np.median([time_cuda(fn, ITERS, warmup=2) for _ in range(RUNS)]))


def host_us(fn, n: int) -> float:
    """Host microseconds a call of ``fn`` (no synchronise inside the loop;
    ``n`` small enough that launches never fill the card's queue)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def host_breakdown(planes, ptrs, dev, chunk, n_chunks, lib, card) -> None:
    """The host time of each piece of a ``streamed_cmul`` call."""
    xr, xi, rr, ri = planes
    per = sk.chunks_per_cta(chunk, n_chunks, sk._sm_count(dev), True)
    stream = torch._C._cuda_getCurrentRawStream(dev)
    entry = sk._entry()
    pieces = {
        "_check_args": (lambda: sk._check_args(xr, xi, rr, ri, CHUNK_ROWS), 2000),
        "get_device x4 + is_contiguous x4": (lambda: (
            xr.get_device(), xi.get_device(), rr.get_device(), ri.get_device(),
            xr.is_contiguous(), xi.is_contiguous(), rr.is_contiguous(), ri.is_contiguous()),
            2000),
        "torch.empty_like (one plane)": (lambda: torch.empty_like(xr), 2000),
        "torch.empty, shape and device (one plane)": (
            lambda: torch.empty((N, N), dtype=torch.float32, device=xr.device), 2000),
        "data_ptr x6": (lambda: tuple(t.data_ptr() for t in (xr, xi, rr, ri, xr, xi)), 2000),
        "chunks_per_cta + _sm_count": (
            lambda: sk.chunks_per_cta(chunk, n_chunks, sk._sm_count(dev), True), 2000),
        "_cuda_getCurrentRawStream": (lambda: torch._C._cuda_getCurrentRawStream(dev), 2000),
        "ctypes call, no launch (chunk 0)": (
            lambda: entry(*ptrs, 0, n_chunks, per, 1, sk.UNROLL, sk.STAGES, dev, stream), 2000),
        "_launch (the kernel launched)": (
            lambda: sk._launch(ptrs, dev, chunk, n_chunks, True, sk.STAGES, sk.UNROLL,
                               sk.CTAS_PER_SM), 200),
        "streamed_cmul (the whole call)": (
            lambda: sk.streamed_cmul(xr, xi, rr, ri, chunk_rows=CHUNK_ROWS), 200),
        "torch.mul, broadcast complex64": (lib, 200),
    }
    for name, (fn, n) in pieces.items():
        runs = [host_us(fn, n) for _ in range(3)]
        print(f"host: {name}: median {float(np.median(runs)):.2f} us a call (runs "
              f"{', '.join(f'{v:.2f}' for v in runs)}; host clock, mean of {n}) [{card}]",
              flush=True)


def parent_entry(root: str):
    """The parent tree's stream kernel, built beside the port's builds."""
    src = Path(root) / "aether_primitives_tpu_torch" / "csrc" / "stream.cu"
    out = build.BUILD_DIR / "sweep-parent-stream.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(out), str(src)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
    fn = ctypes.CDLL(str(out)).stream_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong] + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="a checkout of the parent tree to time beside this one")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    card = card_label()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    rng = np.random.default_rng(17)
    xr, xi = (torch.from_numpy(rng.normal(size=(N, N)).astype(np.float32)).cuda()
              for _ in range(2))
    rr, ri = (torch.from_numpy(rng.normal(size=(CHUNK_ROWS, N)).astype(np.float32)).cuda()
              for _ in range(2))
    want = sk.streamed_cmul_reference(xr, xi, rr, ri)
    out_re, out_im = torch.empty_like(xr), torch.empty_like(xi)
    ptrs = tuple(t.data_ptr() for t in (xr, xi, rr, ri, out_re, out_im))
    dev = xr.device.index
    chunk, n_chunks = CHUNK_ROWS * N, N // CHUNK_ROWS
    xc, rc = torch.complex(xr, xi), torch.complex(rr, ri)
    nbytes = 4 * 4 * N * N + 2 * 4 * CHUNK_ROWS * N
    bound = nbytes / PEAK_BYTES * 1e3
    lib = median_ms(lambda: torch.mul(xc.view(n_chunks, CHUNK_ROWS, N), rc))
    print(f"bound {bound:.4f} ms ({nbytes} B over 3.35 TB/s); broadcast torch.mul complex64 "
          f"{lib:.4f} ms [{card}]")
    print("stages ctas/SM KB/stage grid        kernel_ms  vs_mul  of_bound")
    best = None
    for stages, per_sm, unroll in itertools.product(STAGES, CTAS_PER_SM, UNROLL):
        def run():
            sk._launch(ptrs, dev, chunk, n_chunks, True, stages, unroll, per_sm)
        out_re.zero_()
        run()
        torch.cuda.synchronize()
        if not (torch.equal(out_re, want[0]) and torch.equal(out_im, want[1])):
            sys.exit(f"stages {stages}, {per_sm} CTAs/SM, unroll {unroll}: kernel != twin")
        per = sk.chunks_per_cta(chunk, n_chunks, sk._sm_count(dev), True, unroll, per_sm)
        tiles = -(-chunk // (256 * 4 * unroll))
        ms = median_ms(run)
        best = min(best or (ms, ()), (ms, (stages, per_sm, unroll)))
        print(f"{stages:6d} {per_sm:7d} {8 * unroll:9d} {tiles:4d}x{-(-n_chunks // per):<6d} "
              f"{ms:10.4f} {lib / ms:7.2f} {100 * bound / ms:8.1f}%", flush=True)
    if args.parent:
        old = parent_entry(args.parent)
        stream = torch.cuda.current_stream().cuda_stream

        def run_parent():
            rc = old(*ptrs, chunk, n_chunks, 1, stream)
            if rc:
                sys.exit(f"parent stream kernel: CUDA error {rc}")

        def run_new():
            sk._launch(ptrs, dev, chunk, n_chunks, True, sk.STAGES, sk.UNROLL, sk.CTAS_PER_SM)

        out_re.zero_()
        run_parent()
        torch.cuda.synchronize()
        if not (torch.equal(out_re, want[0]) and torch.equal(out_im, want[1])):
            sys.exit("parent kernel != twin")
        turns = {"parent": [], "this": []}
        for which in ("parent", "this", "this", "parent", "parent", "this"):
            turns[which].append(time_cuda(run_parent if which == "parent" else run_new, ITERS,
                                          warmup=2))
        print(f"launched straight, in turns: parent kernel median "
              f"{float(np.median(turns['parent'])):.4f} ms (runs "
              f"{', '.join(f'{v:.4f}' for v in turns['parent'])}), this kernel at the module's "
              f"shape {float(np.median(turns['this'])):.4f} ms (runs "
              f"{', '.join(f'{v:.4f}' for v in turns['this'])}) [{card}]")
    host_breakdown((xr, xi, rr, ri), ptrs, dev, chunk, n_chunks,
                   lambda: torch.mul(xc.view(n_chunks, CHUNK_ROWS, N), rc), card)
    pub = median_ms(lambda: sk.streamed_cmul(xr, xi, rr, ri, chunk_rows=CHUNK_ROWS))
    lib2 = median_ms(lambda: torch.mul(xc.view(n_chunks, CHUNK_ROWS, N), rc))
    print(f"fastest: {best[0]:.4f} ms at (stages, CTAs/SM, unroll) {best[1]}; module choice "
          f"{(sk.STAGES, sk.CTAS_PER_SM, sk.UNROLL)} through streamed_cmul {pub:.4f} ms, "
          f"torch.mul again {lib2:.4f} ms [{card}]")


if __name__ == "__main__":
    main()
