#!/usr/bin/env python3
"""Launch-shape sweep of the PyTorch port's fused complex multiply (cmul,
cmul_c64) on one CUDA card, and the host time of a call.

Times the fused complex multiply at ``[2048, 2048]`` (the shape of
``chip_smoke.py`` phase 17), split float32 planes and interleaved
complex64, launched straight on outputs made once, over float4 per stream
a thread (``unroll`` 1, 2, 4) x cache hint (0 default, 1 streaming loads
and stores, 2 non-coherent loads that skip L1 with streaming stores) x
grid (0: one group a thread; else SMs x 1-16 CTAs, grid-stride), built
from the bench's own ``benches/torch_cmul_sweep.cu`` (the port's
``csrc/cmul.cu`` is the shape unroll 1, hint 0, grid 0), each launch shape
first held ``torch.equal`` to the plain twin. Every time is printed beside
one ``torch.mul`` on complex64 (the one-call yardstick) and the byte bound,
CUDA events, median of 3 runs of 50 launches. Then the port's kernel,
``torch.mul`` and (``--parent``) the parent's kernel launched straight, in
turns, each also by ``torch.profiler`` (device time a
launch); the public ``cmul`` / ``cmul_c64`` in a timed loop of
calls; and the host time of each piece of a call (host clock,
microseconds a call): where a timed loop of calls is bound by the host
rather than the kernel, these are what it waits on.

``--parent DIR``: also build ``DIR``'s ``csrc/cmul.cu`` (C entries
``cmul_planes_launch(ar, ai, br, bi, out_re, out_im, n, scale, conj_b, vec,
stream)`` and ``cmul_c64_launch(a, b, out, n, scale, conj_b, vec,
stream)``) and time it in turns with this tree's kernel.

Run from the repository root on a machine with a CUDA card:
``python3 benches/torch_cmul_sweep.py [--parent DIR]``. Imports the port
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

from aether_primitives_tpu_torch.cli import card_label, kernel_device_ms, time_cuda  # noqa: E402
from aether_primitives_tpu_torch.ops.cuda import build  # noqa: E402
from aether_primitives_tpu_torch.ops.cuda import cmul as cm  # noqa: E402

N = 2048
UNROLL, HINT, CTAS_PER_SM = (1, 2, 4), (0, 1, 2), (0, 1, 2, 4, 8, 16)
_LAUNCH_ARGS = [ctypes.c_longlong, ctypes.c_float] + [ctypes.c_int] * 6 + [ctypes.c_void_p]
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


def sweep_entries():
    """The launch shapes of ``benches/torch_cmul_sweep.cu``: entries
    ``(planes ptrs..., n, scale, conj_b, vec, unroll, hint, ctas_per_sm,
    device, stream)`` and the complex64 one."""
    src = Path(__file__).with_suffix(".cu")
    out = build.BUILD_DIR / "sweep-cmul-shapes.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(out), str(src)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    planes, c64 = lib.cmul_sweep_planes_launch, lib.cmul_sweep_c64_launch
    planes.argtypes = [ctypes.c_void_p] * 6 + _LAUNCH_ARGS
    c64.argtypes = [ctypes.c_void_p] * 3 + _LAUNCH_ARGS
    planes.restype = c64.restype = ctypes.c_int
    return planes, c64


def parent_entries(root: str):
    """The parent tree's cmul kernels, built beside the port's builds."""
    src = Path(root) / "aether_primitives_tpu_torch" / "csrc" / "cmul.cu"
    out = build.BUILD_DIR / "sweep-parent-cmul.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(out), str(src)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    planes, c64 = lib.cmul_planes_launch, lib.cmul_c64_launch
    planes.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_float]
                       + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    c64.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_float]
                    + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    planes.restype = c64.restype = ctypes.c_int
    return planes, c64


def enter_device(device) -> None:
    with torch.cuda.device(device):
        pass


def host_breakdown(a, ac, bc, ptrs, dev, card) -> None:
    """The host time of each piece of a ``cmul`` / ``cmul_c64`` call."""
    ar, ai, br, bi = a
    entry = cm._entries()[0]
    stream = torch._C._cuda_getCurrentRawStream(dev)
    pieces = {
        "type and dtype checks x4": (lambda: all(type(p) is torch.Tensor and p.dtype is
                                                 torch.float32 for p in a), 2000),
        "shape checks x3": (lambda: ai.shape == ar.shape and br.shape == ar.shape
                            and bi.shape == ar.shape, 2000),
        "get_device x4 + is_contiguous x4": (lambda: (
            ar.get_device(), ai.get_device(), br.get_device(), bi.get_device(),
            ar.is_contiguous(), ai.is_contiguous(), br.is_contiguous(), bi.is_contiguous()),
            2000),
        "torch.as_tensor x4 (the parent's)": (
            lambda: [torch.as_tensor(p, dtype=torch.float32) for p in a], 2000),
        "_outputs (one [2, n, n] allocation, unbind)": (
            lambda: cm._outputs(ar.shape, N * N, ar.device), 2000),
        "torch.empty x2 (the parent's)": (lambda: (
            torch.empty((N, N), dtype=torch.float32, device=ar.device),
            torch.empty((N, N), dtype=torch.float32, device=ar.device)), 2000),
        "with torch.cuda.device (the parent's)": (lambda: enter_device(ar.device), 2000),
        "data_ptr x6 + alignment": (
            lambda: not any(p % 16 for p in tuple(t.data_ptr() for t in (*a, ar, ai))), 2000),
        "_cuda_getCurrentRawStream": (lambda: torch._C._cuda_getCurrentRawStream(dev), 2000),
        "ctypes call, no launch (n 0)": (lambda: entry(*ptrs, 0, 1.0, 0, 1, dev, stream),
                                          2000),
        "_launch_planes (the kernel launched)": (
            lambda: cm._launch_planes(ptrs, dev, N * N, 1.0, False, True), 200),
        "cmul (the whole call)": (lambda: cm.cmul(*a), 200),
        "cmul_c64 (the whole call)": (lambda: cm.cmul_c64(ac, bc), 200),
        "torch.mul, complex64": (lambda: torch.mul(ac, bc), 200),
    }
    for name, (fn, n) in pieces.items():
        runs = [host_us(fn, n) for _ in range(3)]
        print(f"host: {name}: median {float(np.median(runs)):.2f} us a call (runs "
              f"{', '.join(f'{v:.2f}' for v in runs)}; host clock, mean of {n}) [{card}]",
              flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="a checkout of the parent tree to time beside this one")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    card = card_label()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    rng = np.random.default_rng(17)
    a = [torch.from_numpy(rng.normal(size=(N, N)).astype(np.float32)).cuda() for _ in range(4)]
    ac, bc = torch.complex(a[0], a[1]), torch.complex(a[2], a[3])
    want = cm.cmul_reference(*a)
    want_c = cm.cmul_c64_reference(ac, bc)
    out = (torch.empty_like(a[0]), torch.empty_like(a[0]))
    out_c = torch.empty_like(ac)
    ptrs = tuple(t.data_ptr() for t in (*a, *out))
    ptrs_c = (ac.data_ptr(), bc.data_ptr(), out_c.data_ptr())
    dev = a[0].device.index
    nbytes = 6 * 4 * N * N
    bound = nbytes / PEAK_BYTES * 1e3
    lib = median_ms(lambda: torch.mul(ac, bc))
    print(f"bound {bound:.4f} ms ({nbytes} B over 3.35 TB/s); torch.mul complex64 "
          f"{lib:.4f} ms [{card}]")
    print("kind    unroll hint ctas/SM  kernel_ms  vs_mul  of_bound")
    sweep_p, sweep_c = sweep_entries()
    best = {}
    for kind, (u, h, c) in itertools.product(("planes", "c64"),
                                             itertools.product(UNROLL, HINT, CTAS_PER_SM)):
        entry, bufs, got = ((sweep_p, ptrs, out) if kind == "planes"
                            else (sweep_c, ptrs_c, (out_c,)))

        def run(entry=entry, bufs=bufs, u=u, h=h, c=c):
            if entry(*bufs, N * N, 1.0, 0, 1, u, h, c, dev,
                     torch._C._cuda_getCurrentRawStream(dev)):
                sys.exit(f"cmul sweep launch failed at unroll {u}, hint {h}, {c} CTAs/SM")
        for t in got:
            t.zero_()
        run()
        torch.cuda.synchronize()
        same = (torch.equal(out[0], want[0]) and torch.equal(out[1], want[1])
                if kind == "planes" else torch.equal(out_c, want_c))
        if not same:
            sys.exit(f"{kind} unroll {u}, hint {h}, {c} CTAs/SM: kernel != twin")
        ms = median_ms(run)
        best[kind] = min(best.get(kind, (ms, ())), (ms, (u, h, c)))
        print(f"{kind:7s} {u:6d} {h:4d} {c:8d} {ms:10.4f} {lib / ms:7.2f} "
              f"{100 * bound / ms:8.1f}% [{card}]", flush=True)
    for kind, (ms, shape) in best.items():
        print(f"fastest {kind}: {ms:.4f} ms at (unroll, hint, CTAs/SM) {shape} [{card}]")

    turns = {
        "planes, the port's kernel": lambda: cm._launch_planes(ptrs, dev, N * N, 1.0, False,
                                                               True),
        "c64, the port's kernel": lambda: cm._launch_c64(ptrs_c, dev, N * N, 1.0, False, True),
        "torch.mul complex64": lambda: torch.mul(ac, bc),
    }
    if args.parent:
        old_p, old_c = parent_entries(args.parent)
        stream = torch.cuda.current_stream().cuda_stream

        def parent_planes():
            if old_p(*ptrs, N * N, 1.0, 0, 1, stream):
                sys.exit("parent cmul planes kernel failed")

        def parent_c64():
            if old_c(*ptrs_c, N * N, 1.0, 0, 1, stream):
                sys.exit("parent cmul_c64 kernel failed")

        for fn, check in ((parent_planes, lambda: torch.equal(out[0], want[0])
                           and torch.equal(out[1], want[1])),
                          (parent_c64, lambda: torch.equal(out_c, want_c))):
            out[0].zero_()
            out_c.zero_()
            fn()
            torch.cuda.synchronize()
            if not check():
                sys.exit("parent kernel != twin")
        turns["parent planes"] = parent_planes
        turns["parent c64"] = parent_c64
    runs = {k: [] for k in turns}
    names = list(turns)
    for r in range(2 * RUNS):
        for name in (names if r % 2 == 0 else names[::-1]):
            runs[name].append(time_cuda(turns[name], ITERS, warmup=2))
    for name in names:
        dev_ms = kernel_device_ms(turns[name], "elementwise" if "torch.mul" in name else "cmul_")
        print(f"launched straight, in turns: {name} median {float(np.median(runs[name])):.4f} "
              f"ms (runs {', '.join(f'{v:.4f}' for v in runs[name])}; CUDA events, mean of "
              f"{ITERS}); device {dev_ms:.4f} ms a launch (torch.profiler, 20) [{card}]")
    calls = {"cmul (public call)": lambda: cm.cmul(*a),
             "cmul_c64 (public call)": lambda: cm.cmul_c64(ac, bc),
             "torch.mul complex64": lambda: torch.mul(ac, bc)}
    runs = {k: [] for k in calls}
    for r in range(2 * RUNS):
        for name in (list(calls) if r % 2 == 0 else list(calls)[::-1]):
            runs[name].append(time_cuda(calls[name], ITERS, warmup=2))
    for name in calls:
        print(f"timed loop of calls, in turns: {name} median "
              f"{float(np.median(runs[name])):.4f} ms (runs "
              f"{', '.join(f'{v:.4f}' for v in runs[name])}) [{card}]")
    host_breakdown(a, ac, bc, ptrs, dev, card)


if __name__ == "__main__":
    main()
