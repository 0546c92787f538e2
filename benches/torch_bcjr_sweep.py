#!/usr/bin/env python3
"""Instance and launch-shape sweep of the PyTorch port's windowed BCJR
kernel on one CUDA card.

Times ``csrc/bcjr.cu`` at the turbo path's shape (spans ``[96, 2560]``
float32: window 64, guard 16, 256 bursts x 10 windows; the RSC-8 trellis):
the meet instance at 8, 16, 24 and 32 columns a CTA (the port ships 16 and
8; ``benches/torch_bcjr_sweep.cu`` builds all four from the port's source
with one more C entry), the meet instance at Lw 2, 24 and 48 (its fixed
cost and its cost a step), the generic instance on the same tables, and,
with ``--parent``, the parent tree's kernel, in turns. Then the K=7 conv trellis (S 64) at the same spans through the
generic instance (and the parent's). Each case is first held
``torch.equal`` to the plain twin. Times by CUDA events (median of 3 runs
of 50 launches, outputs allocated once: bound by the host where a launch
is shorter than its Python call) and by ``torch.profiler`` (the kernel's
own device time, median of 2 x 20 launches), with the card's name and power
limit on every line, beside the roofline bound and the chain floor (Lw
steps x 6 dependent FP32 operations x 4 cycles at the card's maximum SM
clock: an estimate from assumed counts, not a measurement). First it prints the compiler's register and spill report and,
for each meet instance, its machine instructions by opcode (``cuobjdump
-sass`` of the build: static counts, loops counted once per copy).

``--parent DIR``: also build ``DIR``'s ``csrc/bcjr.cu`` (C entry
``bcjr_launch(ls, lp, llr, scratch, lw, ncols, s_count, idx, coef,
stream)``, the one-thread-per-column kernel) and time it the same way.

Run from the repository root on a machine with a CUDA card:
``python3 benches/torch_bcjr_sweep.py [--parent DIR]``. Imports the port
only.
"""

import argparse
import collections
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from aether_primitives_tpu_torch.cli import (  # noqa: E402
    card_label, kernel_device_ms, max_sm_clock_hz, time_cuda,
)
from aether_primitives_tpu_torch.ops import fec  # noqa: E402
from aether_primitives_tpu_torch.ops.cuda import bcjr as bk  # noqa: E402
from aether_primitives_tpu_torch.ops.cuda import build  # noqa: E402

LW, N = 16 + 64 + 16, 256 * 10
ITERS, RUNS = 50, 3
PEAK_FP32, PEAK_BYTES = 67e12, 3.35e12  # H100 SXM, NVIDIA data sheet
CHAIN_OPS, OP_CYCLES = 6, 4  # dependent FP32 ops a step (add, max, 3-level tree, sub)


def sass_opcodes(card: str) -> None:
    """Static SASS instruction counts by opcode of each meet instance."""
    lib = build.library_path("bcjr")
    tool = Path(build.find_nvcc()).parent / "cuobjdump"
    dump = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True).stdout
    counts, name = {}, None
    for line in dump.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = collections.Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if name and m:
            counts[name][m.group(1).split(".")[0]] += 1
    for fname, c in counts.items():
        m = re.search(r"bcjr_kernel_meetINS_4Rsc8ELi(\d+)E", fname)
        if m:
            top = ", ".join(f"{op} {k}" for op, k in c.most_common(9))
            print(f"  sass meet {m.group(1)} cols: {sum(c.values())} instructions: {top} "
                  f"[{card}]")


def sweep_entry():
    """``bcjr_rsc8_sweep_launch`` of ``benches/torch_bcjr_sweep.cu``: the
    port's meet instance at 8, 16, 24 or 32 columns a CTA."""
    src = Path(__file__).with_suffix(".cu")
    out = build.BUILD_DIR / "sweep-bcjr-cols.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-I",
                           str(build.PACKAGE_DIR / "csrc"), "-o", str(out), str(src)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
    fn = ctypes.CDLL(str(out)).bcjr_rsc8_sweep_launch
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_longlong]
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def parent_entry(root: str):
    """The parent tree's BCJR kernel, built beside the port's builds."""
    src = Path(root) / "aether_primitives_tpu_torch" / "csrc" / "bcjr.cu"
    out = build.BUILD_DIR / "sweep-parent-bcjr.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(out), str(src)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
    fn = ctypes.CDLL(str(out)).bcjr_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int]
                   + [ctypes.c_void_p] * 3)
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
    log = build.library_path("bcjr").with_suffix(".log")
    bk._entries()  # builds
    for line in log.read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  ptxas bcjr: {line.strip()}")
    sass_opcodes(card)
    rng = np.random.default_rng(2026)
    ls, lp = (torch.from_numpy((rng.normal(size=(LW, N)) * 3).astype(np.float32)).cuda()
              for _ in range(2))
    out = torch.empty((LW, N), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    old = parent_entry(args.parent) if args.parent else None
    wide = sweep_entry()
    dev = ls.get_device()
    clock = max_sm_clock_hz()
    floor_ms = LW * CHAIN_OPS * OP_CYCLES / clock * 1e3
    for label, tables in (("RSC-8 (S 8)", None), ("K=7 conv (S 64)", fec._conv_soft_coeffs(
            (0o171, 0o133), 7))):
        idx, coef, instance, cls = bk._host_tables(tables if tables is not None
                                                   else bk.rsc8_tables())
        s_count = idx.shape[1]
        scratch = torch.empty((LW, s_count, N), device="cuda")
        want = bk.bcjr_windowed_llr_reference(ls, lp, LW, tables)
        ops = LW * N * (34 * s_count + 1)
        bound = max(ops / PEAK_FP32, 3 * LW * N * 4 / PEAK_BYTES) * 1e3
        cases = {}
        if instance == "rsc8":
            for cols in (8, 16, 24, 32):
                def run_wide(c=cols):
                    rc = wide(ls.data_ptr(), lp.data_ptr(), out.data_ptr(), LW, N, c, 1,
                              cls.ctypes.data, dev, stream)
                    if rc:
                        sys.exit(f"bcjr meet at {c} columns a CTA: CUDA error {rc}")
                cases[f"meet {cols} cols/CTA ({-(-N // cols)} CTAs)"] = run_wide
            cases[f"meet through the wrapper ({bk.kernel_plan(None, LW)})"] = (
                lambda: bk._launch_meet(ls, lp, out, LW, bk.kernel_plan(None, LW)[1], cls))
        cases["generic (1 thread/column)"] = lambda: bk._launch(ls, lp, out, LW, idx, coef,
                                                                scratch)
        if old is not None:
            def run_parent():
                rc = old(ls.data_ptr(), lp.data_ptr(), out.data_ptr(), scratch.data_ptr(), LW,
                         N, s_count, idx.ctypes.data, coef.ctypes.data, stream)
                if rc:
                    sys.exit(f"parent bcjr kernel: CUDA error {rc}")
            cases["parent kernel"] = run_parent
        for name, run in cases.items():
            out.zero_()
            run()
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                sys.exit(f"{label} {name}: kernel != twin")
        runs = {name: [] for name in cases}
        names = list(cases)
        for r in range(2 * RUNS):  # in turns, the order reversed every other round
            for name in (names if r % 2 == 0 else names[::-1]):
                runs[name].append(time_cuda(cases[name], ITERS, warmup=2))
        dev_ms = {name: float(np.median([kernel_device_ms(cases[name], "bcjr_kernel", 20)
                                         for _ in range(2)])) for name in names}
        print(f"{label}, Lw {LW} x N {N}: bound {bound:.5f} ms ({ops / 1e6:.0f} M FP32 ops), "
              f"chain floor {floor_ms:.5f} ms ({LW} steps x {CHAIN_OPS} ops x {OP_CYCLES} "
              f"cycles at {clock / 1e6:.0f} MHz) [{card}]")
        for name in names:
            ms = float(np.median(runs[name]))
            print(f"  {name:42s} device {dev_ms[name]:.5f} ms a launch (torch.profiler, "
                  f"median of 2 x 20), {dev_ms[name] / floor_ms:.1f}x the chain floor; a loop "
                  f"of launches {ms:.5f} ms (runs {', '.join(f'{v:.5f}' for v in runs[name])};"
                  f" CUDA events, mean of {ITERS}) [{card}]", flush=True)
    # the meet instance's fixed cost and its cost a step: device time at
    # shorter spans of the same columns
    cls = bk._host_tables(bk.rsc8_tables())[3]
    at = {}
    for lw in (2, 24, 48, LW):
        cols = bk.kernel_plan(None, lw)[1]
        sub = out[:lw]
        at[lw] = float(np.median([kernel_device_ms(
            lambda: bk._launch_meet(ls[:lw], lp[:lw], sub, lw, cols, cls),
            "bcjr_kernel", 20) for _ in range(2)]))
        print(f"  meet at Lw {lw:3d} ({cols} cols/CTA): device {at[lw]:.5f} ms a "
              f"launch (torch.profiler) [{card}]")
    step_ns = (at[LW] - at[48]) / (LW - 48) * 1e6
    print(f"  meet: {step_ns:.1f} ns a step from Lw 48 to {LW}, {at[2]:.5f} ms at Lw 2 "
          f"(launch, span load, LLR stores) [{card}]")
    print(f"module choice: kernel_plan(None, {LW}) = {bk.kernel_plan(None, LW)} [{card}]")


if __name__ == "__main__":
    main()
