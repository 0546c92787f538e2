#!/usr/bin/env python3
"""Instance and launch-shape sweep of the PyTorch port's windowed BCJR
kernel on one CUDA card.

Times ``csrc/bcjr.cu`` at the turbo path's shape (spans ``[96, 2560]``
float32: window 64, guard 16, 256 bursts x 10 windows; the RSC-8 trellis):
the meet instance at 8, 16, 24 and 32 columns a CTA (the port ships 16 and
8; ``benches/torch_bcjr_sweep.cu`` builds all four from the port's source
with one more C entry), the meet instance at Lw 2, 24 and 48 (its fixed
cost and its cost a step), and the lanes and block instances on the same
tables. Then the K=7 conv trellis (S 64) through the lanes instance (its
shuffle form and, forced, its table form) and the block instance (forced
through ``bk._launch_block``), at the same spans and at the ccsds +
erasures launch (``[224, 5632]``: window 96, guard 64, 256 captures x 22
windows). Then the block instance's own shapes (``REACH``): S 2 and 3
(random tables), 128, 256 (N 2,048) and 1,024 (N 256), conv codes of K 8,
9 and 11, at Lw 224, and the K=7 and K=3 codes one step past the lanes
instance's span limit (Lw 877 and 1,209, N 2,048); past 1,024 states the
cluster route at ``chip_smoke.py`` phase 7's shape (random S 1,500, Lw 96
x N 7) and at the K 13 code's S 4,096 over Lw 224 x N 256, the shared
route at the K 12 code's S 2,048 and random S 2,048 tables over Lw 224 x N
512; and, through the wrapper, the turbo path's RSC-8 launch (the meet
instance) and the ccsds launch's K=7 code (the lanes instance). Then the
routes past 1,024 states at each geometry (``cluster_geometries``). With
``--parent DIR``
each case also runs through the parent tree's wrapper, in turns. Each
case is first held ``torch.equal`` to the plain twin. Times by CUDA
events (median of 3 runs of 50 launches, outputs allocated once: bound by
the host where a launch is shorter than its Python call) and by
``torch.profiler`` (the kernel's own device time, median of 2 x 20
launches), with the card's name and power limit on every line, beside the
bound (the FP32 operations the function needs a step and column, none an
FMA, at 33.5 T a second: 16 S + 21 where the coefficients factor through
four classes, as for the RSC-8 and conv tables, and 28 S - 3 for any
tables, both printed; or the bytes at 3.35 TB/s), the block instance's
history floor (its half-histories, Lw x P x 4 bytes a column, written and
read once at 3.35 TB/s) and the chain floor (Lw steps x 6 dependent FP32
operations x 4 cycles at the card's maximum SM clock: an estimate from
assumed counts, not a measurement). First it prints the compiler's
register and spill report and, for each meet, lanes and block kernel, its
machine instructions by opcode (``cuobjdump -sass`` of the build: static
counts, loops counted once per copy).

``--parent DIR``: a checkout of the parent tree (``git archive``): its
package imported as ``parent_port`` (its kernels built into ``DIR``'s own
``build/``), its ``bcjr_windowed_llr`` timed beside this tree's at every
shape, in turns (parent, this, this, parent, ...). ``--only`` runs some of
the sections (``reach``: the block instance's shapes; ``geometries``: the
routes past 1,024 states at each geometry; ``calls``: the host's part of a
call past 1,024 states, by the tables' identity, with one hash and through
the parent; ``instances``: the meet and lanes instances), ``--shapes TEXT``
the reach shapes whose label holds TEXT.

Run from the repository root on a machine with a CUDA card:
``python3 benches/torch_bcjr_sweep.py [--parent DIR] [--only SECTION ...]
[--shapes TEXT]``. Imports the port only.
"""


import argparse
import collections
import ctypes
import functools
import importlib
import importlib.util
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
from chip_smoke import random_tables  # noqa: E402
from aether_primitives_tpu_torch.ops import fec  # noqa: E402
from aether_primitives_tpu_torch.ops.cuda import bcjr as bk  # noqa: E402
from aether_primitives_tpu_torch.ops.cuda import build  # noqa: E402

LW, N = 16 + 64 + 16, 256 * 10
CCSDS_LW, CCSDS_N = 96 + 2 * 64, 256 * 22  # the ccsds + erasures launch
ITERS, RUNS = 50, 3
#: The sweep's sections (``--only``): the block instance's shapes, the
#: geometries past 1,024 states, the host's part of a call, the meet and
#: lanes instances at the turbo and ccsds shapes.
SECTIONS = ("reach", "geometries", "calls", "instances")
# H100 SXM, NVIDIA data sheet: FP32 67 TFLOP/s counts an FMA as two; the
# BCJR's adds, multiplies and maxima never fuse, so 33.5 T instructions/s
PEAK_INSTR, PEAK_BYTES = 33.5e12, 3.35e12
CHAIN_OPS, OP_CYCLES = 6, 4  # dependent FP32 ops a step (add, max, 3-level tree, sub)
# the block instance's shapes: (label, S, conv code (K, generators), None
# for random tables or "rsc8" for the turbo trellis, Lw, N); None Lw: one
# step past the lanes limit
REACH = (
    ("S 2 (K=2)", 2, (2, (0o3, 0o1)), 224, 2048),
    ("S 3 (random tables)", 3, None, 224, 2048),
    ("S 128 (K=8)", 128, (8, (0o247, 0o371)), 224, 2048),
    ("S 256 (K=9)", 256, (9, (0o561, 0o753)), 224, 2048),
    ("S 1,024 (K=11)", 1024, (11, (0o2467, 0o3565)), 224, 256),
    ("S 64 (K=7) past the lanes limit", 64, (7, (0o171, 0o133)), None, 2048),
    ("S 4 (K=3) past the lanes limit", 4, (3, (0o5, 0o7)), None, 2048),
    ("S 1,500 (random tables), phase 7's shape", 1500, None, 96, 7),
    ("S 2,048 (K=12)", 2048, (12, (0o4335, 0o5723)), 224, 512),
    ("S 2,048 (random tables)", 2048, None, 224, 512),
    ("S 4,096 (K=13)", 4096, (13, (0o10533, 0o17661)), 224, 256),
    ("RSC-8 (the turbo path's launch)", 8, "rsc8", LW, N),
    ("S 64 (K=7), the ccsds launch", 64, (7, (0o171, 0o133)), CCSDS_LW, CCSDS_N),
)


def bcjr_ops(lw: int, n: int, s_count: int, classes: bool) -> int:
    """FP32 operations a launch's function needs (csrc/bcjr.cu): 28 S - 3 a
    step and column for any tables, 16 S + 21 where every transition's
    coefficients are those of one of four classes."""
    return lw * n * (16 * s_count + 21 if classes else 28 * s_count - 3)


def sass_opcodes(card: str) -> None:
    """Static SASS instruction counts by opcode of the meet, lanes and block
    instances' kernels."""
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
        lanes = re.search(r"bcjr_kernel_lanesILi(\d+)ELb([01])E", fname)
        block = re.search(r"bcjr_kernel_(?:blockILi(\d+)ELb([01])E|thinILi(\d+)E)", fname)
        top = ", ".join(f"{op} {k}" for op, k in c.most_common(9))
        if m:
            print(f"  sass meet {m.group(1)} cols: {sum(c.values())} instructions: {top} "
                  f"[{card}]")
        elif lanes:
            form = "shuffle" if lanes.group(2) == "1" else "table"
            print(f"  sass lanes S {lanes.group(1)} {form} form: {sum(c.values())} "
                  f"instructions: {top} [{card}]")
        elif block:
            form = (f"thin S {block.group(3)}" if block.group(3) else
                    f"block R {block.group(1)}{' multi-warp' if block.group(2) == '1' else ''}")
            print(f"  sass {form}: {sum(c.values())} instructions: {top} [{card}]")


@functools.lru_cache(maxsize=None)
def sweep_library():
    """``benches/torch_bcjr_sweep.cu`` built: the port's source with the
    bench's entries ``bcjr_rsc8_sweep_launch`` (the meet instance at 8, 16,
    24 or 32 columns a CTA)."""
    src = Path(__file__).with_suffix(".cu")
    out = build.BUILD_DIR / "sweep-bcjr.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-I",
                           str(build.PACKAGE_DIR / "csrc"), "-o", str(out), str(src)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    wide = lib.bcjr_rsc8_sweep_launch
    wide.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_longlong]
                     + [ctypes.c_int] * 2 + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    wide.restype = ctypes.c_int
    return wide


def parent_bcjr(root: str):
    """The parent tree's ``ops/cuda/bcjr`` module: its package imported
    from ``root`` as ``parent_port`` (its kernels build into ``root``'s own
    ``build/``)."""
    pkg = Path(root).resolve() / "aether_primitives_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        "parent_port", pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["parent_port"] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module("parent_port.ops.cuda.bcjr")


def reach_cases(pbk, card: str, shapes=None) -> None:
    """The block instance's shapes (``REACH``; those whose label holds
    ``shapes``, where given), this tree's wrapper against the parent's
    (``pbk``, or None) in turns: device time, events, bounds."""
    rng = np.random.default_rng(2028)
    for label, s_count, code, lw, n in REACH:
        if shapes and shapes not in label:
            continue
        tables = (random_tables(s_count, 1900 + s_count) if code is None
                  else None if code == "rsc8" else fec._conv_soft_coeffs(code[1], code[0]))
        lw = lw or bk.lanes_span_limit(s_count) + 1
        ls, lp = (torch.from_numpy((rng.normal(size=(lw, n)) * 3).astype(np.float32)).cuda()
                  for _ in range(2))
        want = bk.bcjr_windowed_llr_reference(ls, lp, lw, tables)
        turns = {"this tree": bk} if pbk is None else {"parent": pbk, "this tree": bk}
        runs = {}
        for name, mod in turns.items():
            run = (lambda m: lambda: m.bcjr_windowed_llr(ls, lp, lw, tables))(mod)
            got = run()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                sys.exit(f"{label}: {name}'s kernel disagrees with the twin")
            runs[name] = run
        names = list(runs)
        ev = {name: [] for name in names}
        dev = {name: [] for name in names}
        for r in range(4):  # in turns, the order reversed every other round
            for name in (names if r % 2 == 0 else names[::-1]):
                ev[name].append(time_cuda(runs[name], 10, warmup=2))
                dev[name].append(kernel_device_ms(runs[name], "bcjr", 10))
        classes = code is not None
        ops_any = bcjr_ops(lw, n, s_count, False)
        ops = bcjr_ops(lw, n, s_count, classes)
        b_bytes = 3 * lw * n * 4 / PEAK_BYTES * 1e3
        bound_any = max(ops_any / PEAK_INSTR * 1e3, b_bytes)
        bound = max(ops / PEAK_INSTR * 1e3, b_bytes)
        layout = bk.block_layout(s_count, n)
        hist_ms = 2 * lw * layout[5] * n * 4 / PEAK_BYTES * 1e3
        print(f"{label}, Lw {lw} x N {n} (this tree's plan {bk.kernel_plan(tables, lw)}, "
              f"route {layout}): bound {bound_any:.5f} ms for any tables"
              f" ({ops_any / 1e6:.1f} M operations), {bound:.5f} ms with four classes"
              f"{'' if classes else ' (random tables: none)'}; history floor {hist_ms:.5f} ms "
              f"({2 * lw * layout[5] * n * 4 / 1e6:.1f} MB written and read) [{card}]")
        for name in names:
            d = float(np.median(dev[name]))
            print(f"  {name:10s} device {d:.5f} ms a launch (torch.profiler, median of 4 x 10; "
                  f"{', '.join(f'{v:.5f}' for v in dev[name])}), {d / bound_any:.1f}x the bound "
                  f"for any tables; events {float(np.median(ev[name])):.5f} ms a call (median of "
                  f"4 x 10) [{card}]", flush=True)


def cluster_geometries(card: str) -> None:
    """The geometries past 1,024 states at the timed shapes (phase 7's
    random S 1,500 at Lw 96 x N 7; the K 12 code's S 2,048 at Lw 224 x N 7,
    64 and 512; random S 2,048 at Lw 224 x N 512): the cluster route at
    clusters of 2, 4 and 8 CTAs (the registers placement, R and W as
    ``bk.cluster_layout`` sizes them for that q) and the shared route
    (``bk.SHARED_GEOMETRY``), each held ``torch.equal`` to the twin, then device
    time a launch in turns (``torch.profiler``)."""
    rng = np.random.default_rng(2029)
    k12 = fec._conv_soft_coeffs((0o4335, 0o5723), 12)
    for s_count, tables, lw, n in ((1500, random_tables(1500, 3400), 96, 7),
                                   (2048, k12, 224, 7), (2048, k12, 224, 64),
                                   (2048, k12, 224, 512),
                                   (2048, random_tables(2048, 3401), 224, 512)):
        ls, lp = (torch.from_numpy((rng.normal(size=(lw, n)) * 3).astype(np.float32)).cuda()
                  for _ in range(2))
        want = bk.bcjr_windowed_llr_reference(ls, lp, lw, tables)
        out = torch.empty_like(want)
        geos = {}
        found = []
        for q in (2, 4, 8):
            sc = -(-s_count // q)
            r = next(r for r in (2, 4, 8) if 128 * r >= sc)
            found.append((q, r, -(-sc // (32 * r)), "registers", r))
        found.append((1, *bk.SHARED_GEOMETRY, "shared", bk.SHARED_GEOMETRY[0]))
        for geo in found:
            bk._launch_block(ls, lp, out, lw, tables, cluster=geo)
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                sys.exit(f"S {s_count}: the geometry {geo} disagrees with the twin")
            geos[geo] = (lambda g: lambda: bk._launch_block(ls, lp, out, lw, tables,
                                                            cluster=g))(geo)
        dev = {g: [] for g in geos}
        names = list(geos)
        for r in range(4):
            for g in (names if r % 2 == 0 else names[::-1]):
                dev[g].append(kernel_device_ms(geos[g], "bcjr_kernel", 10))
        plan = bk.cluster_layout(s_count, n)
        for g in names:
            print(f"geometry S {s_count}, Lw {lw} x N {n}: (q, R, W, place) {g[:4]}"
                  f"{' (the plan)' if g == plan else ''}: device "
                  f"{float(np.median(dev[g])):.5f} ms a launch (torch.profiler, median of 4 x "
                  f"10: {', '.join(f'{v:.5f}' for v in dev[g])}) [{card}]", flush=True)


def call_cost(pbk, card: str) -> None:
    """The host's part of a call past 1,024 states (random S 1,500 and the K
    12 code's S 2,048, Lw 96 x N 7): CUDA events a call (median of 4 x 20)
    where the call finds its table set by the tables object's identity,
    where it hashes them once (the identity map emptied before each call),
    and through the parent's wrapper (``pbk``), in turns, beside the
    kernel's device time."""
    rng = np.random.default_rng(2030)
    for label, tables in (("random S 1,500", random_tables(1500, 3400)),
                          ("K 12 (S 2,048)", fec._conv_soft_coeffs((0o4335, 0o5723), 12))):
        lw, n = 96, 7
        ls, lp = (torch.from_numpy((rng.normal(size=(lw, n)) * 3).astype(np.float32)).cuda()
                  for _ in range(2))
        want = bk.bcjr_windowed_llr_reference(ls, lp, lw, tables)

        def hashed():
            bk._RECENT.clear()
            return bk.bcjr_windowed_llr(ls, lp, lw, tables)
        runs = {"identity": lambda: bk.bcjr_windowed_llr(ls, lp, lw, tables), "one hash": hashed}
        if pbk is not None:
            runs["parent"] = lambda: pbk.bcjr_windowed_llr(ls, lp, lw, tables)
        for name, run in runs.items():
            if not torch.equal(run(), want):
                sys.exit(f"{label}: the {name} call disagrees with the twin")
        ev = {name: [] for name in runs}
        names = list(runs)
        for r in range(4):
            for name in (names if r % 2 == 0 else names[::-1]):
                ev[name].append(time_cuda(runs[name], 20, warmup=2))
        dev = {name: kernel_device_ms(runs[name], "bcjr_kernel", 20) for name in names}
        for name in names:
            print(f"call {label}, Lw {lw} x N {n}, {name}: {float(np.median(ev[name])):.5f} ms a "
                  f"call (CUDA events, median of 4 x 20: "
                  f"{', '.join(f'{v:.5f}' for v in ev[name])}), device {dev[name]:.5f} ms a "
                  f"launch (torch.profiler, 20 calls) [{card}]", flush=True)


def time_cases(label, cases, want, out, lw, n, s_count, card, floor_ms, clock) -> None:
    """Each case held torch.equal to ``want``, then timed in turns (CUDA
    events) and by the profiler; prints a line a case."""
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
    floor_bytes = 3 * lw * n * 4 / PEAK_BYTES
    ops, ops_any = (bcjr_ops(lw, n, s_count, c) for c in (True, False))
    bound = max(ops / PEAK_INSTR, floor_bytes) * 1e3
    bound_any = max(ops_any / PEAK_INSTR, floor_bytes) * 1e3
    print(f"{label}, Lw {lw} x N {n}: bound {bound:.5f} ms ({ops / 1e6:.1f} M FP32 "
          f"operations with four branch-metric classes, no FMA, at {PEAK_INSTR / 1e12:.1f} "
          f"T/s; {bound_any:.5f} ms, {ops_any / 1e6:.1f} M, for any tables), chain floor "
          f"{floor_ms:.5f} ms "
          f"({lw} steps x {CHAIN_OPS} ops x {OP_CYCLES} cycles at {clock / 1e6:.0f} MHz) "
          f"[{card}]")
    for name in names:
        ms = float(np.median(runs[name]))
        print(f"  {name:46s} device {dev_ms[name]:.5f} ms a launch (torch.profiler, "
              f"median of 2 x 20), {dev_ms[name] / bound:.1f}x the bound "
              f"({dev_ms[name] / bound_any:.1f}x the bound for any tables); a loop of "
              f"launches {ms:.5f} ms (runs {', '.join(f'{v:.5f}' for v in runs[name])}; "
              f"CUDA events, mean of {ITERS}) [{card}]", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    ap.add_argument("--parent", help="a checkout of the parent tree to time beside this one")
    ap.add_argument("--only", nargs="+", choices=SECTIONS,
                    help="run these sections only (default: all)")
    ap.add_argument("--shapes", help="reach: the shapes whose label holds this text only")
    args = ap.parse_args()
    only = set(args.only or SECTIONS)
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
    pbk = parent_bcjr(args.parent) if args.parent else None
    if "reach" in only:
        reach_cases(pbk, card, args.shapes)
    if "geometries" in only:
        cluster_geometries(card)
    if "calls" in only:
        call_cost(pbk, card)
    if "instances" not in only:
        return
    rng = np.random.default_rng(2026)
    ls_all, lp_all = (torch.from_numpy((rng.normal(size=(CCSDS_LW, CCSDS_N)) * 3)
                                       .astype(np.float32)).cuda() for _ in range(2))
    stream = torch.cuda.current_stream().cuda_stream
    wide = sweep_library()
    dev = ls_all.get_device()
    clock = max_sm_clock_hz()
    k7 = fec._conv_soft_coeffs((0o171, 0o133), 7)
    shapes = (("RSC-8 (S 8)", None, LW, N), ("K=7 conv (S 64)", k7, LW, N),
              ("K=7 conv (S 64), the ccsds launch", k7, CCSDS_LW, CCSDS_N))
    for label, tables, lw, n in shapes:
        ls, lp = ls_all[:lw, :n].contiguous(), lp_all[:lw, :n].contiguous()
        out = torch.empty((lw, n), device="cuda")
        idx, _, instance, cls = bk._host_tables(tables if tables is not None
                                                else bk.rsc8_tables())
        s_count = idx.shape[1]
        want = bk.bcjr_windowed_llr_reference(ls, lp, lw, tables)
        floor_ms = lw * CHAIN_OPS * OP_CYCLES / clock * 1e3
        cases = {}
        if instance == "rsc8":
            for cols in (8, 16, 24, 32):
                def run_wide(c=cols):
                    rc = wide(ls.data_ptr(), lp.data_ptr(), out.data_ptr(), lw, n, c, 1,
                              cls.ctypes.data, dev, stream)
                    if rc:
                        sys.exit(f"bcjr meet at {c} columns a CTA: CUDA error {rc}")
                cases[f"meet {cols} cols/CTA ({-(-n // cols)} CTAs)"] = run_wide
            cases[f"meet through the wrapper ({bk.kernel_plan(None, lw)})"] = (
                lambda: bk._launch_meet(ls, lp, out, lw, bk.kernel_plan(None, lw)[1], cls))
        shift = bk.shift_register(tables)
        cases["lanes (states over lanes, meeting warps)"] = (
            lambda: bk._launch_lanes(ls, lp, out, lw, tables, shift))
        if shift:
            cases["lanes, table form (no shuffles)"] = (
                lambda: bk._launch_lanes(ls, lp, out, lw, tables, False))
        cases["block (forced, the meeting warps, history in the scratch)"] = (
            lambda: bk._launch_block(ls, lp, out, lw, tables))
        time_cases(label, cases, want, out, lw, n, s_count, card, floor_ms, clock)
    # the meet instance's fixed cost and its cost a step: device time at
    # shorter spans of the same columns
    ls, lp = ls_all[:LW, :N].contiguous(), lp_all[:LW, :N].contiguous()
    out = torch.empty((LW, N), device="cuda")
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
    print(f"module choice: kernel_plan(None, {LW}) = {bk.kernel_plan(None, LW)}, "
          f"kernel_plan(K=7, {CCSDS_LW}) = {bk.kernel_plan(k7, CCSDS_LW)} [{card}]")


if __name__ == "__main__":
    main()
