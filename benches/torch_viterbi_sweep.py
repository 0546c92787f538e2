#!/usr/bin/env python3
"""Launch-shape sweep of the PyTorch port's Viterbi kernel on one CUDA card,
beside the parent tree's kernel.

Two shapes of the burst path, K = 7 rate 1/2 (``chip_smoke.py`` phase 7):
the full block (256 trellises of 638 steps, state-0 start and end) and the
windowed decoder's spans (2,560 spans of 160 steps: window 64, guard 48,
uniform start, argmin end). For every launch shape (warps a block 1, 2, 4,
8 x trellises a warp 1, 2, where the histories fit a block) the kernel is
first held ``torch.equal`` to the plain twin, then timed launched straight
(CUDA events, median of 3 runs of 50 launches) and by ``torch.profiler``
(device time a launch, with the number of kernels it recorded). One
trellis a warp is the port's kernel (``ops/cuda/viterbi.py launch``); two
a warp is the bench's own ``benches/torch_viterbi_sweep.cu``, built on the
port's source, which the port does not ship. Then the port's own launch
(``ops/cuda/viterbi.py WARPS``) and, with ``--parent DIR``, the parent
tree's ``csrc/viterbi.cu`` (built beside the port's builds, 4 trellises a
block, its own choice) in turns: parent, this, this, parent. Then the
block instance's codes (``BLOCK_CASES``: K 10, 15 and 17, K 7 with 16
generators, 256 spans of 112 steps, 4 at K 17; the grid route's K 19 at
``chip_smoke.py`` phase 7's 2 full blocks of 78 steps and at 16 of 1,024;
integer LLRs with ties):
this tree's ``viterbi_lanes`` and, with ``--parent``, the parent tree's
(its package imported from DIR, built into DIR's own ``build/``), each
``torch.equal`` to the twin, then in turns (CUDA events, median of 3 runs of
10 calls; device time a launch by ``torch.profiler``) beside the operation
bound: a step's metric of each distinct output pattern (``n`` FMAs each)
and 6 non-FMA operations a state, each at an FMA's issue slot of the
67 TFLOP/s FP32 peak (``chip_smoke.py viterbi_bound_of``). Prints the
compiler's report of this tree's kernel and writes its SASS for 64 states
to ``build/viterbi_sass.txt`` where ``cuobjdump`` is there. Every line
carries the card's name and power limit.

Run from the repository root on a machine with a CUDA card:
``python3 benches/torch_viterbi_sweep.py [--parent DIR]``. Imports the port
only.
"""

import argparse
import ctypes
import importlib
import importlib.util
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from aether_primitives_tpu_torch.cli import card_label, kernel_device_times, time_cuda  # noqa: E402
from aether_primitives_tpu_torch.ops import fec  # noqa: E402
from aether_primitives_tpu_torch.ops.cuda import build  # noqa: E402
from aether_primitives_tpu_torch.ops.cuda import viterbi as vk  # noqa: E402

POLYS, K = (0o171, 0o133), 7
# (label, trellises, steps, init_state0, end_state0)
CASES = (("full block", 256, 638, True, True), ("windowed spans", 2560, 160, False, False))
SHAPES = [(w, t) for t in (1, 2) for w in (1, 2, 4, 8)]
ITERS, RUNS = 50, 3
# the block instance's codes: (label, K, generators, spans, steps, full
# block (state 0 at both ends) or not, calls a timed window)
K19 = (0o1351753, 0o1746321)
BLOCK_CASES = (
    ("K=10 rate 1/2", 10, (0o1171, 0o1233), 256, 112, False, 10),
    ("K=15 rate 1/2", 15, (0o46321, 0o51271), 256, 112, False, 10),
    ("K=17 rate 1/2", 17, (0o234567, 0o312345), 4, 112, False, 10),
    ("K=7 rate 1/16", 7, tuple(range(0o101, 0o101 + 32, 2)), 256, 112, False, 10),
    ("K=19 rate 1/2, full block", 19, K19, 2, 78, True, 4),
    ("K=19 rate 1/2, full block", 19, K19, 16, 1024, True, 2),
)
PEAK_FP32 = 67e12  # H100 SXM, NVIDIA data sheet


def parent_viterbi(root: str):
    """The parent tree's ``ops/cuda/viterbi`` module: its package imported
    from ``root`` as ``parent_port`` (its kernels build into ``root``'s own
    ``build/``)."""
    pkg = Path(root).resolve() / "aether_primitives_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        "parent_port", pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["parent_port"] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module("parent_port.ops.cuda.viterbi")


def block_cases(parent_root, card: str) -> None:
    """The block instance's codes, this tree against the parent's in turns."""
    pvk = parent_viterbi(parent_root) if parent_root else None
    rng = np.random.default_rng(2027)
    for label, k, polys, n_tr, lw, full, calls in BLOCK_CASES:
        n = len(polys)
        sym = torch.from_numpy(np.round(rng.normal(size=(n_tr, lw, n)) * 2)
                               .astype(np.float32)).cuda()
        want = vk.viterbi_lanes_reference(sym, lw, n, polys, k, full, full)
        turns = {"this tree": vk}
        if pvk is not None:
            turns = {"parent": pvk, **turns}
        runs = {}
        for name, mod in turns.items():
            run = (lambda m: lambda: m.viterbi_lanes(sym, lw, n, polys, k, full, full))(mod)
            got = run()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                sys.exit(f"{label}: {name}'s kernel disagrees with the twin")
            runs[name] = run
        del want
        names = list(runs)
        times = {name: [] for name in names}
        for r in range(RUNS + 1):
            for name in (names if r % 2 == 0 else names[::-1]):
                times[name].append(time_cuda(runs[name], calls, warmup=1))
        s_count = 1 << (k - 1)
        npat = vk.patterns(polys, k)[0]
        # the patterns' metrics (n FMAs each) and 6 non-FMA operations a
        # state, each at an FMA's issue slot (chip_smoke.py viterbi_bound_of)
        bound = 2 * n_tr * lw * (npat * n + 6 * s_count) / PEAK_FP32 * 1e3
        plan = vk.block_plan(lw, n, k, n_tr)
        route = f"cluster route {plan}" if plan else "grid route"
        for r in range(2):  # the profiler in turns too
            for name in (names if r % 2 == 0 else names[::-1]):
                print(f"block {label} [{n_tr} x {lw}], in turns: {name} "
                      f"{device(runs[name], 'viterbi_', 2 * calls)} [{card}]", flush=True)
        for name in names:
            ms = float(np.median(times[name]))
            print(f"block {label} [{n_tr} x {lw}]: {name}"
                  f"{f' ({route})' if name == 'this tree' else ''} median "
                  f"{ms:.5f} ms (runs {', '.join(f'{v:.5f}' for v in times[name])}; CUDA "
                  f"events, {calls} calls); bound {bound:.5f} ms (operations: {npat} patterns x n "
                  f"FMAs + 6 S a step at an FMA's slot) "
                  f"[{card}]", flush=True)
        del sym, runs
        torch.cuda.empty_cache()


def parent_launcher(root: str, sym, bits, lw, init0, end0):
    """The parent tree's kernel (entry ``viterbi_launch(sym, bits, n_trellis,
    lw, n, s_count, init_state0, end_state0, warps, out_mask, scratch,
    stream)``, the histories in shared memory) at 4 trellises a block."""
    src = Path(root) / "aether_primitives_tpu_torch" / "csrc" / "viterbi.cu"
    out = build.BUILD_DIR / "sweep-parent-viterbi.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(out), str(src)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
    fn = ctypes.CDLL(str(out)).viterbi_launch
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong]
                   + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    masks = vk._out_masks(POLYS, K)

    def run():
        if fn(sym.data_ptr(), bits.data_ptr(), sym.shape[0], lw, 2, 1 << (K - 1), int(init0),
              int(end0), 4, masks.ctypes.data, None, torch.cuda.current_stream().cuda_stream):
            sys.exit("parent viterbi launch failed")
    return run


def pair_entry():
    """``viterbi_pair_launch`` of ``benches/torch_viterbi_sweep.cu``: two
    trellises a warp, K = 7 rate 1/2."""
    src = Path(__file__).with_suffix(".cu")
    out = build.BUILD_DIR / "sweep-viterbi-pair.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-I",
                           str(build.PACKAGE_DIR / "csrc"), "-o", str(out), str(src)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
    fn = ctypes.CDLL(str(out)).viterbi_pair_launch
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong]
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def device(fn, name: str, calls: int = 20) -> str:
    """The profiler's device time a launch of ``fn`` (one launch a call):
    the mean over the launches it recorded, and how many of ``calls`` it
    did."""
    for _ in range(3):  # the profiler drops a window's records at times: another
        times = kernel_device_times(fn, name, calls)
        if times:
            break
    us = [t for _, t in times]
    if not us:  # no number where none was measured
        return f"device none (torch.profiler recorded 0 of {calls} launches in 3 windows)"
    names = sorted({n.split("(")[0] for n, _ in times})
    return (f"device {sum(us) / len(us) / 1e3:.5f} ms a launch (torch.profiler: "
            f"{len(us)} of {calls} launches recorded, {min(us):.1f}-"
            f"{max(us):.1f} us each; {', '.join(names)})")


def dump_sass() -> None:
    """The SASS of the port's kernel at 64 states, rate 1/2 (the burst
    path's), into ``build/viterbi_sass.txt``."""
    tool = Path(build.find_nvcc()).parent / "cuobjdump"
    if not tool.exists():
        print("cuobjdump not found: no SASS written")
        return
    dump = subprocess.run([str(tool), "-sass", str(build.library_path("viterbi"))],
                          capture_output=True, text=True).stdout
    keep, lines = False, []
    for line in dump.splitlines():
        if "Function :" in line:
            keep = "viterbi_kernelILi64ELi2E" in line
        if keep:
            lines.append(line)
    out = build.BUILD_DIR.parent / "viterbi_sass.txt"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text("\n".join(lines) + "\n")
    print(f"SASS of viterbi_kernel<64, 2> written to {out} "
          f"({sum(1 for x in lines if x.strip().startswith('/*'))} lines)")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="a checkout of the parent tree to time beside this one")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    card = card_label()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    build.load("viterbi")
    for line in build.library_path("viterbi").with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas viterbi: {line.strip()}")
    dump_sass()
    pair = pair_entry()
    masks = vk._out_masks(POLYS, K)
    rng = np.random.default_rng(2026)
    for label, n_tr, lw, init0, end0 in CASES:
        bits_in = rng.integers(0, 2, (n_tr, lw - (K - 1) if end0 else lw)).astype(np.uint8)
        enc = fec.conv_encode(torch.from_numpy(bits_in), POLYS, K, terminate=end0).numpy()
        llr = ((1 - 2.0 * enc) * 2 + 1.5 * rng.normal(size=enc.shape)).astype(np.float32)
        sym = torch.from_numpy(llr.reshape(n_tr, lw, 2)).cuda()
        want = vk.viterbi_lanes_reference(sym, lw, 2, POLYS, K, init0, end0)
        out = torch.empty_like(want)
        for warps, tpw in SHAPES:
            if warps * tpw * lw * 8 > vk.MAX_SMEM:
                continue

            def run(warps=warps, tpw=tpw):
                if tpw == 1:
                    vk.launch(sym, out, lw, 2, POLYS, K, init0, end0, warps)
                elif pair(sym.data_ptr(), out.data_ptr(), n_tr, lw, int(init0), int(end0), warps,
                          masks.ctypes.data, torch.cuda.current_stream().cuda_stream):
                    sys.exit(f"two-trellis launch failed at {warps} warps a block")
            out.zero_()
            run()
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                sys.exit(f"{label}: {warps} warps x {tpw} trellises disagrees with the twin")
            ms = float(np.median([time_cuda(run, ITERS) for _ in range(RUNS)]))
            print(f"{label} [{n_tr} x {lw}]: {warps} warps a block, {tpw} trellises a "
                  f"warp: {ms:.5f} ms (CUDA events, median of {RUNS} x {ITERS} launches); "
                  f"{device(run, 'viterbi_')} [{card}]", flush=True)
        warps = vk.warps_per_block(lw, K)

        def port_run():
            vk.launch(sym, out, lw, 2, POLYS, K, init0, end0, warps)
        out.zero_()
        port_run()
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            sys.exit(f"{label}: the port's launch disagrees with the twin")
        turns = {f"this tree ({warps} warps a block)": port_run}
        if args.parent:
            pbits = torch.empty_like(want)
            prun = parent_launcher(args.parent, sym, pbits, lw, init0, end0)
            prun()
            torch.cuda.synchronize()
            if not torch.equal(pbits, want):
                sys.exit(f"{label}: the parent's kernel disagrees with the twin")
            turns["parent"] = prun
        names = list(turns)[::-1]
        got = {n: [] for n in names}
        for r in range(2 * RUNS):
            for name in (names if r % 2 == 0 else names[::-1]):
                got[name].append(time_cuda(turns[name], ITERS))
        for r in range(2):  # the profiler in turns too
            for name in (names if r % 2 == 0 else names[::-1]):
                print(f"{label}, in turns: {name} {device(turns[name], 'viterbi_kernel')} "
                      f"[{card}]", flush=True)
        for name in names:
            print(f"{label}, in turns: {name} median {float(np.median(got[name])):.5f} ms "
                  f"(runs {', '.join(f'{v:.5f}' for v in got[name])}; CUDA events) [{card}]",
                  flush=True)
    block_cases(args.parent, card)


if __name__ == "__main__":
    main()
