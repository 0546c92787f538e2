#!/usr/bin/env python3
"""Tile-shape and branch-count sweep of the PyTorch port's PFB fold kernel
on one CUDA card.

Builds ``aether_primitives_tpu_torch/csrc/pfb_fold.cu`` once per tile shape
(``-DPFB_FOLD_ROWS=r -DPFB_FOLD_FRAMES=f``: ``r`` thread rows of 64 columns,
``f`` frames per thread, ``r * f`` frames per block), all builds started
together, and times each at the channelizer's analysis geometry (os 2,
M 2,048, 2,048 frames per class) for P = 1, 9, 17 and 33 branches, with CUDA
events (median of 3 runs of 50 launches, the shapes interleaved). Each
build is first held ``torch.equal`` to the plain twin at P = 33. Prints per
shape the registers, the time per P beside the byte bound, and the slope
per branch: time that grows with P is the arithmetic loop's, time that
does not is the memory phase's.

Run from the repository root on a machine with a CUDA card:
``python3 benches/torch_pfb_fold_sweep.py``. Imports the port only.
"""

import ctypes
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from aether_primitives_tpu_torch.cli import card_label, time_cuda  # noqa: E402
from aether_primitives_tpu_torch.ops.cuda import build  # noqa: E402
from aether_primitives_tpu_torch.ops.cuda import pfb_fold as pf  # noqa: E402

M, OS, T_CLS = 2048, 2, 2048
BRANCHES = (1, 9, 17, 33)
SHAPES = ((8, 8), (4, 8), (16, 8), (8, 4), (16, 4), (4, 16), (8, 16))  # (rows, frames)
ITERS, RUNS = 50, 3
PEAK_BYTES = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet


def build_shape(rows: int, frames: int):
    """Compile the kernel at one tile shape; returns (entry, registers)."""
    src = build.PACKAGE_DIR / "csrc" / "pfb_fold.cu"
    out = build.BUILD_DIR / f"sweep-pfb_fold-{rows}x{frames}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run(
        [build.find_nvcc(), *build.NVCC_FLAGS, f"-DPFB_FOLD_ROWS={rows}",
         f"-DPFB_FOLD_FRAMES={frames}", "-o", str(out), str(src)],
        capture_output=True, text=True,
    )
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {rows}x{frames}:\n{proc.stderr}")
    regs = re.findall(r"Used (\d+) registers", proc.stdout + proc.stderr)
    fn = ctypes.CDLL(str(out)).pfb_fold_launch
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn, int(regs[0]) if regs else -1


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    card = card_label()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    with ThreadPoolExecutor(len(SHAPES)) as pool:
        built = dict(zip(SHAPES, pool.map(lambda s: build_shape(*s), SHAPES)))
    rng = np.random.default_rng(5)
    hop = M // OS
    p_max = max(BRANCHES)
    n = (OS - 1) * hop + (T_CLS - 1 + p_max) * M
    xr, xi = (torch.from_numpy(rng.normal(size=n).astype(np.float32)).cuda() for _ in range(2))
    hbs = {p: torch.from_numpy(rng.normal(size=(p, M)).astype(np.float32)).cuda()
           for p in BRANCHES}
    out_r = torch.empty(OS, T_CLS, M, device="cuda")
    out_i = torch.empty_like(out_r)
    stream = torch.cuda.current_stream().cuda_stream

    def launch(fn, p):
        rc = fn(xr.data_ptr(), xi.data_ptr(), n, hbs[p].data_ptr(), out_r.data_ptr(),
                out_i.data_ptr(), 1, M, p, OS, hop, T_CLS, stream)
        if rc:
            raise RuntimeError(f"launch failed: CUDA error {rc}")

    plain = pf.pfb_fold_os_reference(xr, xi, hbs[p_max], OS, T_CLS)
    for shape, (fn, _) in built.items():
        launch(fn, p_max)
        torch.cuda.synchronize()
        if not (torch.equal(out_r, plain[0]) and torch.equal(out_i, plain[1])):
            sys.exit(f"shape {shape}: kernel and plain twin disagree")
    print(f"all {len(SHAPES)} shapes torch.equal to the plain twin at P {p_max}")

    times = {(s, p): [] for s in SHAPES for p in BRANCHES}
    for _ in range(RUNS):
        for p in BRANCHES:
            for shape, (fn, _) in built.items():
                times[(shape, p)].append(time_cuda(lambda: launch(fn, p), ITERS))
    print(f"pfb_fold at os {OS}, M {M}, t_cls {T_CLS}: ms per launch (median of {RUNS} "
          f"runs of {ITERS}; CUDA events) [{card}]")
    bounds = {p: (8 * ((T_CLS - 1 + p) * M + (OS - 1) * hop) + 8 * OS * T_CLS * M
                  + 4 * p * M) / PEAK_BYTES * 1e3 for p in BRANCHES}
    print("rows x frames  threads  regs  " + "  ".join(f"P={p:<3d}" for p in BRANCHES)
          + "  ms/branch")
    for shape, (_, regs) in built.items():
        med = [float(np.median(times[(shape, p)])) for p in BRANCHES]
        slope = np.polyfit(BRANCHES, med, 1)[0]
        print(f"{shape[0]:4d} x {shape[1]:<6d} {64 * shape[0]:7d} {regs:5d}  "
              + "  ".join(f"{v:.4f}" for v in med) + f"  {slope:.5f}")
    print("byte bound   " + " " * 15 + "  ".join(f"{bounds[p]:.4f}" for p in BRANCHES))


if __name__ == "__main__":
    main()
