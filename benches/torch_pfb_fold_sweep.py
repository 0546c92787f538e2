#!/usr/bin/env python3
"""The PyTorch port's PFB fold kernel past one slab beside a chunk of the
weights (its ranged instance) on one CUDA card, in turns with another
checkout's kernel.

Builds ``aether_primitives_tpu_torch/csrc/pfb_fold.cu`` as it ships, the
edited copies named by ``--variants`` (design variants, held to the twin,
and ablations, which are not; written under the build directory;
each edit must match the source exactly once, else the script exits) and,
with ``--parent DIR``, that checkout's ``csrc/pfb_fold.cu`` (the same C
entry, ``pfb_fold_launch``), all builds started together. At M 2,048 and os
2 it runs

- the five layout and tap-type pairs (analysis, synthesis, real and
  complex taps; planes) at P 295, 512 and 1,024 over 1,024 frames (planes:
  512 class frames) and
- the users' streaming step at P 512: a 4M-sample block, 4,096 frames,
  through each layout's call as ``PfbChannelizerOs`` / ``PfbSynthesizerOs``
  make it (the carried tail and the block; the frames with the carried
  overlap-add, ``emit`` and the periodic divisor),

holds every build's output ``torch.equal`` to the plain twin first, then
times each build's launches (the C entry called straight, outputs made
once) in turns, the order reversed each round (parent, this, variants,
variants, this, parent, ...): device time a launch by ``torch.profiler``
(the mean of the records kept of 20 launches; the median over the rounds)
and CUDA events (30 launches). Prints the registers and spills of each
build's ranged kernels, the plan (:func:`pfb_fold.branch_range`), the terms
the synthesis runs against the real ones (:func:`pfb_fold.ranged_terms`)
and the bound as ``chip_smoke.py`` phase 13 counts it (a multiply and an
add a real term on each plane, four of each a complex one, never an FMA,
each an FMA's issue slot; the bytes). Every line carries the card's name
and power limit.

Run from the repository root on a machine with a CUDA card:
``python3 benches/torch_pfb_fold_sweep.py [--parent DIR] [--variants a,b]
[--rounds 4] [--only P512]`` (unpack a parent with ``git archive <commit> |
tar -x -C build/parent``). Imports the port only.
"""

import argparse
import ctypes
import re
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from aether_primitives_tpu_torch.cli import (  # noqa: E402
    card_label, kernel_device_times, time_cuda,
)
from aether_primitives_tpu_torch.ops.cuda import build  # noqa: E402
from aether_primitives_tpu_torch.ops.cuda import pfb_fold as pf  # noqa: E402

M, OS = 2048, 2
HOP = M // OS
BRANCHES = (295, 512, 1024)
T_FRAMES = 1024  # frames of the shapes at each P (PERF.md's ranged row)
STREAM_P, STREAM_BLOCK = 512, 1 << 22  # the users' streaming step
PAIRS = (("analysis", False), ("analysis", True), ("synthesis", False), ("synthesis", True),
         ("planes", False))
PEAK_BYTES = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
PEAK_FP32 = 67e12  # FP32 operations a second (an FMA counted as two), as chip_smoke.py
ITERS, CALLS = 30, 20
# the shipped ranged kernel's variants: (name, edits of the source). "no
# trim": every thread runs its tile's live branches; "no skip": every range
# and branch, as the parent did (the tile shape's effect alone)
TRIM = ("const int qf = max(0, p - 1 - (u0 + F - 1) + d);", "const int qf = cur.ql;")
TRIM_HI = ("min(cur.qh, p - 1 - u0 + d + tj)", "cur.qh")
SKIP = ("if (M_ == kSynthesis && k < n_my) {", "if (false && k < n_my) {")
# "tile 64": 4 thread rows (a 64-row tile), two blocks an SM, each within
# half the SM's shared memory (ranges of 32 real / 16 complex branches)
TILE64 = (("constexpr int kRowsRanged = 8;", "constexpr int kRowsRanged = 4;"),
          ("  static constexpr int kMinBlocks = 1;\n", "  static constexpr int kMinBlocks = 2;\n"),
          ("long long pc = (optin / 2 - static_cast<long long>(R::kTile)",
           "long long pc = (optin / 4 - 512 - static_cast<long long>(R::kTile)"))
# "o in registers": the synthesis's sum over the classes so far in
# registers, not through the output
OUT_FN = "  auto synthesis_out = [&](int u0, int d, int j, const float2 (&acc)[F]) {"
O_REGS = ((OUT_FN, "  float2 o[F];\n" + OUT_FN),
          ("      if (j > 0) v = add2(*dst, v);",
           "      if (j > 0) v = add2(o[t], v);\n      o[t] = v;"),
          ("      *dst = v;\n", "      if (j == a.os - 1) *dst = v;\n"))
VARIANTS = {"no trim": (TRIM, TRIM_HI), "no skip": (TRIM, TRIM_HI, SKIP), "tile 64": TILE64,
            "o in registers": O_REGS}
# ablations, timed but not held to the twin: the ranged kernel without its
# slab and weight copies, or with its outputs made conditional on a value
# that never occurs (so the arithmetic stays); what is left is the rest's
NO_COPY = ("    if (la >= lb) return;\n", "    if (la >= lb || a.pc > 0) return;\n")
NO_OUT = ("if (cur.r == cur.r_hi - 1) synthesis_out(u0, d, j, acc);",
          "if (cur.r == cur.r_hi - 1 && __float_as_uint(acc[0].x) == 0x7fc00001u) "
          "synthesis_out(u0, d, j, acc);")
NO_STORE = ("if (cur.r == cur.r_hi - 1) store_frames<M_, F>(a, b, c, u0, j, acc);",
            "if (cur.r == cur.r_hi - 1 && __float_as_uint(acc[0].x) == 0x7fc00001u) "
            "store_frames<M_, F>(a, b, c, u0, j, acc);")
ABLATIONS = {"ablation no copies": (NO_COPY,), "ablation no outputs": (NO_OUT, NO_STORE),
             "ablation neither": (NO_COPY, NO_OUT, NO_STORE)}


def report(src: Path) -> str:
    """Registers and spills of the ranged kernels in the build of ``src``."""
    log = build.source_library_path(src).with_suffix(".log")
    rep = []
    for inst in log.read_text().split("Compiling entry function")[1:]:
        t = re.search(r"pfb_fold_ranged_kernelILi(\d)ELb(\d)E", inst)
        regs = re.search(r"Used (\d+) registers", inst)
        spill = re.search(r"(\d+) bytes spill stores", inst)
        if t and regs:
            mode, cplx = (int(v) for v in t.groups())
            rep.append(f"{('analysis', 'synthesis', 'planes')[mode]}/{'rc'[cplx]} "
                       f"{regs.group(1)} regs"
                       + (f" (spill {spill.group(1)} B)" if spill and spill.group(1) != "0"
                          else ""))
    return ", ".join(rep) or "no ranged kernel in the report"


def load(src: Path):
    fn = build.load_source(src).pfb_fold_launch
    fn.argtypes = pf._entry().argtypes
    fn.restype = ctypes.c_int
    return fn, report(src)


def build_variant(name: str, edits):
    src = (build.PACKAGE_DIR / "csrc" / "pfb_fold.cu").read_text()
    for a, b in edits:
        if src.count(a) != 1:
            sys.exit(f"the sweep's edit {a!r} no longer matches csrc/pfb_fold.cu once")
        src = src.replace(a, b)
    path = build.BUILD_DIR / f"sweep-{name.replace(' ', '-')}.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(src)
    return load(path)


def stream():
    return torch.cuda.current_stream().cuda_stream


def c64(rng, *shape):
    return torch.from_numpy((rng.normal(size=shape) + 1j * rng.normal(size=shape))
                            .astype(np.complex64)).cuda()


class Case:
    """One layout at one shape: its inputs, its twin's output, a launcher
    of any build's C entry, and its bound."""

    def __init__(self, label, layout, cplx, p, t_frames, rng, streaming=False):
        self.label, self.layout, self.cplx, self.p = label, layout, cplx, p
        w = torch.from_numpy(rng.normal(size=(p, M)).astype(np.float32)).cuda()
        if cplx:
            w = torch.complex(w, torch.from_numpy(rng.normal(size=(p, M)).astype(np.float32))
                              .cuda())
        self.w = w
        t_cls = -(-t_frames // OS)
        if layout == "synthesis":
            self.frames = c64(rng, t_frames, M)
            n_out = pf.synthesis_length(t_frames, M, p, OS)
            self.tail = c64(rng, p * M - HOP) if streaming else None
            self.div = (torch.from_numpy(rng.uniform(0.5, 2.0, HOP).astype(np.float32)).cuda()
                        if streaming else None)
            emit = t_frames * HOP if streaming else n_out
            self.want = pf.pfb_synthesis_reference(self.frames, w, OS, self.tail, self.div,
                                                   emit if streaming else None)
            self.out = torch.empty(emit, dtype=torch.complex64, device="cuda")
            self.rest = torch.empty(n_out - emit, dtype=torch.complex64, device="cuda")
            self.args = (1, int(cplx), self.frames.data_ptr(), None, t_frames * M, 0,
                         t_frames * M, 0, w.data_ptr(), self.out.data_ptr(),
                         self.rest.data_ptr() if n_out > emit else None, n_out, 1, M, p, OS,
                         t_frames, 0, None if self.tail is None else self.tail.data_ptr(),
                         0 if self.tail is None else self.tail.shape[0],
                         None if self.div is None else self.div.data_ptr(), emit)
            nbytes = 8 * t_frames * M + 8 * n_out + w.element_size() * p * M
            self.terms = pf.ranged_terms(t_frames, M, p, OS)
        else:
            n_in = (t_cls + p) * M
            if streaming:  # the carried tail and the block, as PfbChannelizerOs
                self.head, self.body = c64(rng, p * M - HOP), c64(rng, STREAM_BLOCK)
            else:
                self.head, self.body = c64(rng, n_in), None
            x = self.head if self.body is None else torch.cat([self.head, self.body])
            nbytes = (8 * ((t_cls - 1 + p) * M + (OS - 1) * HOP) + 8 * t_frames * M
                      + w.element_size() * p * M)
            self.terms = None
            if layout == "analysis":
                self.want = pf.pfb_analysis_reference(self.head, self.body, w, OS, t_frames)
                self.out = torch.empty(t_frames, M, dtype=torch.complex64, device="cuda")
                body = self.body
                self.args = (0, int(cplx), self.head.data_ptr(),
                             None if body is None else body.data_ptr(), self.head.shape[0],
                             0 if body is None else body.shape[0], self.head.shape[0],
                             0 if body is None else body.shape[0], w.data_ptr(),
                             self.out.data_ptr(), None, 0, 1, M, p, OS, 0, t_frames, None, 0,
                             None, 0)
            else:
                self.xr, self.xi = x.real.contiguous(), x.imag.contiguous()
                self.want = pf.pfb_fold_os_reference(self.xr, self.xi, w, OS, t_cls)
                self.out = (torch.empty(OS, t_cls, M, device="cuda"),
                            torch.empty(OS, t_cls, M, device="cuda"))
                n = self.xr.shape[0]
                self.args = (2, 0, self.xr.data_ptr(), self.xi.data_ptr(), n, 0, n, n,
                             w.data_ptr(), self.out[0].data_ptr(), self.out[1].data_ptr(), 0,
                             1, M, p, OS, 0, t_cls, None, 0, None, 0)
        ops = 2 * t_frames * M * 2 * (2 * p - 1) * (2 if cplx else 1)
        t_ops, t_bytes = ops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
        self.bound = (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes")

    def run(self, fn):
        def go():
            rc = fn(*self.args, stream())
            if rc:
                raise RuntimeError(f"{self.label}: launch failed, CUDA error {rc}")
        return go

    def equal(self, fn) -> bool:
        self.run(fn)()
        torch.cuda.synchronize()
        if self.layout == "synthesis":
            if isinstance(self.want, tuple):
                return torch.equal(self.out, self.want[0]) and torch.equal(self.rest,
                                                                           self.want[1])
            return torch.equal(self.out, self.want)
        if self.layout == "planes":
            return all(torch.equal(g, q) for g, q in zip(self.out, self.want))
        return torch.equal(self.out, self.want)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None,
                    help="another checkout whose csrc/pfb_fold.cu is timed in turns")
    ap.add_argument("--variants", default="",
                    help="comma-separated edited copies to time too: "
                         f"{', '.join(VARIANTS)}, {', '.join(ABLATIONS)}")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--only", default="",
                    help="run only the cases whose label starts so (P512, stream)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    card = card_label()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    names = [v for v in args.variants.split(",") if v]
    edits = {**VARIANTS, **ABLATIONS}
    for v in names:
        if v not in edits:
            sys.exit(f"unknown variant {v!r}")
    with ThreadPoolExecutor(2 + len(names)) as pool:
        futs = {"this": pool.submit(load, build.PACKAGE_DIR / "csrc" / "pfb_fold.cu")}
        if args.parent:
            futs["parent"] = pool.submit(
                load, Path(args.parent) / "aether_primitives_tpu_torch" / "csrc" / "pfb_fold.cu")
        futs.update({v: pool.submit(build_variant, v, edits[v]) for v in names})
        builds = {k: f.result() for k, f in futs.items()}
    order = [k for k in ("parent", "this") if k in builds] + names
    for k in order:
        print(f"build {k}: ranged kernels {builds[k][1]}")

    rng = np.random.default_rng(22)
    specs = [(f"P{p} {layout}{'-c' if cplx else ''}", layout, cplx, p, T_FRAMES, False)
             for p in BRANCHES for layout, cplx in PAIRS]
    t_stream = 2 * STREAM_BLOCK // M
    specs += [(f"stream P{STREAM_P} {layout}{'-c' if cplx else ''}", layout, cplx, STREAM_P,
               t_stream, True) for layout, cplx in PAIRS if layout != "planes"]
    specs = [s for s in specs if s[0].startswith(args.only)]
    print(f"M {M}, os {OS}: ms a launch, device (torch.profiler, median over {args.rounds} "
          f"rounds of the mean of {CALLS} launches) and CUDA events ({ITERS} launches), "
          f"builds in turns: {', '.join(order)} [{card}]", flush=True)
    for label, layout, cplx, p, t_frames, streaming in specs:
        case = Case(label, layout, cplx, p, t_frames, rng, streaming)
        for k in order:
            if not case.equal(builds[k][0]) and k not in ABLATIONS:
                sys.exit(f"{label}: build {k} and the plain twin disagree")
        dev = {k: [] for k in order}
        ev = {k: [] for k in order}
        for r in range(args.rounds):
            for k in (order if r % 2 == 0 else order[::-1]):
                go = case.run(builds[k][0])
                rec = kernel_device_times(go, "pfb_fold", CALLS)
                if rec:
                    dev[k].append(sum(t for _, t in rec) / len(rec) / 1e3)
                ev[k].append(time_cuda(go, ITERS))
        pc = pf.branch_range(layout, p, cplx)
        plan = f"ranges of {pc}" if pc else "chunked weights (not ranged)"
        terms = (f"; terms run / real {case.terms[0] / case.terms[1]:.4f}"
                 if case.terms and pc else "")
        b_ms, b_by = case.bound
        cells = []
        for k in order:
            d = float(np.median(dev[k])) if dev[k] else float("nan")
            cells.append(f"{k} {d:.4f} (events {float(np.median(ev[k])):.4f}; "
                         f"{d / b_ms:.2f}x)")
        print(f"{label}, {t_frames} frames ({plan}{terms}): bound {b_ms:.4f} ms "
              f"({b_by}); " + "; ".join(cells) + f" [{card}]", flush=True)
        del case
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
