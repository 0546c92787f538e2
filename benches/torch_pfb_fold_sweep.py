#!/usr/bin/env python3
"""Tile-shape, ring-depth and branch-count sweep of the PyTorch port's PFB
fold kernel on one CUDA card, beside the parent's kernel.

Builds ``aether_primitives_tpu_torch/csrc/pfb_fold.cu`` as it ships and
edited copies of it (written under the build directory; each edit must
match the source exactly once): one per tile shape (its ``kRowsAnalysis``,
``kFramesAnalysis``, ``kRowsSynthesis``, ``kFramesSynthesis``: thread rows
of 64 columns and analysis frames or synthesis rows a thread), one with a
ring of one slab (no overlap), one that stages the weights a chunk of
branches at a time (the instance the kernel takes where every class's do
not fit in shared memory), and the parent's kernel (``--parent DIR``: that checkout's
``csrc/pfb_fold.cu``; default: the copy kept in
``benches/torch_pfb_fold_parent.cu``), all builds started together. At
the channelizer path's shape (os 2, M 2,048, P 33; analysis: a step's
carried tail of 66,560 samples and a 4,194,304-sample block, 4,096 frames;
synthesis: 4,096 frames in) it holds
every layout of every build ``torch.equal`` to its plain twin, then times,
launched straight on outputs made once (no wrapper):

- each layout (analysis and synthesis with real and complex branches, the
  planes layout) of each build, by CUDA events
  (median of 3 runs of 30 launches, in turns) and by ``torch.profiler``
  (device time a launch, with the number of records it kept of 20
  launches);
- the parent's kernel on the same inputs as planes (analysis; and its two
  class launches at os 1 that the parent's synthesis step made), in turns
  with the default build (parent, this, this, parent);
- the planes layout beside the parent's kernel at os 8, P 260 and os 32,
  P 33, where the weights are staged a chunk at a time (in turns);
- the shipped shape's layouts against the branch count (P = 1, 9, 17,
  33): time that grows with P is the branch loop's, time that does not is
  the memory's;
- an ablation of the shipped shape (its source with the analysis layout's
  frame stores, its 16-byte slab copies, or both, made conditional on a
  value that never occurs, so the arithmetic stays): the time that stays
  when neither memory stream runs is the branch loop's own.

Prints the registers and spills of each build, the launch plan (ring depth
and where the weights are, :func:`pfb_fold.launch_plan`) and the two
floors. Every line carries the card's name and power limit.

Run from the repository root on a machine with a CUDA card:
``python3 benches/torch_pfb_fold_sweep.py [--parent DIR]``. Imports the
port only.
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

M, OS, P, BLOCK = 2048, 2, 33, 1 << 22
HOP = M // OS
TAIL = P * M - HOP  # a steady step's carried tail
T_FRAMES = 4096  # frames of a steady analysis step
BRANCHES = (1, 9, 17, 33)
WIDE = ((8, 260), (32, 33))  # (os, P) whose weights do not fit beside a slab
# (analysis rows, analysis frames, synthesis rows, synthesis frames); the
# first is the shipped shape
SHAPES = ((8, 16, 4, 11), (4, 11, 4, 15), (8, 16, 8, 16), (4, 15, 4, 12))
TILE_LINES = ("constexpr int kRowsAnalysis = {};", "constexpr int kFramesAnalysis = {};",
              "constexpr int kRowsSynthesis = {};", "constexpr int kFramesSynthesis = {};")
# the shipped shape's variants: (name, edits of the source)
DEPTH = "a.stages = 2 * stage_bytes + wbytes <= optin ? 2 : 1;"
STAGED = "const bool ws = stage_bytes + wbytes <= static_cast<size_t>(optin);"
VARIANTS = (("one stage", ((DEPTH, "a.stages = 1;"),)),
            ("chunked weights", ((STAGED, "const bool ws = false;"),)))
ITERS, RUNS, CALLS = 30, 3, 20
PEAK_BYTES = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
ISSUE_RATE = 132 * 128 * 1.98e9  # FP32 instructions a second: SMs x lanes x boost clock


def build_edited(name, edits):
    """The C entry of the kernel's source with ``edits`` (pairs of old and
    new text, each old text matching once), and its registers and spills."""
    src = (build.PACKAGE_DIR / "csrc" / "pfb_fold.cu").read_text()
    for a, b in edits:
        if src.count(a) != 1:
            sys.exit(f"the sweep's edit {a!r} no longer matches csrc/pfb_fold.cu")
        src = src.replace(a, b)
    path = build.BUILD_DIR / f"sweep-{name.replace(' ', '-')}.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(src)
    fn = build.load_source(path).pfb_fold_launch
    fn.argtypes = pf._entry().argtypes
    fn.restype = ctypes.c_int
    log = build.source_library_path(path).with_suffix(".log").read_text()
    rep = []
    for inst in log.split("Compiling entry function")[1:]:
        t = re.search(r"pfb_fold_kernelILi(\d)ELb(\d)ELb(\d)E", inst)
        regs = re.search(r"Used (\d+) registers", inst)
        spill = re.search(r"(\d+) bytes spill stores", inst)
        if t and regs:
            mode, cplx, staged = (int(v) for v in t.groups())
            rep.append(f"{('analysis', 'synthesis', 'planes')[mode]}/{'cr'[not cplx]}/"
                       f"{'ak'[not staged]} {regs.group(1)}"
                       + (f" (spill {spill.group(1)})" if spill and spill.group(1) != "0"
                          else ""))
    return fn, "registers (layout/complex or real taps/all or chunked weights): " + \
        ", ".join(rep)


def build_shape(shape):
    """The kernel's C entry at one tile shape (the shipped one unedited)."""
    edits = tuple((line.format(v0), line.format(v)) for line, v0, v in
                  zip(TILE_LINES, SHAPES[0], shape) if v != v0)
    return build_edited("x".join(map(str, shape)), edits)


# the ablation's edits of the kernel source (each must match exactly once)
STORE = "if (frame < a.t_out) out[frame * a.m] = acc[t];"
NO_STORE = ("if (frame < a.t_out && __float_as_uint(acc[t].x) == 0x7fc00001u) "
            "out[frame * a.m] = acc[t];")
COPY = "cp_async16(slab + rho * kStrip + k2, src + rho * row_step + k2);"
NO_COPY = "if (a.stages == 99) " + COPY
ABLATION = (("no stores", ((STORE, NO_STORE),)), ("no copies", ((COPY, NO_COPY),)),
            ("neither", ((STORE, NO_STORE), (COPY, NO_COPY))))


def build_parent(root):
    src = (Path(root) / "aether_primitives_tpu_torch" / "csrc" / "pfb_fold.cu" if root
           else ROOT / "benches" / "torch_pfb_fold_parent.cu")
    fn = build.load_source(src).pfb_fold_launch
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn, src


def stream():
    return torch.cuda.current_stream().cuda_stream


def check(rc, what):
    if rc:
        raise RuntimeError(f"{what}: launch failed, CUDA error {rc}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None,
                    help="another checkout whose csrc/pfb_fold.cu is timed in turns")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    card = card_label()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    with ThreadPoolExecutor(len(SHAPES) + len(VARIANTS) + len(ABLATION) + 1) as pool:
        futs = {"x".join(map(str, s)): pool.submit(build_shape, s) for s in SHAPES}
        futs.update({name: pool.submit(build_edited, name, e) for name, e in VARIANTS})
        parent_fut = pool.submit(build_parent, args.parent)
        abl = {name: pool.submit(build_edited, f"ablation {name}", e) for name, e in ABLATION}
        built = {name: f.result() for name, f in futs.items()}
        parent, parent_src = parent_fut.result()
        ablation = {name: f.result()[0] for name, f in abl.items()}
    print(f"parent kernel: {parent_src}")
    for name, (_, rep) in built.items():
        print(f"build {name} (analysis rows x frames x synthesis rows x frames, or a variant "
              f"of {'x'.join(map(str, SHAPES[0]))}): {rep}")

    rng = np.random.default_rng(5)

    def c64(n):
        return torch.from_numpy((rng.normal(size=n) + 1j * rng.normal(size=n))
                                .astype(np.complex64)).cuda()

    head, body = c64(TAIL), c64(BLOCK)
    frames = c64(T_FRAMES * M).reshape(T_FRAMES, M)
    w_r = torch.from_numpy(rng.normal(size=(P, M)).astype(np.float32)).cuda()
    w_c = torch.complex(w_r, torch.from_numpy(rng.normal(size=(P, M)).astype(np.float32))
                        .cuda())
    ws = {p: torch.from_numpy(rng.normal(size=(p, M)).astype(np.float32)).cuda()
          for p in BRANCHES}
    x = torch.cat([head, body])
    t_cls = T_FRAMES // OS
    xr, xi = x.real.contiguous(), x.imag.contiguous()
    syn_len = pf.synthesis_length(T_FRAMES, M, P, OS)
    out_a = torch.empty(T_FRAMES, M, dtype=torch.complex64, device="cuda")
    out_s = torch.empty(syn_len, dtype=torch.complex64, device="cuda")
    out_r = torch.empty(OS, t_cls, M, device="cuda")
    out_i = torch.empty_like(out_r)

    def launcher(fn, layout, cplx, w=None):
        """A closure launching one layout straight, and its output."""
        if layout == "analysis":
            w = w if w is not None else (w_c if cplx else w_r)
            a = (0, int(cplx), head.data_ptr(), body.data_ptr(), TAIL, BLOCK, TAIL, BLOCK,
                 w.data_ptr(), out_a.data_ptr(), None, 0, 1, M, w.shape[0], OS, 0, T_FRAMES,
                 None, 0, None, 0)
            out = out_a
        elif layout == "synthesis":
            w = w if w is not None else (w_c if cplx else w_r)
            n_out = pf.synthesis_length(T_FRAMES, M, w.shape[0], OS)
            a = (1, int(cplx), frames.data_ptr(), None, T_FRAMES * M, 0, T_FRAMES * M, 0,
                 w.data_ptr(), out_s.data_ptr(), None, n_out, 1, M, w.shape[0], OS, T_FRAMES,
                 0, None, 0, None, n_out)
            out = out_s
        else:
            a = (2, 0, xr.data_ptr(), xi.data_ptr(), xr.shape[0], 0, xr.shape[0],
                 xr.shape[0], w_r.data_ptr(), out_r.data_ptr(), out_i.data_ptr(), 0, 1, M, P,
                 OS, 0, t_cls, None, 0, None, 0)
            out = (out_r, out_i)

        def run():
            check(fn(*a, stream()), layout)
        return run, out

    def plan(name, layout, cplx):
        """The launch plan of build ``name`` (``pfb_fold.launch_plan``)."""
        shape = SHAPES[0] if name in dict(VARIANTS) else tuple(map(int, name.split("x")))
        tile = shape[2] * shape[3] if layout == "synthesis" else shape[0] * shape[1]
        stages, staged = pf.launch_plan(layout, P, OS, cplx, tile)
        if name == "one stage":
            stages = 1
        elif name == "chunked weights":
            staged = False
            chunk = pf.CHUNK[layout] * pf.STRIP * (8 if cplx else 4)
            stages = 2 if 2 * (tile + P) * pf.STRIP * 8 + chunk <= pf.MAX_SMEM else 1
        return f"tile {tile}, depth {stages}, weights {'all' if staged else 'chunked'}"

    twins = {
        ("analysis", False): pf.pfb_analysis_reference(head, body, w_r, OS, T_FRAMES),
        ("analysis", True): pf.pfb_analysis_reference(head, body, w_c, OS, T_FRAMES),
        ("synthesis", False): pf.pfb_synthesis_reference(frames, w_r, OS),
        ("synthesis", True): pf.pfb_synthesis_reference(frames, w_c, OS),
        ("planes", False): pf.pfb_fold_os_reference(xr, xi, w_r, OS, t_cls),
    }
    cases = []
    for name, (fn, _) in built.items():
        for (layout, cplx), want in twins.items():
            run, out = launcher(fn, layout, cplx)
            run()
            torch.cuda.synchronize()
            same = (torch.equal(out[0], want[0]) and torch.equal(out[1], want[1])
                    if layout == "planes" else torch.equal(out, want))
            if not same:
                sys.exit(f"build {name} {layout} complex={cplx}: kernel and twin disagree")
            cases.append((name, layout, cplx, run, plan(name, layout, cplx)))
    print(f"{len(cases)} launches (build x layout) torch.equal to their twins")

    # floors: bytes (each input read once, each output written once) and the
    # FP32 instructions (a multiply and an add a real term, 4 + 4 complex)
    a_bytes = 8 * (TAIL + BLOCK) + 8 * T_FRAMES * M + 4 * P * M
    s_bytes = 8 * T_FRAMES * M + 8 * syn_len + 4 * P * M
    a_ins = T_FRAMES * M * 2 * (2 * P - 1)
    s_ins = OS * (t_cls + P - 1) * M * 2 * (2 * P - 1)
    floors = {}
    for layout, nb, ins in (("analysis", a_bytes, a_ins), ("synthesis", s_bytes, s_ins),
                            ("planes", a_bytes, a_ins)):
        for cplx in (False, True):
            ins_c = ins * (2 if cplx else 1)
            floors[(layout, cplx)] = (nb / PEAK_BYTES * 1e3, ins_c / ISSUE_RATE * 1e3)

    times = {i: [] for i in range(len(cases))}
    for r in range(RUNS):
        order = range(len(cases)) if r % 2 == 0 else reversed(range(len(cases)))
        for i in order:
            times[i].append(time_cuda(cases[i][3], ITERS))
    print(f"fold layouts at os {OS}, M {M}, P {P}: ms a launch, CUDA events (median of {RUNS} "
          f"runs of {ITERS}) and torch.profiler device time (mean of the records kept of "
          f"{CALLS}) [{card}]")
    print("build                  layout      taps     plan                              "
          "events   device (records)   floors bytes / issue")
    for i, (name, layout, cplx, run, pl) in enumerate(cases):
        dev = kernel_device_times(run, "pfb_fold", CALLS)
        dms = f"{sum(t for _, t in dev) / len(dev) / 1e3:.4f}" if dev else "  n/a "
        fb, fi = floors[(layout, cplx)]
        print(f"{name:21s}  {layout:10s}  {'complex' if cplx else 'real':7s}  {pl:32s}  "
              f"{float(np.median(times[i])):.4f}   {dms} ({len(dev):2d})   "
              f"{fb:.4f} / {fi:.4f}", flush=True)

    # the parent's kernel in turns with the shipped build
    fn0 = built["x".join(map(str, SHAPES[0]))][0]
    spread = t_cls + P - 1  # slabs of one class's os-1 spread in the parent's step
    sx = c64((spread - 1 + P) * M)
    sxr, sxi = sx.real.contiguous(), sx.imag.contiguous()
    so_r = torch.empty(1, spread, M, device="cuda")
    so_i = torch.empty_like(so_r)

    def parent_analysis():
        check(parent(xr.data_ptr(), xi.data_ptr(), xr.shape[0], w_r.data_ptr(),
                     out_r.data_ptr(), out_i.data_ptr(), 1, M, P, OS, HOP, t_cls, stream()),
              "parent")

    def parent_synthesis():  # the parent's synthesis step: one os-1 launch per class
        for _ in range(OS):
            check(parent(sxr.data_ptr(), sxi.data_ptr(), sxr.shape[0], w_r.data_ptr(),
                         so_r.data_ptr(), so_i.data_ptr(), 1, M, P, 1, M, spread, stream()),
                  "parent")

    pairs = (("analysis", parent_analysis, launcher(fn0, "analysis", False)[0]),
             ("synthesis", parent_synthesis, launcher(fn0, "synthesis", False)[0]))
    for name, par, this in pairs:
        got = {"parent": [], "this": []}
        for r in range(4):
            for who in (("parent", "this"), ("this", "parent"))[r % 2]:
                got[who].append(time_cuda(par if who == "parent" else this, ITERS))
        dev_p = kernel_device_times(par, "pfb_fold", CALLS)
        dev_t = kernel_device_times(this, "pfb_fold", CALLS)
        per_p = OS if name == "synthesis" else 1
        print(f"{name}: parent {float(np.median(got['parent'])):.4f} ms a step "
              f"({per_p} launch(es); runs {', '.join(f'{v:.4f}' for v in got['parent'])}), "
              f"device {sum(t for _, t in dev_p) / max(len(dev_p), 1) / 1e3 * per_p:.4f} ms "
              f"({len(dev_p)} records of {CALLS * per_p}); this tree "
              f"{float(np.median(got['this'])):.4f} ms (runs "
              f"{', '.join(f'{v:.4f}' for v in got['this'])}), device "
              f"{sum(t for _, t in dev_t) / max(len(dev_t), 1) / 1e3:.4f} ms ({len(dev_t)} "
              f"records of {CALLS}); CUDA events, launched straight [{card}]", flush=True)

    # past the staged weights (staged a chunk at a time): the planes layout
    # beside the parent's kernel at the same shapes, in turns
    for os_w, p_w in WIDE:
        t_w = T_FRAMES // os_w
        n_w = (os_w - 1) * (M // os_w) + (t_w - 1 + p_w) * M
        xw_r, xw_i = (torch.from_numpy(rng.normal(size=n_w).astype(np.float32)).cuda()
                      for _ in range(2))
        hw = torch.from_numpy(rng.normal(size=(p_w, M)).astype(np.float32)).cuda()
        ow_r = torch.empty(os_w, t_w, M, device="cuda")
        ow_i = torch.empty_like(ow_r)
        pw_r, pw_i = torch.empty_like(ow_r), torch.empty_like(ow_r)
        a_w = (2, 0, xw_r.data_ptr(), xw_i.data_ptr(), n_w, 0, n_w, n_w, hw.data_ptr(),
               ow_r.data_ptr(), ow_i.data_ptr(), 0, 1, M, p_w, os_w, 0, t_w, None, 0, None, 0)

        def this_w():
            check(fn0(*a_w, stream()), "planes")

        def parent_w():
            check(parent(xw_r.data_ptr(), xw_i.data_ptr(), n_w, hw.data_ptr(), pw_r.data_ptr(),
                         pw_i.data_ptr(), 1, M, p_w, os_w, M // os_w, t_w, stream()), "parent")
        this_w()
        parent_w()
        torch.cuda.synchronize()
        want = pf.pfb_fold_os_reference(xw_r, xw_i, hw, os_w, t_w)
        if not all(torch.equal(g, q) for g, q in zip((ow_r, ow_i, pw_r, pw_i), want * 2)):
            sys.exit(f"os {os_w}, P {p_w}: a kernel and the twin disagree")
        got = {"parent": [], "this": []}
        for r in range(4):
            for who in (("parent", "this"), ("this", "parent"))[r % 2]:
                got[who].append(time_cuda(parent_w if who == "parent" else this_w, ITERS))
        dev_p = kernel_device_times(parent_w, "pfb_fold", CALLS)
        dev_t = kernel_device_times(this_w, "pfb_fold", CALLS)
        print(f"planes at os {os_w}, P {p_w}, M {M}, {t_w} class frames (this tree: "
              f"{pf.launch_plan('planes', p_w, os_w)} (stages, weights staged)): parent "
              f"{float(np.median(got['parent'])):.4f} ms, device "
              f"{sum(t for _, t in dev_p) / max(len(dev_p), 1) / 1e3:.4f} ({len(dev_p)} records "
              f"of {CALLS}); this tree {float(np.median(got['this'])):.4f} ms, device "
              f"{sum(t for _, t in dev_t) / max(len(dev_t), 1) / 1e3:.4f} ({len(dev_t)} "
              f"records); CUDA events, launched straight [{card}]", flush=True)

    # branch count: both layouts of the shipped shape (real branches)
    for layout in ("analysis", "synthesis"):
        med = []
        for p in BRANCHES:
            run, _ = launcher(fn0, layout, False, w=ws[p])
            dev = kernel_device_times(run, "pfb_fold", CALLS)
            med.append(sum(t for _, t in dev) / max(len(dev), 1) / 1e3)
        slope = np.polyfit(BRANCHES, med, 1)[0]
        print(f"{layout} layout against P ({', '.join(map(str, BRANCHES))}): device "
              f"{', '.join(f'{v:.4f}' for v in med)} ms, {slope * 1e3:.3f} us a branch "
              f"[{card}]")

    # ablation: which of the memory streams the branch loop waits for
    got = {}
    for name, fn in (("shipped", fn0), *ablation.items()):
        for layout in ("analysis", "synthesis"):
            run, _ = launcher(fn, layout, False)
            dev = kernel_device_times(run, "pfb_fold", CALLS)
            got[(name, layout)] = (f"{sum(t for _, t in dev) / len(dev) / 1e3:.4f}"
                                   if dev else "n/a", len(dev))
    for layout in ("analysis", "synthesis"):
        print(f"ablation, {layout} layout (real taps; stores and copies are the analysis "
              "layout's frame stores and every layout's 16-byte slab copies): device "
              + ", ".join(f"{name} {ms} ms ({n} records)"
                          for (name, lay), (ms, n) in got.items() if lay == layout)
              + f" [{card}]")


if __name__ == "__main__":
    main()
