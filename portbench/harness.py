"""Run one cell once: set up, warm up, measure a window, optionally trace a
short window, check the window's outputs against the plain reference, and
print the result as one JSON line.

The cell, its configuration and its traffic mix are found by name:
``BENCHMARK.json`` at the checkout's root names the cell's configuration
file and traffic mix; ``traffic/<mix>.json`` names its driver
(``drivers/<driver>.py``); each per-layer metric is read by
``metrics/<metric>.py``. Adding a configuration, a mix or a metric adds
files and entries and edits nothing.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: Top-level module names that no process of the benchmark may hold.
FORBIDDEN = ("jax", "jaxlib", "flax", "aether_primitives_tpu")
#: Build and kernel caches, at fixed paths inside the checkout (the port
#: builds its own kernels into ``build/torch_kernels/`` beside its package).
#: Traced windows tried where a ``device_trace`` metric finds none of its
#: kernels (the profiler drops kernel records at times).
TRACE_TRIES = 3
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions", "TRITON_CACHE_DIR": "triton",
          "PYTORCH_KERNEL_CACHE_PATH": "torch_kernel_cache"}


def use_checkout_caches(root: Path = ROOT) -> None:
    """Point every build and kernel cache at ``build/`` in the checkout;
    called before torch is imported."""
    for var, sub in CACHES.items():
        path = root / "build" / sub
        path.mkdir(parents=True, exist_ok=True)  # torch will not make a named cache directory
        os.environ[var] = str(path)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def forbidden_modules(names=None) -> list:
    """The loaded modules whose top-level name (before the first dot) is
    one of :data:`FORBIDDEN`, compared whole."""
    names = list(sys.modules) if names is None else names
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def load_metric(name: str, root: Path = HERE):
    """``metrics/<name>.py`` as a module (names may hold dots)."""
    path = root / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{len(sys.modules)}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A cell of ``BENCHMARK.json`` with its configuration and traffic mix,
    each loaded from its file."""

    def __init__(self, bench: dict, name: str, root: Path = ROOT):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.entry = cells[name]
        conf = {c["name"]: c for c in bench["configs"]}[self.entry["config"]]
        self.config = load_json(root / conf["file"])
        self.traffic = load_json(root / "portbench" / "traffic" / f"{self.entry['traffic']}.json")
        self.chips = int(self.entry["chips"])
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"] if name in m["workloads"]]

    def limits(self) -> dict:
        """The limits of the numbers compared, from the configuration."""
        return dict(self.config["limits"])


class Run:
    """What a per-layer metric reads: the configuration and traffic mix, the
    cell's shapes, the benchmark's host spans (seconds, from the untraced
    window) and the traced window (None without one)."""

    def __init__(self, cell: Cell, shapes: dict, spans: dict, trace):
        self.config, self.traffic = cell.config, cell.traffic
        self.shapes, self.spans, self.trace = shapes, spans, trace


def parse(argv):
    ap = argparse.ArgumentParser(prog="portbench/run.py",
                                 description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def card(device, chips: int):
    """The card the cell runs on; exits without a result where there are
    fewer cards than the cell asks for. ``device`` "cpu" is the rehearsal of
    the tests."""
    import torch

    if device == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit("portbench: no CUDA device is available; the benchmark runs on a card")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"portbench: the cell asks for {chips} cards, "
                         f"{torch.cuda.device_count()} are visible")
    return torch.device("cuda", 0)


def main(argv=None, t_start=None, device=None, root: Path = ROOT, out=None):
    """Run a cell once and print its result line. ``device="cpu"`` (tests
    only) rehearses at the traffic mix's ``rehearsal`` sizes."""
    t_start = time.perf_counter() if t_start is None else t_start
    out = sys.stdout if out is None else out
    args = parse(argv)
    bench = load_json(root / "BENCHMARK.json")
    cell = Cell(bench, args.workload, root)
    import torch

    t_import = time.perf_counter()
    dev = card(device, cell.chips)
    if dev.type == "cuda":
        torch.cuda.init()
    t_card = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(4)
    traffic = dict(cell.traffic)
    if dev.type == "cpu":
        traffic.update(traffic.pop("rehearsal", {}))
    else:
        traffic.pop("rehearsal", None)
    driver = importlib.import_module(f"portbench.drivers.{traffic['driver']}")
    sut = driver.Cell(cell.config, traffic, args.seed, dev)
    setup_s = time.perf_counter() - t_start
    print(f"setup: {setup_s:.3f} s: import torch {t_import - t_start:.3f} s, reach the card "
          f"{t_card - t_import:.3f} s, " + ", ".join(f"{k} {v:.3f} s" for k, v in sut.phases.items()),
          file=sys.stderr)
    window = sut.window(args.seconds)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    trace = None
    if args.trace:
        from . import tracing

        wanted = [m for m in cell.per_layer if m["source"] == "device_trace"]
        for _ in range(TRACE_TRIES):
            trace = tracing.capture(lambda: sut.traced(float(traffic["trace_seconds"])), dev)
            run = Run(cell, sut.shapes, window["spans"], trace)
            if all(load_metric(m["name"], root / "portbench").read(run) is not None
                   for m in wanted):
                break

    sut.release()
    limits = cell.limits()
    checks = sut.check(limits)
    missing = [c for c in checks if c not in limits]
    if missing:
        raise SystemExit(f"portbench: no limit for {', '.join(missing)}")
    correct = all(checks[c] <= limits[c] for c in checks)

    metrics = {}
    if args.trace:
        run = Run(cell, sut.shapes, window["spans"], trace)
        for m in cell.per_layer:
            v = load_metric(m["name"], root / "portbench").read(run)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        values = dict(window["metrics"], setup_s=setup_s)
        for m in cell.end_to_end:
            if m["name"] in values:
                metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}
    result = {
        "correct": correct,
        "attempted": int(window["attempted"]),
        "failed": int(sut.failed),
        "metrics": metrics,
        "device": {
            "platform": "gpu" if dev.type == "cuda" else "cpu",
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "count": cell.chips,
            "memory_peak_bytes": int(peak),
        },
    }
    if trace is not None:
        result["device"].update(busy_s=trace.busy_s, window_s=trace.window_s)
        result["breakdown"] = trace.breakdown()
    result["checks"] = {c: {"value": checks[c], "limit": limits[c]} for c in checks}
    # Last, once the check and every metric's reader have run in this process.
    found = forbidden_modules()
    if found:
        raise SystemExit(f"portbench: the run loaded {', '.join(found)}")
    for c in checks:
        verdict = "ok" if checks[c] <= limits[c] else "FAIL"
        print(f"check {c}: {checks[c]!r} limit {limits[c]!r} {verdict}", file=sys.stderr)
    print(json.dumps(result), file=out, flush=True)
    return result
