"""The readings that the limits of ``correct`` are set from, at a cell's
own size, on the card, in one process (the benchmark's own runs never run
this):

    python3 portbench/control.py --workload <name> --seeds 1 2 ... \
        --control-seeds 1 2 3 [--faults] [--seconds 3] [--out FILE]

For each seed it runs the program's window as a run does and prints the
numbers compared (the lower readings); for each control seed it puts the
reference computed in bfloat16 in the program's place and prints the same
numbers (the upper readings); with ``--faults`` it runs each planted fault
of ``faults.py`` on the first seed.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None, device=None):
    import importlib

    from portbench import faults, harness

    harness.use_checkout_caches()
    import torch

    ap = argparse.ArgumentParser(prog="portbench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cell = harness.Cell(harness.load_json(ROOT / "BENCHMARK.json"), args.workload)
    dev = harness.card(device, cell.chips)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    traffic = dict(cell.traffic)
    rehearsal = traffic.pop("rehearsal", {})
    if dev.type == "cpu":
        traffic.update(rehearsal)
    driver = importlib.import_module(f"portbench.drivers.{traffic['driver']}")
    limits = cell.limits()
    out = {"workload": args.workload, "limits": limits, "program": [], "control": [],
           "faults": []}

    def one(seed, fault=None):
        t0 = time.perf_counter()
        sut = driver.Cell(cell.config, traffic, seed, dev)
        sut.window(args.seconds)
        sut.release()
        row = {"seed": seed, "numbers": sut.check(limits), "fault": fault}
        if fault is None and seed in args.control_seeds:
            out["control"].append({"seed": seed, "numbers": sut.control()})
            print(json.dumps(out["control"][-1]), flush=True)
        row["seconds"] = time.perf_counter() - t0
        del sut
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        return row

    for seed in args.seeds:
        out["program"].append(one(seed))
        print(json.dumps(out["program"][-1]), flush=True)
    if args.faults:
        for name in faults.NAMES:
            with faults.planted(name):
                out["faults"].append(one(args.seeds[0], name))
            print(json.dumps(out["faults"][-1]), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
