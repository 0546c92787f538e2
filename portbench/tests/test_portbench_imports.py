"""What the benchmark loads: the run path and every configuration, mix and
metric load neither ``jax`` nor the JAX package, and the references load
nothing of the port. Top-level module names (before the first dot) are
compared whole, since the port's name begins with the JAX package's. Each
check runs in a fresh interpreter."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())

LOAD_ALL = """
import importlib, json, runpy, sys
sys.path.insert(0, {root!r})
runpy.run_path({root!r} + "/portbench/run.py", run_name="portbench_run")
from portbench import control, faults, harness, tracing
bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
for w in bench["workloads"]:
    cell = harness.Cell(bench, w["name"])
    importlib.import_module("portbench.drivers." + cell.traffic["driver"])
for m in bench["per_layer"]:
    harness.load_metric(m["name"])
import aether_primitives_tpu_torch.models
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

LOAD_REFERENCE = """
import json, pkgutil, importlib, sys
sys.path.insert(0, {root!r})
import portbench.reference, portbench.gen
for pkg in (portbench.reference, portbench.gen):
    for mod in pkgutil.iter_modules(pkg.__path__):
        importlib.import_module(pkg.__name__ + "." + mod.name)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code.format(root=str(ROOT))], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_run_path_loads_no_jax_and_no_jax_package():
    names = _top_level(LOAD_ALL)
    assert "aether_primitives_tpu_torch" in names and "portbench" in names
    assert not names & {"jax", "jaxlib", "flax", "aether_primitives_tpu"}


def test_the_references_load_nothing_of_the_port():
    names = _top_level(LOAD_REFERENCE)
    assert "torch" in names
    assert not names & {"aether_primitives_tpu_torch", "jax", "jaxlib", "flax",
                        "aether_primitives_tpu"}


def test_forbidden_names_are_compared_whole():
    sys.path.insert(0, str(ROOT))
    from portbench import harness

    assert harness.forbidden_modules(["aether_primitives_tpu_torch.ops", "jaxtyping",
                                      "numpy"]) == []
    assert harness.forbidden_modules(["jax.numpy", "aether_primitives_tpu.ops", "flax"]) == [
        "aether_primitives_tpu.ops", "flax", "jax.numpy"]


def test_every_named_file_exists():
    paths = [ROOT / c["file"] for c in BENCH["configs"]]
    for w in BENCH["workloads"]:
        traffic = ROOT / "portbench" / "traffic" / f"{w['traffic']}.json"
        paths.append(traffic)
        driver = json.loads(traffic.read_text())["driver"]
        paths.append(ROOT / "portbench" / "drivers" / f"{driver}.py")
    paths += [ROOT / "portbench" / "metrics" / f"{m['name']}.py" for m in BENCH["per_layer"]]
    assert [p for p in paths if not p.is_file()] == []
    for c in BENCH["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["source"] == c["source"] and conf["reduced"] == c["reduced"] == []


def test_every_traffic_parameter_has_a_basis():
    """Each parameter of a traffic mix names its source, or says that it is
    assumed and why, or that it is the benchmark's own."""
    for path in sorted((ROOT / "portbench" / "traffic").glob("*.json")):
        mix = json.loads(path.read_text())
        params = set(mix) - {"driver", "rehearsal", "basis"}
        assert params <= set(mix.get("basis", {})), path.name
        assert all(isinstance(v, str) and v for v in mix["basis"].values()), path.name
