"""The harness is driven by data: a configuration, a traffic mix and a
per-layer metric are added as new files and entries, in a copy of the
benchmark, and the cell they make runs with no edit to an existing file
(the CPU rehearsal here; on the card in the ``cuda`` test)."""

import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]

CONFIG = {
    "name": "lte5_rx", "source": "3GPP TS 36.211 LTE 5 MHz: 512-point FFT at 7.68 Msps, decimated by 2",
    "system": "RxChain", "chain": {"fft_len": 512, "decimation": 2, "packed_bits": True},
    "reference": "reference/rx_chain.py", "assumed": [], "reduced": [],
    "limits": {"flip_margin": 1e-4, "flip_share": 1e-5, "state_mismatch": 0},
}
TRAFFIC = {"driver": "rx_resident", "channels": 4, "block": 8192, "pool": 2, "sync_every": 4,
           "warmup_steps": 3, "sample": 4, "trace_seconds": 0.2}
METRIC = '''"""The steps of the traced window (a count)."""


def read(run):
    return None if run.trace is None else run.trace.units["steps"]
'''
CELL = "lte5_rx.resident4"


def _digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


@pytest.fixture
def added(tmp_path):
    """A copy of the benchmark with one configuration, mix and metric added."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(tmp_path / "portbench")
    (tmp_path / "portbench" / "configs" / "lte5_rx.json").write_text(json.dumps(CONFIG))
    (tmp_path / "portbench" / "traffic" / "resident4.json").write_text(json.dumps(TRAFFIC))
    (tmp_path / "portbench" / "metrics" / "rx.traced_steps.py").write_text(METRIC)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "lte5_rx", "source": CONFIG["source"],
                             "file": "portbench/configs/lte5_rx.json", "reduced": [],
                             "why": "a second RX chain geometry"})
    bench["workloads"].append({"name": CELL, "config": "lte5_rx", "traffic": "resident4",
                               "chips": 1, "why": "4 channels of a 5 MHz chain"})
    for m in bench["end_to_end"]:
        if m["name"] == "rx_msps":
            m["workloads"].append(CELL)
    bench["per_layer"].append({"name": "rx.traced_steps", "unit": "count", "better": "higher",
                               "source": "program_counter", "layer": "RX chain step, models/modem.py",
                               "moves": "rx_msps", "workloads": [CELL]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _digest(tmp_path / "portbench")
    assert {k: v for k, v in after.items() if k in before} == before
    return tmp_path


def _env():
    return {**os.environ, "PYTHONPATH": str(ROOT)}


def _rehearse(root: Path, trace: int) -> dict:
    code = (f"import sys; sys.path.insert(0, {str(root)!r}); from portbench import harness; "
            f"harness.main(['--workload', {CELL!r}, '--seed', '4000000003', '--seconds', '0.5', "
            f"'--trace', '{trace}'], device='cpu')")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=_env(), capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_added_cell_runs_with_no_edit(added):
    plain = _rehearse(added, 0)
    assert plain["correct"] and set(plain["metrics"]) == {"rx_msps", "setup_s"}
    traced = _rehearse(added, 1)
    assert traced["correct"] and traced["metrics"]["rx.traced_steps"]["value"] >= 1
    assert set(traced["metrics"]) == {"rx.traced_steps"}  # the others name their cells
    assert list(traced)[-1] == "checks"


LOADS_JAX = '''"""A metric whose reader loads a module named ``jax``."""

import sys
import types


def read(run):
    sys.modules.setdefault("jax", types.ModuleType("jax"))
    return 1.0
'''


def test_a_run_that_loads_jax_prints_no_result(added):
    """The look for the JAX names comes after the check and every metric's
    reader: a reader loaded last that brings in ``jax`` leaves no result."""
    (added / "portbench" / "metrics" / "rx.loads_jax.py").write_text(LOADS_JAX)
    bench = json.loads((added / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "rx.loads_jax", "unit": "count", "better": "lower",
                               "source": "program_counter", "layer": "RX chain step, models/modem.py",
                               "moves": "rx_msps", "workloads": [CELL]})
    (added / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (f"import sys; sys.path.insert(0, {str(added)!r}); from portbench import harness; "
            f"harness.main(['--workload', {CELL!r}, '--seed', '4000000005', '--seconds', '0.5', "
            f"'--trace', '1'], device='cpu')")
    out = subprocess.run([sys.executable, "-c", code], cwd=added, env=_env(), capture_output=True,
                         text=True, timeout=600)
    assert out.returncode != 0
    assert "portbench: the run loaded jax" in out.stderr
    assert '"correct"' not in out.stdout


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_added_cell_runs_on_the_card(added, card):
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELL, "--seed",
                          "4000000004", "--seconds", "2", "--trace", "0"], cwd=added, env=_env(),
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
