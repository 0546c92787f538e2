"""The comparison that decides ``correct`` fails where it should, at the
CPU rehearsal's sizes: a sound run is correct; a run with each fault of
``faults.py`` planted under its timed path is not (the harness's look for
a card skipped, the rest of the run driven as on the card); and the
control, the reference computed in bfloat16 in the program's place, fails
one of the cell's limits."""

import io
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import control, faults, harness  # noqa: E402

CELLS = ("lte20_rx.resident16", "lte20_rx.hostfed", "ccsds_tm.bulk2048")
#: The faults each cell can have: the burst link carries no state, and only it
#: returns CRC flags.
FAULTS = {
    "lte20_rx.resident16": ("state_unchanged", "half_batch", "answer_altered"),
    "lte20_rx.hostfed": ("state_unchanged", "half_batch", "answer_altered"),
    "ccsds_tm.bulk2048": ("half_batch", "answer_altered", "crc_failed"),
}


def _run(cell: str, seed: int) -> dict:
    out = io.StringIO()
    harness.main(["--workload", cell, "--seed", str(seed), "--seconds", "0.3", "--trace", "0"],
                 device="cpu", out=out)
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    res = _run(cell, 3000000011)
    assert res["correct"] and res["failed"] == 0
    assert all(c["value"] <= c["limit"] for c in res["checks"].values())


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS for f in FAULTS[c]])
def test_a_planted_fault_is_not_correct(cell, fault):
    with faults.planted(fault):
        res = _run(cell, 3000000012)
    assert not res["correct"]
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_a_limit(cell):
    out = control.main(["--workload", cell, "--seeds", "3000000013", "--control-seeds",
                        "3000000013", "--seconds", "0.3"], device="cpu")
    limits = out["limits"]
    numbers = out["control"][0]["numbers"]
    assert any(numbers[k] > limits[k] for k in numbers)
    program = out["program"][0]["numbers"]
    assert all(program[k] <= limits[k] for k in program)
