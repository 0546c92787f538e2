"""The port's four examples (``examples/torch_*.py``, the twins of
``examples/modem.py``, ``pipeline.py``, ``stream_policies.py`` and
``packet.py``) run with ``--cpu`` as a user runs them from a bare clone:
a fresh interpreter, another working directory, no ``PYTHONPATH``; each
must exit 0 and print its verdict. Their cards' runs are ``chip_smoke.py``'s.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"

# (example, its arguments before --cpu, the verdict it prints)
CASES = [
    ("torch_modem.py", [], "Modem loopback on cpu bit-exact."),
    ("torch_packet.py", [], "packet recovered exactly"),
    ("torch_stream_policies.py", [], "stream_policies: OK"),
    # pool of 4, 65,536-sample blocks, 0.2 s a timed variant
    ("torch_pipeline.py", ["4", "65536", "0.2"], "bit-exact vs one contiguous step"),
]


@pytest.mark.parametrize("name,args,verdict", CASES, ids=[c[0] for c in CASES])
def test_example_runs_on_the_cpu(tmp_path, name, args, verdict):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run([sys.executable, str(EXAMPLES / name), *args, "--cpu"],
                          cwd=tmp_path, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, f"{name} failed:\n{proc.stdout}\n{proc.stderr}"
    assert verdict in proc.stdout, proc.stdout
