"""The port's per-op micro-benchmark (``aether_primitives_tpu_torch/cli.py
microbench_main``) on the CPU at a tiny batch: every row of the JAX
package's ``microbench_main`` is there, with a time, and the JSON head
says where it ran. The CPU run times nothing of the card: it checks the
rows' calls and the file's layout.
"""

import json

import pytest
import torch

from aether_primitives_tpu_torch import cli

torch.set_num_threads(1)

# The 33 rows of aether_primitives_tpu/cli.py:95-449 at --batch 16: 27
# timed( calls, the FFT and correlator rows looping over 512, 1024 and
# 2048 (:218-231); the bracketed batch of the coding rows is batch / 16
# (:265), batch / 4 for RS (:330).
JAX_ROWS_BATCH_16 = [
    "vecops mul [batch x 2048]",  # cli.py:190
    "vecops scale [batch x 2048]",
    "vecops conj+mirror [batch x 2048]",
    "interpolate (1024,4) [batch]",  # cli.py:196
    "downsample 30720->1024 [batch]",
    "qpsk modulate 8000 bits [batch]",  # cli.py:211
    "qpsk demod 4000 syms [batch]",
    "bpsk modulate 8000 bits [batch]",
    "fft 512 fwd SN [batch]",  # cli.py:221
    "fft 512 bwd SN [batch]",
    "fft 1024 fwd SN [batch]",
    "fft 1024 bwd SN [batch]",
    "fft 2048 fwd SN [batch]",
    "fft 2048 bwd SN [batch]",
    "correlator 512 [batch]",  # cli.py:229
    "correlator 1024 [batch]",
    "correlator 2048 [batch]",
    "nco mix [flat]",  # cli.py:244
    "ddc core: mix+fir129+/8 [flat]",
    "ldpc min-sum 25 iters [1 x 648]",  # cli.py:268
    "ldpc 802.11n(648,R1/2) min-sum 25 it [1 cw]",
    "ldpc 802.11n QC edge decoder 25 it [1 cw]",
    "viterbi K=7 decode [1 x 1024 bits]",  # cli.py:293
    "css demod SF10 [flat]",  # cli.py:303
    "caf 64 dopplers x 4096",  # cli.py:312
    "crc32 2^20 bits",  # cli.py:320
    "rs(255,223) encode [4 cw]",  # cli.py:333
    "rs(255,223) decode t=16 errs [4 cw]",
    "turbo decode 8 iters win64 [1 x 1024 bits]",  # cli.py:364
    "polar SC decode (1024,512) [1 cw]",  # cli.py:390
    "polar CA-SCL L=8 (256,128+crc8) [1 cw]",
    "stft+istft 1024/512 [flat]",  # cli.py:414
    "iir sosfilt butter4 [flat]",
]


def test_cpu_microbench_writes_every_jax_row(tmp_path, capsys):
    out = tmp_path / "micro.json"
    assert cli.microbench_main(["--cpu", "--batch", "16", "--iters", "1", "--rounds", "1",
                                "--json", str(out)]) is None
    payload = json.loads(out.read_text())
    for key in ("platform", "device", "card", "timing", "batch", "iters", "rounds",
                "methodology", "results"):
        assert key in payload, key
    assert payload["platform"] == "cpu" and payload["batch"] == 16
    rows = payload["results"]
    assert [r["bench"] for r in rows] == JAX_ROWS_BATCH_16
    assert len(rows) == 33
    for r in rows:
        assert r["us_per_call"] > 0 and r["msamples_per_s"] > 0, r["bench"]
        assert len(r["rounds_us_per_call"]) == 1 and r["round_spread"] == 1.0
        assert r["kernels_per_call"] is None and r["idle"] is None  # no card: not measured
        assert r["launches"] == {}  # CPU tensors launch none of the seven kernels
    printed = capsys.readouterr().out
    assert all(name in printed for name in JAX_ROWS_BATCH_16)


def test_microbench_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(SystemExit, match="CUDA"):
        cli.microbench_main(["--batch", "16"])
