"""The port's entry points (``aether_primitives_tpu_torch/entry.py``) against
``__graft_entry__.py``'s: ``entry()``'s step on its example block, and
``dryrun_multichip`` over eight CPU shards, whose flagship (fft_len 2048)
sharded bits are held to the JAX ``RxChain.step`` on the same block.

Bar: hard bits agree >= 0.99999 with the JAX package (two float32
implementations may differ on the sign of a bin at zero, ROADMAP.md
§3.5); the dry run's own assertions hold each sharded path to its
one-device form in the port.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from aether_primitives_tpu_torch import entry as port_entry

torch.set_num_threads(1)

AGREEMENT = 0.99999


@pytest.fixture(scope="module")
def jentry():
    pytest.importorskip("jax")
    path = Path(__file__).resolve().parent.parent / "__graft_entry__.py"
    spec = importlib.util.spec_from_file_location("_graft_entry_reference", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def test_entry_matches_jax(jentry):
    import jax

    fn, (block,) = port_entry.entry(device="cpu")
    assert block.re.shape == (32768,) and block.re.device.type == "cpu"
    got = fn(block).numpy()
    jfn, jargs = jentry.entry()
    want = np.asarray(jax.jit(jfn)(*jargs))
    assert np.array_equal(block.re.numpy(), jargs[0].re)
    assert got.shape == want.shape == (16384,)
    assert float((got == want).mean()) >= AGREEMENT


def test_dryrun_on_eight_cpu_shards_matches_jax(jentry, capsys):
    import jax

    out = port_entry.dryrun_multichip(8, devices=["cpu"] * 8)
    line = capsys.readouterr().out
    assert "dryrun_multichip(8)" in line and "tpc=decode-exact(B=16)" in line
    for key, shape in (("bits", (4, 1024)), ("stream_bits", (4, 3072)),
                       ("flagship_bits", (2, 16384)), ("flagship_stream_bits", (2, 49152)),
                       ("burst_bits", (8, 120)), ("tpc", (16, 11, 11))):
        assert tuple(out[key].shape) == shape, key
    jchain = jentry._chain(fft_len=2048, decimation=4)
    want = np.asarray(jax.jit(jchain.step)(out["flagship_block"]))
    assert float((out["flagship_bits"].numpy() == want).mean()) >= AGREEMENT


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        port_entry.entry()
    with pytest.raises(RuntimeError, match="CUDA"):
        port_entry.dryrun_multichip(8)
    with pytest.raises(ValueError, match="need 8 devices"):
        port_entry.dryrun_multichip(8, devices=["cpu"] * 4)


@pytest.mark.cuda
def test_cuda_entry_and_dryrun_equal_the_cpu_run(cuda):
    fn, ex = port_entry.entry()
    got = fn(*ex)
    assert got.device.type == "cuda"
    fn_c, ex_c = port_entry.entry(device="cpu")
    assert float((got.cpu() == fn_c(*ex_c)).to(torch.float64).mean()) >= AGREEMENT
    out = port_entry.dryrun_multichip(8, devices=["cuda:0"] * 8)
    ref = port_entry.dryrun_multichip(8, devices=["cpu"] * 8)
    for key in ("bits", "stream_bits", "flagship_bits", "flagship_stream_bits", "burst_bits",
                "tpc"):
        assert float((out[key] == ref[key]).to(torch.float64).mean()) >= AGREEMENT, key
