"""The port's turbo product code (``ops/tpc.py``) against the JAX package's,
on the same seeded data and LLRs, for both component families.

Tolerances: codewords, decoded data and ``ok`` exact; the elementary
decoder's soft output RMS EVM <= SOFT_DB (-80 dB: the candidates' metrics
are float32 sums taken in another order)."""

import numpy as np
import pytest
import torch

from aether_primitives_tpu_torch.evm import evm_rms_db
from aether_primitives_tpu_torch.ops import tpc
from aether_primitives_tpu_torch.parallel import mesh as mesh_mod

torch.set_num_threads(1)

SOFT_DB = -80.0


@pytest.fixture(scope="module")
def jtpc():
    pytest.importorskip("jax")
    from aether_primitives_tpu.ops import tpc as jtpc

    return jtpc


def _jit(fn, **fixed):
    """``fn`` traced once by ``jax.jit`` with the keyword arguments
    ``fixed``: one XLA program compiles several times faster than the JAX
    package's op-by-op calls."""
    import functools

    import jax

    return jax.jit(functools.partial(fn, **fixed))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _channel(rng, code, blocks, sigma):
    data = rng.integers(0, 2, (blocks, code.k, code.k)).astype(np.uint8)
    cw = np.asarray(code.encode(data))
    llr = (2.0 / sigma ** 2) * ((1 - 2.0 * cw) + sigma * rng.normal(size=cw.shape))
    return data, cw, llr.astype(np.float32)


@pytest.mark.parametrize("m,t", [(4, 1), (5, 1), (4, 2)])
def test_encode_and_decode_match_jax(jtpc, m, t):
    a, b = tpc.TPC(m=m, p=3, iters=3, t_component=t), jtpc.TPC(m=m, p=3, iters=3, t_component=t)
    assert (a.n, a.k, a.rate) == (b.n, b.k, b.rate)
    assert np.array_equal(a._s1, b._s1) and np.array_equal(a._match_w, b._match_w)
    rng = np.random.default_rng(m * 10 + t)
    data, cw, llr = _channel(rng, b, 6, 0.6)
    assert np.array_equal(a.encode(torch.from_numpy(data)).numpy(), cw)
    got = a.decode(torch.from_numpy(llr.reshape(2, 3, a.n, a.n)))
    want = _jit(b.decode)(llr)
    assert got[0].shape == (2, 3, a.k, a.k)
    assert np.array_equal(got[0].numpy().reshape(6, a.k, a.k), np.asarray(want[0]))
    assert np.array_equal(got[1].numpy().reshape(6), np.asarray(want[1]))
    assert got[1].numpy().any()


@pytest.mark.parametrize("t", [1, 2])
def test_siso_soft_output_matches_jax(jtpc, t):
    import jax.numpy as jnp

    a, b = tpc.TPC(m=5, p=4, t_component=t), jtpc.TPC(m=5, p=4, t_component=t)
    rng = np.random.default_rng(40 + t)
    _, cw, llr = _channel(rng, b, 2, 0.7)
    words = llr.reshape(-1, a.n)
    rbar = np.abs(words).mean(axis=-1, keepdims=True).astype(np.float32)
    got = a._siso(torch.from_numpy(words), 0.4, torch.from_numpy(rbar)).numpy()
    want = np.asarray(_jit(b._siso)(jnp.asarray(words), jnp.float32(0.4), jnp.asarray(rbar)))
    assert np.array_equal(got < 0, want < 0)
    assert evm_rms_db(got, want) <= SOFT_DB


def test_ties_in_the_least_reliable_positions_match_jax(jtpc):
    # quantised LLRs put many positions at the least reliability
    a, b = tpc.TPC(m=4, p=3, iters=2), jtpc.TPC(m=4, p=3, iters=2)
    rng = np.random.default_rng(5)
    data = rng.integers(0, 2, (4, a.k, a.k)).astype(np.uint8)
    cw = np.asarray(_jit(b.encode)(data))
    mag = rng.choice(np.array([1.0, 2.0, 4.0], np.float32), size=cw.shape)
    sign = np.where(rng.random(cw.shape) < 0.05, -1.0, 1.0) * (1 - 2.0 * cw)
    llr = (sign * mag).astype(np.float32)
    got = a.decode(torch.from_numpy(llr))
    want = _jit(b.decode)(llr)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_bad_arguments_raise():
    with pytest.raises(ValueError, match="t_component"):
        tpc.TPC(t_component=3)
    code = tpc.TPC(m=4)
    with pytest.raises(ValueError, match="data"):
        code.encode(torch.zeros(10, 10))
    with pytest.raises(ValueError, match="LLRs"):
        code.decode(torch.zeros(15, 16))
    mesh = mesh_mod.make_mesh({"channel": 8}, devices=["cpu"] * 8)
    with pytest.raises(ValueError, match=r"\[B, n, n\]"):
        code.sharded_decode(torch.zeros(16, 16), mesh)
    with pytest.raises(ValueError, match="do not divide over 8"):
        code.sharded_decode(torch.zeros(12, 16, 16), mesh)


def test_sharded_decode_matches_jax(jtpc, eight_devices):
    """``tests/test_tpc.py:166``'s case: 16 blocks over an 8-shard
    ``channel`` mesh, against the JAX package's ``sharded_decode`` on its
    eight CPU devices and the port's own unsharded decode (exact)."""
    import math

    import jax

    from aether_primitives_tpu.parallel import mesh as jmesh

    a, b = tpc.TPC(m=4, p=3, iters=2), jtpc.TPC(m=4, p=3, iters=2)
    rng = np.random.default_rng(7)
    data = rng.integers(0, 2, (16, b.k, b.k)).astype(np.uint8)
    cw = np.asarray(b.encode(data)).astype(np.float64)
    sigma = math.sqrt(1 / (2 * b.rate * 10 ** (4.0 / 10)))  # test_tpc.py's _awgn_llr
    llr = (2 * ((1 - 2 * cw) + sigma * rng.normal(size=cw.shape)) / sigma ** 2).astype(np.float32)
    jm = jmesh.make_mesh({"channel": 8})
    want_dec, want_ok = jax.jit(lambda v: b.sharded_decode(v, jm))(llr)
    mesh = mesh_mod.make_mesh({"channel": 8}, devices=["cpu"] * 8)
    dec, ok = a.sharded_decode(llr, mesh)
    assert dec.spec == ("channel", None, None) and ok.spec == ("channel",)
    assert np.array_equal(dec.gather().numpy(), np.asarray(want_dec))
    assert np.array_equal(ok.gather().numpy(), np.asarray(want_ok))
    got_u, ok_u = a.decode(llr)
    assert torch.equal(dec.gather(), got_u) and torch.equal(ok.gather(), ok_u)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 2])
def test_cuda_decode_equals_the_cpu_run(cuda, t):
    code = tpc.TPC(m=5, t_component=t)
    _, _, llr = _channel(np.random.default_rng(6), code, 32, 0.75)
    got = code.decode(torch.from_numpy(llr).to(cuda))
    want = code.decode(torch.from_numpy(llr))
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
