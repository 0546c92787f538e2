"""The port's LDPC codes (``ops/ldpc.py``) against the JAX package's, on
the same seeded bits and LLRs.

Tolerances: H, G and the info positions exact (``seed=7`` ensemble and the
802.11n 648/Z27 code); codewords, hard decisions and ``ok`` exact (the
posteriors are float32 sums in another order, so frames are drawn off the
decision boundaries)."""

import numpy as np
import pytest
import torch

from aether_primitives_tpu_torch.ops import ldpc

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jldpc():
    pytest.importorskip("jax")
    from aether_primitives_tpu.ops import ldpc as jldpc

    return jldpc


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


def _llrs(rng, g, frames, sigma):
    u = rng.integers(0, 2, (frames, g.shape[0])).astype(np.uint8)
    cw = (u.astype(np.int64) @ g % 2).astype(np.uint8)
    llr = (2.0 / sigma ** 2) * ((1 - 2.0 * cw) + sigma * rng.normal(size=cw.shape))
    return u, cw, llr.astype(np.float32)


@pytest.mark.parametrize("args", [(648, 3, 6, 7), (96, 3, 6, 1), (120, 2, 4, 3)])
def test_regular_ensemble_pinned_to_jax(jldpc, args):
    for got, want in zip(ldpc.make_regular_ldpc(*args), jldpc.make_regular_ldpc(*args)):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    h = ldpc.make_regular_ldpc(*args)[0]
    assert np.array_equal(ldpc.ldpc_generator(h), jldpc.ldpc_generator(h))


def test_wifi_code_pinned_to_jax(jldpc):
    assert np.array_equal(ldpc._WIFI_648_R12, jldpc._WIFI_648_R12)
    for got, want in zip(ldpc.wifi_ldpc(), jldpc.wifi_ldpc()):
        assert np.array_equal(got, want)
    assert np.array_equal(ldpc.qc_expand(ldpc._WIFI_648_R12, 27),
                          jldpc.qc_expand(jldpc._WIFI_648_R12, 27))
    with pytest.raises(ValueError, match="rate-1/2"):
        ldpc.wifi_ldpc("2/3")


def test_encode_and_extract_match_jax(jldpc):
    h, g, info = ldpc.make_regular_ldpc()
    u = np.random.default_rng(1).integers(0, 2, (2, 3, g.shape[0])).astype(np.uint8)
    cw = ldpc.ldpc_encode(torch.from_numpy(u), g)
    assert cw.dtype == torch.uint8 and np.array_equal(cw.numpy(), np.asarray(jldpc.ldpc_encode(u, g)))
    assert not ((cw.numpy().astype(np.int64) @ h.T) % 2).any()
    assert np.array_equal(ldpc.extract_info(cw, info).numpy(), u)


@pytest.mark.parametrize("sigma", [0.7, 0.8])
def test_dense_decode_matches_jax(jldpc, sigma):
    # sigma 0.8 leaves some frames undecoded at 10 iterations
    h, g, _ = ldpc.make_regular_ldpc()
    rng = np.random.default_rng(int(sigma * 10))
    _, cw, llr = _llrs(rng, g, 6, sigma)
    got = ldpc.ldpc_decode(torch.from_numpy(llr.reshape(2, 3, -1)), h, iters=10)
    want = _jit(jldpc.ldpc_decode, h=h, iters=10)(llr)
    assert got[0].shape == (2, 3, 648) and got[1].shape == (2, 3)
    assert np.array_equal(got[0].numpy().reshape(6, -1), np.asarray(want[0]))
    assert np.array_equal(got[1].numpy().reshape(6), np.asarray(want[1]))
    ok = got[1].numpy().reshape(6)
    assert ok.any() and np.array_equal(got[0].numpy().reshape(6, -1)[ok], cw[ok])


@pytest.mark.parametrize("iters", [1, 12])
def test_qc_decode_matches_jax(jldpc, iters):
    h, g, _ = ldpc.wifi_ldpc()
    rng = np.random.default_rng(iters)
    _, cw, llr = _llrs(rng, g, 5, 0.75)
    got = ldpc.qc_ldpc_decode(torch.from_numpy(llr), ldpc._WIFI_648_R12, 27, iters=iters)
    want = _jit(jldpc.qc_ldpc_decode, base=jldpc._WIFI_648_R12, z=27, iters=iters)(llr)
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), np.asarray(b))
    # the QC decoder at iters is the dense decoder at iters - 1, on the same graph
    if iters > 1:
        dense = ldpc.ldpc_decode(torch.from_numpy(llr), h, iters=iters - 1)
        assert torch.equal(dense[0], got[0]) and torch.equal(dense[1], got[1])


def test_check_update_matches_the_dense_plane(jldpc):
    # the edge-plane min-sum against the JAX dense decoder's one iteration
    # posterior on an irregular code with a degree-1 check and exact ties
    rng = np.random.default_rng(4)
    h = (rng.random((10, 24)) < 0.25).astype(np.uint8)
    h[0] = 0
    h[0, 5] = 1
    llr = rng.choice(np.array([-2.0, -1.0, 1.0, 2.0], np.float32), size=(3, 24))
    got = ldpc.ldpc_decode(torch.from_numpy(llr), h, iters=0)
    want = _jit(jldpc.ldpc_decode, h=h, iters=0)(llr)
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(ValueError, match="code length"):
        ldpc.ldpc_decode(torch.zeros(23), h)


@pytest.mark.cuda
def test_cuda_decoders_equal_the_cpu_run(cuda):
    h, g, _ = ldpc.wifi_ldpc()
    _, _, llr = _llrs(np.random.default_rng(5), g, 64, 0.8)
    x = torch.from_numpy(llr)
    for fn in (lambda t: ldpc.qc_ldpc_decode(t, ldpc._WIFI_648_R12, 27, iters=30),
               lambda t: ldpc.ldpc_decode(t, h, iters=30)):
        got, want = fn(x.to(cuda)), fn(x)
        assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
