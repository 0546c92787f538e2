"""The port's binary BCH codec (``ops/bch.py``) against the JAX package's,
on the same seeded bits and LLRs. Every output is an integer, so every
check is exact (``array_equal`` on ``msg``, ``ok`` and ``n_errors``),
including words past the correction budget. Chase-2 is held equal on LLRs
with exact ties among the least reliable positions (where the lower index
must come first, as ``jax.lax.top_k`` orders them). The host builders are
pinned equal to the JAX package's."""

import numpy as np
import pytest
import torch

from aether_primitives_tpu_torch.ops import bch

torch.set_num_threads(1)

CODES = [(15, 1), (15, 2), (63, 3), (255, 8), (40, 2), (100, 4)]  # the last two shortened


@pytest.fixture(scope="module")
def jbch():
    pytest.importorskip("jax")
    from aether_primitives_tpu.ops import bch as jbch

    return jbch


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


def _words(rng, code, counts):
    """Codewords of random messages with ``counts[b]`` bit errors each."""
    msg = rng.integers(0, 2, (len(counts), code.k)).astype(np.uint8)
    cw = np.asarray(code.encode(msg))
    rx = cw.copy()
    for b, e in enumerate(counts):
        rx[b, rng.choice(code.n, e, replace=False)] ^= 1
    return msg, cw, rx


@pytest.mark.parametrize("n,t", CODES)
def test_tables_pinned_to_jax(jbch, n, t):
    a, b = bch.BCH(n, t), jbch.BCH(n, t)
    assert (a.k, a.m, a.generator, a.primitive_poly) == (b.k, b.m, b.generator, b.primitive_poly)
    for name in ("_exp", "_log", "_enc", "_synd", "_ev_lam", "_loc_w", "_loc_b", "_sqm",
                 "_trv", "_ht"):
        if hasattr(b, name):
            assert np.array_equal(getattr(a, name), getattr(b, name)), name
        else:
            assert not hasattr(a, name), name


@pytest.mark.parametrize("n,t", CODES)
def test_encode_and_decode_match_jax(jbch, n, t):
    a, b = bch.BCH(n, t), jbch.BCH(n, t)
    rng = np.random.default_rng(n * 10 + t)
    counts = [0, 1, t, t, t + 1, t + 2, 2 * t + 1, max(0, t - 1)]
    msg, cw, rx = _words(rng, b, counts)
    assert np.array_equal(a.encode(torch.from_numpy(msg)).numpy(), cw)
    got = a.decode(torch.from_numpy(rx))
    want = _jit(b.decode)(rx)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert got[1].numpy()[:4].all() and np.array_equal(got[0].numpy()[:4], msg[:4])
    assert got[2].dtype == torch.int32


@pytest.mark.parametrize("n,t", [(15, 2), (31, 2), (63, 2)])
def test_closed_form_equals_bm_as_in_jax(jbch, n, t):
    # the t <= 2 closed form against the general BM + Chien path, on every
    # weight up to 3: both packages' paths agree wherever they agree
    a, b = bch.BCH(n, t), jbch.BCH(n, t)
    rng = np.random.default_rng(n)
    _, _, rx = _words(rng, b, [0, 1, 2, 3, 1, 2, 3, 2])
    rf = torch.from_numpy(rx.astype(np.float32))
    for got, want in ((a._decode_closed(rf), _jit(b._decode_closed)(rx.astype(np.float32))),
                      (a._decode_bm(rf), _jit(b._decode_bm)(rx.astype(np.float32)))):
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("n,t,p", [(15, 2, 3), (63, 3, 4), (255, 8, 4)])
def test_chase_matches_jax(jbch, n, t, p):
    a, b = bch.BCH(n, t), jbch.BCH(n, t)
    rng = np.random.default_rng(n + p)
    counts = [0, t, t + 1, t + 2, t + 1, 1]
    _, cw, _ = _words(rng, b, counts)
    llr = (1 - 2.0 * cw) * 1.0 + 0.9 * rng.normal(size=cw.shape)
    llr = llr.astype(np.float32).reshape(2, 3, n)
    got = a.decode_soft(torch.from_numpy(llr), p=p)
    want = _jit(b.decode_soft, p=p)(llr)
    for g, w in zip(got, want):
        assert g.shape[:2] == (2, 3) and np.array_equal(g.numpy(), np.asarray(w))


def test_chase_with_exact_ties_matches_jax(jbch):
    # quantised LLRs: many positions share the least reliability, so the
    # chosen p positions and their order decide the result
    a, b = bch.BCH(63, 3), jbch.BCH(63, 3)
    rng = np.random.default_rng(7)
    _, cw, _ = _words(rng, b, [0] * 8)
    mag = rng.choice(np.array([0.5, 1.0, 2.0], np.float32), size=cw.shape, p=[0.15, 0.35, 0.5])
    sign = 1 - 2.0 * cw
    flip = rng.random(cw.shape) < 0.08
    llr = (np.where(flip, -sign, sign) * mag).astype(np.float32)
    llr[0, :4] = -0.0
    got = a.decode_soft(torch.from_numpy(llr), p=4)
    want = _jit(b.decode_soft, p=4)(llr)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    # the flip positions are jax.lax.top_k's, lower index first among ties
    import jax

    rel = np.abs(llr)
    flips = bch.chase_flips(torch.from_numpy(rel), 4, 63).numpy()
    idx = np.asarray(jax.lax.top_k(-rel, 4)[1])
    for i in range(4):
        assert np.array_equal(np.argmax(flips[:, 1 << i], axis=-1), idx[:, i])


def test_constructions_and_bad_arguments(jbch):
    for got, want in ((bch.bch_15_7(), jbch.bch_15_7()), (bch.bch_63_45(), jbch.bch_63_45()),
                      (bch.bch_255_t(5), jbch.bch_255_t(5))):
        assert (got.n, got.k, got.t, got.generator) == (want.n, want.k, want.t, want.generator)
    with pytest.raises(ValueError, match="no message room"):
        bch.BCH(15, 8)
    with pytest.raises(ValueError, match="not primitive"):
        bch.BCH(15, 1, primitive_poly=0x1F)
    code = bch.bch_15_7()
    with pytest.raises(ValueError, match="message bits"):
        code.encode(torch.zeros(8, dtype=torch.uint8))
    with pytest.raises(ValueError, match="received bits"):
        code.decode(torch.zeros(14, dtype=torch.uint8))
    with pytest.raises(ValueError, match="LLRs"):
        code.decode_soft(torch.zeros(16))


@pytest.mark.cuda
@pytest.mark.parametrize("n,t", [(255, 8), (31, 2)])
def test_cuda_decoders_equal_the_cpu_run(cuda, n, t):
    code = bch.BCH(n, t)
    rng = np.random.default_rng(9)
    msg = rng.integers(0, 2, (64, code.k)).astype(np.uint8)
    cw = code.encode(torch.from_numpy(msg)).numpy()
    llr = ((1 - 2.0 * cw) + 0.8 * rng.normal(size=cw.shape)).astype(np.float32)
    hard = (llr < 0).astype(np.uint8)
    for got, want in ((code.decode(torch.from_numpy(hard).to(cuda)),
                       code.decode(torch.from_numpy(hard))),
                      (code.decode_soft(torch.from_numpy(llr).to(cuda)),
                       code.decode_soft(torch.from_numpy(llr)))):
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)
