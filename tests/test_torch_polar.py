"""The port's polar codes (``ops/polar.py``) against the JAX package's, on
``tests/test_polar.py``'s smallest cases: (N, K) = (16, 8), (64, 32) and
(128, 96) at design SNR 1 dB, 16 codewords through BPSK at sigma 0.8.

Tolerances: information sets, codewords, decoded bits, CRC verdicts and
``ok`` flags exact. The list decoders' path metrics are float32 sums whose
order the reference leaves to XLA: within ``PM_RTOL`` (measured at most
1.9e-6 absolute on metrics of 10-300); their bits and path order are
exact on these inputs (no two paths' metrics closer than the rounding).
The leaf-wise decoder is held to JAX's at every list size at N 16 and 64,
at L 8 at N 128.
The fast decoder against the port's own leaf-wise one: path for path,
bits exact wherever the metrics order the paths uniquely, as
``tests/test_polar.py`` holds the two JAX decoders. Each JAX function runs
once a case (``jax.jit``; the leaf-wise decoder at N 128 op by op, which
compiles less), cached for the module.
"""

import functools

import numpy as np
import pytest
import torch

from aether_primitives_tpu_torch.ops import fec, polar

torch.set_num_threads(1)

SIZES = [(16, 8), (64, 32), (128, 96)]
LISTS = [1, 4, 8]
PM_RTOL = 1e-5
SIGMA = 0.8


@pytest.fixture(scope="module")
def jpolar():
    pytest.importorskip("jax")
    from aether_primitives_tpu.ops import polar as jpolar

    return jpolar


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _codewords(n, k, batch=16, seed=None):
    mask = polar.polar_construct(n, k, 1.0)
    rng = np.random.default_rng(n + k if seed is None else seed)
    bits = rng.integers(0, 2, (batch, k)).astype(np.uint8)
    cw = polar.polar_encode(torch.from_numpy(bits), mask).numpy()
    llr = (2.0 / SIGMA ** 2) * ((1.0 - 2.0 * cw) + SIGMA * rng.normal(size=cw.shape))
    return mask, bits, llr.astype(np.float32)


@pytest.fixture(scope="module")
def ref(jpolar):
    """The JAX package's result of a decoder on ``_codewords(n, k)``,
    computed at its first use: ``ref(name, n, k, L=None)``."""
    import jax

    cache = {}

    def get(name, n, k, L=None):
        key = (name, n, k, L)
        if key not in cache:
            mask, _, llr = _codewords(n, k)
            fn, kw = {"sc": (jpolar.polar_decode, {}),
                      "bp": (jpolar.polar_decode_bp, {"iters": 40}),
                      "fast": (jpolar.polar_decode_list, {"list_size": L}),
                      "leaf": (jpolar._decode_list_leafwise, {"list_size": L})}[name]
            call = functools.partial(fn, info_mask=mask, **kw)
            out = (call if name == "leaf" and n >= 128 else jax.jit(call))(llr)
            cache[key] = tuple(map(np.asarray, out)) if isinstance(out, tuple) else np.asarray(out)
        return cache[key]

    return get


def test_construction_and_encoder_equal_jax(jpolar):
    for n, k, snr in ((2, 1, 0.0), (64, 32, 0.0), (128, 96, 1.0), (512, 256, 1.0)):
        assert np.array_equal(polar.polar_construct(n, k, snr),
                              jpolar.polar_construct(n, k, snr))
    mask = polar.polar_construct(64, 32)
    bits = np.random.default_rng(1).integers(0, 2, (3, 5, 32)).astype(np.uint8)
    got = polar.polar_encode(torch.from_numpy(bits), mask)
    assert got.dtype == torch.uint8 and got.shape == (3, 5, 64)
    assert np.array_equal(got.numpy(), np.asarray(jpolar.polar_encode(bits, mask)))
    with pytest.raises(ValueError, match="power of two"):
        polar.polar_construct(48, 8)
    with pytest.raises(ValueError, match="information bits"):
        polar.polar_encode(torch.zeros(3, 31, dtype=torch.uint8), mask)


@pytest.mark.parametrize("n", [2, 4, 8, 64])
def test_encode_matches_kronecker(n):
    k = max(1, n // 2)
    mask = polar.polar_construct(n, k)
    bits = np.random.default_rng(n).integers(0, 2, (5, k)).astype(np.uint8)
    u = np.zeros((5, n), np.uint8)
    u[:, np.nonzero(mask)[0]] = bits
    f, g = np.array([[1, 0], [1, 1]], np.uint8), np.array([[1]], np.uint8)
    while g.shape[0] < n:
        g = np.kron(f, g)
    got = polar.polar_encode(torch.from_numpy(bits), mask).numpy()
    assert np.array_equal(got, (u.astype(np.int64) @ g) % 2)


@pytest.mark.parametrize("n,k", SIZES)
def test_sc_and_bp_equal_jax(ref, n, k):
    mask, bits, llr = _codewords(n, k)
    sc = polar.polar_decode(torch.from_numpy(llr), mask)
    assert sc.dtype == torch.uint8 and np.array_equal(sc.numpy(), ref("sc", n, k))
    got = polar.polar_decode_bp(torch.from_numpy(llr), mask, 40)
    want = ref("bp", n, k)
    assert np.array_equal(got[0].numpy(), want[0]) and np.array_equal(got[1].numpy(), want[1])
    assert (sc.numpy() == bits).all(axis=1).any() and got[1].numpy().any()
    two = polar.polar_decode(torch.from_numpy(llr.reshape(4, 4, n)), mask)
    assert torch.equal(two.reshape(16, k), sc)


@pytest.mark.parametrize("L", LISTS)
@pytest.mark.parametrize("n,k", SIZES)
def test_list_decoders_equal_jax(ref, n, k, L):
    # the JAX leaf-wise decoder at N 128 costs ~5 s a list size: L 8 only
    mask, bits, llr = _codewords(n, k)
    decoders = [("fast", polar.polar_decode_list), ("leaf", polar._decode_list_leafwise)]
    for name, fn in decoders[:1] if n >= 128 and L < 8 else decoders:
        got_bits, got_pm = fn(torch.from_numpy(llr), mask, L)
        want_bits, want_pm = ref(name, n, k, L)
        assert got_bits.dtype == torch.uint8 and got_bits.shape == (16, L, k)
        assert np.array_equal(got_bits.numpy(), want_bits), name
        np.testing.assert_allclose(got_pm.numpy(), want_pm, rtol=PM_RTOL, atol=0)
    assert (got_bits.numpy()[:, 0] == bits).all(axis=1).any()


@pytest.mark.parametrize("L", LISTS)
@pytest.mark.parametrize("n,k", SIZES + [(256, 128)])
def test_fast_list_equals_the_leafwise_decoder(n, k, L):
    mask, _, llr = _codewords(n, k, seed=7)
    fast_bits, fast_pm = polar.polar_decode_list(torch.from_numpy(llr), mask, L)
    leaf_bits, leaf_pm = polar._decode_list_leafwise(torch.from_numpy(llr), mask, L)
    fast_pm, leaf_pm = fast_pm.numpy(), leaf_pm.numpy()
    np.testing.assert_allclose(fast_pm, leaf_pm, rtol=PM_RTOL, atol=1e-3)
    distinct = np.ones_like(fast_pm, bool)
    gaps = np.abs(np.diff(fast_pm, axis=1)) > 1e-4
    distinct[:, 1:] &= gaps
    distinct[:, :-1] &= gaps
    assert (fast_bits.numpy()[distinct] == leaf_bits.numpy()[distinct]).all()


def test_list_size_one_is_sc(ref):
    mask, _, llr = _codewords(64, 32)
    sc = polar.polar_decode(torch.from_numpy(llr), mask)
    lst, pm = polar.polar_decode_list(torch.from_numpy(llr), mask, 1)
    assert torch.equal(lst[:, 0], sc) and pm.shape == (16, 1) and torch.isfinite(pm).all()


def test_tie_heavy_list_needs_the_stable_prune(jpolar, monkeypatch):
    # integer LLRs, most of them 0: many path metrics tie exactly, and the
    # survivors depend on how ties are ordered; torch.topk's order is not
    # top_k's, the stable sort's is
    import jax

    mask = polar.polar_construct(64, 32, 1.0)
    llr = np.random.default_rng(3).choice(
        np.array([-2.0, -1.0, 0.0, 0.0, 0.0, 1.0, 2.0], np.float32), size=(32, 64))
    want = jax.jit(functools.partial(jpolar.polar_decode_list, info_mask=mask,
                                     list_size=8))(llr)
    got = polar.polar_decode_list(torch.from_numpy(llr), mask, 8)
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))

    def topk_prune(pm2, L):
        neg, sel = torch.topk(-pm2, L)
        return -neg, sel

    monkeypatch.setattr(polar, "_prune", topk_prune)
    unstable = polar.polar_decode_list(torch.from_numpy(llr), mask, 8)
    assert not np.array_equal(unstable[0].numpy(), np.asarray(want[0]))


def test_polar_code_with_crc8_equals_jax(jpolar):
    # CA-SCL: the first CRC-passing path in metric order, else path 0; and
    # BP with the CRC in its ok flag
    import jax

    code, jcode = polar.PolarCode(128, 64, 1.0, "crc8", 4), jpolar.PolarCode(128, 64, 1.0, "crc8", 4)
    assert code.payload_bits == jcode.payload_bits == 56
    assert np.array_equal(code.info_mask, jcode.info_mask)
    rng = np.random.default_rng(11)
    payload = rng.integers(0, 2, (12, 56)).astype(np.uint8)
    cw = code.encode(torch.from_numpy(payload))
    assert np.array_equal(cw.numpy(), np.asarray(jax.jit(jcode.encode)(payload)))
    sigma = 0.9
    llr = ((2.0 / sigma ** 2) * ((1.0 - 2.0 * cw.numpy()) + sigma * rng.normal(size=cw.shape)))
    llr = llr.astype(np.float32)
    llr[0] = -llr[0]  # one codeword that no path repairs
    for method in ("decode", "decode_bp"):
        got = getattr(code, method)(torch.from_numpy(llr))
        want = jax.jit(getattr(jcode, method))(llr)
        assert np.array_equal(got[0].numpy(), np.asarray(want[0])), method
        assert np.array_equal(got[1].numpy(), np.asarray(want[1])), method
        ok = got[1].numpy()
        assert not ok[0] and ok[1:].any() and (got[0].numpy()[ok] == payload[ok]).all()
    plain = polar.PolarCode(64, 32)
    bits = torch.from_numpy(payload[:3, :32])
    out, ok = plain.decode(fec.hard_to_llr(plain.encode(bits)) * 4.0)
    assert torch.equal(out, bits) and ok.all()


@pytest.mark.cuda
def test_cuda_decoders_equal_the_cpu_run(cuda):
    mask, _, llr = _codewords(128, 96, batch=64)
    x = torch.from_numpy(llr)
    for fn in (lambda t: polar.polar_decode(t, mask),
               lambda t: polar.polar_decode_bp(t, mask, 40),
               lambda t: polar.polar_decode_list(t, mask, 8),
               lambda t: polar._decode_list_leafwise(t, mask, 8)):
        got, want = fn(x.to(cuda)), fn(x)
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        assert torch.equal(got[0].cpu(), want[0])
        if len(got) > 1 and got[1].dtype == torch.bool:
            assert torch.equal(got[1].cpu(), want[1])
    code = polar.PolarCode(512, 256, 1.0, "crc8", 8)
    llr = torch.from_numpy(_codewords(512, 256, batch=32)[2])
    for method in ("decode", "decode_bp"):
        got, want = getattr(code, method)(llr.to(cuda)), getattr(code, method)(llr)
        assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
