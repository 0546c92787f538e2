"""The port's Reed-Solomon codec (``ops/rs.py``) against the JAX package's,
on the same seeded symbols: every output is an integer, so every check is
exact (``array_equal`` on ``msg``, ``ok`` and ``n_errors``), including the
words beyond the correction budget, where both decoders must fail the same
way. The host table builders are pinned equal to the JAX package's."""

import numpy as np
import pytest
import torch

from aether_primitives_tpu_torch.ops import rs

torch.set_num_threads(1)

CODES = [(255, 223, 1), (156, 124, 1), (15, 9, 0), (40, 29, 1)]  # the last: odd n - k
# the decoders' cases (RS(156, 124) decodes in tests/test_torch_packet.py's fade case)
DECODE_CODES = [c for c in CODES if c[:2] != (156, 124)]


@pytest.fixture(scope="module")
def jrs():
    pytest.importorskip("jax")
    from aether_primitives_tpu.ops import rs as jrs

    return jrs


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


def _corrupt(rng, cw, counts, erase=None):
    """``cw [B, n]`` with ``counts[b]`` random symbol errors (and, with
    ``erase``, ``erase[b]`` erased positions disjoint from them): the
    received words and the erasure mask."""
    rx = cw.copy()
    mask = np.zeros(cw.shape, bool)
    for b, nerr in enumerate(counts):
        rho = 0 if erase is None else erase[b]
        pos = rng.choice(cw.shape[1], nerr + rho, replace=False)
        rx[b, pos[:nerr]] ^= rng.integers(1, 256, nerr).astype(np.uint8)
        mask[b, pos[nerr:]] = True
        rx[b, pos[nerr:]] = rng.integers(0, 256, rho).astype(np.uint8)
    return rx, mask


@pytest.mark.parametrize("n,k,fcr", CODES)
def test_tables_pinned_to_jax(jrs, n, k, fcr):
    a, b = rs.ReedSolomon(n, k, fcr), jrs.ReedSolomon(n, k, fcr)
    for name in ("generator", "_enc", "_synd", "_ev_lam", "_ev_lamd", "_ev_omg", "_exp", "_log"):
        assert np.array_equal(getattr(a, name), getattr(b, name)), name
    for got, want in zip(a._erasure_tables(), b._erasure_tables()):
        assert np.array_equal(got, want)


@pytest.mark.parametrize("n,k,fcr", CODES)
def test_encode_matches_jax(jrs, n, k, fcr):
    msg = np.random.default_rng(n).integers(0, 256, (2, 3, k)).astype(np.uint8)
    got = rs.ReedSolomon(n, k, fcr).encode(torch.from_numpy(msg))
    want = np.asarray(jrs.ReedSolomon(n, k, fcr).encode(msg))
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,k,fcr", DECODE_CODES)
def test_decode_matches_jax(jrs, n, k, fcr):
    # 0..t errors (corrected), and t+1..t+3 (failures or miscorrections,
    # equal in both packages)
    rng = np.random.default_rng(100 + n)
    a, b = rs.ReedSolomon(n, k, fcr), jrs.ReedSolomon(n, k, fcr)
    counts = [0, 1, a.t, a.t, a.t + 1, a.t + 2, min(a.t + 3, n), a.t // 2]
    msg = rng.integers(0, 256, (len(counts), k)).astype(np.uint8)
    rx, _ = _corrupt(rng, np.asarray(_jit(b.encode)(msg)), counts)
    got = a.decode(torch.from_numpy(rx))
    want = _jit(b.decode)(rx)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert got[1].numpy()[:4].all() and np.array_equal(got[0].numpy()[:4], msg[:4])
    assert got[2].dtype == torch.int32 and got[2].numpy()[:4].tolist() == counts[:4]


@pytest.mark.parametrize("n,k,fcr", DECODE_CODES)
def test_decode_erasures_matches_jax(jrs, n, k, fcr):
    rng = np.random.default_rng(200 + n)
    a, b = rs.ReedSolomon(n, k, fcr), jrs.ReedSolomon(n, k, fcr)
    nsym = n - k
    # (errors, erasures): within 2 nu + rho <= n - k, at the edge, past it,
    # erasures only up to and past n - k, none at all
    pairs = [(0, 0), (0, nsym), (1, nsym - 2), (nsym // 2, 0), (nsym // 4, nsym - 2 * (nsym // 4)),
             (2, nsym - 3), (0, nsym + 1), (3, nsym), (0, min(n, nsym + 5))]
    msg = rng.integers(0, 256, (len(pairs), k)).astype(np.uint8)
    rx, mask = _corrupt(rng, np.asarray(_jit(b.encode)(msg)), [p[0] for p in pairs],
                        [p[1] for p in pairs])
    got = a.decode_erasures(torch.from_numpy(rx), torch.from_numpy(mask))
    want = _jit(b.decode_erasures)(rx, mask)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert got[1].numpy()[:5].all() and np.array_equal(got[0].numpy()[:5], msg[:5])


def test_decode_erasures_batched_over_leading_axes():
    # [2, 3, n] words decode as the same 6 words flat (which the cases above
    # hold against the JAX package)
    code = rs.ReedSolomon(60, 40)
    rng = np.random.default_rng(3)
    msg = rng.integers(0, 256, (6, 40)).astype(np.uint8)
    rx, mask = _corrupt(rng, code.encode(torch.from_numpy(msg)).numpy(), [2, 4, 0, 7, 1, 11],
                        [5, 12, 20, 6, 0, 3])
    got = code.decode_erasures(torch.from_numpy(rx.reshape(2, 3, 60)),
                               torch.from_numpy(mask.reshape(2, 3, 60).astype(np.uint8)))
    want = code.decode_erasures(torch.from_numpy(rx), torch.from_numpy(mask))
    for g, w in zip(got, want):
        assert g.shape[:2] == (2, 3)
        assert torch.equal(g.reshape((6,) + g.shape[2:]), w)
    assert want[1][:5].all() and not want[1][5]


def test_bits_and_symbols_match_jax(jrs):
    sym = np.random.default_rng(4).integers(0, 256, (3, 17)).astype(np.uint8)
    bits = rs.symbols_to_bits(torch.from_numpy(sym))
    assert np.array_equal(bits.numpy(), np.asarray(jrs.symbols_to_bits(sym)))
    back = rs.bits_to_symbols(bits)
    assert back.dtype == torch.uint8 and np.array_equal(back.numpy(), sym)
    assert np.array_equal(back.numpy(), np.asarray(jrs.bits_to_symbols(np.asarray(bits))))
    with pytest.raises(ValueError, match="multiple of 8"):
        rs.bits_to_symbols(torch.zeros(12))


def test_bad_arguments_raise():
    with pytest.raises(ValueError, match="0 < k < n"):
        rs.ReedSolomon(256, 200)
    code = rs.rs_255_223()
    assert (code.n, code.k, code.t) == (255, 223, 16)
    with pytest.raises(ValueError, match="message symbols"):
        code.encode(torch.zeros(222, dtype=torch.uint8))
    with pytest.raises(ValueError, match="received symbols"):
        code.decode(torch.zeros(254, dtype=torch.uint8))
    with pytest.raises(ValueError, match="mask"):
        code.decode_erasures(torch.zeros(255, dtype=torch.uint8), torch.zeros(254))


@pytest.mark.cuda
def test_cuda_decoders_equal_the_cpu_run(cuda):
    code = rs.rs_255_223()
    rng = np.random.default_rng(5)
    msg = rng.integers(0, 256, (64, 223)).astype(np.uint8)
    cw = code.encode(torch.from_numpy(msg)).numpy()
    rx, mask = _corrupt(rng, cw, rng.integers(0, 12, 64), rng.integers(0, 12, 64))
    for fn, args in ((code.decode, (rx,)), (code.decode_erasures, (rx, mask))):
        got = fn(*(torch.from_numpy(a).to(cuda) for a in args))
        want = fn(*(torch.from_numpy(a) for a in args))
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)
    assert torch.equal(code.encode(torch.from_numpy(msg).to(cuda)).cpu(), torch.from_numpy(cw))
