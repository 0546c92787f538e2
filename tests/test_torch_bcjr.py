"""The port's windowed BCJR and turbo decoder against the JAX package's.

The plain twin ``bcjr_windowed_llr_reference`` is held against the Pallas
kernel ``bcjr_windowed_llr`` (interpret mode) with the turbo RSC-8 tables
and the K=7 conv tables; the windowed constituent decoder and the whole
turbo decode (window 64, guard 16, 4 iterations) against JAX's XLA scans;
the encoder and interleaver against JAX's. The reference decoders are exact
(max-log, fixed expression tree), so LLRs and bits are compared with
``np.array_equal``: no tolerance. The CUDA kernel is held against the twin
on a card (``cuda`` marker; skipped without one; run with ``python -m
pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_bcjr.py``).
"""

import numpy as np
import pytest
import torch

from aether_primitives_tpu_torch.ops import fec, turbo
from aether_primitives_tpu_torch.ops.cuda import bcjr as bk

torch.set_num_threads(1)

CONV_K7 = fec._conv_soft_coeffs((0o171, 0o133), 7)


@pytest.fixture(scope="module")
def jturbo():
    pytest.importorskip("jax")
    from aether_primitives_tpu.ops import turbo as jax_turbo

    return jax_turbo


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _spans(lw, n, seed):
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=(lw, n)) * 3).astype(np.float32),
            (rng.normal(size=(lw, n)) * 3).astype(np.float32))


def _channel_llrs(n_bits, b, seed, sigma=0.8):
    """Turbo-encoded random bits through BPSK + AWGN, as the five LLR
    streams (float32), and the bits."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (b, n_bits)).astype(np.uint8)
    enc = [s.numpy() for s in turbo.turbo_encode(torch.from_numpy(bits))]
    llrs = tuple(((2.0 / sigma ** 2) * ((1.0 - 2.0 * s.astype(np.float64))
                                        + sigma * rng.normal(size=s.shape)))
                 .astype(np.float32) for s in enc)
    return bits, llrs


def test_encoder_interleaver_and_tables_match_jax(jturbo):
    bits = np.random.default_rng(1).integers(0, 2, (3, 300)).astype(np.uint8)
    got = turbo.turbo_encode(torch.from_numpy(bits))
    for i in range(3):
        want = jturbo.turbo_encode(bits[i])
        for g, w in zip(got, want):
            assert np.array_equal(g[i].numpy(), np.asarray(w))
    for n in (632, 635, 1000):
        assert np.array_equal(turbo.turbo_interleaver(n), jturbo.turbo_interleaver(n))
    from aether_primitives_tpu.ops.pallas.bcjr import _rsc8_tables

    assert bk.rsc8_tables() == _rsc8_tables()
    from aether_primitives_tpu.ops import fec as jfec

    assert CONV_K7 == jfec._conv_soft_coeffs((0o171, 0o133), 7)


@pytest.mark.parametrize("tables", [None, CONV_K7], ids=["rsc8", "conv_k7"])
def test_twin_matches_bcjr_windowed_llr_interpret(jturbo, tables):
    from aether_primitives_tpu.ops.pallas.bcjr import bcjr_windowed_llr

    lw, n = 40, 128
    ls, lp = _spans(lw, n, 2)
    got = bk.bcjr_windowed_llr_reference(torch.from_numpy(ls), torch.from_numpy(lp),
                                         lw, tables).numpy()
    want = np.asarray(bcjr_windowed_llr(ls, lp, lw, tables=tables, tile_n=128,
                                        interpret=True))
    assert np.array_equal(got, want)
    # a ragged N: columns are independent, so the first 93 match too
    ragged = bk.bcjr_windowed_llr(torch.from_numpy(ls[:, :93].copy()),
                                  torch.from_numpy(lp[:, :93].copy()), lw, tables)
    assert np.array_equal(ragged.numpy(), want[:, :93])


def test_windowed_constituent_matches_jax(jturbo):
    rng = np.random.default_rng(3)
    b, n = 3, 1000
    ls = (rng.normal(size=(b, n)) * 3).astype(np.float32)
    lp = (rng.normal(size=(b, n)) * 3).astype(np.float32)
    la = rng.normal(size=(b, n)).astype(np.float32)
    got = turbo._bcjr_maxlog_windowed(torch.from_numpy(ls), torch.from_numpy(lp),
                                      torch.from_numpy(la), 64, 16).numpy()
    want = np.asarray(jturbo._bcjr_maxlog_windowed(ls, lp, la, 64, 16, backend="xla"))
    assert np.array_equal(got, want)
    ref = turbo._bcjr_maxlog_windowed(torch.from_numpy(ls), torch.from_numpy(lp),
                                      torch.from_numpy(la), 64, 16, backend="reference")
    assert np.array_equal(ref.numpy(), want)


@pytest.mark.parametrize("window", [64, 0], ids=["windowed", "exact"])
def test_turbo_decode_matches_jax(jturbo, window):
    bits, llrs = _channel_llrs(512, 2, 4)
    got_bits, got_llr = turbo.turbo_decode(*(torch.from_numpy(v) for v in llrs),
                                           iterations=4, window=window, guard=16)
    want_bits, want_llr = jturbo.turbo_decode(*llrs, iterations=4, window=window,
                                              guard=16, bcjr_backend="xla")
    assert np.array_equal(got_llr.numpy(), np.asarray(want_llr))
    assert np.array_equal(got_bits.numpy(), np.asarray(want_bits))
    assert np.array_equal(got_bits.numpy(), bits)


def test_turbo_decode_matches_the_pallas_kernel(jturbo):
    _, llrs = _channel_llrs(300, 2, 5, sigma=1.0)
    got_bits, got_llr = turbo.turbo_decode(*(torch.from_numpy(v) for v in llrs),
                                           iterations=2, window=64, guard=16)
    want_bits, want_llr = jturbo.turbo_decode(*llrs, iterations=2, window=64, guard=16,
                                              bcjr_backend="pallas_interpret")
    assert np.array_equal(got_llr.numpy(), np.asarray(want_llr))
    assert np.array_equal(got_bits.numpy(), np.asarray(want_bits))


def test_backends_and_argument_checks():
    _, llrs = _channel_llrs(100, 1, 6)
    args = tuple(torch.from_numpy(v) for v in llrs)
    a = turbo.turbo_decode(*args, iterations=1, window=64, guard=16)
    b = turbo.turbo_decode(*args, iterations=1, window=64, guard=16,
                           bcjr_backend="reference")
    assert torch.equal(a[1], b[1])
    for bad in ("xla", "pallas", "bogus"):
        with pytest.raises(ValueError, match="unknown bcjr_backend"):
            turbo.turbo_decode(*args, iterations=1, window=64, bcjr_backend=bad)
    with pytest.raises(ValueError, match="bad spans"):
        bk.bcjr_windowed_llr(torch.zeros(4, 5), torch.zeros(4, 6), 4)
    with pytest.raises(TypeError):
        bk.bcjr_windowed_llr(torch.zeros(4, 5, dtype=torch.float64),
                             torch.zeros(4, 5, dtype=torch.float64), 4)


# ------------------------------------------------------------ on the card


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2560, 1000, 77])
@pytest.mark.parametrize("tables", [None, CONV_K7], ids=["rsc8", "conv_k7"])
def test_cuda_kernel_matches_twin(cuda, tables, n):
    ls, lp = (torch.from_numpy(a).to(cuda) for a in _spans(96, n, 7))
    before = bk.launches
    got = bk.bcjr_windowed_llr(ls, lp, 96, tables)
    want = bk.bcjr_windowed_llr_reference(ls, lp, 96, tables)
    torch.cuda.synchronize()
    assert bk.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_turbo_decode_matches_twin(cuda):
    bits, llrs = _channel_llrs(632, 16, 8)
    args = tuple(torch.from_numpy(v).to(cuda) for v in llrs)
    before = bk.launches
    got = turbo.turbo_decode(*args, iterations=8, window=64, guard=16)
    want = turbo.turbo_decode(*args, iterations=8, window=64, guard=16,
                              bcjr_backend="reference")
    torch.cuda.synchronize()
    assert bk.launches == before + 16
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    assert np.array_equal(got[0].cpu().numpy(), bits)
