"""The port's diversity combiners, Alamouti code and MIMO detectors
(``models/diversity.py``) against the JAX package's, on the same seeded
numpy inputs.

Tolerances: combiner, Alamouti and detector outputs RMS EVM <= -100 dB
against the JAX package's; the MIMO solves and the stream SNRs (an inverse
of the Gram matrix, whose condition number is the square of the
channel's) <= -80 dB at channel condition numbers under 100; the selected
branch and the decisions exact. The ``cuda`` case holds the card to the
CPU run.
"""

import numpy as np
import pytest
import torch

from aether_primitives_tpu_torch.evm import evm_rms_db
from aether_primitives_tpu_torch.models import diversity as tdiv
from aether_primitives_tpu_torch.ops import modulation as tmod

torch.set_num_threads(1)

EVM_DB, MIMO_DB = -100.0, -80.0


@pytest.fixture(scope="module")
def jdiv():
    pytest.importorskip("jax")
    from aether_primitives_tpu.models import diversity

    return diversity


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _jit(fn, **static):
    """The JAX side under ``jax.jit`` (one XLA program a call)."""
    import jax

    return jax.jit(lambda *a: fn(*a, **static))


def _cn(rng, *shape):
    return ((rng.normal(size=shape) + 1j * rng.normal(size=shape)) / np.sqrt(2)).astype(
        np.complex64)


def _qpsk(rng, n):
    bits = rng.integers(0, 2, 2 * n).astype(np.uint8)
    return tmod.qpsk().modulate(torch.from_numpy(bits)).numpy(), bits


def _db(got, want):
    return evm_rms_db(np.asarray(got), np.asarray(want))


def test_combiners_match_jax(jdiv):
    rng = np.random.default_rng(1)
    s, _ = _qpsk(rng, 512)
    # per-block channels [B, n_rx, 1] and per-sample channels [n_rx, n]
    h_blk = _cn(rng, 3, 4, 1)
    y = h_blk * s[None, None, :] + 0.3 * _cn(rng, 3, 4, 512)
    h_smp = _cn(rng, 4, 512)
    y2 = h_smp * s + 0.3 * _cn(rng, 4, 512)
    for fn in ("mrc_combine", "egc_combine", "selection_combine"):
        for yy, hh in ((y, h_blk), (y2, h_smp), (y[0], h_blk[0])):
            want = np.asarray(_jit(getattr(jdiv, fn))(yy, hh))
            got = getattr(tdiv, fn)(torch.from_numpy(yy), torch.from_numpy(hh))
            assert got.dtype == torch.complex64 and got.shape == want.shape, fn
            assert _db(got, want) <= EVM_DB, fn
    # the branch axis anywhere: [n_rx, B, n] with axis=0
    yt = np.ascontiguousarray(np.moveaxis(y, 1, 0))
    ht = np.ascontiguousarray(np.moveaxis(h_blk, 1, 0))
    for fn in ("mrc_combine", "selection_combine"):
        want = np.asarray(getattr(jdiv, fn)(yt, ht, axis=0))
        assert _db(getattr(tdiv, fn)(torch.from_numpy(yt), torch.from_numpy(ht), axis=0), want) \
            <= EVM_DB


def test_selection_picks_the_first_of_equal_branches(jdiv):
    s, _ = _qpsk(np.random.default_rng(2), 64)
    h = np.array([[1.0j], [-1.0], [0.5]], np.complex64)  # two branches of equal power
    y = h * s
    got = tdiv.selection_combine(torch.from_numpy(y), torch.from_numpy(h)).numpy()
    np.testing.assert_allclose(got, s, atol=1e-6)
    assert _db(got, jdiv.selection_combine(y, h)) <= EVM_DB


def test_alamouti_matches_jax(jdiv):
    rng = np.random.default_rng(3)
    s, bits = _qpsk(rng, 1024)
    tx = tdiv.alamouti_encode(torch.from_numpy(s)).numpy()
    jtx = np.asarray(jdiv.alamouti_encode(s))
    assert tx.shape == (2, 1024) and np.array_equal(tx, jtx)
    h0, h1 = _cn(rng, 4), _cn(rng, 4)  # four bursts
    r = h0[:, None] * tx[0] + h1[:, None] * tx[1] + 0.05 * _cn(rng, 4, 1024)
    got = tdiv.alamouti_decode(torch.from_numpy(r), torch.from_numpy(h0), torch.from_numpy(h1))
    assert _db(got, jdiv.alamouti_decode(r, h0, h1)) <= EVM_DB
    with pytest.raises(ValueError, match="PAIRS"):
        tdiv.alamouti_encode(torch.zeros(3, dtype=torch.complex64))
    with pytest.raises(ValueError, match="PAIRS"):
        tdiv.alamouti_decode(torch.zeros(3, dtype=torch.complex64), 1.0, 1.0)


def _well_conditioned(rng, n, n_rx=4, n_tx=4, cond=100.0):
    """``n`` Rayleigh matrices, those with a condition number under ``cond``."""
    h = _cn(rng, 4 * n, n_rx, n_tx)
    keep = np.linalg.cond(h) < cond
    return h[keep][:n]


def test_mimo_detectors_match_jax(jdiv):
    rng = np.random.default_rng(4)
    n = 2048
    h = _well_conditioned(rng, n)
    s, bits = _qpsk(rng, 4 * n)
    s = s.reshape(n, 4) / np.sqrt(2)
    y = (np.einsum("nij,nj->ni", h, s) + 0.05 * _cn(rng, n, 4)).astype(np.complex64)
    th, ty = torch.from_numpy(h), torch.from_numpy(y)
    zf = tdiv.mimo_detect_zf(ty, th)
    mmse = tdiv.mimo_detect_mmse(ty, th, 0.0025)
    snr = tdiv.mimo_stream_snr(th, 0.0025)
    assert zf.dtype == torch.complex64 and snr.dtype == torch.float32
    jzf = np.asarray(_jit(jdiv.mimo_detect_zf)(y, h))
    assert _db(zf, jzf) <= MIMO_DB
    assert _db(mmse, _jit(jdiv.mimo_detect_mmse, noise_var=0.0025)(y, h)) <= MIMO_DB
    assert _db(snr, _jit(jdiv.mimo_stream_snr, noise_var=0.0025)(h)) <= MIMO_DB
    q = tmod.qpsk()
    got = q.demod(zf.reshape(-1)).numpy()
    want = q.demod(torch.from_numpy(jzf).reshape(-1)).numpy()
    assert np.array_equal(got, want) and np.mean(got != bits) < 0.01
    # one matrix a burst, broadcast over its symbol times
    h1 = h[:1]
    y1 = (np.einsum("ij,nj->ni", h1[0], s) + 0.05 * _cn(rng, n, 4)).astype(np.complex64)
    assert _db(tdiv.mimo_detect_zf(torch.from_numpy(y1), torch.from_numpy(h1)),
               jdiv.mimo_detect_zf(y1, h1)) <= MIMO_DB


@pytest.mark.cuda
def test_card_matches_cpu(cuda):
    rng = np.random.default_rng(5)
    n = 4096
    h = _well_conditioned(rng, n)
    y = _cn(rng, n, 4)
    yb, hb = _cn(rng, 4, n), _cn(rng, 4, 1)
    for name, fn in (("zf", lambda a, b: tdiv.mimo_detect_zf(a, b)),
                     ("mmse", lambda a, b: tdiv.mimo_detect_mmse(a, b, 0.01))):
        got = fn(torch.from_numpy(y).to(cuda), torch.from_numpy(h).to(cuda))
        assert _db(got.cpu().numpy(), fn(torch.from_numpy(y), torch.from_numpy(h))) <= MIMO_DB, name
    for fn in (tdiv.mrc_combine, tdiv.egc_combine, tdiv.selection_combine):
        got = fn(torch.from_numpy(yb).to(cuda), torch.from_numpy(hb).to(cuda))
        assert _db(got.cpu().numpy(), fn(torch.from_numpy(yb), torch.from_numpy(hb))) <= EVM_DB
