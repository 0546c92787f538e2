"""The port's adaptive equalizers (``models/equalizer.py``) against the JAX
package's, on the same seeded numpy inputs.

Tolerances: LMS, decision-directed LMS, CMA and FDAF weights, outputs and
error traces RMS EVM <= -100 dB against the JAX package's over the tests'
lengths (the recurrences keep its float32 order, so rounding does not
drift apart); decisions after the settle exact. RLS: the port runs its
recurrence in complex128 (ROADMAP.md §3.17: in float32, the JAX package's
form, the weights turn NaN over a few hundred training symbols), so its
weights, outputs and errors are held to a float64 golden at -100 dB, its
decisions to the golden's exactly, and to the JAX package's only where the
JAX weights are finite (the draws where they are not xfail, citing §3.17).
The JAX side runs under ``jax.jit`` (one XLA program a call). The ``cuda``
case runs every loop on the card under
``torch.cuda.set_sync_debug_mode("error")`` (a host read in a step
raises) and holds it to the CPU run (RLS to the float64 golden).
"""

import numpy as np
import pytest
import torch

from aether_primitives_tpu_torch.evm import evm_rms_db
from aether_primitives_tpu_torch.models import equalizer as teq
from aether_primitives_tpu_torch.ops import modulation as tmod

torch.set_num_threads(1)

EVM_DB = -100.0
RLS_DB = -100.0  # against float64 (ROADMAP.md §3.17)
CHANNEL = np.array([0.2j, 1.0, 0.45, -0.25 + 0.15j], np.complex64)
# ROADMAP.md §3.17's scene, where the JAX package's float32 RLS gives NaN
# weights in 145 of 150 draws: RLS's defaults (11 taps, lam 0.99, delta
# 0.01, delay 0) trained on 800 QPSK symbols through RLS_CHANNEL with
# complex noise of RMS 0.02
RLS_CHANNEL = np.array([1.0, 0.3 - 0.2j, 0.1j], np.complex64)
RLS_NSYM, RLS_TRAIN = 1000, 800


@pytest.fixture(scope="module")
def jeq():
    pytest.importorskip("jax")
    from aether_primitives_tpu.models import equalizer

    return equalizer


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _jit(fn, **static):
    import jax

    return jax.jit(lambda *a: fn(*a, **static))


def _qpsk_through_channel(nsym, seed, noise=1e-3):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, 2 * nsym).astype(np.uint8)
    tx = tmod.qpsk().modulate(torch.from_numpy(bits)).numpy() / np.sqrt(2)  # unit modulus
    x = np.convolve(tx, CHANNEL)[:nsym]
    x += np.sqrt(noise / 2) * (rng.normal(size=nsym) + 1j * rng.normal(size=nsym))
    return bits, tx.astype(np.complex64), x.astype(np.complex64)


def _db(got, want):
    return evm_rms_db(np.asarray(got), np.asarray(want))


def test_lms_then_decision_directed_match_jax(jeq):
    nsym, ntrain, delay = 3000, 800, 4
    bits, tx, x = _qpsk_through_channel(nsym, 1)
    jy, jw, je = _jit(jeq.lms_equalize, ntaps=15, mu=0.4, delay=delay)(x[:ntrain], tx[:ntrain])
    ty, tw, te = teq.lms_equalize(torch.from_numpy(x[:ntrain]), torch.from_numpy(tx[:ntrain]),
                                  ntaps=15, mu=0.4, delay=delay)
    assert ty.dtype == torch.complex64 and te.dtype == torch.float32
    assert max(_db(tw, jw), _db(ty, jy), _db(te, je)) <= EVM_DB
    table = tmod.qpsk().table
    import jax

    jy2, jw2 = jax.jit(lambda v, w: jeq.dd_equalize(v, table, ntaps=15, mu=0.05, w0=w))(
        x[ntrain:], jw)
    ty2, tw2 = teq.dd_equalize(torch.from_numpy(x[ntrain:]), table, ntaps=15, mu=0.05,
                               w0=np.asarray(jw))
    assert max(_db(tw2, jw2), _db(ty2, jy2)) <= EVM_DB
    got = tmod.qpsk().demod(ty2[15:]).numpy()
    assert np.array_equal(got, np.asarray(tmod.qpsk().demod(torch.from_numpy(np.asarray(jy2)[15:]))))
    start = 2 * (ntrain - delay + 15)
    assert np.array_equal(got, bits[start:start + got.size])


def test_lms_full_length_and_defaults_match_jax(jeq):
    _, tx, x = _qpsk_through_channel(1500, 2)
    jy, jw, je = jeq.lms_equalize(x, tx[:600], ntaps=11, mu=0.3, delay=3)
    ty, tw, te = teq.lms_equalize(torch.from_numpy(x), torch.from_numpy(tx[:600]), ntaps=11,
                                  mu=0.3, delay=3)
    assert tw.shape == (11,) and te.shape == (600,) and ty.shape == (1500,)
    assert max(_db(tw, jw), _db(ty, jy), _db(te, je)) <= EVM_DB


def test_cma_matches_jax(jeq):
    _, _, x = _qpsk_through_channel(3000, 3, noise=1e-4)
    jy, jw = _jit(jeq.cma_equalize, ntaps=15, mu=0.02, r2=1.0)(x)
    ty, tw = teq.cma_equalize(torch.from_numpy(x), ntaps=15, mu=0.02, r2=1.0)
    assert max(_db(tw, jw), _db(ty, jy)) <= EVM_DB


def _rls_f64(x, d, ntaps, delay, lam=0.99, delta=0.01):
    """The RLS recurrence in float64 (numpy): ``(y, w, err)``."""
    n = x.size
    xp = np.concatenate([np.zeros(ntaps - 1), x.astype(np.complex128)])
    rows = np.stack([xp[ntaps - 1 - t:ntaps - 1 - t + n] for t in range(ntaps)], axis=-1)
    m = min(d.size, n - delay)
    w = np.zeros(ntaps, np.complex128)
    p = np.eye(ntaps, dtype=np.complex128) / delta
    errs = []
    for u, dd in zip(rows[delay:delay + m], d[:m].astype(np.complex128)):
        pu = p @ u
        k = pu / (lam + np.sum(np.conj(u) * pu))
        e = dd - np.sum(np.conj(w) * u)
        w = w + k * np.conj(e)
        p = (p - k[:, None] * np.conj(pu)[None, :]) / lam
        errs.append(abs(e))
    return rows @ np.conj(w), np.conj(w), np.array(errs)


@pytest.mark.parametrize("seed,ntrain", [(4, 200), (6, 100)])
def test_rls_matches_float64_and_jax_decisions(jeq, seed, ntrain):
    # ROADMAP.md §3.17: RLS's float32 recurrence is where the JAX package
    # differs from float64 (-68 to -85 dB here; its jitted and eager forms
    # differ from each other by -67 to -83 dB), so the port is held to a
    # float64 golden and to the JAX package's decisions
    bits, tx, x = _qpsk_through_channel(800, seed)
    ty, tw, te = teq.rls_equalize(torch.from_numpy(x), torch.from_numpy(tx[:ntrain]), ntaps=9,
                                  delay=4)
    gy, gw, ge = _rls_f64(x, tx[:ntrain], 9, 4)
    assert max(_db(tw, gw), _db(ty, gy), _db(te, ge)) <= RLS_DB
    jy, _, _ = _jit(jeq.rls_equalize, ntaps=9, delay=4)(x, tx[:ntrain])
    q = tmod.qpsk()
    got = q.demod(ty[4 + 100:] * np.sqrt(2)).numpy()
    assert np.array_equal(got, bits[200:200 + got.size])  # y[4 + j] estimates symbol j
    assert np.array_equal(got, q.demod(torch.from_numpy(np.asarray(jy)[4 + 100:]) * np.sqrt(2)).numpy())


def _rls_scene(seed):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, 2 * RLS_NSYM).astype(np.uint8)
    tx = (tmod.qpsk().modulate(torch.from_numpy(bits)).numpy() / np.sqrt(2)).astype(np.complex64)
    noise = rng.normal(size=RLS_NSYM) + 1j * rng.normal(size=RLS_NSYM)
    x = np.convolve(tx, RLS_CHANNEL)[:RLS_NSYM] + 0.02 / np.sqrt(2) * noise
    return tx, x.astype(np.complex64)


def _qpsk_decisions(y):
    return tmod.qpsk().demod(torch.as_tensor(np.asarray(y, np.complex64)) * np.sqrt(2)).numpy()


@pytest.mark.parametrize("seed", range(5))
def test_rls_float32_nan_scene_matches_float64(seed):
    # ROADMAP.md §3.17: no NaN, weights/outputs/errors at -100 dB from the
    # float64 recurrence, decisions equal to its decisions
    tx, x = _rls_scene(seed)
    ty, tw, te = teq.rls_equalize(torch.from_numpy(x), torch.from_numpy(tx[:RLS_TRAIN]))
    assert ty.dtype == torch.complex64 and tw.dtype == torch.complex64
    assert te.dtype == torch.float32 and te.shape == (RLS_TRAIN,)
    assert bool(torch.isfinite(tw).all() and torch.isfinite(ty).all())
    gy, gw, ge = _rls_f64(x, tx[:RLS_TRAIN], 11, 0)
    assert max(_db(tw, gw), _db(ty, gy), _db(te, ge)) <= RLS_DB
    assert np.array_equal(_qpsk_decisions(ty), _qpsk_decisions(gy))


@pytest.mark.parametrize("seed", range(5))
def test_rls_float32_nan_scene_decisions_match_jax(jeq, seed):
    tx, x = _rls_scene(seed)
    jy, jw, _ = _jit(jeq.rls_equalize)(x, tx[:RLS_TRAIN])
    if not np.isfinite(np.asarray(jw)).all():
        pytest.xfail("the JAX package's float32 RLS gives NaN weights here (ROADMAP.md §3.17)")
    ty, _, _ = teq.rls_equalize(torch.from_numpy(x), torch.from_numpy(tx[:RLS_TRAIN]))
    assert np.array_equal(_qpsk_decisions(ty), _qpsk_decisions(jy))


@pytest.mark.parametrize("n,ntaps", [(1 << 13, 33), (3000, 8)])
def test_fdaf_matches_jax(jeq, n, ntaps):
    rng = np.random.default_rng(ntaps)
    h = (0.5 * (rng.normal(size=ntaps) + 1j * rng.normal(size=ntaps))).astype(np.complex64)
    h /= np.sqrt(np.sum(np.abs(h) ** 2))
    x = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
    d = (np.convolve(x, h)[:n] + 1e-3 * (rng.normal(size=n) + 1j * rng.normal(size=n))).astype(
        np.complex64)
    jy, jw, je = _jit(jeq.fdaf, ntaps=ntaps, mu=0.5)(x, d)
    ty, tw, te = teq.fdaf(torch.from_numpy(x), torch.from_numpy(d), ntaps=ntaps, mu=0.5)
    assert ty.shape == (n,) and tw.shape == (ntaps,)
    assert max(_db(tw, jw), _db(ty, jy), _db(te, je)) <= EVM_DB
    with pytest.raises(ValueError, match="equal lengths"):
        teq.fdaf(torch.zeros(128, dtype=torch.complex64), torch.zeros(100, dtype=torch.complex64), 8)


@pytest.mark.cuda
def test_cuda_loops_do_not_read_the_host(cuda):
    bits, tx, x = _qpsk_through_channel(1200, 5)
    table = tmod.qpsk().table
    xc, tc = torch.from_numpy(x).to(cuda), torch.from_numpy(tx).to(cuda)

    def run(xs, ts):
        y, w, e = teq.lms_equalize(xs[:600], ts[:600], ntaps=11, mu=0.4, delay=4)
        y2, w2 = teq.dd_equalize(xs[600:], table, ntaps=11, mu=0.05, w0=w)
        y3, w3 = teq.cma_equalize(xs, ntaps=11, mu=0.02)
        y4, w4, e4 = teq.rls_equalize(xs, ts[:200], ntaps=9, delay=4)
        y5, w5, e5 = teq.fdaf(xs, ts, ntaps=16)
        return (y, w, e, y2, w2, y3, w3, y4, w4, e4, y5, w5, e5)

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        card = run(xc, tc)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    host = run(torch.from_numpy(x), torch.from_numpy(tx))
    gold = _rls_f64(x, tx[:200], 9, 4)
    for i, (c, h) in enumerate(zip(card, host)):
        assert c.device.type == "cuda"
        if 7 <= i <= 9:  # RLS: against float64 (ROADMAP.md §3.17)
            assert _db(c.cpu().numpy(), gold[i - 7]) <= RLS_DB, i
        else:
            assert _db(c.cpu().numpy(), h.numpy()) <= EVM_DB, i
