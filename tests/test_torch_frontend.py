"""The port's front-end conditioning stages (``ops/frontend.py``) against
the JAX package's, on the same seeded numpy inputs, and the shared
midpoint median (``ops/_stats.py``) against ``np.median``.

Tolerances:
- samples (``remove_dc``, ``apply_iq_imbalance``, ``correct_iq_imbalance``,
  ``normalize_rms``, ``agc``, ``impulse_blank`` in clip mode): RMS EVM
  <= -100 dB against the JAX output;
- estimates (``dc_offset``, ``estimate_iq_imbalance``,
  ``image_rejection_db``, ``estimate_snr_m2m4``, ``agc``'s final gain):
  rtol 1e-5;
- masks and gates (``impulse_blank``'s blanked samples, ``squelch``'s
  output and gate) and the median: exact.
"""

import numpy as np
import pytest
import torch

from aether_primitives_tpu_torch.evm import evm_rms_db
from aether_primitives_tpu_torch.ops import frontend as tfe
from aether_primitives_tpu_torch.ops._stats import median_midpoint

torch.set_num_threads(1)

EVM_DB = -100.0
RTOL = 1e-5


@pytest.fixture(scope="module")
def jfe():
    pytest.importorskip("jax")
    from aether_primitives_tpu.ops import frontend

    return frontend


def _c(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_dc_and_iq_imbalance_match_jax(jfe):
    # examples/receiver.py's impairments on three rows: x0.06, Q-arm gain
    # 1.08 / phase 0.04 rad, DC 0.013-0.008j
    x = 0.06 * _c((3, 1 << 16), 1)
    want = np.asarray(jfe.apply_iq_imbalance(x, gain=1.08, phase=0.04))
    got = tfe.apply_iq_imbalance(_t(x), gain=1.08, phase=0.04)
    assert evm_rms_db(got.numpy(), want) <= EVM_DB
    rx = want + np.complex64(0.013 - 0.008j)
    np.testing.assert_allclose(tfe.dc_offset(_t(rx)).numpy(), np.asarray(jfe.dc_offset(rx)),
                               rtol=RTOL)
    jdc = np.asarray(jfe.remove_dc(rx))
    tdc = tfe.remove_dc(_t(rx))
    assert evm_rms_db(tdc.numpy(), jdc) <= EVM_DB
    jg, jph = (np.asarray(v) for v in jfe.estimate_iq_imbalance(jdc))
    tg, tph = tfe.estimate_iq_imbalance(tdc)
    assert tg.dtype == tph.dtype == torch.float32 and tg.shape == (3,)
    np.testing.assert_allclose(tg.numpy(), jg, rtol=RTOL)
    np.testing.assert_allclose(tph.numpy(), jph, rtol=RTOL)
    assert np.all(np.abs(tg.numpy() - 1.08) < 0.02) and np.all(np.abs(tph.numpy() - 0.04) < 0.02)
    # per-row estimates broadcast; scalars too
    for g, ph in ((tg, tph), (1.08, 0.04)):
        jg_in = g.numpy() if isinstance(g, torch.Tensor) else g
        jph_in = ph.numpy() if isinstance(ph, torch.Tensor) else ph
        want_c = np.asarray(jfe.correct_iq_imbalance(jdc, jg_in, jph_in))
        got_c = tfe.correct_iq_imbalance(tdc, g, ph)
        assert evm_rms_db(got_c.numpy(), want_c) <= EVM_DB
    assert evm_rms_db(tfe.normalize_rms(tdc, 0.7).numpy(),
                      np.asarray(jfe.normalize_rms(jdc, 0.7))) <= EVM_DB


def test_image_rejection_db_matches_jax(jfe):
    # a tone with a little noise, so that the corrected image bin is set by
    # the noise and not by float32 rounding
    n, k = 16384, 371
    tone = (np.exp(2j * np.pi * k * np.arange(n) / n) + 0.05 * _c(n, 2)).astype(np.complex64)
    bad = np.asarray(jfe.apply_iq_imbalance(tone, 1.08, 0.04))
    fixed = np.asarray(jfe.correct_iq_imbalance(bad, *jfe.estimate_iq_imbalance(bad)))
    for x in (bad, fixed, np.stack([bad, fixed])):
        np.testing.assert_allclose(tfe.image_rejection_db(_t(x), k).numpy(),
                                   np.asarray(jfe.image_rejection_db(x, k)), rtol=RTOL)
    assert float(tfe.image_rejection_db(_t(fixed), k)) > float(
        tfe.image_rejection_db(_t(bad), k)) + 40.0


@pytest.mark.parametrize("snr_db", [0.0, 10.0, 20.0])
def test_estimate_snr_m2m4_matches_jax(jfe, snr_db):
    rng = np.random.default_rng(int(snr_db) + 5)
    s = np.exp(1j * (np.pi / 4 + np.pi / 2 * rng.integers(0, 4, (2, 8192))))
    sigma = np.sqrt(10 ** (-snr_db / 10) / 2)
    y = (s + sigma * (rng.normal(size=s.shape) + 1j * rng.normal(size=s.shape))).astype(
        np.complex64)
    got = tfe.estimate_snr_m2m4(_t(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(jfe.estimate_snr_m2m4(y)), rtol=RTOL)
    assert np.all(np.abs(10 * np.log10(got.numpy()) - snr_db) < 1.0)


def test_estimate_snr_m2m4_clean_is_inf(jfe):
    s = np.exp(1j * np.pi / 4 * np.arange(64)).astype(np.complex64)
    got = tfe.estimate_snr_m2m4(_t(s))
    assert np.isinf(got.numpy()) and np.isinf(np.asarray(jfe.estimate_snr_m2m4(s)))


@pytest.mark.parametrize("n,block,alpha,gain0", [
    (16 * 256, 256, 0.5, None),  # whole blocks
    (10 * 256 + 77, 256, 0.2, 3.0),  # a ragged tail at the final gain
    (300, 512, 0.5, 2.0),  # shorter than a block: the tail only
    (8 * 128, 128, 1.0, None),  # alpha 1: per-block normalization
])
def test_agc_matches_jax(jfe, n, block, alpha, gain0):
    rng = np.random.default_rng(n)
    level = np.repeat(rng.uniform(0.05, 4.0, n // block + 1), block)[:n]
    x = (_c(n, n + 1) * level).astype(np.complex64)
    jy, jg = jfe.agc(x, target_rms=0.8, block=block, alpha=alpha, gain0=gain0)
    ty, tg = tfe.agc(_t(x), target_rms=0.8, block=block, alpha=alpha, gain0=gain0)
    assert ty.shape == (n,) and ty.dtype == torch.complex64 and tg.dtype == torch.float32
    assert evm_rms_db(ty.numpy(), np.asarray(jy)) <= EVM_DB
    np.testing.assert_allclose(float(tg), float(jg), rtol=RTOL)


def test_agc_continues_a_jax_stream(jfe):
    # the JAX stage's final_gain carries over as a float: the port's second
    # block equals the JAX package's second block
    x = (_c(20 * 256, 9) * np.repeat(np.linspace(0.2, 3.0, 20), 256)).astype(np.complex64)
    a, b = x[:11 * 256], x[11 * 256:]
    _, g1 = jfe.agc(a, block=256, alpha=0.3)
    want, wg = jfe.agc(b, block=256, alpha=0.3, gain0=g1)
    got, tg = tfe.agc(_t(b), block=256, alpha=0.3, gain0=float(g1))
    assert evm_rms_db(got.numpy(), np.asarray(want)) <= EVM_DB
    np.testing.assert_allclose(float(tg), float(wg), rtol=RTOL)


def test_agc_rejects_batched_input(jfe):
    x = np.zeros((2, 512), np.complex64)
    with pytest.raises(ValueError, match="1-D input"):
        jfe.agc(x)
    with pytest.raises(ValueError, match="1-D input"):
        tfe.agc(_t(x))


@pytest.mark.parametrize("mode", ["zero", "clip"])
@pytest.mark.parametrize("n", [4096, 4095])
def test_impulse_blank_matches_jax(jfe, mode, n):
    # an even count takes the midpoint of the middle pair as the median
    x = _c((2, n), 12)
    x[:, ::97] *= 30.0
    want = np.asarray(jfe.impulse_blank(x, 5.0, mode))
    got = tfe.impulse_blank(_t(x), 5.0, mode).numpy()
    assert np.array_equal(got == 0, want == 0)
    if mode == "zero":
        assert np.array_equal(got, want) and (got == 0).sum() >= 2 * (n // 97)
    else:
        assert evm_rms_db(got, want) <= EVM_DB


def test_impulse_blank_rejects_unknown_mode(jfe):
    x = _c(64, 3)
    with pytest.raises(ValueError, match="mode must be 'zero' or 'clip', got 'hold'"):
        jfe.impulse_blank(x, mode="hold")
    with pytest.raises(ValueError, match="mode must be 'zero' or 'clip', got 'hold'"):
        tfe.impulse_blank(_t(x), mode="hold")


def test_squelch_matches_jax(jfe):
    x = _c((4, 2048), 4) * np.array([[0.01], [1.0], [0.2], [0.5]], np.float32)
    jg, jo = jfe.squelch(x, -10.0, ref_power=2.0)
    tg, to = tfe.squelch(_t(x), -10.0, ref_power=2.0)
    assert to.dtype == torch.bool and np.array_equal(to.numpy(), np.asarray(jo))
    assert np.array_equal(tg.numpy(), np.asarray(jg))
    assert to.tolist() == [False, True, False, True]


@pytest.mark.parametrize("n", [1, 2, 7, 8, 255, 256])
def test_median_midpoint_matches_np_median(n):
    x = np.random.default_rng(n).random((3, n)).astype(np.float32)
    x[0, : n // 2] = 0.5  # ties
    got = median_midpoint(torch.from_numpy(x))
    assert got.shape == (3,)
    assert np.array_equal(got.numpy(), np.median(x, axis=-1).astype(np.float32))
    kept = median_midpoint(torch.from_numpy(x), keepdim=True)
    assert kept.shape == (3, 1) and torch.equal(kept[:, 0], got)
