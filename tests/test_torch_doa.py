"""The port's direction finding and beamforming (``models/doa.py``) against
the JAX package's, on the same seeded numpy inputs.

Tolerances: bearings within 1e-4 rad of the JAX package's (the grid step
is 4.3e-3 rad at 721 points); spectra rtol 1e-3 (MUSIC's projection norm
does not depend on the eigenvectors' phases, which differ between eigen
solvers: eigenvectors are never compared); steering vectors, covariances,
smoothed covariances, beams and MVDR weights RMS EVM <= -100 dB. The
sharded bearings equal the port's unsharded ones (``torch.equal`` on the
CPU) and the JAX package's at the same bar. The JAX side runs under
``jax.jit`` where it is more than a few ops. The ``cuda`` case holds the
card to the CPU run.
"""

import numpy as np
import pytest
import torch

from aether_primitives_tpu_torch.evm import evm_rms_db
from aether_primitives_tpu_torch.models import doa as tdoa
from aether_primitives_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(1)

EVM_DB, BEARING_ATOL, SPEC_RTOL = -100.0, 1e-4, 1e-3


@pytest.fixture(scope="module")
def jdoa():
    pytest.importorskip("jax")
    from aether_primitives_tpu.models import doa

    return doa


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _jit(fn, **static):
    """The JAX side under ``jax.jit`` (one XLA program a call)."""
    import jax

    return jax.jit(lambda *a: fn(*a, **static))


def _snapshots(rng, m=8, t_snap=512, deg=(-20.0, 25.0), snr_db=10.0, coherent=False):
    t = np.arange(t_snap)
    x = np.zeros((m, t_snap), np.complex128)
    base = np.exp(2j * np.pi * 0.0137 * t)
    for i, d in enumerate(deg):
        a = np.exp(-2j * np.pi * 0.5 * np.arange(m) * np.sin(np.deg2rad(d)))
        if coherent:
            s = base * (0.9 if i else 1.0)
        else:
            s = np.exp(2j * np.pi * rng.uniform(0.01, 0.45) * t + 2j * np.pi * rng.uniform())
        x += a[:, None] * s[None, :]
    namp = 10 ** (-snr_db / 20)
    x += namp * (rng.normal(size=x.shape) + 1j * rng.normal(size=x.shape)) / np.sqrt(2)
    return x.astype(np.complex64)


def _db(got, want):
    return evm_rms_db(np.asarray(got), np.asarray(want))


def test_steering_covariance_and_smoothing_match_jax(jdoa):
    th = np.array([-0.7, 0.0, 0.3, 1.2], np.float32)
    assert _db(tdoa.steering_vector(8, torch.from_numpy(th)), jdoa.steering_vector(8, th)) <= EVM_DB
    assert _db(tdoa.steering_vector(5, 0.4, 0.3), jdoa.steering_vector(5, 0.4, 0.3)) <= EVM_DB
    pos = np.stack([0.5 * np.arange(4), np.zeros(4), 0.5 * np.arange(4) % 1.0], axis=1)
    az = np.array([0.1, -0.5], np.float32)
    assert _db(tdoa.steering_vector_pos(pos, torch.from_numpy(az), 0.2),
               jdoa.steering_vector_pos(pos, az, 0.2)) <= EVM_DB
    ula = np.stack([0.5 * np.arange(8), np.zeros(8)], axis=1)
    np.testing.assert_allclose(tdoa.steering_vector_pos(ula, 0.3).numpy(),
                               tdoa.steering_vector(8, 0.3).numpy(), atol=1e-6)
    with pytest.raises(ValueError, match="positions"):
        tdoa.steering_vector_pos(np.zeros((4,)), 0.1)
    x = np.stack([_snapshots(np.random.default_rng(s)) for s in range(3)])
    r = tdoa.covariance(torch.from_numpy(x))
    assert r.shape == (3, 8, 8) and _db(r, jdoa.covariance(x)) <= EVM_DB
    assert _db(tdoa.spatial_smoothing(r, 3), jdoa.spatial_smoothing(np.asarray(r), 3)) <= EVM_DB


@pytest.mark.parametrize("method", ["music", "capon"])
def test_spectra_and_bearings_match_jax(jdoa, method):
    x = np.stack([_snapshots(np.random.default_rng(10 + w), deg=(-30.0 + 3 * w, 10.0 + 2 * w))
                  for w in range(4)])
    r = np.asarray(jdoa.covariance(x))
    if method == "music":
        ja, js = _jit(jdoa.music_spectrum, n_sources=2)(r)
        ta, ts = tdoa.music_spectrum(torch.from_numpy(r), 2)
    else:
        ja, js = _jit(jdoa.capon_spectrum)(r)
        ta, ts = tdoa.capon_spectrum(torch.from_numpy(r))
    assert np.array_equal(ta.numpy(), np.asarray(ja)) and ts.shape == (4, 721)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=SPEC_RTOL)
    got = tdoa.estimate_doa(torch.from_numpy(x), 2, method=method)
    want = np.asarray(_jit(jdoa.estimate_doa, n_sources=2, method=method)(x))
    assert got.shape == (4, 2)
    np.testing.assert_allclose(got.numpy(), want, atol=BEARING_ATOL)
    truth = np.deg2rad([[-30.0 + 3 * w, 10.0 + 2 * w] for w in range(4)])
    assert np.abs(got.numpy() - truth).max() < np.deg2rad(1.0)


def test_coherent_pair_with_smoothing_matches_jax(jdoa):
    x = _snapshots(np.random.default_rng(3), snr_db=20.0, coherent=True)
    got = tdoa.estimate_doa(torch.from_numpy(x), 2, smoothing=3)
    want = np.asarray(_jit(jdoa.estimate_doa, n_sources=2, smoothing=3)(x))
    np.testing.assert_allclose(got.numpy(), want, atol=BEARING_ATOL)
    np.testing.assert_allclose(np.rad2deg(got.numpy()), [-20.0, 25.0], atol=1.5)
    with pytest.raises(ValueError, match="unknown DOA method"):
        tdoa.estimate_doa(torch.from_numpy(x), 2, method="esprit")


def test_fewer_peaks_than_sources_ties_like_top_k(jdoa):
    # one source, three requested: the masked -inf entries tie, and the
    # lower grid index comes first, as in lax.top_k
    x = _snapshots(np.random.default_rng(4), deg=(12.0,), snr_db=30.0)
    r = np.asarray(jdoa.covariance(x))
    ja, js = _jit(jdoa.music_spectrum, n_sources=1, n_grid=61)(r)
    jpk = np.asarray(_jit(jdoa._peaks, n_sources=12)(ja, js))
    tpk = tdoa._peaks(torch.from_numpy(np.asarray(ja)), torch.from_numpy(np.asarray(js)), 12)
    np.testing.assert_allclose(tpk.numpy(), jpk, atol=BEARING_ATOL)


def test_2d_music_matches_jax(jdoa):
    rng = np.random.default_rng(5)
    px = np.stack([0.5 * np.arange(5), np.zeros(5), np.zeros(5)], axis=1)
    pz = np.stack([np.zeros(4), np.zeros(4), 0.5 * np.arange(1, 5)], axis=1)
    pos = np.concatenate([px, pz])
    src = [(np.deg2rad(-15.0), np.deg2rad(10.0)), (np.deg2rad(30.0), np.deg2rad(-20.0))]
    t = np.arange(400)
    x = np.zeros((9, 400), np.complex64)
    for az0, el0 in src:
        a = tdoa.steering_vector_pos(pos, az0, el0).numpy()
        x += a[:, None] * np.exp(2j * np.pi * rng.uniform(0.05, 0.45) * t)[None, :]
    x = (x + 0.2 * (rng.normal(size=x.shape) + 1j * rng.normal(size=x.shape))).astype(np.complex64)
    r = np.asarray(jdoa.covariance(x))
    jaz, jel, js = _jit(jdoa.music_spectrum_2d, n_sources=2, positions=pos, n_az=61, n_el=31)(r)
    taz, tel, ts = tdoa.music_spectrum_2d(torch.from_numpy(r), 2, pos, n_az=61, n_el=31)
    assert np.array_equal(taz.numpy(), np.asarray(jaz))
    assert np.array_equal(tel.numpy(), np.asarray(jel))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=SPEC_RTOL)
    got = tdoa.estimate_doa_2d(torch.from_numpy(x), 2, pos, n_az=61, n_el=31)
    want = _jit(jdoa.estimate_doa_2d, n_sources=2, positions=pos, n_az=61, n_el=31)(x)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=BEARING_ATOL)
    np.testing.assert_allclose(np.rad2deg(got.numpy()), np.rad2deg(sorted(src)), atol=3.5)


def test_beamform_and_mvdr_match_jax(jdoa):
    x = _snapshots(np.random.default_rng(6))
    assert _db(tdoa.beamform(torch.from_numpy(x), -0.3), jdoa.beamform(x, -0.3)) <= EVM_DB
    r = np.asarray(jdoa.covariance(x))
    th = np.deg2rad(-20.0)
    w = tdoa.mvdr_weights(torch.from_numpy(r), th)
    assert _db(w, jdoa.mvdr_weights(r, th)) <= EVM_DB
    a1 = tdoa.steering_vector(8, np.deg2rad(25.0)).numpy()
    a0 = tdoa.steering_vector(8, th).numpy()
    g0, g1 = abs(np.vdot(w.numpy(), a0)), abs(np.vdot(w.numpy(), a1))
    assert abs(g0 - 1.0) < 1e-3 and 20 * np.log10(g1 / g0) < -25


def test_sharded_estimate_doa_matches(jdoa, eight_devices):
    from aether_primitives_tpu.parallel import mesh as jmesh

    wins = np.stack([_snapshots(np.random.default_rng(20 + w), deg=(-40.0 + 5 * w, 5.0 + 4 * w))
                     for w in range(16)])
    mesh = tmesh.make_mesh({"channel": 8}, ["cpu"] * 8)
    sharded = tdoa.sharded_estimate_doa(torch.from_numpy(wins), 2, mesh)
    assert isinstance(sharded, tmesh.Sharded) and sharded.shape == (16, 2)
    single = tdoa.estimate_doa(torch.from_numpy(wins), 2)
    assert torch.equal(sharded.gather(), single)
    want = np.asarray(_jit(jdoa.sharded_estimate_doa, n_sources=2,
                           mesh=jmesh.make_mesh({"channel": 8}))(wins))
    np.testing.assert_allclose(sharded.gather().numpy(), want, atol=BEARING_ATOL)
    capon = tdoa.sharded_estimate_doa(torch.from_numpy(wins), 2, mesh, method="capon")
    assert torch.equal(capon.gather(), tdoa.estimate_doa(torch.from_numpy(wins), 2, method="capon"))
    with pytest.raises(ValueError, match="divide"):
        tdoa.sharded_estimate_doa(torch.from_numpy(wins[:3]), 2, mesh)
    with pytest.raises(ValueError, match="windows"):
        tdoa.sharded_estimate_doa(torch.from_numpy(wins[0]), 2, mesh)


@pytest.mark.cuda
def test_card_matches_cpu(cuda):
    wins = np.stack([_snapshots(np.random.default_rng(30 + w), m=16, t_snap=1024,
                                deg=(-35.0 + 4 * w, 12.0 + 3 * w)) for w in range(8)])
    for method in ("music", "capon"):
        got = tdoa.estimate_doa(torch.from_numpy(wins).to(cuda), 2, method=method)
        want = tdoa.estimate_doa(torch.from_numpy(wins), 2, method=method)
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=BEARING_ATOL)
    r = tdoa.covariance(torch.from_numpy(wins).to(cuda))
    assert _db(r.cpu().numpy(), tdoa.covariance(torch.from_numpy(wins)).numpy()) <= EVM_DB
