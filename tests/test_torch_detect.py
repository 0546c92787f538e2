"""The port's detectors (``models/detect.py``) against the JAX package's,
on the same seeded numpy inputs.

Tolerances: detection flags, masks and segments exact; the threshold
factor equal; block powers and the cyclostationary statistic rtol 1e-5;
the cyclostationary rate exact (a bin index over the transform length);
CFAR noise levels within 8 float32 epsilons of the row's total power per
training cell: they are differences of a float32 cumulative sum, whose
rounding floor that is in either package (both sit within 3 of it against
float64 here, ROADMAP.md §3.16).
"""

import numpy as np
import pytest
import torch

from aether_primitives_tpu_torch.models import detect as tdet
from aether_primitives_tpu_torch.ops import fir as tfir

torch.set_num_threads(1)

RTOL = 1e-5
CFAR_EPS = 8  # float32 epsilons of the cumulative sum, per training cell


@pytest.fixture(scope="module")
def jdet():
    pytest.importorskip("jax")
    from aether_primitives_tpu.models import detect

    return detect


def _noise(n, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (scale * (rng.normal(size=n) + 1j * rng.normal(size=n)) / np.sqrt(2)).astype(
        np.complex64)


def test_energy_detect_matches_jax(jdet):
    bl = 64
    x = np.stack([_noise(256 * bl, 1), _noise(256 * bl, 2)])
    x[0, 100 * bl:110 * bl] += 1.5  # +3.5 dB over 10 blocks
    for pfa in (1e-4, 1e-2):
        assert tdet.energy_threshold_factor(bl, pfa) == jdet.energy_threshold_factor(bl, pfa)
        jd, jp = jdet.energy_detect(x, bl, noise_power=1.0, pfa=pfa)
        td, tp = tdet.energy_detect(torch.from_numpy(x), bl, noise_power=1.0, pfa=pfa)
        assert td.dtype == torch.bool and np.array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=RTOL)
    assert set(range(100, 110)) <= set(np.where(td.numpy()[0])[0].tolist())
    with pytest.raises(ValueError, match="divisible"):
        tdet.energy_detect(torch.ones(100, dtype=torch.complex64), 33, 1.0)


@pytest.mark.parametrize("train,guard,pfa", [(16, 2, 1e-4), (32, 2, 1e-2), (4, 0, 1e-3)])
def test_ca_cfar_matches_jax(jdet, train, guard, pfa):
    rng = np.random.default_rng(train)
    p = rng.exponential(scale=np.linspace(1.0, 10.0, 8192)).astype(np.float32)
    p[1000] = p[3000] = 80.0
    rows = np.stack([p, p[::-1].copy()])
    jd, jn = jdet.ca_cfar(rows, train=train, guard=guard, pfa=pfa)
    td, tn = tdet.ca_cfar(torch.from_numpy(rows), train=train, guard=guard, pfa=pfa)
    assert np.array_equal(td.numpy(), np.asarray(jd))
    i, n = np.arange(8192), 8192
    count = (np.clip(i - guard, 0, n) - np.clip(i - train - guard, 0, n)
             + np.clip(i + train + guard + 1, 0, n) - np.clip(i + guard + 1, 0, n))
    floor = CFAR_EPS * np.finfo(np.float32).eps * rows.sum(-1, dtype=np.float64)[:, None]
    assert np.all(np.abs(tn.numpy() - np.asarray(jn)) <= floor / np.maximum(count, 1))
    assert td[0, 1000] and td[0, 3000]


def test_burst_mask_and_segments_match_jax(jdet):
    bl = 32
    x = (0.1 * np.sqrt(2) * _noise(64 * bl, 5)).astype(np.complex64)
    x[10 * bl:14 * bl] += 1.0
    x[40 * bl:41 * bl] += 1.0
    jm = np.asarray(jdet.burst_mask(x, bl, noise_power=0.02, pfa=1e-6))
    tm = tdet.burst_mask(torch.from_numpy(x), bl, noise_power=0.02, pfa=1e-6)
    assert np.array_equal(tm.numpy(), jm)
    segs = tdet.mask_to_segments(tm)
    assert np.array_equal(segs, jdet.mask_to_segments(jm))
    assert segs.tolist() == [[10 * bl, 14 * bl], [40 * bl, 41 * bl]]


def test_cyclostationary_detect_matches_jax(jdet):
    # tests/test_detect.py's batched case: an RRC-shaped BPSK stream at sps 4
    # with noise beside noise alone; the band holds an even count of bins
    rng = np.random.default_rng(17)
    s = (1.0 - 2.0 * rng.integers(0, 2, 8192)).astype(np.complex64)
    up = np.zeros(8192 * 4, np.complex64)
    up[::4] = s
    sig = tfir.fir_filter(torch.from_numpy(up), tfir.rrc_taps(4, span=6)).numpy()
    noise = _noise(sig.size, 18, np.sqrt(2))
    x = np.stack([sig + 0.3 * noise, noise]).astype(np.complex64)
    for kw in ({}, {"baud_min": 0.1, "osr": 2}):
        jstat, jrate = jdet.cyclostationary_detect(x, **kw)
        tstat, trate = tdet.cyclostationary_detect(torch.from_numpy(x), **kw)
        assert tstat.dtype == trate.dtype == torch.float32 and tstat.shape == (2,)
        np.testing.assert_allclose(tstat.numpy(), np.asarray(jstat), rtol=RTOL)
        assert np.array_equal(trate.numpy()[0], np.asarray(jrate)[0])
        if not kw:
            assert float(tstat[0]) > 3.0 * float(tstat[1]) and abs(float(trate[0]) - 0.25) < 1e-3
