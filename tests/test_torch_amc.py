"""The port's modulation classifier (``models/amc.py``) against the JAX
package's, on the same seeded numpy inputs.

Tolerances: ``SIGNATURES`` equal (built from the port's own tables);
features and scores within rtol 1e-4, and 1e-5 absolute: the winning
candidate's score is a residual near zero (1e-4 to 1e-2), a difference of
features ~1.5 whose float32 means round ~1e-6 apart in another summation
order (the CPU against the JAX package: 7e-7; the card against the CPU:
1.6e-6 on a score of 1.3e-3); names exact. The ``cuda`` case holds the card
to the CPU run.
"""

import numpy as np
import pytest
import torch

from aether_primitives_tpu_torch.models import amc as tamc
from aether_primitives_tpu_torch.ops import modulation as tmod

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
MODS = {"bpsk": tmod.bpsk, "qpsk": tmod.qpsk, "psk8": lambda: tmod.psk(8),
        "qam16": tmod.qam16, "qam64": lambda: tmod.qam(64)}


@pytest.fixture(scope="module")
def jamc():
    pytest.importorskip("jax")
    from aether_primitives_tpu.models import amc

    return amc


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _bursts(names, n, snr_db, seed):
    """One burst a name: ``n`` symbols at ``snr_db``, a random phase."""
    rng = np.random.default_rng(seed)
    rows = []
    for name in names:
        m = MODS[name]()
        bits = rng.integers(0, 2, n * m.bits_per_symbol).astype(np.uint8)
        s = m.modulate(torch.from_numpy(bits)).numpy()
        sigma = np.sqrt(np.mean(np.abs(s) ** 2) / 10 ** (snr_db / 10) / 2)
        noisy = s + sigma * (rng.normal(size=n) + 1j * rng.normal(size=n))
        rows.append(noisy * np.exp(2j * np.pi * rng.uniform()))
    return np.stack(rows).astype(np.complex64)


def test_signatures_equal_jax(jamc):
    assert tamc.SIGNATURES == jamc.SIGNATURES


def test_features_and_classification_match_jax(jamc):
    names = list(MODS) * 2
    x = _bursts(names, 8192, 15.0, 1)
    feats = tamc.cumulant_features(torch.from_numpy(x))
    assert feats.shape == (10, 4) and feats.dtype == torch.float32
    import jax

    np.testing.assert_allclose(feats.numpy(), np.asarray(jax.jit(jamc.cumulant_features)(x)),
                               rtol=RTOL, atol=ATOL)
    got, scores = tamc.classify_modulation(torch.from_numpy(x))
    want, jscores = jamc.classify_modulation(x)
    assert got == want and isinstance(scores, np.ndarray) and scores.shape == (10, 5)
    np.testing.assert_allclose(scores, jscores, rtol=RTOL, atol=ATOL)
    assert sum(g == n for g, n in zip(got, names)) >= 9


def test_single_block_and_candidates_match_jax(jamc):
    x = _bursts(["psk8"], 4096, 8.0, 2)[0]
    cands = ("bpsk", "qpsk", "psk8")
    got, scores = tamc.classify_modulation(torch.from_numpy(x), candidates=cands)
    want, jscores = jamc.classify_modulation(x, candidates=cands)
    assert got == want == "psk8" and scores.shape == (3,)
    np.testing.assert_allclose(scores, jscores, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_card_matches_cpu(cuda):
    x = torch.from_numpy(_bursts(list(MODS) * 4, 16384, 18.0, 3))
    got, scores = tamc.classify_modulation(x.to(cuda))
    want, hscores = tamc.classify_modulation(x)
    assert got == want
    np.testing.assert_allclose(scores, hscores, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tamc.cumulant_features(x.to(cuda)).cpu().numpy(),
                               tamc.cumulant_features(x).numpy(), rtol=RTOL, atol=ATOL)
