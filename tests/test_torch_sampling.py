"""The port's ``ops/sampling.py`` against the JAX package's on the same
seeded inputs: ``interpolate``, ``downsample`` and ``downsample_by`` equal
(the same float32 arithmetic, or a slice), ``resample_fft``,
``resample_poly``, ``fractional_delay`` and ``decimate`` at RMS EVM <=
-120 dB, ``_farrow_matrix`` ``np.array_equal`` to the original, and the
reference's own test vectors (tests/test_sampling.py) exact. ``dense=``
is accepted either way and changes nothing.
"""

import numpy as np
import pytest
import torch

from aether_primitives_tpu_torch.evm import evm_rms_db
from aether_primitives_tpu_torch.ops import sampling as ts

torch.set_num_threads(1)

EVM_DB = -120.0


@pytest.fixture(scope="module")
def js():
    pytest.importorskip("jax")
    from aether_primitives_tpu.ops import sampling

    return sampling


def _sig(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)


def test_reference_vectors():
    # reference src/sampling.rs tests, as tests/test_sampling.py runs them
    src = np.array([1 + 1j, 4 + 4j, 7 + 7j], np.complex64)
    got = ts.interpolate(torch.from_numpy(src), 2).numpy()
    assert np.array_equal(got, np.array([1, 2, 3, 4, 5, 6, 7], np.float32) * (1 + 1j))
    # the imaginary ramp starts from the imaginary base (the reference's typo fixed)
    src = np.array([0 + 10j, 3 + 13j], np.complex64)
    assert np.allclose(ts.interpolate(torch.from_numpy(src), 2).numpy(),
                       [0 + 10j, 1 + 11j, 2 + 12j, 3 + 13j])
    x = torch.arange(21, dtype=torch.float32).to(torch.complex64)
    assert torch.equal(ts.downsample(x, 7), x[::3])
    assert torch.equal(ts.downsample_by(x, 3), x[::3])
    with pytest.raises(ValueError):
        ts.downsample(torch.zeros(7, dtype=torch.complex64), 3)
    with pytest.raises(ValueError):
        ts.downsample_by(torch.zeros(7, dtype=torch.complex64), 2)


@pytest.mark.parametrize("n_between", [0, 1, 3, 7])
def test_interpolate_equal_to_jax(js, n_between):
    x = _sig((3, 257), 40)
    got = ts.interpolate(torch.from_numpy(x), n_between, dense=True).numpy()
    want = np.asarray(js.interpolate(x, n_between, dense=False))
    assert got.shape == want.shape == (3, 257 + 256 * n_between)
    assert np.array_equal(got, want)


def test_downsample_equal_to_jax(js):
    x = _sig((2, 4096), 41)
    for out_len in (4096, 1024, 512):
        got = ts.downsample(torch.from_numpy(x), out_len)
        assert got.is_contiguous()
        assert np.array_equal(got.numpy(), np.asarray(js.downsample(x, out_len, dense=False)))
    assert np.array_equal(ts.downsample_by(torch.from_numpy(x), 8, dense=True).numpy(),
                          np.asarray(js.downsample_by(x, 8)))


@pytest.mark.parametrize("n,out_len", [(256, 400), (255, 400), (256, 100), (255, 101),
                                       (300, 300)])
def test_resample_fft_against_jax(js, n, out_len):
    x = _sig((2, n), 42)
    got = ts.resample_fft(torch.from_numpy(x), out_len).numpy()
    want = np.asarray(js.resample_fft(x, out_len))
    assert got.shape == want.shape == (2, out_len)
    assert evm_rms_db(got, want) <= EVM_DB


@pytest.mark.parametrize("p,q", [(3, 2), (2, 3), (5, 4), (4, 6), (1, 1)])
def test_resample_poly_against_jax(js, p, q):
    assert np.array_equal(ts._farrow_matrix(p, q), js._farrow_matrix(p, q))
    x = _sig((2, 600), 43)
    got = ts.resample_poly(torch.from_numpy(x), p, q).numpy()
    want = np.asarray(js.resample_poly(x, p, q))
    assert got.shape == want.shape
    assert evm_rms_db(got, want) <= EVM_DB
    with pytest.raises(ValueError, match="divisible"):
        ts.resample_poly(torch.from_numpy(x[..., :599]), 3, 2)


def test_fractional_delay_against_jax(js):
    x = _sig((3, 512), 44)
    for tau in (0.37, -2.5, 3):
        got = ts.fractional_delay(torch.from_numpy(x), tau).numpy()
        assert evm_rms_db(got, np.asarray(js.fractional_delay(x, tau))) <= EVM_DB
    taus = np.array([0.25, -1.5, 7.75], np.float32)  # one delay a row, as a tensor
    got = ts.fractional_delay(torch.from_numpy(x), torch.from_numpy(taus)).numpy()
    assert evm_rms_db(got, np.asarray(js.fractional_delay(x, taus))) <= EVM_DB


@pytest.mark.parametrize("factor", [1, 2, 5, 8])
def test_decimate_against_jax(js, factor):
    x = _sig((2, 8000), 45)
    if factor > 1:
        assert np.array_equal(ts._decimate_taps(factor, 0.8, 60.0),
                              js._decimate_taps(factor, 0.8, 60.0))
    got = ts.decimate(torch.from_numpy(x), factor).numpy()
    want = np.asarray(js.decimate(x, factor))
    assert got.shape == want.shape
    assert evm_rms_db(got, want) <= EVM_DB
    with pytest.raises(ValueError):
        ts.decimate(torch.from_numpy(x), 4, cutoff=1.0)
    with pytest.raises(ValueError):
        ts.decimate(torch.from_numpy(x), 0)
