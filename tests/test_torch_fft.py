"""The port's FFT layer (torch.fft) against ``aether_primitives_tpu.ops.fft``.

Tolerances: random data is held by RMS EVM <= -120 dB against the JAX
package (40 dB inside the -80 dB contract). ``assert_evm``'s per-element
-80 dB limit is 1e-8 of each bin's magnitude, below float32 resolution for
bins near zero, so it holds exactly computable outputs here (constants, DC
bins, the SN round trip), as in the JAX package's own FFT tests.
"""

import numpy as np
import pytest
import torch

from aether_primitives_tpu.ops import fft as jfft
from aether_primitives_tpu_torch import assert_evm
from aether_primitives_tpu_torch.evm import evm_rms_db
from aether_primitives_tpu_torch.ops import fft as tfft

torch.set_num_threads(1)

SCALES = ["none", "sn", "n", "x"]


def _scales(kind):
    if kind == "x":
        return tfft.Scale.X(0.37), jfft.Scale.X(0.37)
    return tfft.Scale(kind), jfft.Scale(kind)


def _signal(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)


@pytest.mark.parametrize("n", [64, 2048, 12])
@pytest.mark.parametrize("kind", SCALES)
@pytest.mark.parametrize("direction", ["fft", "ifft"])
def test_matches_jax(direction, kind, n):
    ts, js = _scales(kind)
    x = _signal((3, n), n)
    got = getattr(tfft, direction)(torch.from_numpy(x), ts).numpy()
    want = np.asarray(getattr(jfft, direction)(x, js, backend="xla"))
    assert got.dtype == np.complex64 and got.shape == want.shape
    assert evm_rms_db(got, want) <= -120


@pytest.mark.parametrize("kind", SCALES)
def test_plan_fwd_bwd_match_jax(kind):
    ts, js = _scales(kind)
    x = _signal((2, 256), 5)
    p, q = tfft.plan(256), jfft.plan(256, "xla")
    assert evm_rms_db(p.fwd(torch.from_numpy(x), ts).numpy(), np.asarray(q.fwd(x, js))) <= -120
    assert evm_rms_db(p.bwd(torch.from_numpy(x), ts).numpy(), np.asarray(q.bwd(x, js))) <= -120


def test_scale_policy_exact():
    x = torch.full((4,), 4.0 + 0j, dtype=torch.complex64)
    assert_evm(tfft.Scale.NONE.apply(x).numpy(), x.numpy())
    assert_evm(tfft.Scale.SN.apply(x).numpy(), np.full(4, 2.0 + 0j))
    assert_evm(tfft.Scale.N.apply(x).numpy(), np.full(4, 1.0 + 0j))
    assert_evm(tfft.Scale.X(2.0).apply(x).numpy(), np.full(4, 8.0 + 0j))


def test_dc_bin_and_sn_round_trip():
    ones = torch.ones(128, dtype=torch.complex64)
    out = tfft.fft(ones).numpy()
    assert_evm(out[:1], np.array([128.0 + 0j]), -80.0)
    assert np.abs(out[1:]).max() <= 1e-4
    # the JAX package's round trip on a constant block, at its -80 dB
    x = torch.full((100,), 1.0 + 1.0j, dtype=torch.complex64)
    p = tfft.plan(100)
    back = p.bwd(p.fwd(x, tfft.Scale.SN), tfft.Scale.SN).numpy()
    assert_evm(back, x.numpy(), -80.0)
    # and its chained-scale example at its -72 dB
    y = torch.ones(128, dtype=torch.complex64)
    q = tfft.plan(128)
    out = q.bwd(q.fwd(y, tfft.Scale.SN) * 2.0, tfft.Scale.SN).numpy()
    assert_evm(out, np.full(128, 2.0 + 0j), -72.0)
    # random data round-trips within the RMS bound
    z = _signal(128, 9)
    back = q.bwd(q.fwd(torch.from_numpy(z), tfft.Scale.SN), tfft.Scale.SN).numpy()
    assert evm_rms_db(back, z) <= -120


def test_unnormalised_backward():
    x = _signal(64, 4)
    got = tfft.ifft(torch.from_numpy(x)).numpy()
    ref = np.fft.ifft(x.astype(np.complex128)) * 64
    assert evm_rms_db(got, ref) <= -120


@pytest.mark.parametrize("dec", [1, 4])
def test_fft_of_decimated_matches_jax(dec):
    x = _signal((2, 3, 256 * dec), 7)
    got = tfft.fft_of_decimated(torch.from_numpy(x), dec, tfft.Scale.SN).numpy()
    want = np.asarray(jfft.fft_of_decimated(x, dec, jfft.Scale.SN, backend="xla"))
    assert got.shape == want.shape
    assert evm_rms_db(got, want) <= -120
    with pytest.raises(ValueError):
        tfft.fft_of_decimated(torch.from_numpy(x[..., :-1]), 4)


def test_plan_length_check_and_cache():
    with pytest.raises(ValueError):
        tfft.plan(8).fwd(torch.zeros(7, dtype=torch.complex64))
    assert tfft.plan(64) is tfft.plan(64)
    assert len(tfft.plan(64)) == 64
