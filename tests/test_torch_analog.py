"""The port's analog modes (``ops/analog.py``) against the JAX package's
and float64 goldens, on the same seeded numpy inputs.

Tolerances: RMS EVM <= -100 dB for every output. ``fm_mod`` is held to a
float64 golden of the same phase sum, and to the JAX package only at a
deviation where the JAX package's own float32 cumulative sum stays within
that bar (ROADMAP.md §3.14: at deviation 0.1 over 16,384 samples it sits
at -89 dB against float64, the port at -117 dB).
"""

import numpy as np
import pytest
import torch

from aether_primitives_tpu_torch.evm import evm_rms_db
from aether_primitives_tpu_torch.ops import analog as tan

torch.set_num_threads(1)

EVM_DB = -100.0


@pytest.fixture(scope="module")
def jan():
    pytest.importorskip("jax")
    from aether_primitives_tpu.ops import analog

    return analog


def _message(n):
    t = np.arange(n)
    return (0.6 * np.sin(2 * np.pi * 0.003 * t)
            + 0.3 * np.sin(2 * np.pi * 0.011 * t + 1.0)).astype(np.float32)


def _f64_fm(m, dev, phase0=0.0):
    cycles = np.cumsum(np.float64(np.float32(dev)) * m.astype(np.float64), axis=-1)
    return np.exp(1j * (phase0 + 2 * np.pi * cycles))


@pytest.mark.parametrize("dev,n", [(0.1, 1 << 14), (0.05, 3000), (0.2, 700)])
def test_fm_mod_matches_a_float64_golden(dev, n):
    m = _message(n)
    got = tan.fm_mod(torch.from_numpy(m), dev, phase0=0.4)
    assert got.dtype == torch.complex64 and got.shape == (n,)
    assert evm_rms_db(got.numpy(), _f64_fm(m, dev, 0.4)) <= EVM_DB
    rows = np.stack([m, -m])
    assert evm_rms_db(tan.fm_mod(torch.from_numpy(rows), dev).numpy(), _f64_fm(rows, dev)) <= EVM_DB


def test_fm_matches_jax(jan):
    m = _message(1 << 14)
    jy = np.array(jan.fm_mod(m, 0.01))
    assert evm_rms_db(tan.fm_mod(torch.from_numpy(m), 0.01).numpy(), jy) <= EVM_DB
    y = np.asarray(jan.fm_mod(m, 0.1)) * (1.0 + 0.5 * np.sin(np.arange(m.size) * 0.004))
    y = y.astype(np.complex64)
    got = tan.fm_demod(torch.from_numpy(y), 0.1)
    assert got.dtype == torch.float32
    assert evm_rms_db(got.numpy(), np.asarray(jan.fm_demod(y, 0.1))) <= EVM_DB
    # m[0] takes its step from 1+0j
    assert np.isclose(float(got[0]), np.angle(y[0]) / (2 * np.pi * 0.1), atol=1e-6)


def test_fm_long_block_keeps_the_phase():
    # tests/test_analog.py's 1M-sample case: +0.2 cycles/sample throughout
    n, dev = 1 << 20, 0.25
    y = tan.fm_mod(torch.full((n,), 0.8), dev)
    back = tan.fm_demod(y, dev)
    assert float((back[-1000:] - 0.8).abs().max()) < 1e-3


def test_am_matches_jax(jan):
    m = _message(4096)
    for f in (0.0, 0.013):
        y = tan.am_mod(torch.from_numpy(m), 0.5, f)
        jy = np.array(jan.am_mod(m, 0.5, f))
        assert evm_rms_db(y.numpy(), jy) <= EVM_DB
        assert evm_rms_db(tan.am_demod(torch.from_numpy(jy), 0.5).numpy(),
                          np.asarray(jan.am_demod(jy, 0.5))) <= EVM_DB


@pytest.mark.parametrize("n", [1024, 1001])
def test_analytic_signal_matches_jax(jan, n):
    m = np.stack([_message(n), np.cos(0.3 * np.arange(n)).astype(np.float32)])
    got = tan.analytic_signal(torch.from_numpy(m), fft_backend="xla")
    assert evm_rms_db(got.numpy(), np.asarray(jan.analytic_signal(m))) <= EVM_DB
    with pytest.raises(ValueError, match="matmul"):
        tan.analytic_signal(torch.from_numpy(m), fft_backend="matmul")


@pytest.mark.parametrize("sideband", ["upper", "lower"])
@pytest.mark.parametrize("carrier", [0.0, 0.05])
def test_ssb_matches_jax(jan, sideband, carrier):
    m = _message(2048)
    y = tan.ssb_modulate(torch.from_numpy(m), carrier, sideband)
    jy = np.array(jan.ssb_modulate(m, carrier, sideband))
    assert evm_rms_db(y.numpy(), jy) <= EVM_DB
    back = tan.ssb_demodulate(torch.from_numpy(jy), carrier, sideband)
    assert back.dtype == torch.float32
    assert evm_rms_db(back.numpy(), np.asarray(jan.ssb_demodulate(jy, carrier, sideband))) <= EVM_DB
    assert evm_rms_db(back.numpy(), m) <= -60.0  # the round trip, up to edge leakage
    with pytest.raises(ValueError, match="sideband"):
        tan.ssb_modulate(torch.from_numpy(m), carrier, "both")
