"""The port's plain FIR ops against ``aether_primitives_tpu.ops.fir``.

Tolerance: RMS EVM <= -80 dB against the JAX package (the EVM contract;
both sides compute in float32 and land near -130 dB), and against the
float64 golden where one is given.
"""

import numpy as np
import pytest
import torch

from aether_primitives_tpu.models.modem import _default_lowpass
from aether_primitives_tpu.ops import fir as jfir
from aether_primitives_tpu_torch.evm import evm_rms_db
from aether_primitives_tpu_torch.ops import fir as tfir
from aether_primitives_tpu_torch.ops.fft import Scale

torch.set_num_threads(1)

EVM_DB = -80.0


def _signal(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)


def _taps(k, seed=None):
    if seed is None:
        return _default_lowpass(k, 1.0 / 8)
    rng = np.random.default_rng(seed)
    return (rng.normal(size=k) + 1j * rng.normal(size=k)).astype(np.complex64)


# (taps, dec, fft_len, frames): the test size, the flagship, complex taps
# at another decimation, and a geometry without a two-stage split (FFT path)
CASES = [
    (_taps(65), 4, 256, 8),
    (_taps(65), 4, 2048, 2),
    (_taps(17, seed=5), 2, 128, 4),
    (_taps(65), 4, 8192, 2),
]
IDS = ["dec4-256", "dec4-2048", "dec2-128-complex", "dec4-8192-fft"]


@pytest.mark.parametrize("history", [False, True], ids=["zero", "history"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_fir_decimate_fft_matches_jax(case, history):
    taps, dec, fft_len, frames = case
    k = taps.shape[-1]
    x = _signal((2, dec * fft_len * frames), fft_len + dec)
    h = _signal((2, k - 1), 3) if history else None
    got = tfir.fir_decimate_fft(
        torch.from_numpy(x), taps, dec, fft_len, Scale.SN,
        history=None if h is None else torch.from_numpy(h),
    ).numpy()
    want = np.asarray(jfir.fir_decimate_fft(
        x, taps, dec, fft_len, jfir.Scale.SN, history=h, fft_backend="matmul",
    ))
    assert got.shape == want.shape == (2, frames, fft_len)
    assert evm_rms_db(got, want) <= EVM_DB
    # and against the float64 chain on the history-extended input
    ext = x if h is None else np.concatenate([h, x], axis=-1)
    for row in range(2):
        y = np.convolve(ext[row].astype(np.complex128), taps.astype(np.complex128))
        y = y[k - 1:k - 1 + x.shape[-1]] if h is not None else y[:x.shape[-1]]
        ref = np.fft.fft(y[::dec].reshape(frames, fft_len), axis=-1) / np.sqrt(fft_len)
        assert evm_rms_db(got[row], ref) <= EVM_DB


@pytest.mark.parametrize("history", [False, True], ids=["zero", "history"])
@pytest.mark.parametrize("case", CASES[:3], ids=IDS[:3])
def test_staged_layout_matches_jax(case, history):
    taps, dec, fft_len, frames = case
    k = taps.shape[-1]
    x = _signal(dec * fft_len * frames, fft_len)
    h = _signal(k - 1, 4) if history else None
    got = tfir.fir_decimate_fft(
        torch.from_numpy(x), taps, dec, fft_len,
        history=None if h is None else torch.from_numpy(h), _staged_layout=True,
    ).numpy()
    want = np.asarray(jfir.fir_decimate_fft(
        x, taps, dec, fft_len, history=h, fft_backend="matmul",
        _staged_layout=True,
    ))
    n1 = tfir._fused_stage_n1(dec, fft_len)
    assert got.shape == want.shape == (n1, frames, fft_len // n1)
    assert evm_rms_db(got, want) <= EVM_DB


def test_stage_n1_override_matches_jax():
    taps = _taps(65)
    x = _signal(4 * 256 * 4, 8)
    got = tfir.fir_decimate_fft(torch.from_numpy(x), taps, 4, 256, stage_n1=16).numpy()
    want = np.asarray(jfir.fir_decimate_fft(x, taps, 4, 256, fft_backend="matmul",
                                            stage_n1=16))
    assert evm_rms_db(got, want) <= EVM_DB


def test_fir_decimate_fft_rejects_bad_shapes():
    taps = _taps(65)
    with pytest.raises(ValueError):
        tfir.fir_decimate_fft(torch.zeros(1000, dtype=torch.complex64), taps, 4, 256)
    with pytest.raises(ValueError):
        tfir.fir_decimate_fft(torch.zeros(64, dtype=torch.complex64),
                              np.ones(70, np.complex64), 4, 16)
    with pytest.raises(ValueError):
        tfir.fir_decimate_fft(torch.zeros(4 * 8192, dtype=torch.complex64), taps,
                              4, 8192, _staged_layout=True)
    with pytest.raises(ValueError):
        tfir.fir_decimate_fft(torch.zeros(1024, dtype=torch.complex64), taps, 4, 256,
                              history=torch.zeros(10, dtype=torch.complex64))


@pytest.mark.parametrize("k", [1, 65])
def test_fir_filter_matches_jax_and_golden(k):
    taps = _taps(k, seed=9)
    x = _signal((2, 3000), 10)
    got = tfir.fir_filter(torch.from_numpy(x), taps).numpy()
    want = np.asarray(jfir.fir_filter(x, taps))
    assert evm_rms_db(got, want) <= EVM_DB
    for row in range(2):
        gold = np.convolve(x[row].astype(np.complex128), taps.astype(np.complex128))[:3000]
        assert evm_rms_db(got[row], gold) <= EVM_DB


def test_fir_filter_history_continues_a_stream():
    taps = _taps(65)
    x = _signal(4000, 11)
    whole = tfir.fir_filter(torch.from_numpy(x), taps).numpy()
    a = tfir.fir_filter(torch.from_numpy(x[:1500]), taps).numpy()
    b = tfir.fir_filter(torch.from_numpy(x[1500:]), taps,
                        history=torch.from_numpy(x[1500 - 64:1500])).numpy()
    want = np.asarray(jfir.fir_filter_decimate(x[1500 - 64:], taps, 1, padding="valid"))
    assert evm_rms_db(b, want) <= EVM_DB
    assert evm_rms_db(np.concatenate([a, b]), whole) <= -120
