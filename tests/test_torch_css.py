"""The port's chirp modem (``models/css.py``) against the JAX package's, on
the same seeded numpy inputs.

Tolerances: chips RMS EVM <= -100 dB against the JAX package's (the
phase is exact int32 arithmetic, then float32 trig in the same order);
symbols, bits and the config carried by ``convert`` exact; peak
magnitudes rtol 1e-5. The ``cuda`` cases hold the card to the CPU run
and check that the modem defaults to the card.
"""

import dataclasses

import numpy as np
import pytest
import torch

from aether_primitives_tpu_torch import convert
from aether_primitives_tpu_torch.evm import evm_rms_db
from aether_primitives_tpu_torch.models import CssConfig, CssModem

torch.set_num_threads(1)

EVM_DB = -100.0


@pytest.fixture(scope="module")
def jcss():
    pytest.importorskip("jax")
    from aether_primitives_tpu.models import css

    return css


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _pair(jcss, sf):
    jcfg = jcss.CssConfig(sf=sf)
    cfg = convert.css_config_from_numpy(dataclasses.asdict(jcfg))
    return jcss.CssModem(jcfg), CssModem(cfg, device="cpu")


def test_config_carries_and_refuses_unknown_fields(jcss):
    for jcfg in (jcss.CssConfig(), jcss.CssConfig(sf=11, fft_backend="xla"),
                 jcss.CssConfig(sf=7, fft_backend="matmul")):
        cfg = convert.css_config_from_numpy(dataclasses.asdict(jcfg))
        assert cfg.sf == jcfg.sf and cfg.n_chips == jcfg.n_chips
        assert cfg.fft_backend == (None if jcfg.fft_backend == "matmul" else jcfg.fft_backend)
    with pytest.raises(ValueError, match="no fields"):
        convert.css_config_from_numpy({"sf": 7, "bandwidth": 125e3})


@pytest.mark.parametrize("sf", [6, 10])
def test_chips_symbols_and_bits_match_jax(jcss, sf):
    jm, tm = _pair(jcss, sf)
    assert np.array_equal(tm._upchirp.numpy(), jm._upchirp)
    rng = np.random.default_rng(sf)
    bits = rng.integers(0, 2, sf * 48).astype(np.uint8)
    import jax

    jchips = np.asarray(jax.jit(jm.tx)(bits))
    tchips = tm.tx(torch.from_numpy(bits))
    assert tchips.dtype == torch.complex64 and tchips.shape == jchips.shape
    assert evm_rms_db(tchips.numpy(), jchips) <= EVM_DB
    n = tchips.shape[-1]
    sigma = np.sqrt(10.0 / 2)  # -10 dB per chip
    noisy = (jchips + sigma * (rng.normal(size=n) + 1j * rng.normal(size=n))).astype(np.complex64)
    js, jp = jax.jit(jm.demod_symbols)(noisy)
    ts, tp = tm.demod_symbols(torch.from_numpy(noisy))
    assert ts.dtype == torch.int32 and np.array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-5)
    tb = tm.rx(torch.from_numpy(noisy))
    assert tb.dtype == torch.uint8 and np.array_equal(tb.numpy(), np.asarray(jax.jit(jm.rx)(noisy)))
    assert np.array_equal(tm.loopback(torch.from_numpy(bits)).numpy(), bits)


def test_shifted_chirp_identity_and_batch(jcss):
    jm, tm = _pair(jcss, 6)
    k = np.arange(64)
    u = np.exp(1j * np.pi * (k * k % 128) / 64)
    syms = np.array([[0, 1, 17, 63], [5, 9, 33, 2]])
    got = tm.modulate_symbols(torch.from_numpy(syms)).numpy().reshape(2, 4, 64)
    for r in range(2):
        for c, s in enumerate(syms[r]):
            assert np.abs(got[r, c] - np.roll(u, -s)).max() < 1e-5
    assert evm_rms_db(got.reshape(2, -1), np.asarray(jm.modulate_symbols(syms))) <= EVM_DB


def test_bad_lengths_raise(jcss):
    _, tm = _pair(jcss, 8)
    with pytest.raises(ValueError, match="sf"):
        tm.tx(torch.zeros(13, dtype=torch.uint8))
    with pytest.raises(ValueError, match="N"):
        tm.rx(torch.zeros(100, dtype=torch.complex64))


def test_modem_defaults_to_the_card():
    if torch.cuda.is_available():
        assert CssModem(CssConfig(sf=7)).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            CssModem(CssConfig(sf=7))


@pytest.mark.cuda
def test_card_matches_cpu(cuda):
    rng = np.random.default_rng(12)
    bits = torch.from_numpy(rng.integers(0, 2, 12 * 64).astype(np.uint8))
    card, host = CssModem(CssConfig(sf=12), device=cuda), CssModem(CssConfig(sf=12), device="cpu")
    chips = card.tx(bits)
    assert chips.device.type == "cuda"
    assert evm_rms_db(chips.cpu().numpy(), host.tx(bits).numpy()) <= EVM_DB
    n = chips.shape[-1]
    noisy = chips.cpu() + torch.from_numpy(
        (np.sqrt(15.0) * (rng.normal(size=n) + 1j * rng.normal(size=n))).astype(np.complex64))
    assert torch.equal(card.rx(noisy.to(cuda)).cpu(), host.rx(noisy))
