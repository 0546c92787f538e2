"""The port's CPFSK/MSK/GMSK modem and OQPSK (``models/fsk.py``) against
the JAX package's, on the same seeded numpy inputs.

Tolerances: bits exact (at noise 0 and against the JAX package's
decisions under noise); modulated samples RMS EVM <= -100 dB against the
JAX package's; ``gaussian_pulse`` and the carried config equal. The
``cuda`` case holds ``FskModem`` on the card to its CPU run (bits exact,
samples <= -100 dB).
"""

import dataclasses

import numpy as np
import pytest
import torch

from aether_primitives_tpu_torch import convert
from aether_primitives_tpu_torch.evm import evm_rms_db
from aether_primitives_tpu_torch.models import FskConfig, FskModem
from aether_primitives_tpu_torch.models import fsk as tfsk

torch.set_num_threads(1)

EVM_DB = -100.0
CONFIGS = [FskConfig(), FskConfig(bt=0.3), FskConfig(sps=4, h=0.7), FskConfig(bt=0.5, pulse_span=2)]


@pytest.fixture(scope="module")
def jfsk():
    pytest.importorskip("jax")
    from aether_primitives_tpu.models import fsk

    return fsk


def _jit(fn):
    """The JAX side under ``jax.jit``: one XLA program a call, faster to
    compile than its eager ops."""
    import jax

    return jax.jit(fn)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _bits(n, seed):
    return np.random.default_rng(seed).integers(0, 2, n).astype(np.uint8)


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: f"sps{c.sps}-h{c.h}-bt{c.bt}")
def test_fsk_modem_matches_jax(jfsk, cfg):
    bits = _bits(1000, cfg.sps)
    jm = jfsk.FskModem(convert_back(jfsk, cfg))
    tm = FskModem(cfg, device="cpu")
    assert np.array_equal(tm.pulse, jm.pulse) and tm.deviation == jm.deviation
    jy = np.array(_jit(jm.modulate)(bits))
    ty = tm.modulate(torch.from_numpy(bits))
    assert ty.shape == jy.shape and ty.dtype == torch.complex64
    assert evm_rms_db(ty.numpy(), jy) <= EVM_DB
    got = tm.demodulate(ty)
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy()[:bits.size], bits)
    rng = np.random.default_rng(7)
    noisy = (jy + 0.3 * (rng.normal(size=jy.shape) + 1j * rng.normal(size=jy.shape))).astype(
        np.complex64)
    assert np.array_equal(tm.demodulate(torch.from_numpy(noisy)).numpy(),
                          np.asarray(_jit(jm.demodulate)(noisy)))
    assert torch.equal(tm(torch.from_numpy(bits)), ty)


def convert_back(jfsk, cfg):
    """The port's config as the JAX package's (the carried fields)."""
    return jfsk.FskConfig(**dataclasses.asdict(cfg))


def test_fsk_config_carries_from_jax(jfsk):
    for jcfg in (jfsk.FskConfig(), jfsk.FskConfig(sps=4, h=0.7, bt=0.3, pulse_span=2)):
        assert convert.fsk_config_from_numpy(dataclasses.asdict(jcfg)) == FskConfig(
            **dataclasses.asdict(jcfg))
    with pytest.raises(ValueError, match="no fields"):
        convert.fsk_config_from_numpy({"sps": 8, "baud": 9600})


@pytest.mark.parametrize("bt,sps,span", [(0.3, 8, 3), (0.5, 4, 2)])
def test_gaussian_pulse_equals_jax(jfsk, bt, sps, span):
    assert np.array_equal(tfsk.gaussian_pulse(bt, sps, span), jfsk.gaussian_pulse(bt, sps, span))


def test_fsk_modem_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="FskModem device 'cuda'"):
        FskModem()


@pytest.mark.parametrize("sps", [4, 8])
def test_oqpsk_matches_jax(jfsk, sps):
    bits = _bits(2000, sps + 1)
    jy = np.array(_jit(lambda b: jfsk.oqpsk_modulate(b, sps))(bits))
    ty = tfsk.oqpsk_modulate(torch.from_numpy(bits), sps)
    assert ty.shape == jy.shape and evm_rms_db(ty.numpy(), jy) <= EVM_DB
    got = tfsk.oqpsk_demodulate(ty, bits.size, sps)
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), bits)
    rng = np.random.default_rng(sps)
    noisy = (jy + 0.4 * (rng.normal(size=jy.shape) + 1j * rng.normal(size=jy.shape))).astype(
        np.complex64)
    assert np.array_equal(tfsk.oqpsk_demodulate(torch.from_numpy(noisy), bits.size, sps).numpy(),
                          np.asarray(_jit(lambda x: jfsk.oqpsk_demodulate(x, bits.size, sps))(noisy)))


def test_oqpsk_validation():
    with pytest.raises(ValueError, match="PAIRS"):
        tfsk.oqpsk_modulate(torch.ones(5, dtype=torch.uint8))
    with pytest.raises(ValueError, match="even"):
        tfsk.oqpsk_modulate(torch.ones(4, dtype=torch.uint8), sps=3)


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", CONFIGS[:2], ids=["msk", "gmsk"])
def test_cuda_fsk_modem_matches_the_cpu(cuda, cfg):
    bits = torch.from_numpy(_bits(4096, 3))
    card, host = FskModem(cfg, device=cuda), FskModem(cfg, device="cpu")
    y = card.modulate(bits.to(cuda))
    hy = host.modulate(bits)
    assert y.device.type == "cuda" and evm_rms_db(y.cpu().numpy(), hy.numpy()) <= EVM_DB
    got = card.demodulate(y)
    assert torch.equal(got.cpu(), host.demodulate(hy)) and torch.equal(got.cpu()[:4096], bits)
    oq = tfsk.oqpsk_modulate(bits.to(cuda))
    assert evm_rms_db(oq.cpu().numpy(), tfsk.oqpsk_modulate(bits).numpy()) <= EVM_DB
    assert torch.equal(tfsk.oqpsk_demodulate(oq, 4096).cpu(), bits)
