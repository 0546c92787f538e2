"""The port's frequency hopper (``models/fhss.py``) against the JAX
package's, on the same seeded numpy inputs.

Tolerances: hop sequences and rotators exact (the same host float64
arithmetic); hopped signals RMS EVM <= -100 dB against the JAX package's
(one complex64 multiply each); the dehop of the hop gives back the input
at the same bar; the config carried by ``convert`` equal, an unknown field
refused. The ``cuda`` case holds the card to the CPU run and checks that
the rotators are made once per configuration and device.
"""

import dataclasses

import numpy as np
import pytest
import torch

from aether_primitives_tpu_torch import convert
from aether_primitives_tpu_torch.evm import evm_rms_db
from aether_primitives_tpu_torch.models import fhss as tfhss

torch.set_num_threads(1)

EVM_DB = -100.0


@pytest.fixture(scope="module")
def jfhss():
    pytest.importorskip("jax")
    from aether_primitives_tpu.models import fhss

    return fhss


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _carry(jfhss, **fields):
    jcfg = jfhss.FhssConfig(**fields)
    return jcfg, convert.fhss_config_from_numpy(dataclasses.asdict(jcfg))


def test_config_carries_and_refuses_unknown_fields(jfhss):
    jcfg, cfg = _carry(jfhss, n_channels=79, dwell=625, cinit=0x123, spacing=1e-3)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.channel_spacing == jcfg.channel_spacing
    with pytest.raises(ValueError, match="no fields"):
        convert.fhss_config_from_numpy({"dwell": 8, "hop_rate": 1.0})


@pytest.mark.parametrize("fields", [dict(n_channels=8, dwell=128), dict(n_channels=79, dwell=625),
                                    dict(n_channels=10, dwell=32, cinit=0x123, spacing=0.02)])
def test_hop_matches_jax(jfhss, fields):
    jcfg, cfg = _carry(jfhss, **fields)
    n_hops = 24
    assert np.array_equal(tfhss.hop_sequence(cfg, 200), jfhss.hop_sequence(jcfg, 200))
    for conj in (False, True):
        assert np.array_equal(tfhss._dwell_rotators(cfg, n_hops, conj),
                              jfhss._dwell_rotators(jcfg, n_hops, conj))
    rng = np.random.default_rng(fields["dwell"])
    n = n_hops * cfg.dwell
    x = (rng.normal(size=(2, n)) + 1j * rng.normal(size=(2, n))).astype(np.complex64)
    y = tfhss.hop_spread(torch.from_numpy(x), cfg)
    assert y.dtype == torch.complex64 and y.shape == (2, n)
    assert evm_rms_db(y.numpy(), np.asarray(jfhss.hop_spread(x, jcfg))) <= EVM_DB
    back = tfhss.hop_despread(y, cfg)
    assert evm_rms_db(back.numpy(), np.asarray(jfhss.hop_despread(np.asarray(y), jcfg))) <= EVM_DB
    assert evm_rms_db(back.numpy(), x) <= EVM_DB
    with pytest.raises(ValueError, match="multiple of the dwell"):
        tfhss.hop_spread(torch.zeros(cfg.dwell + 1, dtype=torch.complex64), cfg)


@pytest.mark.cuda
def test_card_matches_cpu(cuda):
    cfg = tfhss.FhssConfig(n_channels=79, dwell=625)
    rng = np.random.default_rng(6400)
    x = torch.from_numpy((rng.normal(size=640 * 625) + 1j * rng.normal(size=640 * 625)).astype(
        np.complex64))
    y = tfhss.hop_spread(x.to(cuda), cfg)
    assert evm_rms_db(y.cpu().numpy(), tfhss.hop_spread(x, cfg).numpy()) <= EVM_DB
    misses = tfhss._device_rotators.cache_info().misses
    back = tfhss.hop_despread(tfhss.hop_spread(x.to(cuda), cfg), cfg)
    assert tfhss._device_rotators.cache_info().misses == misses + 1  # the dehop's, once
    assert evm_rms_db(back.cpu().numpy(), x.numpy()) <= EVM_DB
