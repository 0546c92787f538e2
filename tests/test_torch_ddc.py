"""The port's NCO mixer, DDC, DDC bank and DUC against
``aether_primitives_tpu`` (``ops/frontend.py``, ``models/ddc.py``).

Tolerances: port against JAX and against the float64 composed golden (mix,
convolve, decimate) RMS EVM <= -110 dB (both compute in float32 and differ
by the FFT library); block-by-block against one-shot <= -115 dB, the bar of
``tests/test_ddc.py``; host values (phases, designed taps) exact.
"""

import dataclasses

import numpy as np
import pytest
import torch

from aether_primitives_tpu.models import ddc as jddc
from aether_primitives_tpu.ops import frontend as jfe
from aether_primitives_tpu_torch.convert import ddc_config_from_numpy, stage_state_from_numpy
from aether_primitives_tpu_torch.evm import evm_rms_db
from aether_primitives_tpu_torch.models import ddc as tddc
from aether_primitives_tpu_torch.ops import frontend as tfe

torch.set_num_threads(1)

DB = -110.0


def _c(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)


@pytest.mark.parametrize("freq,phase0", [(0.1375, 0.0), (-0.043, 1.3), (0.25, 0.0),
                                         (np.array([0.1, -0.31]), 0.7)],
                         ids=["ddc-bench", "negative-phase", "quarter", "per-row"])
def test_nco_mix_matches_jax(freq, phase0):
    x = _c((2, 5000), 1)
    got = tfe.nco_mix(torch.from_numpy(x), freq, phase0).numpy()
    want = np.asarray(jfe.nco_mix(x, freq, phase0))
    assert evm_rms_db(got, want) <= DB
    n = np.arange(5000)
    f = np.asarray(freq, np.float64)[..., None] if np.ndim(freq) else freq
    gold = x.astype(np.complex128) * np.exp(1j * (2 * np.pi * f * n + phase0))
    assert evm_rms_db(got, gold) <= DB
    assert np.array_equal(tfe.next_phase(5000, freq, phase0),
                          jfe.next_phase(5000, freq, phase0))


def test_nco_mix_keeps_the_phase_at_4m_samples():
    # the float64 table split keeps whole-cycle accuracy where a float32
    # ramp drifts: check the last samples of a 4M-sample mix
    n = 1 << 22
    x = torch.ones(n, dtype=torch.complex64)
    got = tfe.nco_mix(x, 0.1375).numpy()[-4096:]
    gold = np.exp(2j * np.pi * 0.1375 * np.arange(n - 4096, n, dtype=np.float64))
    assert evm_rms_db(got, gold) <= DB


def test_nco_mix_tensor_frequency_matches_jax():
    jnp = pytest.importorskip("jax.numpy")
    x = _c(3000, 2)
    got = tfe.nco_mix(torch.from_numpy(x), torch.tensor(0.013), 0.2).numpy()
    want = np.asarray(jfe.nco_mix(x, jnp.float32(0.013), 0.2))
    assert evm_rms_db(got, want) <= DB
    assert abs(float(tfe.next_phase(100, torch.tensor(0.013), 0.2))
               - float(jfe.next_phase(100, jnp.float32(0.013), 0.2))) < 1e-6


@pytest.mark.parametrize("dec,taps", [(4, None), (8, None), (1, None), (4, "complex")])
def test_ddc_config_taps_equal(dec, taps):
    t = _c(33, 3) if taps else None
    a = tddc.DdcConfig(freq=0.1, decimation=dec, taps=t).resolved_taps()
    b = jddc.DdcConfig(freq=0.1, decimation=dec, taps=t).resolved_taps()
    assert a.dtype == b.dtype and np.array_equal(a, b)
    a = tddc.DucConfig(interpolation=dec, taps=t).resolved_taps()
    b = jddc.DucConfig(interpolation=dec, taps=t).resolved_taps()
    assert np.array_equal(a, b)
    assert np.array_equal(tddc._polyphase_branches(a, dec), jddc._polyphase_branches(b, dec))


@pytest.mark.parametrize("freq,dec,block", [(0.1375, 8, 4096), (-0.043, 4, 4096),
                                            (0.2, 4, 1000), (0.05, 1, 1024)],
                         ids=["ddc-bench", "test-ddc", "ragged-blocks", "pure-mixer"])
def test_ddc_streams_like_jax_and_golden(freq, dec, block):
    x = _c(16384, 4)
    ours = tddc.Ddc(tddc.DdcConfig(freq=freq, decimation=dec), device="cpu")
    theirs = jddc.Ddc(jddc.DdcConfig(freq=freq, decimation=dec))
    got, want = [], []
    for i in range(0, 16384, block):
        got.append(ours.step(x[i:i + block]).numpy())
        want.append(np.asarray(theirs.step(x[i:i + block])))
        assert evm_rms_db(got[-1], want[-1]) <= DB
    assert ours._phase == theirs._phase
    stitched = np.concatenate(got)
    n = np.arange(16384)
    mixed = x.astype(np.complex128) * np.exp(-2j * np.pi * freq * n)
    gold = np.convolve(mixed, ours.taps.astype(np.complex128))[:16384][::dec]
    assert evm_rms_db(stitched, gold) <= DB
    whole = tddc.Ddc(tddc.DdcConfig(freq=freq, decimation=dec), device="cpu").step(x)
    assert evm_rms_db(stitched, whole.numpy()) <= -115


def test_ddc_short_blocks_carry_history():
    x = _c(600, 5)
    cfg = dict(freq=0.07, decimation=4)
    ours = tddc.Ddc(tddc.DdcConfig(**cfg), device="cpu")
    theirs = jddc.Ddc(jddc.DdcConfig(**cfg))
    for a, b in ((0, 20), (20, 300), (300, 340), (340, 600)):  # some shorter than K-1
        assert evm_rms_db(ours.step(x[a:b]).numpy(), np.asarray(theirs.step(x[a:b]))) <= DB
    # the history is mixed samples: float32 mixes, so compared by EVM
    assert evm_rms_db(ours._history.numpy(), np.asarray(theirs._history)) <= DB


def test_ddc_bank_matches_jax():
    x = _c(8192, 6)
    freqs = [-0.2, 0.05, 0.31]
    got = tddc.ddc_bank(torch.from_numpy(x), freqs, 4).numpy()
    assert got.shape == (3, 2048)
    assert evm_rms_db(got, np.asarray(jddc.ddc_bank(x, freqs, 4))) <= DB
    with pytest.raises(ValueError, match="1-D"):
        tddc.ddc_bank(x.reshape(2, -1), freqs, 4)


@pytest.mark.parametrize("ell,freq,block", [(4, 0.22, 2048), (3, 0.11, 2048), (2, -0.3, 700)])
def test_duc_streams_like_jax_and_golden(ell, freq, block):
    x = _c(6144, 7)
    ours = tddc.Duc(tddc.DucConfig(freq=freq, interpolation=ell), device="cpu")
    theirs = jddc.Duc(jddc.DucConfig(freq=freq, interpolation=ell))
    got = []
    for i in range(0, 6144, block):
        got.append(ours.step(x[i:i + block]).numpy())
        assert evm_rms_db(got[-1], np.asarray(theirs.step(x[i:i + block]))) <= DB
    up = np.zeros(6144 * ell, np.complex128)
    up[::ell] = x
    gold = np.convolve(up, ours.taps.astype(np.complex128))[:up.size]
    gold = gold * np.exp(2j * np.pi * freq * np.arange(up.size))
    assert evm_rms_db(np.concatenate(got), gold) <= DB


def test_ddc_state_carries_over_from_jax():
    x = _c(16384, 8)
    cfg = jddc.DdcConfig(freq=0.1375, decimation=8)
    theirs = jddc.Ddc(cfg)
    theirs.step(x[:8192])
    ours = stage_state_from_numpy(
        tddc.Ddc(ddc_config_from_numpy(dataclasses.asdict(cfg)), device="cpu"),
        phase=theirs._phase, history=np.asarray(theirs._history))
    assert evm_rms_db(ours.step(x[8192:]).numpy(), np.asarray(theirs.step(x[8192:]))) <= DB
    with pytest.raises(ValueError, match="K-1"):
        stage_state_from_numpy(ours, history=np.zeros(3, np.complex64))
    with pytest.raises(ValueError, match="not a tail"):
        stage_state_from_numpy(ours, tail=np.zeros(3, np.complex64))
    with pytest.raises(TypeError):
        stage_state_from_numpy(object(), tail=None)


def test_ddc_config_from_numpy():
    fields = dataclasses.asdict(jddc.DdcConfig(freq=0.3, decimation=2, taps=[1, 2, 3],
                                               block_len=512, fft_backend="matmul"))
    cfg = ddc_config_from_numpy(fields)
    assert cfg.freq == 0.3 and cfg.decimation == 2 and cfg.block_len == 512
    assert cfg.taps.dtype == np.complex64
    with pytest.raises(ValueError, match="no fields"):
        ddc_config_from_numpy({"bogus": 1})


def test_stages_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: tddc.Ddc(), lambda: tddc.Duc()):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
