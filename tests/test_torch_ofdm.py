"""The port's CP-OFDM modem and syncs (``models/ofdm.py``) against the JAX
package's, on the same seeded numpy inputs.

Tolerances: time samples and spectra RMS EVM <= -100 dB against the JAX
package's; bits, ``sc_preamble`` and the ``cp_sync`` / ``sc_sync`` offsets
exact; CFO estimates within 1e-7 cycles/sample (rtol-free: the estimates
are ~1e-4 and the grid of either sync is far coarser); the config carried
by ``convert`` equal, an unknown field refused. The ``cuda`` cases hold the
card to the CPU run and check that the modem defaults to the card. The
JAX side runs under ``jax.jit``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from aether_primitives_tpu_torch import convert
from aether_primitives_tpu_torch.evm import evm_rms_db
from aether_primitives_tpu_torch.models import OfdmConfig, OfdmModem, cp_sync
from aether_primitives_tpu_torch.models import ofdm as tofdm
from aether_primitives_tpu_torch.models.sync import OfdmEqualizer, apply_freq_shift

torch.set_num_threads(1)

EVM_DB, CFO_ATOL = -100.0, 1e-7
CFG = OfdmConfig(fft_len=256, cp_len=32, active_bins=192)


@pytest.fixture(scope="module")
def jofdm():
    pytest.importorskip("jax")
    from aether_primitives_tpu.models import ofdm

    return ofdm


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _carry(jofdm, **fields):
    jcfg = jofdm.OfdmConfig(**fields)
    return jcfg, convert.ofdm_config_from_numpy(dataclasses.asdict(jcfg))


def test_config_carries_and_refuses_unknown_fields(jofdm):
    jcfg, cfg = _carry(jofdm, fft_len=128, cp_len=9, active_bins=100, modulation="qam16",
                       fft_backend="matmul")
    assert dataclasses.asdict(cfg) == {**dataclasses.asdict(jcfg), "fft_backend": None}
    assert cfg.symbol_len == jcfg.symbol_len and cfg.bins() == jcfg.bins()
    with pytest.raises(ValueError, match="no fields"):
        convert.ofdm_config_from_numpy({"fft_len": 64, "pilots": 4})
    with pytest.raises(ValueError, match="even"):
        OfdmModem(OfdmConfig(fft_len=64, active_bins=33), device="cpu")
    with pytest.raises(ValueError, match="unknown modulation"):
        OfdmModem(OfdmConfig(modulation="psk8"), device="cpu")
    with pytest.raises(ValueError, match="frames"):
        OfdmModem(device="cpu").modulate(torch.zeros(7, dtype=torch.uint8))


@pytest.mark.parametrize("fields", [
    dict(fft_len=256, cp_len=32, active_bins=192),
    dict(fft_len=128, cp_len=16, modulation="bpsk"),
    dict(fft_len=128, cp_len=0, active_bins=72, modulation="qam16"),
    dict(fft_len=64, cp_len=8, modulation="qam64"),
], ids=lambda f: f"{f['fft_len']}-{f['cp_len']}-{f.get('modulation', 'qpsk')}")
def test_modem_matches_jax(jofdm, fields):
    jcfg, cfg = _carry(jofdm, **fields)
    jm, tm = jofdm.OfdmModem(jcfg), OfdmModem(cfg, device="cpu")
    rng = np.random.default_rng(fields["fft_len"] + fields["cp_len"])
    bits = rng.integers(0, 2, 5 * tm.bits_per_frame()).astype(np.uint8)
    import jax

    jx = np.asarray(jax.jit(jm.modulate)(bits))
    tx = tm.modulate(torch.from_numpy(bits))
    assert tx.dtype == torch.complex64 and tx.shape == jx.shape
    assert evm_rms_db(tx.numpy(), jx) <= EVM_DB
    noisy = (jx + 0.05 * (rng.normal(size=jx.size) + 1j * rng.normal(size=jx.size))).astype(
        np.complex64)
    assert evm_rms_db(tm.spectra(torch.from_numpy(noisy)).numpy(),
                      np.asarray(jax.jit(jm.spectra)(noisy))) <= EVM_DB
    assert np.array_equal(tm.demodulate(torch.from_numpy(noisy)).numpy(),
                          np.asarray(jax.jit(jm.demodulate)(noisy)))
    assert np.array_equal(tm.demodulate(tx).numpy(), bits)


def test_multipath_and_one_tap_equalizer(jofdm):
    jm, tm = jofdm.OfdmModem(jofdm.OfdmConfig(**dataclasses.asdict(CFG))), OfdmModem(CFG, "cpu")
    rng = np.random.default_rng(9)
    bits = rng.integers(0, 2, 9 * tm.bits_per_frame()).astype(np.uint8)
    x = tm.modulate(torch.from_numpy(bits)).numpy()
    h_chan = np.zeros(20, np.complex64)
    h_chan[0], h_chan[7], h_chan[19] = 1.0, 0.5j, -0.3
    rx = np.convolve(x, h_chan)[:x.size].astype(np.complex64)
    bpf = tm.bits_per_frame()
    spec = tm.spectra(torch.from_numpy(rx))
    pilot = tm.modulation.modulate(torch.from_numpy(bits[:bpf])).reshape(1, -1)
    h = OfdmEqualizer.estimate(spec[:1], pilot)
    out = tm.demodulate(torch.from_numpy(rx[CFG.symbol_len:]), h)
    assert np.array_equal(out.numpy(), bits[bpf:])
    assert np.array_equal(out.numpy(), np.asarray(jm.demodulate(rx[CFG.symbol_len:], h.numpy())))


def _channel(x, delay, f0, rng, taps=None, noise=0.01, tail=0):
    rx = np.concatenate([np.zeros(delay, np.complex64), x, np.zeros(tail, np.complex64)])
    if taps is not None:
        rx = np.convolve(rx, taps)[:rx.size]
    rx = rx * np.exp(2j * np.pi * f0 * np.arange(rx.size))
    return (rx + noise * (rng.normal(size=rx.size) + 1j * rng.normal(size=rx.size))).astype(
        np.complex64)


@pytest.mark.parametrize("fields,delay,f0", [
    (dict(fft_len=256, cp_len=32, active_bins=192), 77, 3.1e-4),
    (dict(fft_len=2048, cp_len=144, active_bins=1200, modulation="qam64"), 1500, -1.7e-4),
])
def test_cp_sync_matches_jax(jofdm, fields, delay, f0):
    jcfg, cfg = _carry(jofdm, **fields)
    tm = OfdmModem(cfg, device="cpu")
    rng = np.random.default_rng(delay)
    bits = rng.integers(0, 2, 12 * tm.bits_per_frame()).astype(np.uint8)
    rx = _channel(tm.modulate(torch.from_numpy(bits)).numpy(), delay, f0, rng)
    off, cfo = cp_sync(torch.from_numpy(rx), cfg)
    import jax

    joff, jcfo = jax.jit(lambda v: jofdm.cp_sync(v, jcfg))(rx)
    assert int(off) == int(joff) and int(off) == delay % cfg.symbol_len
    assert abs(float(cfo) - float(jcfo)) <= CFO_ATOL and abs(float(cfo) - f0) < 2e-5
    # batched rows
    rows = np.stack([rx, np.roll(rx, 5)])
    boff, bcfo = cp_sync(torch.from_numpy(rows), cfg)
    jboff, jbcfo = jax.jit(lambda v: jofdm.cp_sync(v, jcfg))(rows)
    assert np.array_equal(boff.numpy(), np.asarray(jboff))
    np.testing.assert_allclose(bcfo.numpy(), np.asarray(jbcfo), atol=CFO_ATOL, rtol=0)
    fixed = apply_freq_shift(torch.from_numpy(rx), cfo)
    start = int(off) + (delay // cfg.symbol_len) * cfg.symbol_len
    out = tm.demodulate(fixed[start:start + 11 * cfg.symbol_len])
    assert np.array_equal(out.numpy(), bits[:out.shape[-1]])


@pytest.mark.parametrize("fields", [dict(fft_len=256, cp_len=32, active_bins=192),
                                    dict(fft_len=2048, cp_len=144, active_bins=1200)])
def test_sc_preamble_and_sync_match_jax(jofdm, fields):
    import jax

    jcfg, cfg = _carry(jofdm, **fields)
    pre = tofdm.sc_preamble(cfg)
    assert pre.dtype == np.complex64 and np.array_equal(pre, jofdm.sc_preamble(jcfg))
    assert np.array_equal(tofdm.sc_preamble(cfg, seed=3), jofdm.sc_preamble(jcfg, seed=3))
    tm = OfdmModem(cfg, device="cpu")
    rng = np.random.default_rng(fields["fft_len"])
    bits = rng.integers(0, 2, 4 * tm.bits_per_frame()).astype(np.uint8)
    burst = np.concatenate([pre, tm.modulate(torch.from_numpy(bits)).numpy()])
    taps = np.zeros(12, np.complex64)
    taps[0], taps[5], taps[11] = 1.0, 0.4j, -0.2
    for t, f0 in ((None, 1.7e-3 * 256 / cfg.fft_len), (taps, 0.0)):
        rx = _channel(burst, 133, f0, rng, taps=t, noise=0.02, tail=64)
        off, cfo = tofdm.sc_sync(torch.from_numpy(rx), cfg)
        joff, jcfo = jax.jit(lambda v: jofdm.sc_sync(v, jcfg))(rx)
        assert int(off) == int(joff) and abs(int(off) - 133 - cfg.cp_len) <= 12
        assert abs(float(cfo) - float(jcfo)) <= CFO_ATOL and abs(float(cfo) - f0) < 5e-5
    with pytest.raises(ValueError, match="even fft_len"):
        tofdm.sc_preamble(OfdmConfig(fft_len=63, cp_len=4))


def test_modem_defaults_to_the_card():
    if torch.cuda.is_available():
        assert OfdmModem().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            OfdmModem()


@pytest.mark.cuda
def test_card_matches_cpu(cuda):
    cfg = OfdmConfig(fft_len=2048, cp_len=144, active_bins=1200, modulation="qam64")
    card, host = OfdmModem(cfg, device=cuda), OfdmModem(cfg, device="cpu")
    rng = np.random.default_rng(14)
    bits = torch.from_numpy(rng.integers(0, 2, 20 * card.bits_per_frame()).astype(np.uint8))
    x = card.modulate(bits.to(cuda))
    assert evm_rms_db(x.cpu().numpy(), host.modulate(bits).numpy()) <= EVM_DB
    rx = _channel(x.cpu().numpy(), 999, 1.1e-4, rng)
    off, cfo = cp_sync(torch.from_numpy(rx).to(cuda), cfg)
    hoff, hcfo = cp_sync(torch.from_numpy(rx), cfg)
    assert int(off) == int(hoff) and abs(float(cfo) - float(hcfo)) <= CFO_ATOL
    assert torch.equal(card.demodulate(x).cpu(), bits)
