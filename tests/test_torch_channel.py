"""The port's channel simulation (``models/channel.py``) and BER curves
(``models/ber.py``) against the JAX package's, on the same seeded inputs.

Tolerances:
- the deterministic impairments (``delay_pad``, ``multipath``, ``cfo``,
  ``iq_imbalance``, ``dc_offset``, ``pa_saturate``) and a ``Channel`` of
  them: RMS EVM <= -120 dB against JAX;
- the keyed ones (``rayleigh_block``, ``jakes``, ``phase_noise``, the
  channel's AWGN) draw from a ``torch.Generator``, not threefry: held by
  statistics, as tests/test_channel.py holds the JAX package's (power of
  the gains within 5 sigma, the Wiener increments' variance within 10%, the
  Jakes autocorrelation within 0.1 of ``J0``), for both packages;
- ``q_function`` and ``theoretical_ber``: equal floats;
- ``simulate_ber`` on ``n_bits <= 1 << 16``: within 5 binomial sigma of
  ``theoretical_ber``.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from aether_primitives_tpu_torch import convert
from aether_primitives_tpu_torch.evm import evm_rms_db
from aether_primitives_tpu_torch.models import Channel, ChannelConfig, ber
from aether_primitives_tpu_torch.models import channel as tch

torch.set_num_threads(1)

EVM_DB = -120.0
CPU = "cpu"


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax

    from aether_primitives_tpu.models import ber as jber
    from aether_primitives_tpu.models import channel as jch

    return jax, jch, jber


def _c(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)


def test_deterministic_impairments_against_jax(jx):
    _, jch, _ = jx
    x = _c((2, 4096), 80)
    t = torch.from_numpy(x)
    taps = (1.0, 0.3 - 0.2j, 0.05j)
    cases = [
        (tch.delay_pad(t[..., :1000], 77, 2048), jch.delay_pad(x[..., :1000], 77, 2048)),
        (tch.delay_pad(t[..., :1000], 1500, 2048), jch.delay_pad(x[..., :1000], 1500, 2048)),
        (tch.multipath(t, taps), jch.multipath(x, taps)),
        (tch.cfo(t, 1.3e-3, 0.4), jch.cfo(x, 1.3e-3, 0.4)),
        (tch.iq_imbalance(t, 0.7, 3.0), jch.iq_imbalance(x, 0.7, 3.0)),
        (tch.dc_offset(t, 0.02 - 0.01j), jch.dc_offset(x, 0.02 - 0.01j)),
        (tch.pa_saturate(t, 0.8, 2.0), jch.pa_saturate(x, 0.8, 2.0)),
    ]
    for got, want in cases:
        assert got.dtype == torch.complex64 and got.shape == np.shape(want)
        assert evm_rms_db(got.numpy(), np.asarray(want)) <= EVM_DB
    with pytest.raises(ValueError, match="longer than the capture"):
        tch.delay_pad(t, 0, 100)


def test_channel_without_keyed_stages_against_jax(jx):
    jax, jch, _ = jx
    x = _c(8192, 81)
    fields = dict(taps=(1.0, 0.2 - 0.1j), cfo=2e-4, phase0=0.3, iq_amp_db=0.5,
                  iq_phase_deg=2.0, dc=0.01 + 0.02j, sat_level=1.5, delay=33, capture_len=9000)
    jcfg = jch.ChannelConfig(**fields)
    cfg = convert.channel_config_from_numpy(dataclasses.asdict(jcfg))
    assert cfg == ChannelConfig(**fields)
    got = Channel(cfg, device=CPU).apply(5, torch.from_numpy(x))
    want = np.asarray(jch.Channel(jcfg).apply(jax.random.key(5), x))
    assert got.shape == want.shape == (9000,)
    assert evm_rms_db(got.numpy(), want) <= EVM_DB
    with pytest.raises(ValueError, match="no fields"):
        convert.channel_config_from_numpy({"taps": None, "fading": 1})


def test_rayleigh_block_statistics(jx):
    jax, jch, _ = jx
    x = np.ones((4, 4096 * 16), np.complex64)
    got = tch.rayleigh_block(torch.Generator().manual_seed(1), torch.from_numpy(x), 16).numpy()
    want = np.asarray(jch.rayleigh_block(jax.random.key(1), x, 16))
    nb = x.size // 16
    for g in (got, want):
        gains = g.reshape(-1, 16)
        assert np.allclose(gains, gains[:, :1])  # constant within a block
        p = np.abs(gains[:, 0]) ** 2  # exponential, mean 1, std 1
        assert abs(p.mean() - 1.0) <= 5 / np.sqrt(nb)
    with pytest.raises(ValueError, match="block_len"):
        tch.rayleigh_block(1, torch.from_numpy(x[..., :100]), 16)


def test_jakes_autocorrelation_and_power(jx):
    # tests/test_channel.py:42-53's check: unit power, autocorrelation near J0
    from scipy.special import j0

    jax, jch, _ = jx
    fd, n, lag = 0.01, 20000, 30
    gs = [tch.jakes(torch.Generator().manual_seed(s), n, fd, 64, device=CPU).numpy()
          for s in range(8)]
    js = [np.asarray(jch.jakes(jax.random.key(s), n, fd, 64)) for s in range(8)]
    for hs in (gs, js):
        h = np.stack(hs)
        assert h.dtype == np.complex64 and h.shape == (8, n)
        assert abs(np.mean(np.abs(h) ** 2) - 1.0) < 0.15
        r = np.mean(h[:, lag:] * np.conj(h[:, :-lag])) / np.mean(np.abs(h) ** 2)
        assert abs(r.real - j0(2 * np.pi * fd * lag)) < 0.1


def test_phase_noise_wiener_variance(jx):
    jax, jch, _ = jx
    lw, n = 1e-4, 4096
    x = np.ones((64, n), np.complex64)
    got = tch.phase_noise(torch.Generator().manual_seed(2), torch.from_numpy(x), lw).numpy()
    want = np.asarray(jch.phase_noise(jax.random.key(2), x, lw))
    for y in (got, want):
        assert np.allclose(np.abs(y), 1.0, atol=1e-5)
        ph = np.unwrap(np.angle(y), axis=-1)
        var = np.var(ph[:, -1])  # a walk of n steps: 2 pi lw n
        assert abs(var / (2 * np.pi * lw * n) - 1.0) < 0.35
        inc = np.diff(ph, axis=-1)
        assert abs(np.var(inc) / (2 * np.pi * lw) - 1.0) < 0.1


def test_channel_noise_statistics():
    c = Channel(ChannelConfig(noise_power=0.05), device=CPU)
    x = torch.zeros(65536, dtype=torch.complex64)
    y = c.apply(torch.Generator().manual_seed(4), x).numpy()
    for comp in (y.real, y.imag):
        assert abs(comp.var() - 0.05) <= 5 * 0.05 * np.sqrt(2 / y.size)
    assert torch.equal(c.apply(9, x), c.apply(9, x))  # one seed, the same channel
    keyed = Channel(ChannelConfig(doppler=1e-3, linewidth=1e-5, noise_power=1e-3), device=CPU)
    z = keyed.apply(3, torch.ones(4096, dtype=torch.complex64))
    assert z.shape == (4096,) and torch.isfinite(z.abs()).all()


def test_ber_theory_equal_to_jax(jx):
    _, _, jber = jx
    for xv in (0.0, 0.5, 1.0, 3.0, 6.0):
        assert ber.q_function(xv) == jber.q_function(xv)
    for mod in ("qpsk", "bpsk", "qam16", "qam64", "qam256"):
        for p in (0.01, 0.1, 0.5, 1.0):
            assert ber.theoretical_ber(mod, p) == jber.theoretical_ber(mod, p)
    with pytest.raises(ValueError):
        ber.theoretical_ber("psk8", 0.1)
    with pytest.raises(ValueError):
        ber.theoretical_ber("qam32", 0.1)


@pytest.mark.parametrize("mod,powers", [("qpsk", (0.25, 0.5, 1.0)), ("bpsk", (0.5, 1.0)),
                                        ("qam16", (0.02, 0.05))])
def test_simulate_ber_within_five_sigma(mod, powers):
    n_bits = 1 << 16
    rows = ber.simulate_ber(mod, powers, n_bits, seed=815, device=CPU)
    assert [r[0] for r in rows] == list(powers)
    for p, sim, th in rows:
        assert th == ber.theoretical_ber(mod, p)
        assert abs(sim - th) <= 5 * math.sqrt(th * (1 - th) / n_bits)
    assert rows == ber.simulate_ber(mod, powers, n_bits, seed=815, device=CPU)


def test_channel_and_ber_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (Channel, lambda: tch.jakes(1, 16, 0.01), lambda: ber.simulate_ber(n_bits=64)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
