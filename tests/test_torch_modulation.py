"""The port's modulation tables, hard demod and max-log soft demod against
``aether_primitives_tpu.ops.modulation``: tables, symbols, hard bits and
LLRs are identical (tolerance: none)."""

import numpy as np
import pytest
import torch

from aether_primitives_tpu.ops import modulation as jmod
from aether_primitives_tpu_torch.ops import modulation as tmod

torch.set_num_threads(1)

TABLES = ["bpsk", "qpsk", "qam16", "qam64", "psk8"]


def _pair(name):
    if name in ("bpsk", "qpsk", "qam16"):
        return getattr(tmod, name)(), getattr(jmod, name)()
    if name.startswith("qam"):
        return tmod.qam(int(name[3:])), jmod.qam(int(name[3:]))
    return tmod.psk(int(name[3:])), jmod.psk(int(name[3:]))


@pytest.mark.parametrize("name", TABLES)
def test_tables_identical(name):
    t, j = _pair(name)
    assert t.table.tobytes() == j.table.tobytes()
    assert t.bits_per_symbol == j.bits_per_symbol
    assert t._sign_fast == j._sign_fast


@pytest.mark.parametrize("name", TABLES)
def test_hard_bits_byte_identical(name):
    t, j = _pair(name)
    rng = np.random.default_rng(11)
    s = (0.8 * (rng.normal(size=(3, 500)) + 1j * rng.normal(size=(3, 500)))).astype(np.complex64)
    got = t.demod(torch.from_numpy(s)).numpy()
    want = np.asarray(j.demod(s))
    assert got.dtype == want.dtype == np.uint8
    assert got.shape == want.shape
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("name", ["bpsk", "qpsk"])
def test_sign_demod_boundaries_go_to_bit_zero(name):
    # strict comparisons: a symbol on a decision boundary demods to bit 0
    t, j = _pair(name)
    s = np.array([0.0, 1.0 - 1.0j, -0.0, 0.5], np.complex64)
    got = t.demod(torch.from_numpy(s)).numpy()
    assert got.tobytes() == np.asarray(j.demod(s)).tobytes()


@pytest.mark.parametrize("name", TABLES)
def test_modulate_identical_and_round_trips(name):
    t, j = _pair(name)
    rng = np.random.default_rng(12)
    bits = rng.integers(0, 2, size=(2, 48 * t.bits_per_symbol)).astype(np.uint8)
    got = t.modulate(torch.from_numpy(bits)).numpy()
    assert got.tobytes() == np.asarray(j.modulate(bits)).tobytes()
    assert np.array_equal(t.demod(torch.from_numpy(got)).numpy(), bits)
    with pytest.raises(ValueError):
        t.index(torch.zeros(2, t.bits_per_symbol + 1, dtype=torch.uint8))


def test_bad_orders_raise():
    for bad in (3, 8):
        with pytest.raises(ValueError):
            tmod.qam(bad)
    with pytest.raises(ValueError):
        tmod.psk(6)
    with pytest.raises(ValueError):
        tmod.Modulation(np.ones(3, np.complex64))


@pytest.mark.parametrize("name", TABLES)
def test_demod_soft_identical(name):
    # max-log LLRs: the same float32 operations in the same order, so the
    # values are identical (tolerance: none), scalar or per-row variance
    t, j = _pair(name)
    rng = np.random.default_rng(13)
    s = (0.8 * (rng.normal(size=(3, 200)) + 1j * rng.normal(size=(3, 200)))).astype(np.complex64)
    nv = np.array([0.5, 0.01, 2.0], np.float32)
    got = t.demod_soft(torch.from_numpy(s), torch.from_numpy(nv[:, None])).numpy()
    want = np.stack([np.asarray(j.demod_soft(s[i], nv[i])) for i in range(3)])
    assert got.dtype == np.float32 and np.array_equal(got, want)
    assert np.array_equal(t.demod_soft(torch.from_numpy(s)).numpy(),
                          np.asarray(j.demod_soft(s)))
    assert np.array_equal(t.hard_from_soft(torch.from_numpy(got)).numpy(),
                          np.asarray(j.hard_from_soft(got)))


# ------------------------------------------- APSK, differential coding, pi/4-DQPSK
# Tables equal to the JAX package's; indices and bits identical off the
# decision boundaries (the inputs are random, ROADMAP §3.5); pi/4-DQPSK
# symbols at RMS EVM <= PI4_DB (the float32 phase is a cumsum, summed in
# another order).
PI4_DB = -90.0


@pytest.mark.parametrize("order,gamma", [(16, None), (16, "9/10"), (16, 3.0), (32, None),
                                         (32, "5/6")])
def test_apsk_tables_identical(order, gamma):
    t, j = tmod.apsk(order, gamma), jmod.apsk(order, gamma)
    assert t.table.tobytes() == j.table.tobytes() and t.name == j.name
    rng = np.random.default_rng(14)
    s = (0.9 * (rng.normal(size=300) + 1j * rng.normal(size=300))).astype(np.complex64)
    assert t.demod(torch.from_numpy(s)).numpy().tobytes() == np.asarray(j.demod(s)).tobytes()
    assert tmod.APSK16_GAMMA == jmod.APSK16_GAMMA and tmod.APSK32_GAMMA == jmod.APSK32_GAMMA
    with pytest.raises(ValueError):
        tmod.apsk(8)


def test_symbol_identical():
    t, j = tmod.qam16(), jmod.qam16()
    idx = np.array([[0, 5, 15], [3, 3, 9]])
    assert np.array_equal(t.symbol(torch.from_numpy(idx)).numpy(), np.asarray(j.symbol(idx)))
    assert np.array_equal(t.demod_naive(t.symbol(torch.from_numpy(idx))).numpy(),
                          np.asarray(j.demod_naive(j.symbol(idx))))


@pytest.mark.parametrize("order", [2, 4, 8, 16])
def test_differential_coding_and_nearest_index_identical(order):
    rng = np.random.default_rng(15 + order)
    d = rng.integers(0, order, (3, 400))
    enc = tmod.differential_encode(torch.from_numpy(d), order)
    assert enc.dtype == torch.int32
    assert np.array_equal(enc.numpy(), np.asarray(jmod.differential_encode(d, order)))
    dec = tmod.differential_decode(enc, order)
    assert np.array_equal(dec.numpy(), np.asarray(jmod.differential_decode(enc.numpy(), order)))
    assert np.array_equal(dec.numpy(), d)
    table = tmod.psk_table(order)
    assert table.tobytes() == jmod.psk_table(order).tobytes()
    s = (table[enc.numpy()] * np.exp(0.1j) + 0.05 * (rng.normal(size=enc.shape) + 1j * rng.normal(
        size=enc.shape))).astype(np.complex64)
    got = tmod.nearest_index(torch.from_numpy(s), table)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(jmod.nearest_index(s, table)))


def test_pi4dqpsk_against_jax():
    rng = np.random.default_rng(16)
    bits = rng.integers(0, 2, (2, 2000)).astype(np.uint8)
    sym = tmod.pi4dqpsk_modulate(torch.from_numpy(bits))
    jsym = np.asarray(jmod.pi4dqpsk_modulate(bits))
    assert sym.dtype == torch.complex64 and sym.shape == jsym.shape == (2, 1000)
    err = np.mean(np.abs(sym.numpy().astype(np.complex128) - jsym) ** 2) / np.mean(np.abs(jsym) ** 2)
    assert 10 * np.log10(err) <= PI4_DB
    # a constant rotation and noise: the bits come back, equal to JAX's
    rx = (jsym * np.exp(0.7j) + 0.05 * (rng.normal(size=jsym.shape) + 1j * rng.normal(
        size=jsym.shape))).astype(np.complex64)
    got = tmod.pi4dqpsk_demod(torch.from_numpy(rx)).numpy()
    assert got.dtype == np.uint8
    assert np.array_equal(got, np.asarray(jmod.pi4dqpsk_demod(rx)))
    assert np.array_equal(tmod.pi4dqpsk_demod(sym).numpy(), bits)
    with pytest.raises(ValueError, match="PAIRS"):
        tmod.pi4dqpsk_modulate(torch.zeros(3, dtype=torch.uint8))
