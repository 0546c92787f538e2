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
