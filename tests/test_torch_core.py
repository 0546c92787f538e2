"""The port's core contract against the JAX package: the numpy-only copies
(EVM, the float64 constant builders) are identical, ``Scale`` scales by the
same floats, and importing the port never imports JAX."""

import importlib
import inspect
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from aether_primitives_tpu.models.modem import _default_lowpass
from aether_primitives_tpu.ops import fft as jfft
from aether_primitives_tpu.ops import fir as jfir
from aether_primitives_tpu_torch import Split, as_cf32, merge, split
from aether_primitives_tpu_torch.ops import fft as tfft
from aether_primitives_tpu_torch.ops import fir as tfir

torch.set_num_threads(1)

# the packages export a function named evm, which shadows the module name
jevm = importlib.import_module("aether_primitives_tpu.evm")
tevm = importlib.import_module("aether_primitives_tpu_torch.evm")

REPO = Path(__file__).resolve().parents[1]


def _taps(kind: str) -> np.ndarray:
    if kind == "lowpass65":
        return _default_lowpass(65, 1.0 / 8)
    if kind == "random17":
        rng = np.random.default_rng(3)
        return (rng.normal(size=17) + 1j * rng.normal(size=17)).astype(np.complex64)
    return np.asarray([1.0 + 0j], np.complex64)


# (taps, dec, fft_len): the flagship, the test size, complex taps, K = 1
GEOMETRIES = [
    ("lowpass65", 4, 2048),
    ("lowpass65", 4, 256),
    ("random17", 2, 128),
    ("identity", 1, 64),
]


def test_evm_module_is_a_verbatim_copy():
    assert inspect.getsource(tevm) == inspect.getsource(jevm)


@pytest.mark.parametrize("name", ["evm", "evm_db", "evm_rms_db"])
def test_evm_functions_agree(name):
    rng = np.random.default_rng(1)
    ref = (rng.normal(size=64) + 1j * rng.normal(size=64)).astype(np.complex64)
    cases = [
        ref + np.complex64(1e-5),  # a small error
        ref.copy(),  # exact match
        np.where(np.arange(64) == 3, 0, ref).astype(np.complex64),
    ]
    for actual in cases:
        a = getattr(tevm, name)(actual, ref)
        b = getattr(jevm, name)(actual, ref)
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_assert_evm_agrees():
    ref = np.array([1.0, 2.0, 0.0], np.complex64)
    tevm.assert_evm(ref, ref)
    bad = np.array([1.0, 2.0 + 1e-3, 0.0], np.complex64)
    with pytest.raises(AssertionError) as t_err:
        tevm.assert_evm(bad, ref)
    with pytest.raises(AssertionError) as j_err:
        jevm.assert_evm(bad, ref)
    assert str(t_err.value) == str(j_err.value)


@pytest.mark.parametrize("name", ["_fused_stage_matrices", "_fused_rx_matrices"])
def test_constant_builders_are_verbatim_copies(name):
    t = getattr(tfir, name).__wrapped__
    j = getattr(jfir, name).__wrapped__
    assert inspect.getsource(t) == inspect.getsource(j)


@pytest.mark.parametrize("taps,dec,fft_len", GEOMETRIES)
def test_constant_builders_byte_identical(taps, dec, fft_len):
    h = _taps(taps)
    k = h.shape[-1]
    n1 = tfir._fused_stage_n1(dec, fft_len)
    assert n1 == jfir._fused_stage_n1(dec, fft_len)
    for t, j in zip(tfir._fused_stage_matrices(h.tobytes(), k, dec, fft_len, n1),
                    jfir._fused_stage_matrices(h.tobytes(), k, dec, fft_len, n1)):
        assert t.dtype == j.dtype and t.shape == j.shape
        assert t.tobytes() == j.tobytes()
    for t, j in zip(tfir._fused_rx_matrices(h.tobytes(), k, dec, fft_len),
                    jfir._fused_rx_matrices(h.tobytes(), k, dec, fft_len)):
        assert t.dtype == j.dtype and t.shape == j.shape
        assert t.tobytes() == j.tobytes()


def test_stage_n1_matches_jax_off_tpu():
    # the JAX package's TPU-measured table applies only on a TPU; off it
    # both sides run the same heuristic and validate overrides alike
    for dec in (1, 2, 4, 8):
        for fft_len in (64, 96, 128, 256, 1000, 2048, 4096, 8192):
            assert tfir._fused_stage_n1(dec, fft_len) == jfir._fused_stage_n1(dec, fft_len)
    assert tfir._fused_stage_n1(4, 2048) == 128
    assert tfir._fused_stage_n1(4, 2048, 16) == 16
    for bad in (7, 0):
        with pytest.raises(ValueError):
            tfir._fused_stage_n1(4, 2048, bad)


@pytest.mark.parametrize("kind", ["none", "sn", "n", "x"])
def test_scale_factor_identical(kind):
    t = tfft.Scale.X(0.37) if kind == "x" else tfft.Scale(kind)
    j = jfft.Scale.X(0.37) if kind == "x" else jfft.Scale(kind)
    for n in (1, 2, 3, 7, 8, 64, 1000, 2048, 4096, 8192, 12345, 1 << 22):
        assert t.factor_for(n) == j.factor_for(n)


def test_import_leaves_jax_out():
    code = (
        "import sys\n"
        "import aether_primitives_tpu_torch, aether_primitives_tpu_torch.cli\n"
        "import aether_primitives_tpu_torch.convert\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'aether_primitives_tpu')]\n"
        "print(bad)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120, env=dict(os.environ),
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_split_merge_roundtrip():
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(2, 16)) + 1j * rng.normal(size=(2, 16))).astype(np.complex64)
    s = split(x)
    assert isinstance(s, Split)
    assert s.re.dtype == torch.float32 and s.im.dtype == torch.float32
    assert np.array_equal(s.re.numpy(), x.real)
    back = merge(s)
    assert back.dtype == torch.complex64
    assert np.array_equal(back.numpy(), x)
    assert np.array_equal(merge((x.real, x.imag)).numpy(), x)
    assert as_cf32([1.0, 2.0]).dtype == torch.complex64
