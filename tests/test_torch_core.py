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
from aether_primitives_tpu.ops import firdes as jfirdes
from aether_primitives_tpu.ops import vecops as jvec
from aether_primitives_tpu_torch import Split, as_cf32, merge, split
from aether_primitives_tpu_torch.ops import fft as tfft
from aether_primitives_tpu_torch.ops import fir as tfir
from aether_primitives_tpu_torch.ops import firdes as tfirdes
from aether_primitives_tpu_torch.ops import vecops as tvec

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
        "import aether_primitives_tpu_torch.models.channelizer\n"
        "import aether_primitives_tpu_torch.models.ddc\n"
        "import aether_primitives_tpu_torch.ops.cuda.pfb_fold\n"
        "import aether_primitives_tpu_torch.ops.firdes\n"
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


# ------------------------------------------------------------------ firdes

FIRDES = {
    "windowed_sinc": [(63, 0.1), (64, 0.2, "hann"), (31, 0.05, "blackman"), (9, 0.3, "rect")],
    "kaiser_beta": [(10.0,), (30.0,), (60.0,), (80.0,)],
    "kaiser_order": [(60.0, 0.05), (80.0, 0.01), (40.0, 0.1)],
    "kaiser_lowpass": [(0.1, 0.05), (0.2, 0.02, 60.0), (0.05, 0.1, 40.0)],
    "remez": [(31, [(0, 0.1), (0.15, 0.5)], [1, 0]),
              (41, [(0, 0.08), (0.12, 0.3), (0.35, 0.5)], [0, 1, 0], [1, 2, 1]),
              (21, [(0, 0.2), (0.25, 0.5)], [1, 0], None, 8)],
    "hilbert_taps": [(31,), (15, "blackman"), (65, "rect")],
}


@pytest.mark.parametrize("name", sorted(FIRDES))
def test_firdes_designers_equal(name):
    for args in FIRDES[name]:
        a = getattr(tfirdes, name)(*args)
        b = getattr(jfirdes, name)(*args)
        assert np.array_equal(np.asarray(a), np.asarray(b)), (name, args)


@pytest.mark.parametrize("kind", ["highpass", "bandpass", "bandstop"])
def test_firdes_band_transform_equal(kind):
    lp = jfirdes.windowed_sinc(33, 0.1)
    assert np.array_equal(tfirdes.band_transform(lp, kind, 0.2),
                          jfirdes.band_transform(lp, kind, 0.2))
    with pytest.raises(ValueError):
        tfirdes.band_transform(lp, "notch")


def test_firdes_is_a_numpy_copy():
    # the module body after the docstring is the original's, line for line
    def body(mod):
        src = inspect.getsource(mod)
        return src[src.index("from __future__"):]

    assert body(tfirdes) == body(jfirdes)
    for bad in ((tfirdes.windowed_sinc, (31, 0.6)), (tfirdes.remez, (30, [(0, 0.1)], [1])),
                (tfirdes.hilbert_taps, (30,))):
        with pytest.raises(ValueError):
            bad[0](*bad[1])


# ------------------------------------------------------------------ vecops


def _vec(seed, n=100):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(2, n)) + 1j * rng.normal(size=(2, n))).astype(np.complex64)


@pytest.mark.parametrize("name", ["mul", "div", "add", "sub"])
def test_vecops_binary_match_jax(name):
    a, b = _vec(1), _vec(2)
    got = getattr(tvec, name)(torch.from_numpy(a), b).numpy()
    want = np.asarray(getattr(jvec, name)(a, b))
    assert tevm.evm_rms_db(got, want) <= -120
    with pytest.raises(ValueError, match="same length"):
        getattr(tvec, name)(torch.from_numpy(a), b[:, :50])


@pytest.mark.parametrize("n", [4, 5, 100, 101])
def test_vecops_unary_match_jax(n):
    a = _vec(3, n)
    for name in ("conj", "mirror", "clone", "zero"):
        got = getattr(tvec, name)(torch.from_numpy(a)).numpy()
        assert np.array_equal(got, np.asarray(getattr(jvec, name)(a))), name
    assert np.array_equal(tvec.scale(torch.from_numpy(a), 2.5).numpy(),
                          np.asarray(jvec.scale(a, 2.5)))
    got = tvec.mutate_indexed(torch.from_numpy(a), lambda x, i: x * i.float()).numpy()
    want = np.asarray(jvec.mutate_indexed(a, lambda x, i: x * i.astype(np.float32)))
    assert np.array_equal(got, want)
    assert np.array_equal(tvec.mutate(a, lambda x: x * 2).numpy(),
                          np.asarray(jvec.mutate(a, lambda x: x * 2)))


def test_vecops_mirror_reference_vectors():
    assert tvec.mirror(torch.arange(4)).tolist() == [2, 3, 0, 1]
    assert tvec.mirror(torch.arange(5)).tolist() == [2, 3, 0, 1, 4]


def test_cvec_chain_matches_jax():
    twos = np.full(100, 2 + 2j, np.complex64)
    ones = np.full(100, 1 + 1j, np.complex64)

    def chain(cls, real, ones_like):
        return (cls(twos).vec_div(twos).vec_mul(twos).vec_zero().vec_add(ones)
                .vec_sub(twos).vec_clone(ones)
                .vec_mutate(lambda c: real(c) - 1j * ones_like(real(c)))
                .vec_conj().vec_mirror().vec_scale(2.0))

    got = chain(tvec.CVec, torch.real, torch.ones_like).array.numpy()
    want = np.asarray(chain(jvec.CVec, np.real, np.ones_like).array)
    assert np.array_equal(got, want)
    assert len(tvec.CVec(twos)) == 100 and "CVec" in repr(tvec.CVec(twos[:2]))


def test_cvec_fft_roundtrips():
    v = tvec.CVec(np.full(100, 1 + 1j, np.complex64))
    out = v.vec_fft(tfft.Scale.SN).vec_ifft(tfft.Scale.SN).array.numpy()
    tevm.assert_evm(out, np.full(100, 1 + 1j, np.complex64), -80.0)
    p = tfft.plan(100)
    out = v.vec_rfft(p, tfft.Scale.SN).vec_scale(2.0).vec_rifft(p, tfft.Scale.SN).array.numpy()
    tevm.assert_evm(out, np.full(100, 2 + 2j, np.complex64), -72.0)
