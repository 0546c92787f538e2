"""The port's plotting (``utils/plot.py``): its compute cores against the
JAX package's same computations on the same seeded numpy inputs, and every
figure rendered and saved.

Tolerances: spectrum levels and the ambiguity image (``|CAF|`` in dB) RMS
EVM <= -100 dB against the JAX package's, linear and in dB;
the spatial spectrum's dB curve within 1e-9 dB of the same float64
arithmetic on the JAX package's spectrum (the spectra themselves agree
within rtol 1e-3, ``tests/test_torch_doa.py``). The module imports without
matplotlib; the rendering cases skip without it.
"""

import sys

import numpy as np
import pytest
import torch

from aether_primitives_tpu_torch.evm import evm_rms_db
from aether_primitives_tpu_torch.models import doa as tdoa

torch.set_num_threads(1)

EVM_DB = -100.0


@pytest.fixture(scope="module")
def plot():
    pytest.importorskip("matplotlib")
    from aether_primitives_tpu_torch.utils import plot

    return plot


@pytest.fixture(scope="module")
def jplot():
    pytest.importorskip("jax")
    pytest.importorskip("matplotlib")
    from aether_primitives_tpu.utils import plot

    return plot


@pytest.fixture
def sig():
    rng = np.random.default_rng(512)
    return (rng.normal(size=512) + 1j * rng.normal(size=512)).astype(np.complex64)


def test_plot_loads_lazily_without_matplotlib(monkeypatch):
    import aether_primitives_tpu_torch.utils as tutils

    for name in [m for m in sys.modules if m == "matplotlib" or m.startswith("matplotlib.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.delitem(sys.modules, "aether_primitives_tpu_torch.utils.plot", raising=False)
    monkeypatch.delattr(tutils, "plot", raising=False)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    mod = tutils.plot
    assert mod.spectrum_levels(torch.ones(8, dtype=torch.complex64), 8, False)[0] > 0
    with pytest.raises(ImportError):
        mod.constellation(np.zeros(4, np.complex64), "x", "unused.png")


def test_spectrum_levels_match_jax(jplot, sig):
    from aether_primitives_tpu.ops.fft import Scale, plan

    for n, use_db, s in ((256, False, sig), (128, True, sig), (1024, True, sig[:300])):
        got = __import__("aether_primitives_tpu_torch.utils.plot", fromlist=["x"]).spectrum_levels(
            torch.from_numpy(s), n, use_db)
        ss = np.pad(s, (0, max(0, n - s.size)))
        mag = np.abs(np.asarray(plan(n).fwd(ss[:n].astype(np.complex64), Scale.SN)))
        want = 10.0 * np.log10(mag) if use_db else mag
        assert got.shape == (n,) and evm_rms_db(got, want) <= EVM_DB


def test_ambiguity_levels_match_jax(plot, jplot):
    from aether_primitives_tpu.models.caf import ambiguity

    rng = np.random.default_rng(7)
    ref = (rng.normal(size=512) + 1j * rng.normal(size=512)).astype(np.complex64)
    x = np.roll(ref, 100).astype(np.complex64)
    dops, surf = plot.ambiguity_levels(torch.from_numpy(x), ref, 1e-3, 16, use_db=False)
    jd = np.linspace(-1e-3, 1e-3, 16)
    want = np.abs(np.asarray(ambiguity(x, ref, jd.astype(np.float32))))
    assert np.array_equal(dops, jd) and evm_rms_db(surf, want) <= EVM_DB
    _, sdb = plot.ambiguity_levels(torch.from_numpy(x), ref, 1e-3, 16)
    assert evm_rms_db(sdb, 20.0 * np.log10(np.maximum(want, 1e-12))) <= EVM_DB


def test_doa_levels_match_jax(plot, jplot):
    from aether_primitives_tpu.models import doa as jdoa

    rng = np.random.default_rng(9)
    x = (rng.normal(size=(8, 128)) + 1j * rng.normal(size=(8, 128))).astype(np.complex64)
    ang, spec = tdoa.music_spectrum(tdoa.covariance(torch.from_numpy(x)), 2)
    ja, js = jdoa.music_spectrum(jdoa.covariance(x), 2)
    deg, sdb = plot.doa_levels(ang, spec)
    assert np.array_equal(deg, np.degrees(np.asarray(ja, np.float64)))
    s = np.abs(spec.numpy().astype(np.float64))
    np.testing.assert_allclose(sdb, 10.0 * np.log10(s / (s.max() + 1e-30) + 1e-12), atol=1e-9)
    jsd = np.abs(np.asarray(js, np.float64))
    np.testing.assert_allclose(sdb, 10.0 * np.log10(jsd / (jsd.max() + 1e-30) + 1e-12), atol=0.01)


def test_figures_render_and_save(plot, sig, tmp_path):
    t = torch.from_numpy(sig)
    rng = np.random.default_rng(3)
    up = np.zeros(1600, np.complex64)
    up[::4] = np.exp(1j * np.pi / 4 * (2 * rng.integers(0, 4, 400) + 1))
    ang, spec = tdoa.music_spectrum(tdoa.covariance(torch.from_numpy(
        (rng.normal(size=(8, 128)) + 1j * rng.normal(size=(8, 128))).astype(np.complex64))), 2)
    calls = {
        "c": lambda f: plot.constellation(t, "constellation", f),
        "w": lambda f: plot.waterfall(t, 128, True, "waterfall", f),
        "s": lambda f: plot.spectrum(t, 256, False, "spectrum", f),
        "p": lambda f: plot.psd(np.tile(sig, 16), 512, "psd", file=f),
        "t": lambda f: plot.time(t[:200], "time", f),
        "cmp": lambda f: plot.compare(t[:200], sig[200:400], "compare", f),
        "caf": lambda f: plot.ambiguity_surface(np.roll(sig, 100), sig, 1e-3, 16, file=f),
        "eye": lambda f: plot.eye(np.convolve(up, np.ones(4))[:1600], sps=4, n_traces=100, file=f),
        "doa": lambda f: plot.doa_spectrum(ang, spec, "doa", estimates=[0.1], file=f),
    }
    for name, call in calls.items():
        p = tmp_path / f"{name}.png"
        call(str(p))
        assert p.stat().st_size > 0, name
    with pytest.raises(ValueError, match="equal length"):
        plot.compare(sig[:10], sig[:20], "x")
    with pytest.raises(ValueError, match="too short"):
        plot.eye(np.zeros(4, np.complex64), sps=4)
