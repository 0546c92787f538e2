"""The port's host utilities against the JAX package's originals:
``utils.metrics.StageStats`` (a copy: same reports under one clock),
``utils.file`` (a copy: files written by either are byte-identical and read
back by the other), ``native`` with ``csrc/hostops.cpp`` (a copy: the same
arrays from the compiled path and the numpy fallback, and the same feeder
blocks), ``utils.profiling`` on ``torch.profiler``, and the port importing
with ``jax`` and the JAX package blocked.
"""

import inspect
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from aether_primitives_tpu_torch import native as tnative
from aether_primitives_tpu_torch.utils import file as tfile
from aether_primitives_tpu_torch.utils import metrics as tmetrics
from aether_primitives_tpu_torch.utils import profiling

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def jax_utils():
    pytest.importorskip("jax")
    from aether_primitives_tpu import native as jnative
    from aether_primitives_tpu.utils import file as jfile
    from aether_primitives_tpu.utils import metrics as jmetrics

    return jnative, jfile, jmetrics


def _capture(n, seed=815):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)


# -- StageStats ----------------------------------------------------------------


def test_stage_stats_is_a_copy(jax_utils):
    _, _, jmetrics = jax_utils
    assert inspect.getsource(tmetrics.StageStats) == inspect.getsource(jmetrics.StageStats)


def test_stage_stats_reports_equal_under_one_clock(jax_utils, monkeypatch):
    _, _, jmetrics = jax_utils
    clock = {"t": 100.0}
    monkeypatch.setattr("time.monotonic", lambda: clock["t"])
    logs = {"port": [], "jax": []}
    stats = {"port": tmetrics.StageStats("rx stream", report_every_s=0.5,
                                         printer=logs["port"].append, window_started=100.0),
             "jax": jmetrics.StageStats("rx stream", report_every_s=0.5,
                                        printer=logs["jax"].append, window_started=100.0)}
    assert stats["port"].summary() == stats["jax"].summary()
    for i in range(12):
        clock["t"] += 0.125 + 0.01 * i
        for s in stats.values():
            s.record(0.003 * (i + 1), samples=4096 * (i % 3))
    assert logs["port"] == logs["jax"] and len(logs["port"]) >= 3
    p, j = stats["port"], stats["jax"]
    assert p.summary() == j.summary()
    assert (p.total_n, p.total_samples, p.total_active_s) == (j.total_n, j.total_samples,
                                                              j.total_active_s)
    assert p.lifetime_ops_per_s(3.0) == j.lifetime_ops_per_s(3.0)


# -- native --------------------------------------------------------------------


def test_hostops_source_is_a_copy():
    port = REPO / "aether_primitives_tpu_torch" / "csrc" / "hostops.cpp"
    assert port.read_bytes() == (REPO / "csrc" / "hostops.cpp").read_bytes()


def test_native_builds_and_loads():
    assert tnative.available(), "the port's native host extension failed to build/load"


@pytest.mark.parametrize("native_path", [True, False])
def test_native_ops_match_jax(jax_utils, monkeypatch, native_path):
    jnative, _, _ = jax_utils
    if not native_path:
        monkeypatch.setattr(tnative, "_load", lambda: None)
        monkeypatch.setattr(jnative, "_load", lambda: None)
    x = _capture(50_001)
    for a, b in zip(tnative.deinterleave(x), jnative.deinterleave(x)):
        assert np.array_equal(a, b)
    x2 = _capture(32 * 64).reshape(32, 64)
    t_re, t_im = tnative.deinterleave(x2)
    assert t_re.shape == (32, 64) and np.array_equal(t_re, x2.real)
    assert np.array_equal(tnative.interleave(t_re, t_im), jnative.interleave(t_re, t_im))
    x[1234] = 30 + 40j
    assert tnative.peak(x) == jnative.peak(x)
    bits = np.random.default_rng(3).integers(0, 2, 1003).astype(np.uint8)
    packed = tnative.pack_bits(bits)
    assert np.array_equal(packed, jnative.pack_bits(bits))
    assert np.array_equal(tnative.unpack_bits(packed, 1003), jnative.unpack_bits(packed, 1003))
    assert np.array_equal(tnative.unpack_bits(packed, 1003), bits)


@pytest.mark.parametrize("native_path", [True, False])
@pytest.mark.parametrize("n,block,depth", [(10_000, 4096, 3), (2048, 1024, 2), (5000, 2048, 4)])
def test_stream_blocks_match_jax(jax_utils, tmp_path, monkeypatch, native_path, n, block, depth):
    jnative, jfile, _ = jax_utils
    if not native_path:
        monkeypatch.setattr(tnative, "_load", lambda: None)
        monkeypatch.setattr(jnative, "_load", lambda: None)
    x = _capture(n, 7)
    p = tmp_path / "cap.bin"
    tfile.save(p, x)
    with tfile.stream_blocks(p, block, depth=depth) as feeder:
        got = list(feeder)
    want = list(jfile.stream_blocks(p, block, depth=depth))
    assert [g[0].size for g in got] == [w[0].size for w in want]
    assert [g[0].size for g in got] == [block] * (n // block) + ([n % block] if n % block else [])
    for (gr, gi), (wr, wi) in zip(got, want):
        assert np.array_equal(gr, wr) and np.array_equal(gi, wi)
    assert np.array_equal(np.concatenate([g[0] for g in got]), x.real)


def test_stream_blocks_missing_file(tmp_path):
    with pytest.raises(FileNotFoundError):
        tfile.stream_blocks(tmp_path / "nope.bin", 1024)


# -- utils.file ----------------------------------------------------------------


def test_raw_files_identical_both_ways(jax_utils, tmp_path):
    _, jfile, _ = jax_utils
    x = _capture(3000, 8)
    tfile.save(tmp_path / "t.bin", x)
    jfile.save(tmp_path / "j.bin", x)
    assert (tmp_path / "t.bin").read_bytes() == (tmp_path / "j.bin").read_bytes()
    assert np.array_equal(jfile.load(tmp_path / "t.bin"), x)
    assert np.array_equal(tfile.load(tmp_path / "j.bin"), x)
    assert np.array_equal(tfile.load(tmp_path / "j.bin", mmap=True), x)
    assert tfile.count_structs_in_file(tmp_path / "t.bin") == 3000
    with tfile.binary_writer(tmp_path / "w.bin") as w:
        w.write(x[:1000])
        w.write(x[1000:])
    assert (tmp_path / "w.bin").read_bytes() == (tmp_path / "j.bin").read_bytes()
    with tfile.binary_reader(tmp_path / "j.bin") as r:
        assert np.array_equal(r.read(10), x[:10])
        assert np.array_equal(r.read_all(), x[10:])
    (tmp_path / "odd.bin").write_bytes(b"\0" * 12)
    for mod in (tfile, jfile):
        with pytest.raises(ValueError, match="integer number"):
            mod.count_structs_in_file(tmp_path / "odd.bin")


@pytest.mark.parametrize("fmt", ["sc16", "sc8", "u8"])
def test_iq_files_identical_both_ways(jax_utils, tmp_path, fmt):
    _, jfile, _ = jax_utils
    x = (0.4 * _capture(999, 9)).astype(np.complex64)
    tfile.save_iq(tmp_path / "t.iq", x, fmt)
    jfile.save_iq(tmp_path / "j.iq", x, fmt)
    assert (tmp_path / "t.iq").read_bytes() == (tmp_path / "j.iq").read_bytes()
    assert np.array_equal(tfile.load_iq(tmp_path / "j.iq", fmt), jfile.load_iq(tmp_path / "t.iq", fmt))
    with pytest.raises(ValueError, match="unknown IQ format"):
        tfile.load_iq(tmp_path / "t.iq", "sc4")


def test_csv_identical_both_ways(jax_utils, tmp_path):
    _, jfile, _ = jax_utils
    x = _capture(50, 10)
    for mod, name in ((tfile, "t.csv"), (jfile, "j.csv")):
        with mod.csv_writer(tmp_path / name) as w:
            w.write(x)
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()
    assert np.array_equal(tfile.csv_reader(tmp_path / "j.csv"), jfile.csv_reader(tmp_path / "t.csv"))


@pytest.mark.parametrize("datatype", ["cf32_le", "ci16_le", "ci8_le"])
def test_sigmf_identical_both_ways(jax_utils, tmp_path, datatype):
    _, jfile, _ = jax_utils
    x = (0.5 * _capture(777, 11)).astype(np.complex64)
    ann = [{"core:sample_start": 0, "core:sample_count": 100, "core:label": "burst"}]
    for mod, base in ((tfile, "t"), (jfile, "j")):
        mod.save_sigmf(tmp_path / base, x, 1e6, frequency=2.4e9, datatype=datatype,
                       description="d", annotations=ann)
    for ext in (".sigmf-data", ".sigmf-meta"):
        assert (tmp_path / f"t{ext}").read_bytes() == (tmp_path / f"j{ext}").read_bytes()
    ts, tmeta = tfile.load_sigmf(tmp_path / "j")
    js, jmeta = jfile.load_sigmf(tmp_path / "t.sigmf-data")
    assert np.array_equal(ts, js) and tmeta == jmeta


@pytest.mark.parametrize("channels", [1, 2])
def test_wav_identical_both_ways(jax_utils, tmp_path, channels):
    _, jfile, _ = jax_utils
    audio = np.random.default_rng(12).normal(size=(channels, 400)).squeeze()
    tfile.save_wav(tmp_path / "t.wav", audio, 8000)
    jfile.save_wav(tmp_path / "j.wav", audio, 8000)
    assert (tmp_path / "t.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    (ta, tr), (ja, jr) = tfile.load_wav(tmp_path / "j.wav"), jfile.load_wav(tmp_path / "t.wav")
    assert tr == jr == 8000 and np.array_equal(ta, ja) and ta.shape == audio.shape


# -- profiling -------------------------------------------------------------------


def test_device_memory_stats():
    stats = profiling.device_memory_stats()
    if torch.cuda.is_available():
        assert set(stats) == {"bytes_in_use", "peak_bytes_in_use", "bytes_limit"}
        assert stats["bytes_limit"] > 0
    else:
        assert stats == {}


def test_trace_and_annotate(tmp_path):
    with profiling.trace(str(tmp_path / "trace")):
        with profiling.annotate("stage one"):
            y = torch.ones(64) * 2
    assert float(y.sum()) == 128.0
    text = (tmp_path / "trace" / "trace.json").read_text()
    assert "stage one" in text


# -- the port imports nothing of JAX -------------------------------------------


def test_port_imports_with_jax_blocked():
    code = (
        "import importlib, pkgutil, sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'aether_primitives_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import aether_primitives_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "import aether_primitives_tpu_torch.parallel.streaming, aether_primitives_tpu_torch.native\n"
        "import aether_primitives_tpu_torch.models.fsk, aether_primitives_tpu_torch.models.detect\n"
        "import aether_primitives_tpu_torch.ops.analog, aether_primitives_tpu_torch.ops.iir\n"
        "import aether_primitives_tpu_torch.ops._stats, aether_primitives_tpu_torch.utils.db\n"
        "from aether_primitives_tpu_torch.models import css, equalizer, diversity, doa, caf, ofdm\n"
        "from aether_primitives_tpu_torch.models import amc, fhss\n"
        "import aether_primitives_tpu_torch.utils.plot\n"
        "assert pkg.analog is aether_primitives_tpu_torch.ops.analog and pkg.DB is not None\n"
        "print(len(names), sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'aether_primitives_tpu')))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300, env=dict(os.environ))
    assert out.returncode == 0, out.stderr
    count, mods = out.stdout.strip().split(" ", 1)
    assert int(count) >= 30 and mods == "[]"


def test_chip_smoke_imports_nothing_of_jax():
    src = (REPO / "chip_smoke.py").read_text()
    assert "import jax" not in src and "from jax" not in src
    assert "aether_primitives_tpu." not in src.replace("aether_primitives_tpu_torch", "")
