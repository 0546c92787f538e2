"""The port's channelizers (waterfall, Welch, critically sampled and
oversampled PFB, STFT) against ``aether_primitives_tpu.models.channelizer``.

Tolerances:

- port against JAX (``pallas=False`` and ``pallas="interpret"`` where JAX
  reaches the fold kernel): RMS EVM <= -110 dB. Both compute in float32;
  they differ by the FFT library and, in the synthesis spread, by the
  order of the branch sum;
- against a float64 golden: <= -110 dB;
- streaming against one-shot: <= -120 dB for analysis (the same folds,
  frame for frame) and <= -110 dB for the synthesis interior;
- the oversampled analysis -> synthesis roundtrip: <= -70 dB, the
  root-Nyquist floor of ``tests/test_pfb.py``;
- host designs (prototypes, windows, synthesis taps): ``array_equal``, and
  their sources are verbatim copies.
"""

import inspect

import numpy as np
import pytest
import torch

from aether_primitives_tpu.models import channelizer as jch
from aether_primitives_tpu.ops.fft import Scale as JScale
from aether_primitives_tpu_torch.convert import stage_state_from_numpy
from aether_primitives_tpu_torch.evm import evm_rms_db
from aether_primitives_tpu_torch.models import channelizer as tch
from aether_primitives_tpu_torch.ops.fft import Scale

torch.set_num_threads(1)

DB = -110.0


def _c(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# --------------------------------------------------------------- host designs


@pytest.mark.parametrize("name", ["pfb_prototype", "pfb_synthesis_taps", "_stft_window",
                                  "_resolve_window", "pfb_prototype_nyquist"])
def test_host_designs_are_verbatim_copies(name):
    assert inspect.getsource(getattr(tch, name)) == inspect.getsource(getattr(jch, name))


@pytest.mark.parametrize("m,p", [(16, 1), (64, 4), (256, 8), (2048, 8)])
def test_prototypes_equal(m, p):
    assert np.array_equal(tch.pfb_prototype(m, p), jch.pfb_prototype(m, p))
    a, b = tch.pfb_prototype_nyquist(m, p), jch.pfb_prototype_nyquist(m, p)
    assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("complex_taps", [False, True], ids=["real", "complex"])
def test_synthesis_taps_equal(complex_taps):
    m = 32
    h = _c(3 * m, 1) if complex_taps else jch.pfb_prototype(m, 3)
    for q in (None, 12):
        a, b = tch.pfb_synthesis_taps(h, m, q), jch.pfb_synthesis_taps(h, m, q)
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_windows_equal():
    for w in ("hann", "sqrt_hann", "rect"):
        assert np.array_equal(tch._stft_window(w, 64), jch._stft_window(w, 64))
    for w in ("hann", "hamming", "blackman", None):
        a, b = tch._resolve_window(w, 64), jch._resolve_window(w, 64)
        assert (a is None and b is None) or np.array_equal(a, b)


# ------------------------------------------------------------- waterfall, Welch


@pytest.mark.parametrize("kw", [{}, {"use_db": True}, {"window": "hann", "hop": 32},
                                {"window": "blackman", "hop": 16, "use_db": True}],
                         ids=["plain", "db", "hann-hop32", "blackman-hop16-db"])
def test_waterfall_matches_jax(kw):
    x = _c((2, 64 * 20 + 7), 2)
    got = tch.waterfall_spectra(torch.from_numpy(x), 64, **kw)
    want = np.asarray(jch.waterfall_spectra(x, 64, **kw))
    assert got.shape == want.shape
    assert evm_rms_db(_np(got), want) <= DB
    stage = tch.Channelizer(64, device="cpu", **kw)
    assert torch.equal(stage.step(x), got)


@pytest.mark.parametrize("shift", [False, True])
@pytest.mark.parametrize("window", ["hann", None])
def test_welch_matches_jax(window, shift):
    x = _c((2, 5000), 3)
    f1, p1 = tch.welch_psd(x, 128, window=window, fs=2.0, shift=shift)
    f2, p2 = jch.welch_psd(x, 128, window=window, fs=2.0, shift=shift)
    assert np.array_equal(f1, f2)
    assert p1.dtype == torch.float32 and evm_rms_db(_np(p1), np.asarray(p2)) <= DB
    with pytest.raises(ValueError, match="shorter"):
        tch.welch_psd(x[:, :100], 128)


# ------------------------------------------------------ critically sampled PFB


@pytest.mark.parametrize("case", ["default", "complex-batch", "history", "p1"])
def test_pfb_channelize_matches_jax(case):
    m, p = 32, 4
    x = _c((2, m * 25 + 5) if case == "complex-batch" else m * 25, 4)
    kw = {"taps_per_branch": p}
    if case == "complex-batch":
        kw = {"taps": _c(3 * m - 5, 5)}
    if case == "history":
        kw["history"] = _c((p - 1) * m, 6)
    if case == "p1":
        kw = {"taps": np.ones(m, np.float32)}
    got = tch.pfb_channelize(torch.from_numpy(x), m, **kw)
    want = np.asarray(jch.pfb_channelize(x, m, **kw))
    assert got.shape == want.shape
    assert evm_rms_db(_np(got), want) <= DB
    got_db = tch.pfb_spectra(x, m, use_db=True, taps_per_branch=p)
    assert evm_rms_db(_np(got_db), np.asarray(jch.pfb_spectra(x, m, use_db=True,
                                                              taps_per_branch=p))) <= DB


def test_pfb_channelize_f64_golden_and_streaming():
    m, p = 16, 4
    x = _c(m * 30, 7)
    h = tch.pfb_prototype(m, p).astype(np.float64)
    got = _np(tch.pfb_channelize(x, m, taps_per_branch=p))
    fr = x.astype(np.complex128).reshape(-1, m)
    u = np.zeros_like(fr)
    for t in range(fr.shape[0]):
        for pi in range(p):
            if t >= pi:
                u[t] += h.reshape(p, m)[pi] * fr[t - pi]
    assert evm_rms_db(got, np.fft.fft(u, axis=-1)) <= DB
    stage = tch.PfbChannelizer(m, taps_per_branch=p, device="cpu")
    parts = [_np(stage.step(x[i:i + m * 10])) for i in range(0, m * 30, m * 10)]
    assert evm_rms_db(np.concatenate(parts), got) <= -120
    with pytest.raises(ValueError, match="history"):
        tch.pfb_channelize(x, m, taps_per_branch=p, history=np.zeros(5, np.complex64))


@pytest.mark.parametrize("backend", ["reference", "auto"])
@pytest.mark.parametrize("taps", ["ls", "rect", "complex"])
def test_pfb_synthesize_matches_jax(taps, backend):
    m = 32
    g = {"ls": jch.pfb_synthesis_taps(jch.pfb_prototype(m, 3), m),
         "rect": None, "complex": _c(5 * m, 8)}[taps]
    y = _c((2, 23, m), 9)
    got = tch.pfb_synthesize(torch.from_numpy(y), m, taps=g, backend=backend)
    want = np.asarray(jch.pfb_synthesize(y, m, taps=g, pallas=False))
    assert got.shape == want.shape
    assert evm_rms_db(_np(got), want) <= DB
    if taps == "ls":  # the Pallas spread (interpret mode) takes 2-D frames
        interp = np.asarray(jch.pfb_synthesize(y[0], m, taps=g, pallas="interpret"))
        assert evm_rms_db(_np(got[0]), interp) <= DB


def test_pfb_synthesizer_streams_like_jax():
    m = 16
    g = jch.pfb_synthesis_taps(jch.pfb_prototype(m, 2), m)
    y = _c((40, m), 10)
    ours = tch.PfbSynthesizer(m, taps=g, device="cpu")
    theirs = jch.PfbSynthesizer(m, taps=g)
    for a, b in ((0, 17), (17, 40)):
        assert evm_rms_db(_np(ours.step(y[a:b])), np.asarray(theirs.step(y[a:b]))) <= DB
    assert evm_rms_db(_np(ours.flush()), np.asarray(theirs.flush())) <= DB
    with pytest.raises(ValueError, match="Q-1"):
        tch.PfbSynthesizer(m, taps=g, device="cpu").step(y[:3])


# --------------------------------------------------------------------- STFT


@pytest.mark.parametrize("hop,window", [(None, "sqrt_hann"), (16, "hann"), (64, "rect")])
def test_stft_istft_match_jax_and_roundtrip(hop, window):
    x = _c((2, 1000), 11)
    s = tch.stft(torch.from_numpy(x), 64, hop=hop, window=window)
    want = np.asarray(jch.stft(x, 64, hop=hop, window=window))
    assert s.shape == want.shape and evm_rms_db(_np(s), want) <= DB
    back = tch.istft(s, hop=hop, window=window, length=1000)
    assert evm_rms_db(_np(back), np.asarray(jch.istft(want, hop=hop, window=window,
                                                      length=1000))) <= DB
    assert evm_rms_db(_np(back), x) <= -120


def test_istft_rejects_bad_hops():
    s = tch.stft(np.zeros(2048, np.complex64), 256, hop=256, window="hann")
    with pytest.raises(ValueError, match="NOLA"):
        tch.istft(s, hop=256, window="hann")
    with pytest.raises(ValueError, match="multiple"):
        tch.istft(s, hop=100)


# ------------------------------------------------------------ oversampled PFB

# (M, os, P, n): the JAX tests' geometries and smaller
OS_CASES = [(256, 2, 8, 256 * 40 + 13), (128, 4, 4, 128 * 37), (64, 1, 3, 64 * 20 + 5),
            (16, 2, 6, 3000), (32, 4, 5, 1500)]
OS_IDS = [f"m{m}-os{o}-p{p}" for m, o, p, _ in OS_CASES]


@pytest.mark.parametrize("m,os_,p,n", OS_CASES, ids=OS_IDS)
def test_pfb_channelize_os_matches_jax(m, os_, p, n):
    x = _c(n, m + p)
    got = _np(tch.pfb_channelize_os(torch.from_numpy(x), m, os=os_, taps_per_branch=p))
    for pallas in (False, "interpret"):
        want = np.asarray(jch.pfb_channelize_os(x, m, os=os_, taps_per_branch=p,
                                                pallas=pallas))
        assert got.shape == want.shape
        assert evm_rms_db(got, want) <= DB, pallas
    plain = _np(tch.pfb_channelize_os(x, m, os=os_, taps_per_branch=p, backend="reference"))
    assert np.array_equal(plain, got)


@pytest.mark.parametrize("m,os_,p,n", OS_CASES, ids=OS_IDS)
def test_pfb_synthesize_os_matches_jax(m, os_, p, n):
    y = _np(tch.pfb_channelize_os(_c(n, 2 * m + p), m, os=os_, taps_per_branch=p))
    got = _np(tch.pfb_synthesize_os(torch.from_numpy(y), m, os=os_, taps_per_branch=p))
    for pallas in (False, "interpret"):
        want = np.asarray(jch.pfb_synthesize_os(y, m, os=os_, taps_per_branch=p,
                                                pallas=pallas))
        assert got.shape == want.shape
        assert evm_rms_db(got, want) <= DB, pallas
    raw = _np(tch.pfb_synthesize_os(y, m, os=os_, taps_per_branch=p, normalize=False,
                                    length=n, backend="reference"))
    want = np.asarray(jch.pfb_synthesize_os(y, m, os=os_, taps_per_branch=p,
                                            normalize=False, length=n, pallas=False))
    assert raw.shape == (n,) and evm_rms_db(raw, want) <= DB


@pytest.mark.parametrize("which", ["batch", "complex-taps", "short"])
def test_pfb_os_batch_complex_and_short_captures(which):
    m = 16
    if which == "batch":
        x, kw = _c((2, 3, 700), 20), {"taps_per_branch": 3}
    elif which == "complex-taps":
        x, kw = _c((2, 900), 21), {"taps": _c(5 * m - 3, 22)}
    else:
        x, kw = _c(40, 23), {"taps_per_branch": 3}  # shorter than P*M: one frame
    got = _np(tch.pfb_channelize_os(x, m, os=2, **kw))
    want = np.asarray(jch.pfb_channelize_os(x, m, os=2, **kw))
    assert got.shape == want.shape and evm_rms_db(got, want) <= DB
    back = _np(tch.pfb_synthesize_os(got, m, os=2, **kw))
    assert evm_rms_db(back, np.asarray(jch.pfb_synthesize_os(want, m, os=2, **kw))) <= DB


@pytest.mark.parametrize("os_", [2, 4])
def test_pfb_os_complex_prototype_through_the_fold_matches_jax(os_):
    # backend="auto" on a CPU tensor runs the fold's plain twin with the
    # complex tap plane; "reference" runs the same twin
    m = 32
    h = _c(5 * m - 7, 30 + os_)
    x = _c((2, 1500), 31)
    got = tch.pfb_channelize_os(torch.from_numpy(x), m, os=os_, taps=h)
    want = np.asarray(jch.pfb_channelize_os(x, m, os=os_, taps=h))
    assert got.shape == want.shape and evm_rms_db(_np(got), want) <= DB
    assert torch.equal(got, tch.pfb_channelize_os(x, m, os=os_, taps=h, backend="reference"))
    back = tch.pfb_synthesize_os(got, m, os=os_, taps=h)
    jback = np.asarray(jch.pfb_synthesize_os(want, m, os=os_, taps=h))
    assert back.shape == jback.shape and evm_rms_db(_np(back), jback) <= DB
    assert torch.equal(back, tch.pfb_synthesize_os(got, m, os=os_, taps=h, backend="reference"))
    if os_ != 2:
        return
    # the stages carry a complex prototype too
    ana = tch.PfbChannelizerOs(m, os=os_, taps=h, device="cpu")
    syn = tch.PfbSynthesizerOs(m, os=os_, taps=h, device="cpu")
    jana, jsyn = jch.PfbChannelizerOs(m, os=os_, taps=h), jch.PfbSynthesizerOs(m, os=os_, taps=h)
    for blk in (x[0, :700], x[0, 700:]):
        fr = ana.step(blk)
        jfr = np.asarray(jana.step(blk))
        assert evm_rms_db(_np(fr), jfr) <= DB
        assert evm_rms_db(_np(syn.step(fr)), np.asarray(jsyn.step(jfr))) <= DB


def test_pfb_os_stage_tail_straddles_the_seam():
    # blocks shorter than the carried tail: the next tail is part head, part
    # body; the stage still equals one-shot frame for frame
    m, os_ = 16, 2
    x = _c(m * 40, 56)
    whole = _np(tch.pfb_channelize_os(x, m, os=os_, taps_per_branch=4))
    ana = tch.PfbChannelizerOs(m, os=os_, taps_per_branch=4, device="cpu")
    parts = [_np(ana.step(x[:m * 12]))]
    for a in range(m * 12, m * 40, 40):
        try:
            parts.append(_np(ana.step(x[a:a + 40])))
        except ValueError:  # too short for a frame group: nothing consumed
            continue
    got = np.concatenate(parts)
    assert np.array_equal(got, whole[:got.shape[0]])


def test_pfb_os_f64_golden():
    m, os_, p = 8, 2, 3
    hop = m // os_
    x = _c(100, 50)
    h = tch.pfb_prototype_nyquist(m, p).astype(np.float64)
    y = _np(tch.pfb_channelize_os(x, m, os=os_, taps=h))
    t_frames = y.shape[0]
    pm = -(-len(h) // m) * m
    hh = np.pad(h, (0, pm - len(h)))
    xx = np.pad(x.astype(np.complex128), (0, (t_frames - 1) * hop + pm - len(x)))
    ref = np.zeros((t_frames, m), np.complex128)
    mm = np.arange(pm)
    for t in range(t_frames):
        for k in range(m):
            ref[t, k] = np.sum(hh * xx[t * hop + mm] * np.exp(-2j * np.pi * k * (t * hop + mm) / m))
    assert evm_rms_db(y, ref) <= DB


def test_pfb_os_roundtrip_floor():
    n, m = 30000, 64
    x = _c(n, 52)
    back = _np(tch.pfb_synthesize_os(tch.pfb_channelize_os(x, m, os=2), m, os=2, length=n))
    core = slice(2 * m * 16, n - 2 * m * 16)
    assert evm_rms_db(back[core], x[core]) <= -70


def test_pfb_os_streaming_matches_one_shot_and_jax():
    m, os_ = 16, 2
    x = _c(m * 80, 53)
    whole = _np(tch.pfb_channelize_os(x, m, os=os_, taps_per_branch=4))
    ours = tch.PfbChannelizerOs(m, os=os_, taps_per_branch=4, device="cpu")
    theirs = jch.PfbChannelizerOs(m, os=os_, taps_per_branch=4)
    parts = []
    for blk in (x[:m * 30], x[m * 30:m * 55], x[m * 55:]):
        parts.append(_np(ours.step(blk)))
        assert evm_rms_db(parts[-1], np.asarray(theirs.step(blk))) <= DB
    got = np.concatenate(parts)
    assert evm_rms_db(got, whole[:got.shape[0]]) <= -120
    # synthesis streaming == the one-shot interior
    whole_e = whole[:whole.shape[0] - whole.shape[0] % os_]
    syn_whole = _np(tch.pfb_synthesize_os(whole_e, m, os=os_, taps_per_branch=4))
    sy = tch.PfbSynthesizerOs(m, os=os_, taps_per_branch=4, device="cpu")
    jsy = jch.PfbSynthesizerOs(m, os=os_, taps_per_branch=4)
    t1 = whole_e.shape[0] // 2 - (whole_e.shape[0] // 2) % os_
    outs = []
    for blk in (whole_e[:t1], whole_e[t1:]):
        outs.append(_np(sy.step(blk)))
        assert evm_rms_db(outs[-1], np.asarray(jsy.step(blk))) <= DB
    outs.append(_np(sy.flush()))
    assert evm_rms_db(outs[-1], np.asarray(jsy.flush())) <= DB
    got_s = np.concatenate(outs)
    core = slice(8 * m, min(len(got_s), len(syn_whole)) - 8 * m)
    assert evm_rms_db(got_s[core], syn_whole[core]) <= DB


def test_pfb_os_stages_roundtrip_at_zero_lag():
    m = 32
    n = m * 200
    x = _c(n, 54)
    ana = tch.PfbChannelizerOs(m, os=2, device="cpu")
    syn = tch.PfbSynthesizerOs(m, os=2, device="cpu")
    back = np.concatenate([_np(syn.step(ana.step(x[i * n // 4:(i + 1) * n // 4])))
                           for i in range(4)])
    pm = 33 * m
    core = slice(2 * pm, len(back) - pm)
    assert evm_rms_db(back[core], x[core]) <= -70


def test_state_carries_over_from_jax():
    m, os_ = 16, 2
    x = _c(m * 70, 55)
    a, b = x[:m * 33], x[m * 33:]
    jana = jch.PfbChannelizerOs(m, os=os_, taps_per_branch=4)
    jsyn = jch.PfbSynthesizerOs(m, os=os_, taps_per_branch=4)
    jsyn.step(jana.step(a))
    ana = stage_state_from_numpy(tch.PfbChannelizerOs(m, os=os_, taps_per_branch=4,
                                                      device="cpu"),
                                 tail=np.asarray(jana._tail))
    syn = stage_state_from_numpy(tch.PfbSynthesizerOs(m, os=os_, taps_per_branch=4,
                                                      device="cpu"),
                                 tail=np.asarray(jsyn._tail))
    y_j = jana.step(b)
    y_t = ana.step(b)
    assert evm_rms_db(_np(y_t), np.asarray(y_j)) <= DB
    assert evm_rms_db(_np(syn.step(y_t)), np.asarray(jsyn.step(y_j))) <= DB
    with pytest.raises(ValueError, match="only a tail"):
        stage_state_from_numpy(ana, phase=0.1)


def test_stages_validate():
    with pytest.raises(ValueError, match="os must divide"):
        tch.pfb_channelize_os(_c(400, 1), 16, os=3)
    with pytest.raises(ValueError, match="os must divide"):
        tch.pfb_synthesize_os(_c((4, 16), 1), 16, os=5)
    with pytest.raises(ValueError, match="block too short"):
        tch.PfbChannelizerOs(16, os=2, taps_per_branch=4, device="cpu").step(
            np.zeros(32, np.complex64))
    with pytest.raises(ValueError, match="multiple of os"):
        tch.PfbSynthesizerOs(16, os=2, taps_per_branch=4, device="cpu").step(
            np.zeros((3, 16), np.complex64))
    for bad in ("xla", "pallas", "interpret"):
        with pytest.raises(ValueError, match="unknown backend"):
            tch.pfb_channelize_os(_c(400, 1), 16, backend=bad)
        with pytest.raises(ValueError, match="unknown backend"):
            tch.pfb_synthesize(_c((4, 16), 1), 16, backend=bad)


def test_stages_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: tch.PfbChannelizerOs(16), lambda: tch.PfbSynthesizerOs(16),
                 lambda: tch.PfbChannelizer(16), lambda: tch.PfbSynthesizer(16),
                 lambda: tch.Channelizer(16)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()


def test_scale_defaults_follow_jax():
    x = _c(3000, 60)
    y = tch.pfb_channelize_os(x, 16, os=2, taps_per_branch=3, scale=Scale.SN)
    want = np.asarray(jch.pfb_channelize_os(x, 16, os=2, taps_per_branch=3, scale=JScale.SN))
    assert evm_rms_db(_np(y), want) <= DB
    sig = inspect.signature
    assert sig(tch.pfb_channelize_os).parameters["scale"].default == Scale.NONE
    assert sig(tch.pfb_synthesize_os).parameters["scale"].default == Scale.N
    assert sig(tch.pfb_synthesize).parameters["scale"].default == Scale.N
    assert sig(tch.stft).parameters["scale"].default == Scale.SN
    assert sig(tch.pfb_synthesize).parameters["backend"].default == "reference"
    assert sig(tch.pfb_channelize_os).parameters["backend"].default == "auto"


# ------------------------------------------------------------- sharded forms


def _meshes(axis):
    from aether_primitives_tpu.parallel import mesh as jmesh
    from aether_primitives_tpu_torch.parallel import mesh as tmesh

    return tmesh.make_mesh({axis: 8}, devices=["cpu"] * 8), jmesh.make_mesh({axis: 8})


def test_sharded_pfb_matches_single_and_jax(eight_devices):
    # tests/test_pfb.py: the sharded PFB equals the one-device PFB bit for bit
    m_t, m_j = _meshes("time")
    m, p = 16, 4
    x = _c(8 * m * 4, 36)  # 4 frames per shard
    single = tch.pfb_channelize(x, m, taps_per_branch=p)
    sharded = tch.sharded_pfb(x, m, m_t, taps_per_branch=p)
    assert sharded.spec == ("time", None)
    assert torch.equal(sharded.gather(), single)
    want = np.asarray(jch.sharded_pfb(x, m, m_j, taps_per_branch=p))
    assert evm_rms_db(_np(sharded.gather()), want.astype(np.complex128)) < DB
    rows = tch.sharded_pfb(_c((2, 8 * m * 4), 38), m, m_t, taps_per_branch=1)
    assert rows.shape == (2, 32, m)  # P = 1: no halo


def test_sharded_pfb_os_matches_single_and_jax(eight_devices):
    m_t, m_j = _meshes("time")
    m, p = 16, 4  # the prototype spans 2p+1 = 9 branches: a right halo of 136 samples
    x = _c(8 * m * 12, 37)  # span 192 >= the halo
    single = tch.pfb_channelize_os(x, m, os=2, taps_per_branch=p)
    sharded = tch.sharded_pfb_os(x, m, m_t, os=2, taps_per_branch=p).gather()
    # sharded emits n/hop frames (the capture's end zero-extended); the
    # one-shot emits the frames whose windows fit: a prefix
    t = single.shape[0]
    assert sharded.shape[0] == x.shape[-1] // (m // 2) >= t
    assert torch.equal(sharded[:t], single)
    assert bool(torch.isfinite(sharded[t:].abs()).all())
    want = np.asarray(jch.sharded_pfb_os(x, m, m_j, os=2, taps_per_branch=p))
    assert want.shape == tuple(sharded.shape)
    assert evm_rms_db(_np(sharded), want.astype(np.complex128)) < DB
    for fn, mesh in ((tch.sharded_pfb_os, m_t), (jch.sharded_pfb_os, m_j)):
        with pytest.raises(ValueError, match="span"):  # undersized spans are refused
            fn(_c(8 * m * 6, 39), m, mesh, os=2, taps_per_branch=p)
    with pytest.raises(ValueError, match="divisible by n_chan"):
        tch.sharded_pfb_os(_c(8 * (m * 12 + 8), 39), m, m_t, os=2, taps_per_branch=p)
    with pytest.raises(ValueError, match="os must divide"):
        tch.sharded_pfb_os(x, m, m_t, os=3)


@pytest.mark.parametrize("use_db", [False, True])
def test_sharded_waterfall_matches_single_and_jax(eight_devices, use_db):
    m_t, m_j = _meshes("channel")
    cap = _c(8 * 4 * 256, 40)  # 32 rows of 256 over 8 shards
    single = tch.waterfall_spectra(cap, 256, use_db=use_db)
    sharded = tch.sharded_waterfall(cap, 256, m_t, use_db=use_db)
    assert sharded.spec == ("channel", None)
    assert torch.equal(sharded.gather(), single)
    want = np.asarray(jch.sharded_waterfall(cap, 256, m_j, use_db=use_db))
    assert np.allclose(_np(sharded.gather()), want, atol=1e-5 if not use_db else 1e-3)
