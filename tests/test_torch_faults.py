"""The port's repaired faults against the JAX package (ROADMAP.md §3,
F1-F7), each on the same numpy inputs from a seed through both packages.

Tolerances are the reference's own: filters RMS EVM <= -120 dB against the
JAX function, spectra <= -80 dB, the RX chain's bits >= 0.99999 agreement
(two float32 implementations may split a sign only on near-zero bins,
ROADMAP.md §3.5), and exact equality where the reference is exact
(scrambler bits, the Split planes, the bound arguments of a call).
"""

import dataclasses
import inspect
import types

import numpy as np
import pytest
import torch

import aether_primitives_tpu_torch as tp
from aether_primitives_tpu_torch import boundary, convert
from aether_primitives_tpu_torch import types as ttypes
from aether_primitives_tpu_torch.evm import evm_rms_db
from aether_primitives_tpu_torch.models import RxChain, RxChainConfig, channelizer, ddc
from aether_primitives_tpu_torch.models import sync as tsync
from aether_primitives_tpu_torch.ops import fft as tfft
from aether_primitives_tpu_torch.ops import fir as tfir
from aether_primitives_tpu_torch.ops import sequence as tseq
from aether_primitives_tpu_torch.ops.cuda import rx_frame as rf

torch.set_num_threads(1)

FILTER_DB, SPECTRUM_DB, AGREEMENT = -120.0, -80.0, 0.99999


@pytest.fixture(scope="module")
def jx():
    """The JAX side (imported here, so the file loads without jax)."""
    pytest.importorskip("jax")
    import aether_primitives_tpu as jtop
    from aether_primitives_tpu import boundary as jboundary
    from aether_primitives_tpu import types as jtypes
    from aether_primitives_tpu.models import channelizer as jch
    from aether_primitives_tpu.models import ddc as jddc
    from aether_primitives_tpu.models import modem as jmodem
    from aether_primitives_tpu.models import sync as jsync
    from aether_primitives_tpu.ops import fft as jfft
    from aether_primitives_tpu.ops import fir as jfir
    from aether_primitives_tpu.ops import sequence as jseq

    return types.SimpleNamespace(top=jtop, boundary=jboundary, types=jtypes, ch=jch, ddc=jddc,
                                 modem=jmodem, sync=jsync, fft=jfft, fir=jfir, seq=jseq)


def _c(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)


# ------------------------------------------------------------ F1: per-row taps


@pytest.mark.parametrize("x_shape,taps_shape", [((3, 4096), (3, 17)), ((2, 3, 1000), (3, 9)),
                                                ((2, 3, 1000), (2, 1, 9))])
def test_f1_fir_filter_os_filters_each_row_by_its_taps(jx, x_shape, taps_shape):
    x, taps = _c(x_shape, 1), _c(taps_shape, 2)
    hist = _c(x_shape[:-1] + (taps_shape[-1] - 1,), 3)
    want = np.asarray(jx.fir.fir_filter_os(x, taps, history=hist))
    got = tfir.fir_filter_os(torch.from_numpy(x), taps, history=torch.from_numpy(hist))
    assert got.shape == want.shape
    assert evm_rms_db(got.numpy(), want) <= FILTER_DB


@pytest.mark.parametrize("as_tensor", [False, True])
def test_f1_matched_filter_correlates_each_row_with_its_reference(jx, as_tensor):
    x, ref = _c((3, 4096), 4), _c((3, 33), 5)
    want = np.asarray(jx.fir.matched_filter(x, ref, block_len=512))
    got = tfir.matched_filter(torch.from_numpy(x), torch.from_numpy(ref) if as_tensor else ref,
                              block_len=512)
    assert evm_rms_db(got.numpy(), want) <= FILTER_DB


def test_f1_single_tap_vector_filters_raise_on_per_row_taps(jx):
    x, taps = _c((3, 256), 6), _c((3, 17), 7)
    for jfn, tfn in ((jx.fir.fir_filter, tfir.fir_filter),
                     (lambda a, b: jx.fir.fir_filter_decimate(a, b, 2),
                      lambda a, b: tfir.fir_filter_decimate(a, b, 2))):
        with pytest.raises(ValueError):
            jfn(x, taps)
        with pytest.raises(ValueError, match="one \\[K\\] tap vector"):
            tfn(torch.from_numpy(x), taps)
    for call in (lambda: tfir.fir_filter_os_decimate(torch.from_numpy(x), taps, 2),
                 lambda: tfir.fir_decimate_fft(torch.from_numpy(x), taps, 2, 64)):
        with pytest.raises(ValueError, match="one \\[K\\] tap vector"):
            call()
    # one tap vector in a [1, K] array still filters, as a [K] one
    one = taps[:1]
    want = np.asarray(jx.fir.fir_filter_os(x, one[0]))
    assert evm_rms_db(tfir.fir_filter_os(torch.from_numpy(x), one).numpy(), want) <= FILTER_DB


# --------------------------------------------------- F2: the Split and types surface


def test_f2_split_methods_and_trees_match_jax(jx):
    x = _c((2, 5), 8)
    js, ts = jx.boundary.split(x), boundary.split(x)
    assert ts.shape == tuple(js.shape) == (2, 5)
    assert np.array_equal(ts.numpy(), js.numpy()) and ts.numpy().dtype == np.complex64
    assert np.array_equal(ts.to_complex().numpy(), np.asarray(js.to_complex()))
    tree = {"a": [x, 3], "b": (x[0], "s")}
    jt, tt = jx.boundary.tree_split(tree), boundary.tree_split(tree)
    assert isinstance(tt["a"][0], boundary.Split) and isinstance(tt["b"][0], boundary.Split)
    assert np.array_equal(tt["a"][0].numpy(), jt["a"][0].numpy()) and tt["a"][1] == 3
    back = boundary.tree_merge(tt)
    assert torch.equal(back["b"][0], torch.from_numpy(x[0])) and back["b"][1] == "s"
    conj = boundary.f32_boundary(torch.conj)
    assert conj.__name__ == "conj_f32"
    assert np.array_equal(conj(ts).numpy(), np.conj(x))


def test_f2_types_match_jax(jx):
    assert str(ttypes.cf64).split(".")[-1] == np.dtype(jx.types.cf64).name == "complex128"
    x = _c((3, 7), 9)
    jre, jim = jx.types.split_complex(x)
    tre, tim = ttypes.split_complex(x)
    assert tre.dtype == tim.dtype == torch.float32
    assert np.array_equal(tre.numpy(), np.asarray(jre)) and np.array_equal(tim.numpy(), np.asarray(jim))
    merged = ttypes.merge_complex(tre, tim)
    assert merged.dtype == torch.complex64
    assert np.array_equal(merged.numpy(), np.asarray(jx.types.merge_complex(jre, jim)))


# ------------------------------------------------------------ F3: the exports


def test_f3_top_level_exports_what_is_ported(jx):
    ported = ("parallel", "utils", "vecops", "sequence", "frontend", "fec", "CVec", "cf64",
              "f32_boundary")
    for name in ported:
        assert name in jx.top.__all__ and name in tp.__all__, name
        assert getattr(tp, name) is not None
    assert tp.parallel.mesh.make_mesh is not None and tp.utils.StageStats is not None
    assert set(tp.__all__) - set(jx.top.__all__) <= {"evm_rms_db", "RxChain", "RxChainConfig",
                                                     "PacketConfig", "PacketModem"}
    assert "Two paths" not in tp.__doc__


# ------------------------------------------------------------ F4: the fft_backend slot

#: (port function, JAX function name in module, positional arguments up to the slot)
_SLOT_CALLS = [
    (tfir.fir_filter_os, "fir.fir_filter_os", ("x", "taps", 256, "xla", "hist")),
    (tfir.fir_filter_os_decimate, "fir.fir_filter_os_decimate", ("x", "taps", 4, 256, "xla", "h")),
    (tfir.matched_filter, "fir.matched_filter", ("x", "ref", 256, "xla", "hist")),
    (tfir.fir_decimate_fft, "fir.fir_decimate_fft",
     ("x", "taps", 4, 64, "scale", "hist", "xla", None, 16)),
    (tfft.fft, "fft.fft", ("x", "scale", "xla")),
    (tfft.ifft, "fft.ifft", ("x", "scale", "xla")),
    (tfft.plan, "fft.plan", (64, "xla")),
    (tfft.fft_of_decimated, "fft.fft_of_decimated", ("x", 2, "scale", "xla")),
    (channelizer.waterfall_spectra, "ch.waterfall_spectra", ("x", 64, True, "xla", "w")),
    (channelizer.welch_psd, "ch.welch_psd", ("x", 64, 32, "hann", 2.0, "xla", True)),
    (channelizer.pfb_channelize, "ch.pfb_channelize", ("x", 16, None, 8, "scale", "xla", "h")),
    (channelizer.pfb_spectra, "ch.pfb_spectra", ("x", 16, True, None, 8, "xla")),
    (channelizer.pfb_synthesize_os, "ch.pfb_synthesize_os",
     ("f", 16, 2, None, 16, "scale", "xla", 100)),
    (channelizer.istft, "ch.istft", ("f", 16, "w", "scale", "xla", 100)),
    (channelizer.stft, "ch.stft", ("x", 64, 16, "w", "scale", "xla")),
    (channelizer.sharded_pfb, "ch.sharded_pfb", ("x", 16, "mesh", None, 8, "s", "time", "xla")),
    (channelizer.sharded_pfb_os, "ch.sharded_pfb_os",
     ("x", 16, "mesh", 2, None, 16, "s", "time", "xla")),
    (channelizer.sharded_waterfall, "ch.sharded_waterfall", ("x", 64, "mesh", True, "c", "xla")),
    (ddc.ddc_bank, "ddc.ddc_bank", ("x", [0.1], 4, None, "xla")),
    (tsync.detect_preamble, "sync.detect_preamble", ("x", "pre", "xla")),
]
_SLOT_CLASSES = [
    (channelizer.Channelizer, "ch.Channelizer", (64, True, "w", 32, "xla")),
    (channelizer.PfbChannelizer, "ch.PfbChannelizer", (16, None, 8, "scale", "xla")),
    (channelizer.PfbSynthesizer, "ch.PfbSynthesizer", (16, None, "scale", "xla")),
    (channelizer.PfbChannelizerOs, "ch.PfbChannelizerOs", (16, 2, None, 16, "scale", "xla")),
    (channelizer.PfbSynthesizerOs, "ch.PfbSynthesizerOs", (16, 2, None, 16, "scale", "xla")),
]


def _jax_obj(jx, dotted):
    mod, name = dotted.split(".")
    return getattr(getattr(jx, mod), name)


@pytest.mark.parametrize("fn,jname,args", _SLOT_CALLS, ids=[c[1] for c in _SLOT_CALLS])
def test_f4_positional_calls_bind_the_same_arguments(jx, fn, jname, args):
    want = inspect.signature(_jax_obj(jx, jname)).bind(*args).arguments
    got = inspect.signature(fn).bind(*args).arguments
    assert got == want


@pytest.mark.parametrize("cls,jname,args", _SLOT_CLASSES, ids=[c[1] for c in _SLOT_CLASSES])
def test_f4_stage_classes_keep_the_slot_before_device(jx, cls, jname, args):
    want = inspect.signature(_jax_obj(jx, jname).__init__).bind("self", *args).arguments
    got = inspect.signature(cls.__init__).bind("self", *args).arguments
    assert got == want and "device" not in got


def test_f4_backends_accept_xla_and_refuse_matmul(jx):
    x = _c((2, 1024), 10)
    taps = _c((33,), 11)
    hist = _c((2, 32), 12)
    want = np.asarray(jx.fir.fir_filter_os(x, taps, 256, None, hist))
    got = tfir.fir_filter_os(torch.from_numpy(x), taps, 256, "xla", torch.from_numpy(hist))
    assert evm_rms_db(got.numpy(), want) <= FILTER_DB
    with pytest.raises(ValueError, match="cuFFT"):
        tfir.fir_filter_os(torch.from_numpy(x), taps, 256, "matmul")
    with pytest.raises(ValueError, match="cuFFT"):
        tfft.fft(torch.from_numpy(x), tfft.Scale.NONE, "matmul")
    with pytest.raises(ValueError, match="unknown fft_backend"):
        tfft.plan(64, "mxu")
    with pytest.raises(ValueError, match="cuFFT"):
        channelizer.PfbChannelizerOs(16, fft_backend="matmul", device="cpu")
    with pytest.raises(ValueError, match="cuFFT"):
        ddc.Ddc(ddc.DdcConfig(fft_backend="matmul"), device="cpu")
    with pytest.raises(ValueError, match="cuFFT"):
        RxChain(RxChainConfig(fft_backend="matmul"), device="cpu")


def test_f4_configs_carry_the_field(jx):
    for jcls, tcls in ((jx.modem.RxChainConfig, RxChainConfig), (jx.ddc.DdcConfig, ddc.DdcConfig),
                       (jx.ddc.DucConfig, ddc.DucConfig)):
        assert [f.name for f in dataclasses.fields(tcls)] == [f.name for f in dataclasses.fields(jcls)]
    jcfg = jx.modem.RxChainConfig(fft_len=256, fft_backend="xla", packed_bits=True)
    cfg = convert.config_from_numpy(dataclasses.asdict(jcfg))
    assert cfg.fft_backend == "xla" and RxChain(cfg, device="cpu").config.fft_backend == "xla"
    dcfg = convert.ddc_config_from_numpy(dataclasses.asdict(jx.ddc.DdcConfig(fft_backend="xla")))
    assert dcfg.fft_backend == "xla"
    # a config tuned for the TPU's matmul FFT carries over onto cuFFT
    tpu = convert.config_from_numpy(dataclasses.asdict(jx.modem.RxChainConfig(fft_backend="matmul")))
    assert tpu.fft_backend is None
    assert not hasattr(convert, "_DROPPED")


# ------------------------------------------------------------ F5


@pytest.mark.parametrize("m,grid", [(4, "diagonal"), (4, "axes"), (8, "axes"), (2, "axes")])
def test_f5_estimate_phase_mpsk_grid_matches_jax(jx, m, grid):
    rng = np.random.default_rng(13)
    k = rng.integers(0, m, (3, 512))
    off = np.pi / m if grid == "diagonal" else 0.0
    x = (np.exp(1j * (2 * np.pi * k / m + off + 0.07)) + 0.05 * _c((3, 512), 14)).astype(np.complex64)
    want = np.asarray(jx.sync.estimate_phase_mpsk(x, m, grid))
    got = tsync.estimate_phase_mpsk(torch.from_numpy(x), m, grid).numpy()
    assert np.allclose(got, want, atol=1e-5) and np.allclose(got, 0.07, atol=0.02)
    with pytest.raises(ValueError, match="grid"):
        tsync.estimate_phase_mpsk(torch.from_numpy(x), m, "ring")


def test_f5_scramble_multiplicative_takes_block(jx):
    bits = np.random.default_rng(15).integers(0, 2, 1000).astype(np.uint8)
    want = np.asarray(jx.seq.scramble_multiplicative(bits, (14, 15), None, 64))
    got = tseq.scramble_multiplicative(torch.from_numpy(bits), (14, 15), None, 64)
    assert np.array_equal(got.numpy(), want.astype(np.uint8))


# ------------------------------------------------------------ F6


@pytest.mark.parametrize("mod", ["qpsk", "bpsk"])
def test_f6_unpacked_chain_of_partial_bytes_returns_bits(jx, mod):
    jcfg = jx.modem.RxChainConfig(fft_len=30, decimation=5, modulation=mod)
    jchain = jx.modem.RxChain(jcfg)
    chain = RxChain(convert.config_from_numpy(dataclasses.asdict(jcfg)), device="cpu")
    assert chain._sign_fast_path_ok()
    x = _c((2, 150 * 24), 16)
    jstate, state = jchain.init_state((2,)), chain.init_state((2,))
    for xb in (x[:, :1800], x[:, 1800:]):
        jb, jstate = jchain.streaming_step(xb, jstate)
        b, state = chain.streaming_step(torch.from_numpy(xb), state)
        assert b.shape == np.shape(jb) and b.dtype == torch.uint8
        assert (b.numpy() == np.asarray(jb)).mean() >= AGREEMENT
        assert np.array_equal(state.numpy(), np.asarray(jstate))


# ------------------------------------------------------------ F7


@pytest.mark.parametrize("dec,fft_len,instance", [(4, 4096, "tile512"), (4, 64, "tile256"),
                                                  (1, 128, "tile256"), (5, 30, "generic")])
def test_f7_the_cards_split_agrees_with_jax(jx, dec, fft_len, instance):
    # the card's own factorisation (kernel_plan) through the plain twin,
    # against the JAX chain's spectra and bits at the usual bars
    chain = RxChain(RxChainConfig(fft_len=fft_len, decimation=dec), device="cpu")
    plan = rf.kernel_plan(dec, fft_len, None, chain.taps.shape[-1])
    assert plan[0] == instance
    span = dec * fft_len
    x = _c((span * max(2, 8192 // span),), 17)
    hist = _c((chain.taps.shape[-1] - 1,), 18)
    want = np.asarray(jx.fir.fir_decimate_fft(x, chain.taps, dec, fft_len, jx.fft.Scale.SN,
                                              history=hist))
    got = rf.rx_frame_reference(torch.from_numpy(x), chain.taps, dec, fft_len,
                                torch.from_numpy(hist), "spectrum", plan[1])
    assert evm_rms_db(got.numpy(), want) <= SPECTRUM_DB
    bits = rf.sign_bits(got, "qpsk").numpy()
    jbits = np.stack([want.real < 0, want.imag < 0], -1).astype(np.uint8).reshape(-1)
    assert (bits == jbits).mean() >= AGREEMENT
