"""The port's repaired faults against the JAX package (ROADMAP.md §3,
F1-F16), each on the same numpy inputs from a seed through both packages.

Tolerances are the reference's own: filters RMS EVM <= -120 dB against the
JAX function, spectra <= -80 dB, the RX chain's bits >= 0.99999 agreement
(two float32 implementations may split a sign only on near-zero bins,
ROADMAP.md §3.5), and exact equality where the reference is exact
(scrambler bits, the Split planes, the bound arguments of a call, the
exported names, the filled samples, the configs each package refuses).

F13-F16 are the configurations the card refused before and the JAX package
computes: the port's plain twins against the JAX package on the CPU, and the
plans that now take them.
- F13, the PFB fold past P = 294 branches: the planes twin against the
  Pallas fold (interpret mode) at P = 300 at relative RMS error <= 1e-6
  (``tests/test_torch_pfb_fold.py``'s bar: the same products in the same
  order, the JAX side contracting to FMAs), and the analysis and synthesis
  twins, real and complex taps, against a float64 fold at P 300 and 400.
- F14, the RX frame kernel past 4,096 points with no cluster split and past
  65,536 points: ``RxChain`` at dec 4 / fft_len 4,099, 2 / 8,198 and
  1 / 131,072 against the JAX chain and the float64 chain, two streaming
  blocks: bits >= 0.99999 (exact wherever a decision's margin is clear) and
  block 2's spectrum at <= -80 dB, the carried state exact.
- F15, Viterbi at 2 states, past 256 states and past 8 generators:
  ``viterbi_decode`` at K 2, K 10 and K 7 with 9 generators, full block and
  windowed, exactly (``np.array_equal``).
- F16, the windowed BCJR at state counts outside 4-64:
  ``conv_decode_soft`` windowed at K 2 and K 8, its hard decisions exactly.
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
from aether_primitives_tpu_torch.cli import numpy_reference_spectra
from aether_primitives_tpu_torch.evm import evm_rms_db
from aether_primitives_tpu_torch.models import RxChain, RxChainConfig, channelizer, ddc
from aether_primitives_tpu_torch.models import sync as tsync
from aether_primitives_tpu_torch.ops import fft as tfft
from aether_primitives_tpu_torch.ops import fir as tfir
from aether_primitives_tpu_torch.ops import fec
from aether_primitives_tpu_torch.ops import sequence as tseq
from aether_primitives_tpu_torch.ops.cuda import bcjr as bk
from aether_primitives_tpu_torch.ops.cuda import pfb_fold as pf
from aether_primitives_tpu_torch.ops.cuda import rx_frame as rf
from aether_primitives_tpu_torch.ops.cuda import viterbi as vk

torch.set_num_threads(1)

FILTER_DB, SPECTRUM_DB, AGREEMENT = -120.0, -80.0, 0.99999
EVM_DB = SPECTRUM_DB
MARGIN = 1e-4
FOLD_REL = 1e-6
# float32 against float64 after P = 300 rounded products and sums (each
# within 2^-24 relative): about 1e-6 RMS; the bar leaves a factor of ten
FOLD_F64_REL = 1e-5


@pytest.fixture(scope="module")
def jx():
    """The JAX side (imported here, so the file loads without jax)."""
    pytest.importorskip("jax")
    import aether_primitives_tpu as jtop
    from aether_primitives_tpu import boundary as jboundary
    from aether_primitives_tpu import types as jtypes
    from aether_primitives_tpu import models as jmodels
    from aether_primitives_tpu.models import channel as jchannel
    from aether_primitives_tpu.models import channelizer as jch
    from aether_primitives_tpu.models import ddc as jddc
    from aether_primitives_tpu.models import modem as jmodem
    from aether_primitives_tpu.models import packet as jpacket
    from aether_primitives_tpu.models import sync as jsync
    from aether_primitives_tpu.ops import fft as jfft
    from aether_primitives_tpu.ops import fir as jfir
    from aether_primitives_tpu.ops import sequence as jseq

    return types.SimpleNamespace(top=jtop, boundary=jboundary, types=jtypes, ch=jch, ddc=jddc,
                                 modem=jmodem, sync=jsync, fft=jfft, fir=jfir, seq=jseq,
                                 models=jmodels, channel=jchannel, packet=jpacket)


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


@pytest.mark.parametrize("dec,fft_len,instance", [
    (4, 4096, "direct"), (4, 64, "direct"), (1, 128, "direct"), (5, 30, "direct"),
    (4, 48, "direct"), (1, 16384, "cluster"),
])
def test_f7_the_cards_split_agrees_with_jax(jx, dec, fft_len, instance):
    # the split kernel_plan names for the plain twin (the heuristic's, the
    # JAX package's: dec 4, fft_len 48 -> n1 48; none at dec 1, fft_len
    # 16384, where the twin takes the span-point FFT route), against the JAX
    # chain's spectra and bits at the usual bars
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


# ------------------------------------------------------------ F11: every geometry
# on the card; the plain twin where the chain has no stage split

F11_GEOMETRIES = [(16, 2048), (4, 8192), (64, 512), (1, 65536), (3, 1536), (4, 131), (5, 30)]


@pytest.mark.parametrize("dec,fft_len", F11_GEOMETRIES)
def test_f11_the_twin_agrees_with_jax_where_the_card_raised(jx, dec, fft_len):
    # geometries the RX frame kernel refused before it took every one; the
    # plain twin the card is held to (the staged split where one exists,
    # else the JAX package's span-point FFT route) against JAX
    # fir_decimate_fft and the JAX chain, two-frame blocks, the second with
    # the first's tail as history
    chain = RxChain(RxChainConfig(fft_len=fft_len, decimation=dec, fir_mode="fused"),
                    device="cpu")
    assert rf.kernel_supports(dec, fft_len, None, chain.taps.shape[-1]) is not None
    jchain = jx.modem.RxChain(jx.modem.RxChainConfig(fft_len=fft_len, decimation=dec,
                                                     fir_mode="fused"))
    assert np.array_equal(np.asarray(jchain.taps), chain.taps)
    span = dec * fft_len
    x = _c((2 * 2 * span,), 19)
    jstate = jchain.init_state()
    hist = None
    for blk in (x[:2 * span], x[2 * span:]):
        want = np.asarray(jx.fir.fir_decimate_fft(blk, chain.taps, dec, fft_len,
                                                  jx.fft.Scale.SN, history=hist))
        spec = rf.rx_frame_reference(torch.from_numpy(blk), chain.taps, dec, fft_len,
                                     None if hist is None else torch.from_numpy(hist),
                                     "spectrum")
        assert evm_rms_db(spec.numpy(), want) <= SPECTRUM_DB
        jbits, jstate = jchain.streaming_step(blk, jstate)
        bits = rf.sign_bits(spec, "qpsk").numpy()
        assert bits.shape == np.shape(jbits)
        assert (bits == np.asarray(jbits)).mean() >= AGREEMENT
        hist = blk[span * 2 - (chain.taps.shape[-1] - 1):]
        assert np.array_equal(np.asarray(jstate), hist)


# ------------------------------------------------------------ F8: the models exports


def test_f8_models_export_every_ported_name(jx):
    # every name of the JAX models.__all__ whose module the port has
    import importlib

    from aether_primitives_tpu_torch import models as tmodels

    missing = []
    for name in jx.models.__all__:
        obj = getattr(jx.models, name)
        module = name if isinstance(obj, types.ModuleType) else obj.__module__.rsplit(".", 1)[-1]
        try:
            importlib.import_module(f"aether_primitives_tpu_torch.models.{module}")
        except ModuleNotFoundError:
            continue  # a module still to port (ROADMAP.md queue 1)
        if not hasattr(tmodels, name):
            missing.append(name)
        elif name not in tmodels.__all__:
            missing.append(f"{name} (not in __all__)")
    assert not missing, missing
    assert tmodels.detect_preamble is tsync.detect_preamble
    assert tmodels.sharded_ddc is ddc.sharded_ddc and tmodels.stft is channelizer.stft


def _ported_names(jmod, pkg: str, port_pkg: str) -> list:
    """Names of ``jmod.__all__`` whose module the port has, with the port
    module's path: a module name itself, or the module defining the object
    (lazy names such as ``utils.plot`` are modules of the package)."""
    import importlib

    out = []
    for name in jmod.__all__:
        obj = vars(jmod).get(name)
        if obj is None or isinstance(obj, types.ModuleType):
            module = obj.__name__ if obj is not None else f"{jmod.__name__}.{name}"
        else:
            module = getattr(obj, "__module__", "") or ""
        if not module.startswith(pkg + ".") and module != pkg:
            out.append(name)  # a name from outside the package (a dtype): the port has it too
            continue
        try:
            importlib.import_module(port_pkg + module[len(pkg):])
        except ModuleNotFoundError:
            continue  # a module still to port (ROADMAP.md queue 1)
        out.append(name)
    return out


@pytest.mark.parametrize("sub", ["", "ops", "models", "utils"])
def test_every_ported_name_of_the_jax_all_is_exported(jx, sub):
    # the top level, ops, models and utils: each name of the JAX __all__
    # whose module is ported is exported by the port under the same name
    import importlib

    jmod = importlib.import_module("aether_primitives_tpu" + (f".{sub}" if sub else ""))
    tmod = importlib.import_module("aether_primitives_tpu_torch" + (f".{sub}" if sub else ""))
    names = _ported_names(jmod, "aether_primitives_tpu", "aether_primitives_tpu_torch")
    missing = [n for n in names if not hasattr(tmod, n) or n not in tmod.__all__]
    assert not missing, missing
    want = {"": {"analog", "DB"}, "ops": {"analog", "iir"},
            "models": {"fsk", "FskConfig", "FskModem"}, "utils": {"DB", "db"}}[sub]
    assert want <= set(names)
    assert tp.analog.fm_mod is not None and tp.DB.from_ratio(100).db() == 20.0


def test_db_equals_the_jax_copy(jx):
    from aether_primitives_tpu.utils import db as jdb

    from aether_primitives_tpu_torch.utils import db as tdb

    for r in (1e-3, 0.5, 1.0, 2.0, 1234.5):
        assert tdb.DB.from_ratio(r).db() == jdb.DB.from_ratio(r).db()
        assert tdb.DB(r).ratio() == jdb.DB(r).ratio()
    arr = np.array([0.1, 1.0, 10.0, 3.3])
    assert np.array_equal(tdb.to_db(arr), jdb.to_db(arr))
    assert np.array_equal(tdb.from_db(arr), jdb.from_db(arr))
    assert tp.DB is tdb.DB and tp.utils.DB is tdb.DB


# ------------------------------------------------------------ F9: delay_pad offsets


@pytest.mark.parametrize("offset", [-3, -15, 0, 5, 25])
def test_f9_delay_pad_counts_negative_offsets_from_the_end(jx, offset):
    from aether_primitives_tpu_torch.models import channel as tchannel

    x = _c((10,), 30)
    got = tchannel.delay_pad(torch.from_numpy(x), offset, 20).numpy()
    want = np.asarray(jx.channel.delay_pad(x, offset, 20))
    assert np.array_equal(got, want)
    assert np.array_equal(np.nonzero(got)[0], np.nonzero(want)[0])


def test_f9_delay_pad_batched_negative_offset(jx):
    from aether_primitives_tpu_torch.models import channel as tchannel

    x = _c((2, 1000), 31)
    got = tchannel.delay_pad(torch.from_numpy(x), -5, 1200).numpy()
    want = np.asarray(jx.channel.delay_pad(x, -5, 1200))
    assert np.array_equal(got, want)


# ------------------------------------------------------------ F10: PacketModem checks


@pytest.mark.parametrize("field,value,match", [
    ("ccsds_interleaver", "bad", "unknown ccsds_interleaver"),
    ("ccsds_interleave_rows", 0, "ccsds_interleave_rows >= 1"),
    ("polar_decoder", "BP", "unknown polar_decoder"),
])
def test_f10_packet_modem_refuses_what_the_reference_refuses(jx, field, value, match):
    from aether_primitives_tpu_torch.models.packet import PacketConfig, PacketModem

    kw = {field: value}
    if field == "ccsds_interleave_rows":
        kw["ccsds_interleaver"] = "conv"
    with pytest.raises(ValueError, match=match) as jerr:
        jx.packet.PacketModem(jx.packet.PacketConfig(fec="viterbi", **kw))
    with pytest.raises(ValueError, match=match) as err:
        PacketModem(PacketConfig(fec="viterbi", **kw), device="cpu")
    assert str(err.value) == str(jerr.value)


# ------------------------------------------- F13-F16: what the card refused

CODES_F15 = {
    "k2": ((0o3, 0o1), 2),
    "k10": ((0o1171, 0o1233), 10),
    "k7-n9": ((0o171, 0o133, 0o165, 0o117, 0o127, 0o155, 0o135, 0o147, 0o173), 7),
}
CODES_F16 = {2: (0o3, 0o1), 8: (0o247, 0o371)}


@pytest.fixture(scope="module")
def jfec():
    pytest.importorskip("jax")
    from aether_primitives_tpu.ops import fec as jax_fec

    return jax_fec


@pytest.fixture(scope="module")
def jax_modem():
    pytest.importorskip("jax")
    from aether_primitives_tpu.models import modem

    return modem


@pytest.fixture(scope="module")
def jax_fold():
    pytest.importorskip("jax")
    from aether_primitives_tpu.ops.pallas.pfb_fold import pfb_fold_os

    return pfb_fold_os


def _rel(got, ref):
    got, ref = np.asarray(got, np.complex128), np.asarray(ref, np.complex128)
    return float(np.sqrt(np.mean(np.abs(got - ref) ** 2) / np.mean(np.abs(ref) ** 2)))


# ------------------------------------------------------------------ F13


def test_f13_the_kernel_takes_every_branch_count():
    for p in (295, 300, 512, 1024):
        for mode, cplx in (("analysis", False), ("analysis", True), ("planes", False),
                           ("synthesis", False), ("synthesis", True)):
            assert pf.kernel_supports(2048, p, 2, mode=mode, complex_taps=cplx)
            ranged = pf.branch_range(mode, p, cplx)
            assert ranged > 0 or mode == "synthesis" and p < 389
            if ranged:
                assert pf.launch_plan(mode, p, 2, cplx) == (2, False)
                # one ranged tile of 8 x 16 in every layout: ranges of 64
                # real / 48 complex branches, two ring stages within 227 KB
                assert ranged == (48 if cplx else 64)
                stage = (pf.RANGED_TILE + ranged) * 64 * 8 + ranged * 64 * (8 if cplx else 4)
                assert 2 * stage <= pf.MAX_SMEM
    assert pf.RANGED_TILE == pf.RANGED_ROWS * pf.RANGED_FRAMES == 128
    assert pf.kernel_supports(64, 4, 2, batch=70_000)
    assert pf.kernel_supports(64 * 70_000, 4, 2)  # 70,000 strips of 64 columns


def test_f13_planes_twin_matches_the_pallas_fold_at_p300(jax_fold):
    m, os, p, t_cls = 16, 2, 300, 8
    rng = np.random.default_rng(1300)
    need = (os - 1) * (m // os) + (t_cls - 1 + p) * m
    xr, xi = (rng.normal(size=need).astype(np.float32) for _ in range(2))
    hb = rng.normal(size=(p, m)).astype(np.float32)
    got_r, got_i = pf.pfb_fold_os_reference(torch.from_numpy(xr), torch.from_numpy(xi),
                                            torch.from_numpy(hb), os, t_cls)
    want_r, want_i = jax_fold(xr, xi, hb, os, t_cls, tile_t=8, interpret=True)
    assert _rel(got_r.numpy(), np.asarray(want_r)) <= FOLD_REL
    assert _rel(got_i.numpy(), np.asarray(want_i)) <= FOLD_REL


def _f64_analysis(x, w, m, os, t_frames):
    """out[t, c] = sum_p w[p, r] x[j hop + (i + p) M + r], t = i os + j,
    r = (c - j hop) mod M, in float64."""
    hop = m // os
    p = w.shape[0]
    out = np.zeros((t_frames, m), np.complex128)
    for t in range(t_frames):
        i, j = divmod(t, os)
        acc = np.zeros(m, np.complex128)
        for q in range(p):
            s = j * hop + (i + q) * m
            seg = np.zeros(m, np.complex128)
            avail = x[s:s + m]
            seg[:avail.shape[0]] = avail
            acc += w[q] * seg
        out[t] = np.roll(acc, (j * hop) % m)
    return out


@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
def test_f13_analysis_twin_matches_float64_at_p300(cplx):
    m, os, p, t_frames = 16, 2, 300, 7
    rng = np.random.default_rng(1301)
    n = (t_frames // os + p + 1) * m
    x = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
    w = rng.normal(size=(p, m)) + (1j * rng.normal(size=(p, m)) if cplx else 0)
    w = w.astype(np.complex64 if cplx else np.float32)
    got = pf.pfb_analysis_reference(torch.from_numpy(x[:100]), torch.from_numpy(x[100:]),
                                    torch.from_numpy(w), os, t_frames)
    want = _f64_analysis(x.astype(np.complex128), w.astype(np.complex128), m, os, t_frames)
    assert _rel(got.numpy(), want) <= FOLD_F64_REL


@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
def test_f13_synthesis_twin_matches_float64_at_p400(cplx):
    # P 400: past the chunked synthesis (388 real, 366 complex taps)
    m, os, p, t_frames = 8, 2, 400, 5
    hop = m // os
    rng = np.random.default_rng(1302)
    fr = (rng.normal(size=(t_frames, m)) + 1j * rng.normal(size=(t_frames, m))).astype(np.complex64)
    w = rng.normal(size=(p, m)) + (1j * rng.normal(size=(p, m)) if cplx else 0)
    w = w.astype(np.complex64 if cplx else np.float32)
    got = pf.pfb_synthesis_reference(torch.from_numpy(fr), torch.from_numpy(w), os).numpy()
    length = pf.synthesis_length(t_frames, m, p, os)
    # out[U M + c] = sum over classes j of sum_q g[q, r] v[(U - d + q - (P-1)) os + j, c]
    want = np.zeros(length, np.complex128)
    frames = fr.astype(np.complex128)
    g = w.astype(np.complex128)
    for u_row in range(-(-length // m)):
        for c in range(m):
            idx = u_row * m + c
            if idx >= length:
                continue
            for j in range(os):
                d = 1 if c < j * hop else 0
                r = (c - j * hop) % m
                for q in range(p):
                    cls = u_row - d + q - (p - 1)
                    t = cls * os + j
                    if 0 <= cls and t < t_frames:
                        want[idx] += g[q, r] * frames[t, c]
    assert got.shape == (length,)
    assert _rel(got, want) <= FOLD_F64_REL


# ------------------------------------------------------------------ F14


def _decisions(spec, table):
    """float64 nearest-point bits and each bit's margin (tests/test_torch_modem.py's)."""
    s = spec.reshape(-1, 1)
    score = s.real * table.real + s.imag * table.imag - 0.5 * np.abs(table) ** 2
    order = np.sort(score, axis=-1)
    idx = np.argmax(score, axis=-1)
    bps = int(np.log2(table.shape[0]))
    bits = ((idx[:, None] >> np.arange(bps)) & 1).astype(np.uint8).reshape(-1)
    return bits, np.repeat(order[:, -1] - order[:, -2], bps)


def _check_bits(got, want, margin):
    got, want = np.asarray(got).reshape(-1), np.asarray(want).reshape(-1)
    assert got.shape == want.shape
    clear = margin > MARGIN * np.sqrt(np.mean(margin ** 2))
    assert np.array_equal(got[clear], want[clear])
    assert (got == want).mean() >= AGREEMENT


@pytest.mark.parametrize("dec,fft_len", [(4, 4099), (2, 8198), (1, 131072)],
                         ids=["4-4099", "2-8198", "1-131072"])
def test_f14_rx_chain_matches_jax_and_float64(jax_modem, dec, fft_len):
    jcfg = jax_modem.RxChainConfig(fft_len=fft_len, decimation=dec, packed_bits=False)
    jchain = jax_modem.RxChain(jcfg)
    chain = RxChain(convert.config_from_numpy(dataclasses.asdict(jcfg)), device="cpu")
    assert chain.taps.tobytes() == jchain.taps.tobytes()
    k = chain.taps.shape[-1]
    assert rf.kernel_supports(dec, fft_len, None, k) == "global"
    lay = rf.global_layout(dec, fft_len, k)
    # Bluestein past a power of two: an m-point FFT, m >= 2 n - 1
    assert lay["bluestein"] == (fft_len != 131072)
    assert lay["m"] >= 2 * fft_len - 1 if lay["bluestein"] else lay["m"] == fft_len
    span = dec * fft_len
    rng = np.random.default_rng(1400 + fft_len)
    x = (rng.normal(size=4 * span) + 1j * rng.normal(size=4 * span)).astype(np.complex64)
    jstate, state = jchain.init_state(), chain.init_state()
    got, want, hist = [], [], []
    for xb in (x[:2 * span], x[2 * span:]):
        hist.append((state, jstate))
        jb, jstate = jchain.streaming_step(xb, jstate)
        b, state = chain.streaming_step(torch.from_numpy(xb), state)
        got.append(b.numpy())
        want.append(np.asarray(jb))
        assert np.array_equal(state.numpy(), np.asarray(jstate))
    ref_spec = numpy_reference_spectra(x, chain.taps, dec, fft_len)
    ref_bits, margin = _decisions(ref_spec, chain.modulation.table)
    _check_bits(np.concatenate(got), np.concatenate(want), margin)
    _check_bits(np.concatenate(got), ref_bits, margin)
    state1, jstate1 = hist[1]
    spec2 = chain._frames_spectra(torch.from_numpy(x[2 * span:]), history=state1).numpy()
    jspec2 = np.asarray(jchain._frames_spectra(x[2 * span:], history=jstate1))
    assert evm_rms_db(spec2, ref_spec[2:]) <= EVM_DB
    assert evm_rms_db(spec2, jspec2) <= EVM_DB


def test_f14_every_frame_up_to_4m_points_has_an_instance():
    for dec, fft_len in ((4, 4099), (2, 8198), (4, 16411), (1, 131072), (4, 262144),
                         (1, 4194304)):
        assert rf.kernel_supports(dec, fft_len, None, 65) == "global"
    assert rf.kernel_supports(4, 2048, None, 65) == "direct"  # the main path
    assert rf.kernel_supports(1, 65536, None, 1) == "cluster"


# ------------------------------------------------------------------ F15


def _llrs(polys, k, shape, seed):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, shape).astype(np.uint8)
    enc = fec.conv_encode(torch.from_numpy(bits), polys, k).numpy()
    return bits, ((1 - 2.0 * enc) * 2 + rng.normal(size=enc.shape)).astype(np.float32)


@pytest.mark.parametrize("code", sorted(CODES_F15))
def test_f15_viterbi_decode_matches_jax(jfec, code):
    polys, k = CODES_F15[code]
    n = len(polys)
    assert vk.kernel_supports(150, n, k)
    assert vk.instance(n, k) == ("warp" if k == 2 else "block")
    _, llr = _llrs(polys, k, (2, 150), 1500 + k + n)
    for kw in ({}, {"window": 64, "guard": 48}):
        got = fec.viterbi_decode(torch.from_numpy(llr), polys, k, **kw).numpy()
        want = np.asarray(jfec.viterbi_decode(llr, polys, k, backend="xla", **kw))
        assert np.array_equal(got, want)


# ------------------------------------------------------------------ F16


@pytest.mark.parametrize("k", sorted(CODES_F16))
def test_f16_conv_decode_soft_windowed_matches_jax(jfec, k):
    polys = CODES_F16[k]
    tables = fec._conv_soft_coeffs(polys, k)
    assert bk.kernel_plan(tables, 64 + 2 * 32) == ("block", 32 if k == 2 else 1)
    bits, llr = _llrs(polys, k, (2, 150), 1600 + k)
    got = fec.conv_decode_soft(torch.from_numpy(llr), polys, k, window=64, guard=32).numpy()
    want = np.asarray(jfec.conv_decode_soft(llr, polys, k, window=64, guard=32,
                                            backend="xla"))
    assert got.shape == want.shape
    assert np.array_equal(got < 0, want < 0)
    assert np.array_equal((got < 0).astype(np.uint8), bits)
