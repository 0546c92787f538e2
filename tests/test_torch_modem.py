"""The port's streaming RX chain against the JAX package's ``RxChain`` and
the float64 chain: two consecutive blocks of one capture at fft_len 2048,
decimation 4, 8 frames per block, with parameters and state carried over
through :mod:`aether_primitives_tpu_torch.convert`.

Tolerances: hard bits are exact wherever the float64 decision margin
exceeds ``MARGIN`` x its RMS and agree >= ``AGREEMENT`` overall; block-2
spectra hold RMS EVM <= -80 dB; the carried state is exact. CUDA cases
carry the ``cuda`` marker and skip without a card.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from aether_primitives_tpu_torch import convert
from aether_primitives_tpu_torch.boundary import Split
from aether_primitives_tpu_torch.cli import numpy_reference_spectra
from aether_primitives_tpu_torch.evm import evm_rms_db
from aether_primitives_tpu_torch.models import RxChain, RxChainConfig
from aether_primitives_tpu_torch.ops.cuda import build
from aether_primitives_tpu_torch.ops.cuda import rx_frame as rf

torch.set_num_threads(1)

AGREEMENT = 0.99999
MARGIN = 1e-4
EVM_DB = -80.0
N_FFT, DEC, FRAMES = 2048, 4, 8
BLOCK = N_FFT * DEC * FRAMES


@pytest.fixture(scope="module")
def jax_modem():
    pytest.importorskip("jax")
    from aether_primitives_tpu.models import modem

    return modem


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _signal(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)


def _decisions(spec, table):
    """float64 nearest-point bits (LSB-first) and each bit's margin: the
    gap between the best and second-best correlation score."""
    s = spec.reshape(-1, 1)
    score = s.real * table.real + s.imag * table.imag - 0.5 * np.abs(table) ** 2
    order = np.sort(score, axis=-1)
    idx = np.argmax(score, axis=-1)
    bps = int(np.log2(table.shape[0]))
    bits = ((idx[:, None] >> np.arange(bps)) & 1).astype(np.uint8).reshape(-1)
    margin = np.repeat(order[:, -1] - order[:, -2], bps)
    return bits, margin


def _check_bits(got, want, margin):
    got, want = np.asarray(got).reshape(-1), np.asarray(want).reshape(-1)
    assert got.shape == want.shape
    clear = margin > MARGIN * np.sqrt(np.mean(margin ** 2))
    assert np.array_equal(got[clear], want[clear])
    assert (got == want).mean() >= AGREEMENT


def _flat(bits, packed):
    b = np.asarray(bits)
    return np.unpackbits(b, bitorder="little") if packed else b


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "unpacked"])
@pytest.mark.parametrize("mod", ["qpsk", "bpsk", "qam16"])
def test_two_block_streaming_matches_jax_and_float64(jax_modem, mod, packed):
    jcfg = jax_modem.RxChainConfig(
        fft_len=N_FFT, decimation=DEC, fir_mode="fused", fft_backend="matmul",
        modulation=mod, packed_bits=packed,
    )
    jchain = jax_modem.RxChain(jcfg)
    chain = RxChain(convert.config_from_numpy(dataclasses.asdict(jcfg)), device="cpu")
    assert chain.taps.tobytes() == jchain.taps.tobytes()
    assert chain._sign_fast_path_ok() == jchain._sign_fast_path_ok() == (mod != "qam16")
    x = _signal(2 * BLOCK, 200)
    jstate = jchain.init_state()
    state = convert.state_from_numpy(np.asarray(jstate), "cpu")
    got, want, histories = [], [], []
    for i in range(2):
        xb = x[i * BLOCK:(i + 1) * BLOCK]
        histories.append((state, jstate))
        jb, jstate = jchain.streaming_step(xb, jstate)
        b, state = chain.streaming_step(torch.from_numpy(xb), state)
        assert b.dtype == torch.uint8 and b.shape == np.shape(jb)
        got.append(_flat(b.numpy(), packed))
        want.append(_flat(jb, packed))
        assert np.array_equal(state.numpy(), np.asarray(jstate))
        assert np.array_equal(state.numpy(), xb[-(chain.taps.shape[-1] - 1):])
    ref_spec = numpy_reference_spectra(x, chain.taps, DEC, N_FFT)
    ref_bits, margin = _decisions(ref_spec, chain.modulation.table)
    _check_bits(np.concatenate(got), np.concatenate(want), margin)
    _check_bits(np.concatenate(got), ref_bits, margin)
    # block 2's spectra, whose first K-1 samples come from the carried history
    state1, jstate1 = histories[1]
    spec2 = chain._frames_spectra(torch.from_numpy(x[BLOCK:]), history=state1).numpy()
    jspec2 = np.asarray(jchain._frames_spectra(x[BLOCK:], history=jstate1))
    assert evm_rms_db(spec2, ref_spec[FRAMES:]) <= EVM_DB
    assert evm_rms_db(spec2, jspec2) <= EVM_DB


@pytest.mark.parametrize("mod", ["qpsk", "qam16"])
def test_streaming_equals_one_contiguous_step(mod):
    chain = RxChain(RxChainConfig(fft_len=256, decimation=4, modulation=mod,
                                  packed_bits=True), device="cpu")
    x = torch.from_numpy(_signal(4 * 256 * 4 * 3, 201))
    contiguous = chain.step(x)
    state = chain.init_state()
    outs = []
    for blk in x.split(4 * 256 * 4):
        bits, state = chain.streaming_step(blk, state)
        outs.append(bits)
    ref_bits, margin = _decisions(numpy_reference_spectra(x.numpy(), chain.taps, 4, 256),
                                  chain.modulation.table)
    streamed = np.unpackbits(torch.cat(outs).numpy(), bitorder="little")
    _check_bits(streamed, np.unpackbits(contiguous.numpy(), bitorder="little"), margin)
    _check_bits(streamed, ref_bits, margin)


@pytest.mark.parametrize("dec,fft_len", [(4, 2048), (4, 256), (1, 256), (4, 4096),
                                         (8, 2048), (4, 8192), (1, 8192)])
@pytest.mark.parametrize("mod", ["qpsk", "bpsk", "qam16"])
def test_fast_path_condition_matches_jax(jax_modem, dec, fft_len, mod):
    # the port takes the RX frame op wherever the JAX chain takes _bits_fast,
    # whether or not the CUDA kernel takes the geometry
    jchain = jax_modem.RxChain(jax_modem.RxChainConfig(
        fft_len=fft_len, decimation=dec, modulation=mod, fir_mode="fused",
        fft_backend="matmul"))
    chain = RxChain(RxChainConfig(fft_len=fft_len, decimation=dec, modulation=mod),
                    device="cpu")
    assert chain._sign_fast_path_ok() == jchain._sign_fast_path_ok()


@pytest.mark.parametrize("dec,fft_len,mod", [(1, 256, "qpsk"), (4, 4096, "bpsk")])
def test_geometries_outside_the_kernel_match_jax_on_the_cpu(jax_modem, dec, fft_len, mod):
    # geometries whose JAX split is not the main path's (the heuristic's n2 =
    # 2; a frame over 64 KB) go through the RX frame op's plain version on
    # the CPU at the JAX package's split; on a card the direct instance,
    # which has no split
    assert rf.kernel_plan(dec, fft_len) == ("direct", rf._fir._fused_stage_n1(dec, fft_len))
    jcfg = jax_modem.RxChainConfig(fft_len=fft_len, decimation=dec, modulation=mod,
                                   fir_mode="fused", fft_backend="matmul",
                                   packed_bits=True)
    jchain = jax_modem.RxChain(jcfg)
    chain = RxChain(convert.config_from_numpy(dataclasses.asdict(jcfg)), device="cpu")
    assert chain._sign_fast_path_ok()
    span = dec * fft_len
    x = _signal(2 * 2 * span, 202)
    jstate, state = jchain.init_state(), chain.init_state()
    got, want = [], []
    for xb in (x[:2 * span], x[2 * span:]):
        jb, jstate = jchain.streaming_step(xb, jstate)
        b, state = chain.streaming_step(torch.from_numpy(xb), state)
        got.append(_flat(b.numpy(), True))
        want.append(_flat(jb, True))
        assert np.array_equal(state.numpy(), np.asarray(jstate))
    ref_bits, margin = _decisions(numpy_reference_spectra(x, chain.taps, dec, fft_len),
                                  chain.modulation.table)
    _check_bits(np.concatenate(got), np.concatenate(want), margin)
    _check_bits(np.concatenate(got), ref_bits, margin)


def test_active_bins_match_jax(jax_modem):
    jcfg = jax_modem.RxChainConfig(fft_len=256, decimation=4, fir_mode="fused",
                                   fft_backend="matmul", active_bins=128)
    jchain = jax_modem.RxChain(jcfg)
    chain = RxChain(convert.config_from_numpy(dataclasses.asdict(jcfg)), device="cpu")
    assert not chain._sign_fast_path_ok()
    x = _signal(4 * 256 * 4, 203)
    spec = chain.spectra(x).numpy()
    jspec = np.asarray(jchain.spectra(x))
    assert spec.shape == jspec.shape == (4, 128)
    assert evm_rms_db(spec, jspec) <= EVM_DB
    _, margin = _decisions(jspec.astype(np.complex128), chain.modulation.table)
    _check_bits(chain.step(x).numpy(), np.asarray(jchain.step(x)), margin)


def test_short_block_keeps_the_previous_state():
    # taps fit in a frame, so the only block shorter than the filter memory
    # is an empty one: it emits no bits and keeps the carried history
    chain = RxChain(RxChainConfig(fft_len=256, decimation=4, packed_bits=True), device="cpu")
    state = torch.from_numpy(_signal(chain.taps.shape[-1] - 1, 204))
    bits, new_state = chain.streaming_step(np.zeros(0, np.complex64), state)
    assert bits.shape == (0,)
    assert torch.equal(new_state, state)


def test_config_errors():
    # the other FIR modes are ported: they build, and only unknown ones raise
    for mode in ("os", "shift_add", "fused", None):
        assert RxChain(RxChainConfig(fir_mode=mode), device="cpu").fir_mode == (mode or "fused")
    with pytest.raises(ValueError, match="unknown fir_mode"):
        RxChain(RxChainConfig(fir_mode="bogus"), device="cpu")
    with pytest.raises(ValueError, match="TPU"):
        RxChain(RxChainConfig(precision="high"), device="cpu")
    with pytest.raises(ValueError):
        RxChain(RxChainConfig(precision="default"), device="cpu")
    with pytest.raises(ValueError):
        RxChain(RxChainConfig(modulation="bpsk", active_bins=4, packed_bits=True),
                device="cpu")
    with pytest.raises(ValueError):
        RxChain(RxChainConfig(modulation="ook"), device="cpu")
    with pytest.raises(ValueError):
        RxChain(RxChainConfig(fft_len=256), device="cpu").step(
            torch.zeros(1000, dtype=torch.complex64))


def test_convert_carries_config_and_state(jax_modem):
    jcfg = jax_modem.RxChainConfig(fir_taps=np.hanning(33), decimation=2,
                                   fft_len=512, packed_bits=True, stage_n1=64)
    cfg = convert.config_from_numpy(dataclasses.asdict(jcfg))
    assert cfg.fir_taps.dtype == np.complex64
    assert cfg.fir_taps.tobytes() == np.asarray(jcfg.fir_taps, np.complex64).tobytes()
    assert (cfg.decimation, cfg.fft_len, cfg.packed_bits, cfg.stage_n1) == (2, 512, True, 64)
    assert RxChain(cfg, device="cpu").taps.tobytes() == jax_modem.RxChain(jcfg).taps.tobytes()
    with pytest.raises(ValueError):
        convert.config_from_numpy({"decimation": 4, "window": "hann"})
    s = _signal(64, 206)
    a = convert.state_from_numpy(s, "cpu")
    b = convert.state_from_numpy((s.real, s.imag), "cpu")
    assert a.dtype == torch.complex64 and torch.equal(a, b)
    assert np.array_equal(a.numpy(), s)


def test_cuda_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RxChain(RxChainConfig(), device="cuda")


def test_bench_main_fails_without_cuda(monkeypatch, capsys):
    from aether_primitives_tpu_torch.cli import bench_main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exit_:
        bench_main([])
    assert exit_.value.code != 0
    assert capsys.readouterr().out == ""  # no result line


def test_kernel_loader_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "DEFAULT_CUDA_HOME", tmp_path / "no-cuda")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load.__wrapped__("rx_frame")
    assert not (tmp_path / "build").exists()


# ------------------------------------------------------------ on the card


@pytest.mark.cuda
@pytest.mark.parametrize("mod", ["qpsk", "bpsk"])
def test_cuda_chain_goes_through_the_kernel(cuda, mod):
    cfg = RxChainConfig(fft_len=N_FFT, decimation=DEC, modulation=mod, packed_bits=True)
    chain, host = RxChain(cfg, device=cuda), RxChain(cfg, device="cpu")
    x = _signal(2 * BLOCK, 207)
    state, hstate = chain.init_state(), host.init_state()
    got, want = [], []
    before = rf.launches
    for blk in torch.from_numpy(x).split(BLOCK):
        bits, state = chain.streaming_step(blk, state)
        hbits, hstate = host.streaming_step(blk, hstate)
        got.append(bits.cpu().numpy())
        want.append(hbits.numpy())
    assert rf.launches == before + 2
    assert torch.equal(state.cpu(), hstate)
    ref_bits, margin = _decisions(numpy_reference_spectra(x, chain.taps, DEC, N_FFT),
                                  chain.modulation.table)
    flat = np.unpackbits(np.concatenate(got), bitorder="little")
    _check_bits(flat, np.unpackbits(np.concatenate(want), bitorder="little"), margin)
    _check_bits(flat, ref_bits, margin)


@pytest.mark.cuda
def test_cuda_chain_raises_where_the_kernel_does_not_go(cuda, monkeypatch):
    # fft_len 16,411 is a prime past the 4,096 points one CTA holds, with no
    # split for a cluster: the global instance takes it (Bluestein), one
    # launch a step; the kernel goes no further than the card's memory, and
    # past it (a card of 1 MB here) the chain raises instead of running the
    # plain version (fft_len 3750, which raised before the mixed-radix FFT,
    # launches the direct instance)
    chain = RxChain(RxChainConfig(fft_len=16411, decimation=1), device=cuda)
    assert rf.kernel_supports(1, 16411, None, chain.taps.shape[-1]) == "global"
    assert rf.kernel_supports(4, 3750, None, 65) == "direct"
    x = torch.from_numpy(_signal(2 * 16411, 301))
    before = rf.launches
    bits, state = chain.streaming_step(x, chain.init_state())
    host = RxChain(RxChainConfig(fft_len=16411, decimation=1), device="cpu")
    hbits, hstate = host.streaming_step(x, host.init_state())
    assert rf.launches == before + 1
    assert torch.equal(state.cpu(), hstate)
    assert (bits.cpu() == hbits).float().mean().item() >= AGREEMENT
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: types.SimpleNamespace(total_memory=1 << 20))
    with pytest.raises(ValueError, match="does not take"):
        chain.step(torch.zeros(16411, dtype=torch.complex64))
    with pytest.raises(ValueError, match="does not take"):
        chain.streaming_step(torch.zeros(16411, dtype=torch.complex64),
                             chain.init_state())
    monkeypatch.undo()
    assert rf.launches == before + 1


# ------------------------------------------- ragged-capture policies and Split
# (tests/test_models.py:426-556 run these on fir_mode="os", which the port
# does not take; here the JAX chain runs fir_mode="fused")

SPAN_CFG = dict(fft_len=256, decimation=4)
SPAN = 4 * 256


def _chains(jax_modem, packed=False):
    jcfg = jax_modem.RxChainConfig(fir_mode="fused", fft_backend="matmul",
                                   packed_bits=packed, **SPAN_CFG)
    return jax_modem.RxChain(jcfg), RxChain(convert.config_from_numpy(
        dataclasses.asdict(jcfg)), device="cpu")


def _margin(chain, x):
    return _decisions(numpy_reference_spectra(x, chain.taps, 4, 256), chain.modulation.table)[1]


def test_span_error_names_the_policies(jax_modem):
    jchain, chain = _chains(jax_modem)
    x = _signal(1000, 210)
    for fn in (chain.step, jchain.step, lambda b: chain.streaming_step(b, chain.init_state())):
        with pytest.raises(ValueError, match="step_ragged") as err:
            fn(x)
        assert "step_padded" in str(err.value)


@pytest.mark.parametrize("packed", [False, True], ids=["unpacked", "packed"])
def test_step_ragged_matches_jax(jax_modem, packed):
    jchain, chain = _chains(jax_modem, packed)
    x = _signal(3 * SPAN + 217, 211)
    bits, tail = chain.step_ragged(torch.from_numpy(x))
    jbits, jtail = jchain.step_ragged(x)
    assert torch.equal(bits, chain.step(x[:3 * SPAN]))
    assert np.array_equal(tail.numpy(), x[3 * SPAN:]) and np.array_equal(np.asarray(jtail), x[3 * SPAN:])
    assert bits.dtype == torch.uint8 and bits.shape == np.shape(jbits)
    _check_bits(_flat(bits.numpy(), packed), _flat(np.asarray(jbits), packed),
                _margin(chain, x[:3 * SPAN]))
    # remainder carried in front of the next capture loses nothing
    y = _signal(2 * SPAN - 217, 212)
    bits2 = chain.step(torch.cat([tail, torch.from_numpy(y)]))
    whole = chain.step_padded(np.concatenate([x, y]))
    assert bits.shape[-1] + bits2.shape[-1] == whole.shape[-1]


def test_step_ragged_shorter_than_frame(jax_modem):
    jchain, chain = _chains(jax_modem)
    x = _signal(100, 213)
    bits, tail = chain.step_ragged(x)
    jbits, jtail = jchain.step_ragged(x)
    assert bits.shape == np.shape(jbits) == (0,) and bits.dtype == torch.uint8
    assert np.array_equal(tail.numpy(), x) and np.array_equal(np.asarray(jtail), x)


@pytest.mark.parametrize("packed", [False, True], ids=["unpacked", "packed"])
def test_step_padded_matches_manual_zero_pad_and_jax(jax_modem, packed):
    jchain, chain = _chains(jax_modem, packed)
    n = 2 * SPAN + 100
    x = _signal(n, 214)
    got = chain.step_padded(x)
    manual = np.zeros(3 * SPAN, np.complex64)
    manual[:n] = x
    assert torch.equal(got, chain.step(manual))
    jgot = np.asarray(jchain.step_padded(x))
    assert got.shape == jgot.shape
    _check_bits(_flat(got.numpy(), packed), _flat(jgot, packed), _margin(chain, manual))
    assert torch.equal(chain.step_padded(x[:2 * SPAN]), chain.step(x[:2 * SPAN]))


@pytest.mark.parametrize("shape,multiple", [((1000,), 1024), ((2, 4396), 4096),
                                            ((3, 2048), 1024), ((0,), 8)])
def test_pad_to_frames_matches_jax(jax_modem, shape, multiple):
    from aether_primitives_tpu_torch.models import pad_to_frames

    rng = np.random.default_rng(215)
    for x in ((rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64),
              rng.normal(size=shape).astype(np.float32)):
        got = pad_to_frames(torch.from_numpy(x), multiple)
        want = np.asarray(jax_modem.pad_to_frames(x, multiple))
        assert got.dtype == torch.from_numpy(x).dtype
        assert np.array_equal(got.numpy(), want)


def test_split_variants_match_step_and_jax(jax_modem):
    from aether_primitives_tpu.boundary import Split as JaxSplit

    jchain, chain = _chains(jax_modem)
    nblk, nblocks = 2 * SPAN, 3
    x = _signal(nblk * nblocks, 216)
    contiguous = chain.step(x)
    state, jstate = chain.init_state_split(), jchain.init_state_split()
    assert isinstance(state, Split) and state.re.dtype == torch.float32
    assert state.re.shape == np.shape(jstate.re) == (chain.taps.shape[-1] - 1,)
    outs, jouts = [], []
    for i in range(nblocks):
        blk = x[i * nblk:(i + 1) * nblk]
        bits, state = chain.streaming_step_split(Split(blk.real.copy(), blk.imag.copy()), state)
        jbits, jstate = jchain.streaming_step_split(JaxSplit(blk.real.copy(), blk.imag.copy()),
                                                    jstate)
        outs.append(bits)
        jouts.append(np.asarray(jbits))
        assert np.array_equal(state.re.numpy(), np.asarray(jstate.re))
        assert np.array_equal(state.im.numpy(), np.asarray(jstate.im))
        assert state.re.is_contiguous() and state.im.is_contiguous()
    assert torch.equal(torch.cat(outs), contiguous)
    _check_bits(torch.cat(outs).numpy(), np.concatenate(jouts), _margin(chain, x))
    assert torch.equal(chain.step_split(Split(torch.from_numpy(x.real.copy()),
                                              torch.from_numpy(x.imag.copy()))), contiguous)
    with pytest.raises(TypeError, match="Split"):
        chain.step_split(x)
    with pytest.raises(TypeError, match="Split"):
        chain.streaming_step_split(x, chain.init_state_split())


@pytest.mark.cuda
def test_policies_on_the_card(cuda):
    cfg = RxChainConfig(fft_len=N_FFT, decimation=DEC, packed_bits=True)
    chain, host = RxChain(cfg, device=cuda), RxChain(cfg, device="cpu")
    x = _signal(2 * BLOCK + 5000, 217)
    before = rf.launches
    bits, tail = chain.step_ragged(torch.from_numpy(x).to(cuda))
    padded = chain.step_padded(x)
    state = chain.init_state_split()
    sbits, state = chain.streaming_step_split(Split(x.real[:BLOCK].copy(),
                                                    x.imag[:BLOCK].copy()), state)
    torch.cuda.synchronize()
    assert rf.launches == before + 3
    assert torch.equal(tail.cpu(), torch.from_numpy(x[2 * BLOCK:]))
    manual = np.zeros(3 * BLOCK, np.complex64)
    manual[:x.size] = x
    for got, want, sig in ((bits, host.step(x[:2 * BLOCK]), x[:2 * BLOCK]),
                           (padded, host.step(manual), manual[:2 * BLOCK + N_FFT * DEC]),
                           (sbits, host.step(x[:BLOCK]), x[:BLOCK])):
        margin = _decisions(numpy_reference_spectra(sig, chain.taps, DEC, N_FFT),
                            chain.modulation.table)[1]
        flat_got = np.unpackbits(got.cpu().numpy(), bitorder="little")
        flat_want = np.unpackbits(want.numpy(), bitorder="little")
        n = margin.size
        _check_bits(flat_got[:n], flat_want[:n], margin)
