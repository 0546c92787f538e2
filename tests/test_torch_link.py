"""The port's link path against the JAX package's, on the same seeded numpy
inputs: the TX frame op ``interp_fir_ifft``, ``correlate``, ``TxChain`` in
each FIR mode, the RX chain's ``"os"`` and ``"shift_add"`` modes,
``Modem``, ``loopback_delay``, ``OfdmEqualizer`` and the TX -> RX loopback
of ``tests/test_models.py:180-257``, each mode named on both sides (the
JAX package's None is ``"shift_add"`` off the TPU, the port's
``"fused"``).

Tolerances:
- ``_fused_tx_matrices``: ``np.array_equal`` to the original;
- ``interp_fir_ifft``, ``correlate``, ``TxChain.step`` per mode: RMS EVM
  <= -120 dB against JAX, and ``interp_fir_ifft`` <= -120 dB against a
  float64 golden (``ifft`` -> zero-stuff -> ``np.convolve``);
- RX bits of the other modes: agreement >= 0.99999 with the JAX chain in
  the same mode and with the port's fused chain (the spectra <= -120 dB);
- loopback interior frames, ``Modem`` and equalised QAM16 data: exact;
- ``OfdmEqualizer``: RMS EVM <= -120 dB.
The ``cuda`` cases skip without a card: the routing of fused chains that
are not on the sign path through the RX frame kernel's spectrum epilogue
(one launch a step, <= -120 dB against the plain twin), the other modes
without a launch, and ``TxChain`` on the card against the CPU.
"""

import dataclasses

import numpy as np
import pytest
import torch

import aether_primitives_tpu_torch as tp
from aether_primitives_tpu_torch import convert
from aether_primitives_tpu_torch.evm import evm_rms_db
from aether_primitives_tpu_torch.models import (
    Modem, ModemConfig, OfdmEqualizer, RxChain, RxChainConfig, TxChain, loopback_delay,
)
from aether_primitives_tpu_torch.models.modem import _default_lowpass
from aether_primitives_tpu_torch.ops import fir, noise
from aether_primitives_tpu_torch.ops.cuda import rx_frame as rf
from aether_primitives_tpu_torch.ops.fft import Scale

torch.set_num_threads(1)

EVM_DB = -120.0
AGREEMENT = 0.99999
MODES = ("fused", "os", "shift_add")
LINK = dict(fft_len=256, decimation=4, active_bins=128)
CPU = "cpu"


@pytest.fixture(scope="module")
def jax_pkg():
    pytest.importorskip("jax")
    import aether_primitives_tpu as ae
    from aether_primitives_tpu.models import modem as jmodem
    from aether_primitives_tpu.models import sync as jsync
    from aether_primitives_tpu.ops import fft as jfft
    from aether_primitives_tpu.ops import fir as jfir
    from aether_primitives_tpu.ops import noise as jnoise

    return {"ae": ae, "modem": jmodem, "sync": jsync, "fft": jfft, "fir": jfir,
            "noise": jnoise}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _c(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)


def _bits(n, seed):
    return np.random.default_rng(seed).integers(0, 2, n).astype(np.uint8)


def _jscale(jax_pkg, scale):
    return getattr(jax_pkg["fft"].Scale, scale.kind.upper())


def _golden_tx(spec, taps, dec, s, history_spec=None):
    """float64 (ifft * N * s) -> zero-stuff -> causal FIR over each row's
    flattened frames; ``history_spec`` is one frame in front, then cut."""
    spec = np.asarray(spec, np.complex128)
    lead = 0
    if history_spec is not None:
        spec = np.concatenate([np.asarray(history_spec, np.complex128)[..., None, :], spec], -2)
        lead = 1
    n = spec.shape[-1]
    frames = np.fft.ifft(spec, axis=-1) * n * s
    up = np.zeros(frames.shape[:-1] + (n * dec,), np.complex128)
    up[..., ::dec] = frames
    flat = up.reshape(up.shape[:-2] + (-1,))
    rows = flat.reshape(-1, flat.shape[-1])
    out = np.stack([np.convolve(r, taps.astype(np.complex128))[:r.size] for r in rows])
    return out.reshape(flat.shape)[..., lead * n * dec:]


# ------------------------------------------------------------ exports, convert


def test_exports_where_the_jax_package_has_them(jax_pkg):
    ae = jax_pkg["ae"]
    for name in ("noise", "sampling"):
        assert getattr(ae, name).__name__.rsplit(".", 1)[-1] == name
        assert getattr(tp, name) is getattr(tp.ops, name)
        assert name in tp.__all__ and name in tp.ops.__all__
    for name in ("TxChain", "Modem", "ModemConfig", "Channel", "ChannelConfig",
                 "OfdmEqualizer", "loopback_delay"):
        assert hasattr(ae.models, name)
        assert name in tp.models.__all__ and getattr(tp.models, name) is not None
    for name in ("ber", "channel"):
        assert getattr(tp.models, name).__name__.endswith(name)


def test_convert_carries_modem_config(jax_pkg):
    jcfg = jax_pkg["modem"].ModemConfig(modulation="bpsk", noise_power=0.02, seed=9)
    cfg = convert.modem_config_from_numpy(dataclasses.asdict(jcfg))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    with pytest.raises(ValueError, match="no fields"):
        convert.modem_config_from_numpy({"modulation": "qpsk", "snr": 3})


# ------------------------------------------------------- the TX frame op


@pytest.mark.parametrize("k,dec", [(65, 4), (9, 2), (1, 4), (33, 1), (200, 2)])
def test_fused_tx_matrices_equal_to_jax(jax_pkg, k, dec):
    taps = _c(k, 50 + k)
    s = Scale.SN.factor_for(64)
    got = fir._fused_tx_matrices(taps.tobytes(), k, dec, 64, s)
    want = jax_pkg["fir"]._fused_tx_matrices(taps.tobytes(), k, dec, 64, s)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("k,dec,scale", [(65, 4, Scale.SN), (9, 2, Scale.NONE),
                                         (1, 4, Scale.N), (129, 8, Scale.SN)])
@pytest.mark.parametrize("with_history", [False, True], ids=["causal", "history"])
def test_interp_fir_ifft_against_jax_and_float64(jax_pkg, k, dec, scale, with_history):
    taps = _default_lowpass(k, 1 / (2 * dec)) * np.complex64(dec) if k > 1 else np.ones(1, np.complex64)
    spec = _c((2, 5, 64), 51)
    hs = _c((2, 64), 52) if with_history else None
    got = fir.interp_fir_ifft(torch.from_numpy(spec), taps, dec, scale,
                              history_spec=None if hs is None else torch.from_numpy(hs))
    want = np.asarray(jax_pkg["fir"].interp_fir_ifft(spec, taps, dec, _jscale(jax_pkg, scale),
                                                     history_spec=hs))
    assert got.dtype == torch.complex64 and got.shape == want.shape == (2, 5 * dec * 64)
    assert evm_rms_db(got.numpy(), want) <= EVM_DB
    gold = _golden_tx(spec, taps, dec, scale.factor_for(64), hs)
    assert evm_rms_db(got.numpy(), gold) <= EVM_DB


def test_interp_fir_ifft_errors():
    with pytest.raises(ValueError, match="longer than a frame"):
        fir.interp_fir_ifft(torch.zeros(1, 4, dtype=torch.complex64), np.ones(10), 2)
    with pytest.raises(ValueError, match="history_spec"):
        fir.interp_fir_ifft(torch.zeros(2, 8, dtype=torch.complex64), np.ones(5), 2,
                            history_spec=torch.zeros(4, dtype=torch.complex64))
    with pytest.raises(ValueError, match="per-row taps"):
        fir.interp_fir_ifft(torch.zeros(2, 8, dtype=torch.complex64), np.ones((2, 5)), 2)


def test_correlate_against_jax(jax_pkg):
    x = _c((3, 1000), 53)
    for ref in (x[0, 100:163].copy(), x[1].copy(), _c((3, 1000), 54)):
        got = fir.correlate(torch.from_numpy(x), torch.from_numpy(ref)).numpy()
        want = np.asarray(jax_pkg["fir"].correlate(x, ref))
        assert evm_rms_db(got, want) <= EVM_DB
    with pytest.raises(ValueError, match="longer"):
        fir.correlate(torch.from_numpy(x[0, :10]), torch.from_numpy(x[0, :11]))


# --------------------------------------------------------------- TxChain


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("mod,extra", [("qpsk", LINK), ("qam16", LINK),
                                       ("bpsk", dict(fft_len=128, decimation=1))])
def test_tx_chain_against_jax(jax_pkg, mode, mod, extra):
    jm = jax_pkg["modem"]
    jcfg = jm.RxChainConfig(modulation=mod, fir_mode=mode, **extra)
    cfg = convert.config_from_numpy(dataclasses.asdict(jcfg))
    tx, jtx = TxChain(cfg, device=CPU), jm.TxChain(jcfg)
    assert tx.bits_per_frame() == jtx.bits_per_frame()
    assert tx.taps.tobytes() == jtx.taps.tobytes()
    bits = _bits((2, 3 * tx.bits_per_frame()), 55)
    got = tx.step(torch.from_numpy(bits))
    want = np.asarray(jtx.step(bits))
    assert got.dtype == torch.complex64 and got.shape == want.shape
    assert evm_rms_db(got.numpy(), want) <= EVM_DB


def test_tx_chain_errors():
    tx = TxChain(RxChainConfig(fft_len=256, decimation=1, active_bins=64), device=CPU)
    with pytest.raises(ValueError, match="divisible"):
        tx.step(np.zeros(100, np.uint8))
    with pytest.raises(ValueError, match="unknown fir_mode"):
        TxChain(RxChainConfig(fir_mode="bogus"), device=CPU)


def test_link_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (TxChain, Modem, lambda: TxChain(RxChainConfig(fir_mode="os"))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()


# ------------------------------------------------ RxChain's other FIR modes


@pytest.mark.parametrize("mode", ["os", "shift_add"])
def test_rx_modes_agree_with_jax_and_fused(jax_pkg, mode):
    # tests/test_models.py:91-104's case: noise in, every mode the same bits
    jm = jax_pkg["modem"]
    x = _c(4 * 256 * 4, 7)
    jcfg = jm.RxChainConfig(fft_len=256, decimation=4, fir_mode=mode)
    chain = RxChain(convert.config_from_numpy(dataclasses.asdict(jcfg)), device=CPU)
    fused = RxChain(RxChainConfig(fft_len=256, decimation=4, fir_mode="fused"), device=CPU)
    assert not chain._sign_fast_path_ok() and fused._sign_fast_path_ok()
    got = chain.step(torch.from_numpy(x)).numpy()
    assert (got == np.asarray(jm.RxChain(jcfg).step(x))).mean() >= AGREEMENT
    assert (got == fused.step(torch.from_numpy(x)).numpy()).mean() >= AGREEMENT
    spec = chain._frames_spectra(torch.from_numpy(x))
    assert evm_rms_db(spec.numpy(), fused._frames_spectra(torch.from_numpy(x)).numpy()) <= EVM_DB
    assert evm_rms_db(spec.numpy(), np.asarray(jm.RxChain(jcfg)._frames_spectra(x))) <= EVM_DB


@pytest.mark.parametrize("mode", ["os", "shift_add"])
@pytest.mark.parametrize("mod", ["qpsk", "qam16"])
def test_rx_modes_streaming_equals_contiguous(mode, mod):
    chain = RxChain(RxChainConfig(fft_len=256, decimation=4, modulation=mod, fir_mode=mode,
                                  packed_bits=True), device=CPU)
    x = torch.from_numpy(_c(4 * 256 * 2 * 3, 8))
    whole = chain.step(x)
    state, outs = chain.init_state(), []
    for blk in x.split(4 * 256 * 2):
        b, state = chain.streaming_step(blk, state)
        outs.append(b)
    assert (torch.cat(outs) == whole).double().mean() >= AGREEMENT
    assert torch.equal(state, x[-(chain.taps.shape[-1] - 1):])


@pytest.mark.parametrize("mode", ["os", "shift_add"])
def test_rx_modes_sharded_match_single(mode):
    # tests/test_models.py:105-118's case in the port's other modes: the
    # halo carries the FIR history into each time shard, so a sharded step
    # (one axis, and streaming over a {channel, time} mesh) equals one step
    from aether_primitives_tpu_torch.parallel import mesh as mesh_mod

    chain = RxChain(RxChainConfig(fft_len=256, decimation=4, fir_mode=mode), device=CPU)
    n = 8 * 4 * 256 * 2
    x = torch.from_numpy(_c((2, n), 9))
    single = chain.step(x)
    m1 = mesh_mod.make_mesh({"time": 8}, devices=[CPU] * 8)
    assert torch.equal(chain.sharded_step(x[0], m1).gather(), single[0])
    m2 = mesh_mod.make_mesh({"channel": 2, "time": 4}, devices=[CPU] * 8)
    state, outs = chain.init_state((2,)), []
    for i in range(2):
        bits, state = chain.sharded_streaming_step_2d(x[:, i * n // 2:(i + 1) * n // 2], state, m2)
        outs.append(bits.gather())
    assert torch.equal(torch.cat(outs, dim=-1), single)


# ------------------------------------------------------------- loopback


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("noisy", [False, True], ids=["clean", "awgn"])
def test_tx_rx_loopback_as_in_jax(jax_pkg, mode, noisy):
    # tests/test_models.py:180-219, each mode named on both sides
    jm = jax_pkg["modem"]
    jcfg = jm.RxChainConfig(fir_mode=mode, **LINK)
    cfg = convert.config_from_numpy(dataclasses.asdict(jcfg))
    tx, rx, jtx, jrx = TxChain(cfg, device=CPU), RxChain(cfg, device=CPU), jm.TxChain(jcfg), \
        jm.RxChain(jcfg)
    d = loopback_delay(tx, rx)
    assert d == jm.loopback_delay(jtx, jrx)
    nframes, bpf = 6, tx.bits_per_frame()
    bits = _bits(nframes * bpf, 21 if not noisy else 22)
    x = tx.step(torch.from_numpy(bits))
    jx = np.asarray(jtx.step(bits))
    if noisy:
        x = noise.new(1e-6, 815, device=CPU).apply(x)
        jx = np.asarray(jax_pkg["noise"].new(1e-6, 815).apply(jx))
    out = rx.step(torch.cat([x[d:], torch.zeros(d, dtype=torch.complex64)])).numpy()
    jout = np.asarray(jrx.step(np.concatenate([jx[d:], np.zeros(d, np.complex64)])))
    inner = slice(bpf, (nframes - 1) * bpf)
    assert np.array_equal(out[inner], bits[inner])
    assert np.array_equal(jout[inner], bits[inner])


def test_tx_rx_loopback_qam16_with_equalizer_as_in_jax(jax_pkg):
    # tests/test_models.py:229-257
    jm, jsync = jax_pkg["modem"], jax_pkg["sync"]
    jcfg = jm.RxChainConfig(modulation="qam16", fir_mode="fused", **LINK)
    cfg = convert.config_from_numpy(dataclasses.asdict(jcfg))
    tx, rx, jrx = TxChain(cfg, device=CPU), RxChain(cfg, device=CPU), jm.RxChain(jcfg)
    bpf = tx.bits_per_frame()
    bits = _bits(5 * bpf, 23)
    pilot, data = bits[bpf:2 * bpf], bits[2 * bpf:]
    x = tx.step(torch.from_numpy(bits))
    d = loopback_delay(tx, rx)
    rin = torch.cat([x[d:], torch.zeros(d, dtype=torch.complex64)])
    spec = rx.spectra(rin)
    jspec = np.asarray(jrx.spectra(rin.numpy()))
    assert evm_rms_db(spec.numpy(), jspec) <= EVM_DB
    h = OfdmEqualizer.estimate(spec[1], rx.modulation.modulate(torch.from_numpy(pilot)))
    jh = np.asarray(jsync.OfdmEqualizer.estimate(jspec[1], np.asarray(
        jrx.modulation.modulate(pilot))))
    assert evm_rms_db(h.numpy(), jh) <= EVM_DB
    eq = OfdmEqualizer.apply(spec[2:], h)
    assert evm_rms_db(eq.numpy(), np.asarray(jsync.OfdmEqualizer.apply(jspec[2:], jh))) <= EVM_DB
    out = rx.demod_spectra(eq).numpy()
    assert np.array_equal(out[:2 * bpf], data[:2 * bpf])


def test_ofdm_equalizer_guard_bins_and_jax(jax_pkg):
    jsync = jax_pkg["sync"]
    rx_p, tx_p = _c(64, 60), _c(64, 61)
    tx_p[:8] = 0  # guard bins
    h = OfdmEqualizer.estimate(torch.from_numpy(rx_p), torch.from_numpy(tx_p))
    assert torch.equal(h[:8], torch.ones(8, dtype=torch.complex64))
    assert evm_rms_db(h.numpy(), np.asarray(jsync.OfdmEqualizer.estimate(rx_p, tx_p))) <= EVM_DB
    spec = _c((3, 64), 62)
    got = OfdmEqualizer.apply(torch.from_numpy(spec), h).numpy()
    assert evm_rms_db(got, np.asarray(jsync.OfdmEqualizer.apply(spec, h.numpy()))) <= EVM_DB


# ----------------------------------------------------------------- Modem


@pytest.mark.parametrize("mod", ["qpsk", "bpsk", "qam16"])
def test_modem_against_jax(jax_pkg, mod):
    # tests/test_models.py:15-47: loopback bit-exact at the reference's noise
    jm = jax_pkg["modem"]
    jmodem = jm.Modem(jm.ModemConfig(modulation=mod, noise_power=0.01 if mod != "qam16" else 1e-4))
    m = Modem(convert.modem_config_from_numpy(dataclasses.asdict(jmodem.config)), device=CPU)
    bits = _bits(128 * m.modulation.bits_per_symbol, 0)
    syms = m.tx(bits)
    assert np.array_equal(syms.numpy(), np.asarray(jmodem.tx(bits)))
    assert np.array_equal(m.rx(syms).numpy(), np.asarray(jmodem.rx(np.asarray(syms))))
    out = m.loopback(bits)
    assert np.array_equal(out.numpy(), bits)
    assert np.array_equal(np.asarray(jmodem.loopback(bits)), bits)
    # deterministic: the default generator is seeded from config.seed
    assert torch.equal(m.loopback(bits), out)
    gen = torch.Generator().manual_seed(3)
    assert np.array_equal(m.loopback(bits, gen).numpy(), bits)


# ------------------------------------------------------------ on the card


@pytest.mark.cuda
@pytest.mark.parametrize("mod,extra", [("qpsk", dict(active_bins=1024)),
                                       ("qam16", {}), ("psk8", dict(active_bins=512))])
def test_cuda_fused_chains_take_the_spectrum_epilogue(cuda, monkeypatch, mod, extra):
    cfg = RxChainConfig(fft_len=2048, decimation=4, modulation=mod, **extra)
    chain, host = RxChain(cfg, device=cuda), RxChain(cfg, device=CPU)
    assert not chain._sign_fast_path_ok()
    x = _c(2 * 4 * 2048 * 8, 70)
    epilogues, real = [], rf.rx_frame

    def recording(*args, **kwargs):
        epilogues.append(kwargs.get("epilogue"))
        return real(*args, **kwargs)

    monkeypatch.setattr(rf, "rx_frame", recording)
    xd = torch.from_numpy(x).to(cuda)
    state, outs = chain.init_state(), []
    before = rf.launches
    for blk in xd.split(4 * 2048 * 8):
        b, state = chain.streaming_step(blk, state)
        outs.append(b)
    spec = chain.spectra(xd)
    torch.cuda.synchronize()
    assert rf.launches == before + 3 and epilogues == ["spectrum"] * 3
    twin = chain._active(rf.rx_frame_reference(xd, chain.taps, 4, 2048, epilogue="spectrum"))
    assert evm_rms_db(spec.cpu().numpy(), twin.cpu().numpy()) <= EVM_DB
    hbits = host.step(x).numpy()
    assert (torch.cat(outs).cpu().numpy() == hbits).mean() >= AGREEMENT


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["os", "shift_add"])
def test_cuda_other_modes_launch_no_kernel(cuda, mode):
    cfg = RxChainConfig(fir_mode=mode, **LINK)
    tx, rx = TxChain(cfg, device=cuda), RxChain(cfg, device=cuda)
    bpf, d = tx.bits_per_frame(), loopback_delay(tx, rx)
    bits = torch.from_numpy(_bits(8 * bpf, 71)).to(cuda)
    before = rf.launches
    x = tx.step(bits)
    out = rx.step(torch.cat([x[d:], torch.zeros(d, dtype=x.dtype, device=cuda)]))
    torch.cuda.synchronize()
    assert rf.launches == before
    assert torch.equal(out[bpf:7 * bpf], bits[bpf:7 * bpf])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
def test_cuda_tx_chain_against_the_cpu(cuda, mode):
    cfg = RxChainConfig(fft_len=2048, decimation=4, active_bins=1024, fir_mode=mode)
    bits = torch.from_numpy(_bits(16 * 2048, 72))
    got = TxChain(cfg, device=cuda).step(bits.to(cuda)).cpu().numpy()
    assert evm_rms_db(got, TxChain(cfg, device=CPU).step(bits).numpy()) <= EVM_DB
