"""The port's burst link (``PacketModem``) and its modules against the JAX
package's, at ``tests/test_packet.py``'s batched size: B = 4 bursts of a
480-bit payload in 8192-sample captures, each with its own delay, CFO and
noise.

Tolerances:
- decoded payloads, CRC verdicts and burst offsets: exact;
- CFO, complex gain, noise variance and preamble metric: ``rtol = RTOL``
  (1e-3; both sides compute them in float32 from FFTs and sums taken in
  another order; measured at most 4e-7 apart);
- ``_rx_front`` LLRs and TX bursts: RMS EVM <= -80 dB (the repo's EVM
  contract; measured -133.6 dB for the Viterbi link's LLRs, -134.0 dB for
  the turbo link's, and identical TX bursts);
- bits of the sequences, scrambler, CRC and interleaver, the preamble and
  the turbo permutation: exact.
The CUDA cases carry the ``cuda`` marker and skip without a card; on one,
run them with ``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_packet.py``.
"""

import dataclasses
import zlib

import numpy as np
import pytest
import torch

from aether_primitives_tpu_torch import convert
from aether_primitives_tpu_torch.evm import evm_rms_db
from aether_primitives_tpu_torch.models import RxChain, RxChainConfig, sync
from aether_primitives_tpu_torch.models.packet import (
    PORTED_FECS, UNPORTED_FECS, PacketConfig, PacketModem,
)
from aether_primitives_tpu_torch.ops import fec, sequence, turbo
from aether_primitives_tpu_torch.ops.cuda import bcjr as bk
from aether_primitives_tpu_torch.ops.cuda import viterbi as vk

torch.set_num_threads(1)

B, PAYLOAD, CAPTURE = 4, 480, 8192
RTOL = 1e-3
EVM_DB = -80.0
DECODED = ("viterbi", "turbo")


@pytest.fixture(scope="module")
def jax_mods():
    pytest.importorskip("jax")
    import jax
    from aether_primitives_tpu.models import packet as jpacket
    from aether_primitives_tpu.models import sync as jsync
    from aether_primitives_tpu.ops import fec as jfec
    from aether_primitives_tpu.ops import sequence as jseq

    return {"jax": jax, "packet": jpacket, "sync": jsync, "fec": jfec, "seq": jseq}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _channel(burst, rng, delay, cfo, gain=0.4 * np.exp(1j * 1.1), sigma=0.08):
    x = np.zeros(CAPTURE, np.complex64)
    x[delay:delay + burst.size] = burst
    n = np.arange(CAPTURE)
    x = x * gain * np.exp(2j * np.pi * cfo * n)
    x += sigma * (rng.normal(size=CAPTURE) + 1j * rng.normal(size=CAPTURE))
    return x.astype(np.complex64)


@pytest.fixture(scope="module")
def link(jax_mods):
    """Per FEC: the JAX modem's bursts for B random payloads, the captures
    after the channel, and JAX ``rx_batch`` / ``_rx_front`` on them."""
    jax, jpacket = jax_mods["jax"], jax_mods["packet"]
    out = {}
    for i, fec_name in enumerate(DECODED):
        rng = np.random.default_rng(815 + i)
        jpm = jpacket.PacketModem(jpacket.PacketConfig(payload_bits=PAYLOAD, fec=fec_name))
        payloads = rng.integers(0, 2, (B, PAYLOAD)).astype(np.uint8)
        bursts = np.stack([np.asarray(jpm.tx(p)) for p in payloads])
        caps = np.stack([_channel(bursts[b], rng, delay=100 + 137 * b, cfo=(b - 1.5) * 4e-4)
                         for b in range(B)])
        jb, jok, jdiag = jpm.rx_batch(caps)
        jllr, _ = jax.vmap(jpm._rx_front)(caps)
        out[fec_name] = {
            "jpm": jpm, "payloads": payloads, "bursts": bursts, "caps": caps,
            "bits": np.asarray(jb), "ok": np.asarray(jok), "llr": np.asarray(jllr),
            "diag": {k: np.asarray(v) for k, v in jdiag.items()},
        }
    return out


def _modem(fec_name, **kw):
    return PacketModem(PacketConfig(payload_bits=PAYLOAD, fec=fec_name, **kw), device="cpu")


@pytest.mark.parametrize("fec_name", DECODED)
def test_rx_batch_matches_jax(link, fec_name):
    ref = link[fec_name]
    pm = _modem(fec_name)
    bits, ok, diag = pm.rx_batch(torch.from_numpy(ref["caps"]))
    assert bits.dtype == torch.uint8 and bits.shape == (B, PAYLOAD)
    assert np.array_equal(bits.numpy(), ref["bits"])
    assert np.array_equal(ok.numpy(), ref["ok"])
    assert np.array_equal(diag["offset"].numpy(), ref["diag"]["offset"])
    assert ok.numpy().all() and np.array_equal(bits.numpy(), ref["payloads"])
    for key in ("cfo", "gain", "noise_var", "metric"):
        np.testing.assert_allclose(diag[key].numpy(), ref["diag"][key], rtol=RTOL)


@pytest.mark.parametrize("fec_name", DECODED)
def test_rx_front_llrs_match_jax(link, fec_name):
    ref = link[fec_name]
    llr, _ = _modem(fec_name)._rx_front(torch.from_numpy(ref["caps"]))
    assert llr.dtype == torch.float32 and llr.shape == ref["llr"].shape
    assert evm_rms_db(llr.numpy(), ref["llr"]) <= EVM_DB


@pytest.mark.parametrize("fec_name", DECODED)
def test_rx_per_burst_equals_rx_batch(link, fec_name):
    ref = link[fec_name]
    pm = _modem(fec_name)
    bits, ok, diag = pm.rx_batch(torch.from_numpy(ref["caps"]))
    b1, ok1, diag1 = pm.rx(torch.from_numpy(ref["caps"][2]))
    assert torch.equal(b1, bits[2]) and bool(ok1) == bool(ok[2])
    assert int(diag1["offset"]) == int(diag["offset"][2])


@pytest.mark.parametrize("fec_name", PORTED_FECS)
def test_tx_matches_jax(jax_mods, fec_name):
    jpm = jax_mods["packet"].PacketModem(
        jax_mods["packet"].PacketConfig(payload_bits=PAYLOAD, fec=fec_name))
    pm = _modem(fec_name)
    payloads = np.random.default_rng(3).integers(0, 2, (3, PAYLOAD)).astype(np.uint8)
    got = pm.tx(torch.from_numpy(payloads)).numpy()
    want = np.stack([np.asarray(jpm.tx(p)) for p in payloads])
    assert got.dtype == np.complex64 and got.shape == want.shape == (3, pm.burst_len)
    assert evm_rms_db(got, want) <= EVM_DB
    assert np.array_equal(pm.tx(torch.from_numpy(payloads[1])).numpy(), got[1])


@pytest.mark.parametrize("fec_name", PORTED_FECS)
def test_loopback_with_interleaver(fec_name):
    pm = _modem(fec_name, interleave_rows=7)
    payload = np.random.default_rng(4).integers(0, 2, PAYLOAD).astype(np.uint8)
    bits, ok, diag = pm.loopback(torch.from_numpy(payload))
    assert bool(ok) and np.array_equal(bits.numpy(), payload)
    assert int(diag["offset"]) == 0


@pytest.mark.parametrize("fec_name", ["viterbi", "none"])
def test_apsk16_round_trips_as_in_jax(jax_mods, fec_name):
    # the 16-APSK table (ops/modulation.py apsk) through the burst link: the
    # same bursts as the JAX modem's, and both decode the payloads of B
    # captures with a gain, a delay, a CFO and noise
    jpacket = jax_mods["packet"]
    jpm = jpacket.PacketModem(jpacket.PacketConfig(payload_bits=PAYLOAD, fec=fec_name,
                                                   modulation="apsk16"))
    pm = _modem(fec_name, modulation="apsk16")
    assert pm.modulation.table.tobytes() == jpm.modulation.table.tobytes()
    rng = np.random.default_rng(5)
    payloads = rng.integers(0, 2, (B, PAYLOAD)).astype(np.uint8)
    bursts = pm.tx(torch.from_numpy(payloads)).numpy()
    want = np.stack([np.asarray(jpm.tx(p)) for p in payloads])
    assert evm_rms_db(bursts, want) <= EVM_DB
    caps = np.stack([_channel(bursts[b], rng, delay=90 + 101 * b, cfo=(b - 1.5) * 2e-4,
                              sigma=0.02) for b in range(B)])
    bits, ok, diag = pm.rx_batch(torch.from_numpy(caps))
    jbits, jok, jdiag = jpm.rx_batch(caps)
    assert ok.numpy().all() and np.array_equal(bits.numpy(), payloads)
    assert np.array_equal(np.asarray(jok), ok.numpy())
    assert np.array_equal(np.asarray(jbits), bits.numpy())
    assert np.array_equal(diag["offset"].numpy(), np.asarray(jdiag["offset"]))


def test_preamble_permutation_and_config_carry_over(jax_mods):
    jpacket = jax_mods["packet"]
    jcfg = jpacket.PacketConfig(payload_bits=600, fec="turbo", preamble_cinit=0x77,
                                scrambler=(18, 23))
    cfg = convert.packet_config_from_numpy(dataclasses.asdict(jcfg))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    pm, jpm = PacketModem(cfg, device="cpu"), jpacket.PacketModem(jcfg)
    assert pm.preamble.tobytes() == jpm.preamble.tobytes()
    assert (pm.burst_len, pm.coded_bits, pm.frame_bits) == (
        jpm.burst_len, jpm.coded_bits, jpm.frame_bits)
    from aether_primitives_tpu.ops import turbo as jturbo

    assert np.array_equal(turbo.turbo_interleaver(pm.frame_bits),
                          jturbo.turbo_interleaver(jpm.frame_bits))
    with pytest.raises(ValueError, match="no fields"):
        convert.packet_config_from_numpy({"fec": "viterbi", "window": 3})


@pytest.mark.parametrize("fec_name", UNPORTED_FECS)
def test_unported_fec_raises(fec_name):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _modem(fec_name)


def test_bad_inputs_raise():
    with pytest.raises(ValueError, match="unknown fec"):
        _modem("bogus")
    with pytest.raises(ValueError, match="order 16 or 32"):
        _modem("viterbi", modulation="apsk8")
    pm = _modem("none")
    with pytest.raises(ValueError, match="B, window"):
        pm.rx_batch(np.zeros(4096, np.complex64))
    with pytest.raises(ValueError, match="payload must be"):
        pm.tx(np.zeros(PAYLOAD + 1, np.uint8))


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RxChain()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RxChain(RxChainConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PacketModem()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PacketModem(PacketConfig(fec="turbo"))
    assert RxChain(device="cpu").device.type == "cpu"
    assert PacketModem(device="cpu").device.type == "cpu"


# ------------------------------------------------- the modules of the link


def test_sequences_and_scrambler_match_jax(jax_mods):
    jseq = jax_mods["seq"]
    for c_init, n in ((0x1234, 256), (1, 64), (0x5A5A5, 1000)):
        assert np.array_equal(sequence.lte_gold(c_init, n), np.asarray(jseq.lte_gold(c_init, n)))
    bits = np.random.default_rng(5).integers(0, 2, (3, 700)).astype(np.uint8)
    for delays, init in (((14, 15), None), ((18, 23), np.arange(23) % 2), ((3, 5, 7), None)):
        got = sequence.scramble_multiplicative(torch.from_numpy(bits), delays, init).numpy()
        want = np.stack([np.asarray(jseq.scramble_multiplicative(b, delays, init)) for b in bits])
        assert np.array_equal(got, want)
        back = sequence.descramble_multiplicative(torch.from_numpy(got), delays, init).numpy()
        assert np.array_equal(back, bits)
        assert np.array_equal(back[0], np.asarray(jseq.descramble_multiplicative(got[0], delays, init)))


@pytest.mark.parametrize("kind", sorted(fec.CRC_PARAMS))
def test_crc_matches_jax(jax_mods, kind):
    jfec = jax_mods["fec"]
    bits = np.random.default_rng(6).integers(0, 2, (3, 611)).astype(np.uint8)
    got = fec.crc_append(torch.from_numpy(bits), kind).numpy()
    want = np.stack([np.asarray(jfec.crc_append(b, kind)) for b in bits])
    assert np.array_equal(got, want)
    assert fec.crc_check(torch.from_numpy(got), kind).numpy().all()
    got[1, 5] ^= 1
    assert fec.crc_check(torch.from_numpy(got), kind).numpy().tolist() == [True, False, True]
    short = np.array([1, 0, 1], np.uint8)  # shorter than the register
    assert np.array_equal(fec.crc_bits(torch.from_numpy(short), kind).numpy(),
                          np.asarray(jfec.crc_bits(short, kind)))


def test_crc32_matches_zlib():
    data = bytes(range(7, 107))
    bits = np.unpackbits(np.frombuffer(data, np.uint8), bitorder="little")
    out = fec.crc_bits(torch.from_numpy(bits), "crc32").numpy()
    assert int(np.packbits(out[::-1], bitorder="little").view(np.uint32)[0]) == zlib.crc32(data)


def test_interleaver_matches_jax(jax_mods):
    jfec = jax_mods["fec"]
    x = np.random.default_rng(7).normal(size=(2, 84)).astype(np.float32)
    got = fec.interleave(torch.from_numpy(x), 7).numpy()
    assert np.array_equal(got, np.asarray(jfec.interleave(x, 7)))
    assert np.array_equal(fec.deinterleave(torch.from_numpy(got), 7).numpy(), x)
    with pytest.raises(ValueError):
        fec.interleave(torch.zeros(10), 3)


def test_sync_matches_jax(jax_mods):
    jsync = jax_mods["sync"]
    rng = np.random.default_rng(8)
    pre = _modem("none").preamble
    qpsk = ((1 - 2 * rng.integers(0, 2, (3, 600))) + 1j * (1 - 2 * rng.integers(0, 2, (3, 600))))
    x = np.zeros((3, 2000), np.complex64)
    for b in range(3):
        x[b, 200 + 300 * b:328 + 300 * b] = pre
        x[b, 328 + 300 * b:928 + 300 * b] = qpsk[b]
    n = np.arange(2000)
    x = (x * np.exp(2j * np.pi * 2e-4 * (n + 1)) * np.exp(0.3j)
         + 0.05 * (rng.normal(size=x.shape) + 1j * rng.normal(size=x.shape))).astype(np.complex64)
    xt = torch.from_numpy(x)
    off, metric = sync.detect_preamble(xt, pre)
    joff, jmetric = zip(*[jsync.detect_preamble(r, pre) for r in x])
    assert np.array_equal(off.numpy(), np.asarray(joff)) and off.tolist() == [200, 500, 800]
    np.testing.assert_allclose(metric.numpy(), np.asarray(jmetric), rtol=RTOL)
    checks = [
        (sync.estimate_cfo(xt[:, 200:], 64), [jsync.estimate_cfo(r[200:], 64) for r in x]),
        (sync.estimate_cfo_blind(xt[:, 1000:1600]),
         [jsync.estimate_cfo_blind(r[1000:1600]) for r in x]),
        (sync.estimate_phase_mpsk(xt[:, 1000:1600]),
         [jsync.estimate_phase_mpsk(r[1000:1600]) for r in x]),
    ]
    for got, want in checks:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)
    f = np.array([1e-4, -3e-4, 0.0], np.float32)
    shifted = sync.apply_freq_shift(xt, torch.from_numpy(f)).numpy()
    want = np.stack([np.asarray(jsync.apply_freq_shift(x[b], f[b])) for b in range(3)])
    assert evm_rms_db(shifted, want) <= EVM_DB


# ------------------------------------------------------------ on the card


@pytest.mark.cuda
@pytest.mark.parametrize("fec_name", DECODED)
def test_cuda_rx_batch_goes_through_the_kernels(cuda, fec_name):
    rng = np.random.default_rng(9)
    host, card = _modem(fec_name), PacketModem(PacketConfig(payload_bits=PAYLOAD, fec=fec_name))
    payloads = rng.integers(0, 2, (B, PAYLOAD)).astype(np.uint8)
    bursts = card.tx(torch.from_numpy(payloads)).cpu().numpy()
    assert np.array_equal(bursts, host.tx(torch.from_numpy(payloads)).numpy())
    caps = np.stack([_channel(bursts[b], rng, 100 + 137 * b, (b - 1.5) * 4e-4)
                     for b in range(B)])
    v0, b0 = vk.launches, bk.launches
    bits, ok, diag = card.rx_batch(torch.from_numpy(caps).to(cuda))
    torch.cuda.synchronize()
    assert (vk.launches - v0, bk.launches - b0) == ((1, 0) if fec_name == "viterbi" else (0, 16))
    hbits, hok, hdiag = host.rx_batch(torch.from_numpy(caps))
    assert np.array_equal(bits.cpu().numpy(), payloads) and ok.cpu().numpy().all()
    assert np.array_equal(bits.cpu().numpy(), hbits.numpy())
    assert np.array_equal(diag["offset"].cpu().numpy(), hdiag["offset"].numpy())


# ------------------------------------------------------------- sharded bursts


@pytest.mark.parametrize("fec_name", DECODED)
def test_rx_batch_sharded_matches_unsharded(link, fec_name):
    # tests/test_packet.py's case: payloads, CRC and offsets equal to rx_batch
    from aether_primitives_tpu_torch.parallel import mesh as mesh_mod

    ref = link[fec_name]
    pm = _modem(fec_name)
    mesh = mesh_mod.make_mesh({"channel": B}, devices=["cpu"] * B)
    caps = torch.from_numpy(ref["caps"])
    bits_s, ok_s, diag_s = pm.rx_batch_sharded(caps, mesh)
    bits_u, ok_u, diag_u = pm.rx_batch(caps)
    assert bits_s.spec == ("channel", None) and ok_s.spec == ("channel",)
    assert torch.equal(bits_s.gather(), bits_u) and torch.equal(ok_s.gather(), ok_u)
    for key in diag_u:
        assert torch.equal(diag_s[key].gather(), diag_u[key]), key
    assert np.array_equal(np.asarray(bits_s), ref["payloads"]) and np.asarray(ok_s).all()
    assert np.array_equal(np.asarray(diag_s["offset"]), ref["diag"]["offset"])
    two = mesh_mod.make_mesh({"channel": 2, "time": 1}, devices=["cpu"] * 2)
    assert torch.equal(pm.rx_batch_sharded(caps, two)[0].gather(), bits_u)
    with pytest.raises(ValueError, match="divide"):
        pm.rx_batch_sharded(caps[:3], mesh)
    with pytest.raises(ValueError, match=r"takes \[B, window\] captures"):
        pm.rx_batch_sharded(caps[0], mesh)
