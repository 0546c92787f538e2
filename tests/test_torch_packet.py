"""The port's burst link (``PacketModem``) and its modules against the JAX
package's, at ``tests/test_packet.py``'s batched size: B = 4 bursts of a
480-bit payload in 8192-sample captures, each with its own delay, CFO and
noise, for every FEC family the port decodes (``FAMILIES`` adds the RS,
CCSDS, BCH, TPC, LDPC, NR LDPC and polar families, and the LDPC and NR
tables loaded from files, to the Viterbi and turbo links), and
``tests/test_packet.py``'s fade-and-erasure cases. The code tables go to
files under a temporary directory, written by each package's own
``code_io`` for its modem.

Tolerances:
- decoded payloads, CRC verdicts and burst offsets: exact, and the TX
  bursts of the ``FAMILIES`` links bit-equal;
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
    PORTED_FECS, PacketConfig, PacketModem,
)
from aether_primitives_tpu_torch.ops import code_io, fec, ldpc, nr_ldpc, sequence, turbo
from aether_primitives_tpu_torch.ops.cuda import bcjr as bk
from aether_primitives_tpu_torch.ops.cuda import viterbi as vk

torch.set_num_threads(1)

B, PAYLOAD, CAPTURE = 4, 480, 8192
RTOL = 1e-3
EVM_DB = -80.0
DECODED = ("viterbi", "turbo")
#: The other decoded links: name -> PacketConfig fields; a ``*_file`` field
#: names a file of ``TABLES``.
FAMILIES = {
    "rs": {"fec": "rs"},
    "ccsds": {"fec": "ccsds"},
    "ccsds-conv": {"fec": "ccsds", "ccsds_interleaver": "conv"},
    "ccsds-erasures": {"fec": "ccsds", "rs_erasures": True},
    "bch": {"fec": "bch"},
    "bch-chase": {"fec": "bch", "bch_chase": 4},
    "tpc": {"fec": "tpc"},
    "ldpc": {"fec": "ldpc"},
    "ldpc11n": {"fec": "ldpc11n"},
    "nr_ldpc": {"fec": "nr_ldpc"},
    "polar": {"fec": "polar"},
    "polar-bp": {"fec": "polar", "polar_decoder": "bp"},
    "ldpc-alist": {"fec": "ldpc", "ldpc_file": "regular.alist"},
    "ldpc-npz": {"fec": "ldpc", "ldpc_file": "wifi_qc.npz"},
    "nr-file": {"fec": "nr_ldpc", "nr_base_graph_file": "bg2_z64.npz"},
}
#: file name -> (writer name of ``code_io``, the table's arguments): the
#: Gallager code's H, the 802.11n 648/Z27 base, and an NR BG2 graph for z 64
#: of another seed than the built-in one (at this payload's z 52 its shifts
#: apply mod 52)
TABLES = {
    "regular.alist": ("save_alist", lambda: (ldpc.make_regular_ldpc()[0],)),
    "wifi_qc.npz": ("save_qc_npz", lambda: (ldpc._WIFI_648_R12, 27)),
    "bg2_z64.npz": ("save_qc_npz", lambda: (nr_ldpc.make_nr_base_graph(2, 64, seed=99), 64)),
}


def _write_tables(cio, folder):
    """Every file of ``TABLES`` written by ``cio`` (a ``code_io`` module)
    into ``folder``."""
    for fname, (writer, args) in TABLES.items():
        getattr(cio, writer)(*args(), folder / fname)
    return folder


def _fields(name, folder):
    """``FAMILIES[name]`` with its file names under ``folder``."""
    return {k: str(folder / v) if k.endswith("_file") else v for k, v in FAMILIES[name].items()}


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


def _jax_link(jax, jpacket, cfg: dict, seed: int, jit: bool = False) -> dict:
    """The JAX modem's bursts for B random payloads, the captures after the
    channel, and JAX ``rx_batch`` / ``_rx_front`` on them (``jit``: each
    traced once, as one XLA program, which compiles several times faster
    than the op-by-op calls)."""
    rng = np.random.default_rng(seed)
    jpm = jpacket.PacketModem(jpacket.PacketConfig(payload_bits=PAYLOAD, **cfg))
    wrap = jax.jit if jit else (lambda f: f)
    payloads = rng.integers(0, 2, (B, PAYLOAD)).astype(np.uint8)
    tx = wrap(jpm.tx)
    bursts = np.stack([np.asarray(tx(p)) for p in payloads])
    caps = np.stack([_channel(bursts[b], rng, delay=100 + 137 * b, cfo=(b - 1.5) * 4e-4)
                     for b in range(B)])
    jb, jok, jdiag = wrap(jpm.rx_batch)(caps)
    jllr, _ = wrap(jax.vmap(jpm._rx_front))(caps)
    return {
        "jpm": jpm, "payloads": payloads, "bursts": bursts, "caps": caps,
        "bits": np.asarray(jb), "ok": np.asarray(jok), "llr": np.asarray(jllr),
        "diag": {k: np.asarray(v) for k, v in jdiag.items()},
    }


@pytest.fixture(scope="module")
def link(jax_mods):
    """Per FEC of ``DECODED``: :func:`_jax_link`."""
    return {fec_name: _jax_link(jax_mods["jax"], jax_mods["packet"], {"fec": fec_name}, 815 + i)
            for i, fec_name in enumerate(DECODED)}


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    """The port's ``TABLES``, written by its own ``code_io``."""
    return _write_tables(code_io, tmp_path_factory.mktemp("port_tables"))


@pytest.fixture(scope="module")
def families(jax_mods, tmp_path_factory):
    """:func:`_jax_link` of a ``FAMILIES`` link, made at its first use (the
    JAX modem reads ``TABLES`` written by the JAX package's ``code_io``)."""
    from aether_primitives_tpu.ops import code_io as jcode_io

    folder = _write_tables(jcode_io, tmp_path_factory.mktemp("jax_tables"))
    cache = {}

    def get(name):
        if name not in cache:
            seed = 900 + list(FAMILIES).index(name)
            cache[name] = _jax_link(jax_mods["jax"], jax_mods["packet"], _fields(name, folder),
                                    seed, jit=True)
        return cache[name]

    return get


def _modem(fec_name, **kw):
    return PacketModem(PacketConfig(payload_bits=PAYLOAD, fec=fec_name, **kw), device="cpu")


def _family_modem(name, folder, device="cpu"):
    return PacketModem(PacketConfig(payload_bits=PAYLOAD, **_fields(name, folder)), device=device)


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
    jtx = jax_mods["jax"].jit(jpm.tx)
    want = np.stack([np.asarray(jtx(p)) for p in payloads])
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


def test_every_jax_fec_is_ported(jax_mods):
    # the families that the JAX PacketConfig's fec field lists in its comment
    import inspect
    import re

    line = next(ln for ln in inspect.getsource(jax_mods["packet"].PacketConfig).splitlines()
                if ln.strip().startswith("fec: str"))
    listed = re.findall(r'"([a-z0-9_]+)"', line.split("#", 1)[1])
    assert len(listed) == 11 and sorted(listed) == sorted(PORTED_FECS)
    for fec_name in listed:
        # a JAX config carried over by convert builds the same frame
        jcfg = jax_mods["packet"].PacketConfig(payload_bits=PAYLOAD, fec=fec_name)
        jpm = jax_mods["packet"].PacketModem(jcfg)
        pm = PacketModem(convert.packet_config_from_numpy(dataclasses.asdict(jcfg)), device="cpu")
        assert (pm.burst_len, pm.coded_bits, pm.frame_bits) == (
            jpm.burst_len, jpm.coded_bits, jpm.frame_bits), fec_name
    with pytest.raises(ValueError, match="unknown fec"):
        _modem("polar2")


def test_file_tables_replace_the_built_in_ones(tables):
    # a QC .npz keeps the QC decoder, an .alist takes the dense one; the NR
    # graph of the file (shifts mod the modem's z) replaces the built-in one
    alist, npz = _family_modem("ldpc-alist", tables), _family_modem("ldpc-npz", tables)
    assert alist._ldpc_qc is None and np.array_equal(alist._ldpc[0], ldpc.make_regular_ldpc()[0])
    base, z = npz._ldpc_qc
    assert z == 27 and np.array_equal(base, ldpc._WIFI_648_R12)
    assert np.array_equal(npz._ldpc[0], ldpc.wifi_ldpc()[0])
    nr = _family_modem("nr-file", tables)._nr
    base = nr_ldpc.make_nr_base_graph(2, 64, seed=99)
    assert nr.z == 52 and nr.base_graph == tuple(map(tuple, np.where(base >= 0, base % 52,
                                                                     -1).tolist()))
    assert nr.base_graph != tuple(map(tuple, nr_ldpc.make_nr_base_graph(2, 52).tolist()))


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


# ------------------------------------------------------------------ F17
# The psk2 and psk4 tables lie on the axes (1, -1; 1, j, -1, -j), so the
# burst's fine phase takes the "axes" grid for them (ROADMAP.md §3, F17);
# the JAX package takes the diagonal grid for every table, and its psk2 /
# psk4 bursts fail the CRC (ROADMAP.md §3.9).


@pytest.mark.parametrize("fec_name", ["none", "viterbi"])
@pytest.mark.parametrize("modulation", ["psk2", "psk4"])
def test_f17_psk_loopback_is_exact(modulation, fec_name):
    pm = _modem(fec_name, modulation=modulation)
    payload = np.random.default_rng(17).integers(0, 2, PAYLOAD).astype(np.uint8)
    bits, ok, diag = pm.loopback(torch.from_numpy(payload))
    assert bool(ok) and np.array_equal(bits.numpy(), payload)
    assert int(diag["offset"]) == 0


def test_f17_psk4_rx_batch_decodes_every_capture():
    # B captures with a gain, a delay, a CFO and noise, uncoded: a phase
    # off by pi/4 would turn every symbol
    pm = _modem("none", modulation="psk4")
    rng = np.random.default_rng(1717)
    payloads = rng.integers(0, 2, (B, PAYLOAD)).astype(np.uint8)
    bursts = pm.tx(torch.from_numpy(payloads)).numpy()
    caps = np.stack([_channel(bursts[b], rng, delay=70 + 97 * b, cfo=(b - 1.5) * 2e-4,
                              sigma=0.02) for b in range(B)])
    bits, ok, _ = pm.rx_batch(torch.from_numpy(caps))
    assert ok.numpy().all() and np.array_equal(bits.numpy(), payloads)


@pytest.mark.xfail(strict=True, reason="ROADMAP.md §3.9: the JAX package's burst RX takes "
                   "the diagonal phase grid for the axis psk tables, so its psk4 bursts fail "
                   "the CRC")
def test_f17_psk4_rx_matches_jax(jax_mods):
    jax, jpacket = jax_mods["jax"], jax_mods["packet"]
    jpm = jpacket.PacketModem(jpacket.PacketConfig(payload_bits=PAYLOAD, fec="none",
                                                   modulation="psk4"))
    pm = _modem("none", modulation="psk4")
    payload = np.random.default_rng(18).integers(0, 2, PAYLOAD).astype(np.uint8)
    burst = pm.tx(torch.from_numpy(payload)).numpy()
    assert evm_rms_db(burst, np.asarray(jax.jit(jpm.tx)(payload))) <= EVM_DB
    bits, ok, _ = pm.rx(torch.from_numpy(burst))
    jbits, jok, _ = jax.jit(jpm.rx)(burst)
    assert bool(ok) and bool(jok) and np.array_equal(np.asarray(jbits), bits.numpy())


# ------------------------------------------- the RS, CCSDS, BCH, TPC, LDPC links


@pytest.mark.parametrize("name", FAMILIES)
def test_family_rx_batch_matches_jax(families, tables, name):
    ref = families(name)
    pm = _family_modem(name, tables)
    bits, ok, diag = pm.rx_batch(torch.from_numpy(ref["caps"]))
    assert bits.dtype == torch.uint8 and bits.shape == (B, PAYLOAD)
    assert np.array_equal(bits.numpy(), ref["bits"])
    assert np.array_equal(ok.numpy(), ref["ok"])
    assert np.array_equal(diag["offset"].numpy(), ref["diag"]["offset"])
    assert ok.numpy().all() and np.array_equal(bits.numpy(), ref["payloads"])


@pytest.mark.parametrize("name", FAMILIES)
def test_family_tx_is_bit_equal_to_jax(families, tables, name):
    ref = families(name)
    pm = _family_modem(name, tables)
    assert (pm.burst_len, pm.coded_bits) == (ref["jpm"].burst_len, ref["jpm"].coded_bits)
    got = pm.tx(torch.from_numpy(ref["payloads"])).numpy()
    assert got.dtype == np.complex64 and np.array_equal(got, ref["bursts"])
    llr, _ = pm._rx_front(torch.from_numpy(ref["caps"]))
    assert evm_rms_db(llr.numpy(), ref["llr"]) <= EVM_DB


@pytest.mark.parametrize("name", FAMILIES)
def test_family_rx_per_burst_equals_rx_batch(tables, name):
    pm = _family_modem(name, tables)
    rng = np.random.default_rng(17)
    payloads = rng.integers(0, 2, (3, PAYLOAD)).astype(np.uint8)
    bursts = pm.tx(torch.from_numpy(payloads)).numpy()
    caps = np.stack([_channel(bursts[b], rng, 60 + 91 * b, (b - 1) * 3e-4) for b in range(3)])
    bits, ok, diag = pm.rx_batch(torch.from_numpy(caps))
    assert ok.numpy().all() and np.array_equal(bits.numpy(), payloads)
    b1, ok1, diag1 = pm.rx(torch.from_numpy(caps[1]))
    assert torch.equal(b1, bits[1]) and bool(ok1) and int(diag1["offset"]) == int(diag["offset"][1])


def test_erasure_median_averages_the_middle_pair(jax_mods):
    # jnp.median takes the mean of the two middle values (torch.median the
    # lower one): the erasure rule's median at an even rs_n
    import jax.numpy as jnp

    from aether_primitives_tpu_torch.ops._stats import median_midpoint

    x = np.random.default_rng(18).random((3, 2, 156)).astype(np.float32)
    x[0, 0, :4] = 0.5
    for n in (156, 255, 2):
        got = median_midpoint(torch.from_numpy(x[..., :n]), keepdim=True)
        want = np.asarray(jnp.median(x[..., :n], axis=-1, keepdims=True))
        assert np.array_equal(got.numpy(), want)


def _faded_rs_captures(pm, rng, payloads):
    """tests/test_packet.py's 80-symbol fade inside the shortened RS
    codeword, one capture a payload."""
    caps = []
    for i, p in enumerate(payloads):
        burst = pm.tx(torch.from_numpy(p)).numpy()
        cap = np.zeros(6000, np.complex64)
        cap[400:400 + burst.size] = burst
        n = np.arange(cap.size)
        cap = cap * np.exp(2j * np.pi * 5e-4 * n)
        cap += 0.03 * (rng.normal(size=cap.size) + 1j * rng.normal(size=cap.size))
        lo = 400 + pm.preamble.size + 230 + 7 * i
        cap[lo:lo + 80] = 0.02 * (rng.normal(size=80) + 1j * rng.normal(size=80))
        caps.append(cap.astype(np.complex64))
    return np.stack(caps)


def test_rs_erasures_survive_the_fade_as_in_jax(jax_mods):
    # tests/test_packet.py:168: ~21 symbol errors of RS(156, 124), beyond
    # t = 16 for plain RS, within 2 nu + rho <= 32 once the fade is erased
    jpacket = jax_mods["packet"]
    cfg = dict(payload_bits=960, fec="rs", rs_n=156, rs_k=124)
    rng = np.random.default_rng(19)
    payloads = rng.integers(0, 2, (B, 960)).astype(np.uint8)
    plain = PacketModem(PacketConfig(**cfg), device="cpu")
    caps = _faded_rs_captures(plain, rng, payloads)
    for erasures in (False, True):
        pm = PacketModem(PacketConfig(**cfg, rs_erasures=erasures), device="cpu")
        jpm = jpacket.PacketModem(jpacket.PacketConfig(**cfg, rs_erasures=erasures))
        bits, ok, diag = pm.rx_batch(torch.from_numpy(caps))
        jbits, jok, jdiag = jax_mods["jax"].jit(jpm.rx_batch)(caps)
        assert np.array_equal(bits.numpy(), np.asarray(jbits))
        assert np.array_equal(ok.numpy(), np.asarray(jok))
        assert np.array_equal(diag["offset"].numpy(), np.asarray(jdiag["offset"]))
        if erasures:
            assert ok.numpy().all() and np.array_equal(bits.numpy(), payloads)
        else:
            assert not ok.numpy().any()


def test_ccsds_soft_erasures_survive_the_fade_as_in_jax(jax_mods):
    # tests/test_packet.py:309: a 140-symbol fade kills the hard-decision
    # chain; the BCJR's reliabilities let the outer RS erase it
    jpacket = jax_mods["packet"]
    rng = np.random.default_rng(4242)
    payloads = rng.integers(0, 2, (2, 960)).astype(np.uint8)
    plain = PacketModem(PacketConfig(payload_bits=960, fec="ccsds"), device="cpu")
    caps = []
    for seed in (1, 2):
        r = np.random.default_rng(seed)
        x = plain.tx(torch.from_numpy(payloads[seed - 1])).numpy().copy()
        lo = plain.preamble.size + 40
        x[lo:lo + 140] *= 0.05
        x += (0.25 * (r.normal(size=x.shape) + 1j * r.normal(size=x.shape))).astype(np.complex64)
        caps.append(x.astype(np.complex64))
    caps = np.stack(caps)
    for erasures in (False, True):
        cfg = dict(payload_bits=960, fec="ccsds", rs_erasures=erasures)
        pm = PacketModem(PacketConfig(**cfg), device="cpu")
        jpm = jpacket.PacketModem(jpacket.PacketConfig(**cfg))
        jbits, jok, jdiag = jax_mods["jax"].jit(jpm.rx_batch)(caps)
        bits, ok, diag = pm.rx_batch(torch.from_numpy(caps))
        assert np.array_equal(bits.numpy(), np.asarray(jbits))
        assert np.array_equal(ok.numpy(), np.asarray(jok))
        assert np.array_equal(diag["offset"].numpy(), np.asarray(jdiag["offset"]))
        if erasures:
            assert ok.numpy().all() and np.array_equal(bits.numpy(), payloads)
        else:
            assert not ok.numpy().any()


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


@pytest.mark.cuda
@pytest.mark.parametrize("name", FAMILIES)
def test_cuda_family_rx_batch_equals_the_cpu_run(cuda, tables, name):
    # ccsds decodes its inner code through one kernel launch (Viterbi, or
    # BCJR with erasures); the other families launch none of the kernels
    rng = np.random.default_rng(20)
    host, card = _family_modem(name, tables), _family_modem(name, tables, device=cuda)
    payloads = rng.integers(0, 2, (B, PAYLOAD)).astype(np.uint8)
    bursts = card.tx(torch.from_numpy(payloads)).cpu().numpy()
    assert np.array_equal(bursts, host.tx(torch.from_numpy(payloads)).numpy())
    caps = np.stack([_channel(bursts[b], rng, 100 + 137 * b, (b - 1.5) * 4e-4)
                     for b in range(B)])
    v0, b0 = vk.launches, bk.launches
    bits, ok, diag = card.rx_batch(torch.from_numpy(caps).to(cuda))
    torch.cuda.synchronize()
    want = {"ccsds": (1, 0), "ccsds-conv": (1, 0), "ccsds-erasures": (0, 1)}.get(name, (0, 0))
    assert (vk.launches - v0, bk.launches - b0) == want
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
