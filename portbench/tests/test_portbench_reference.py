"""The benchmark's frozen copies held against the port at tiny sizes on the
CPU: the float64 RX chain, the burst transmitter and its codes, the
reference burst receiver, and the roofline arithmetic. The tests may import
the port; the references may not (``test_portbench_imports.py``)."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench.gen import burst_tx, channel  # noqa: E402
from portbench.reference import burst_rx, roofline  # noqa: E402
from portbench.reference import rx_chain as ref  # noqa: E402
from portbench.reference.precision import bf16  # noqa: E402

from aether_primitives_tpu_torch import cli  # noqa: E402
from aether_primitives_tpu_torch.models import (PacketConfig, PacketModem, RxChain,  # noqa: E402
                                                RxChainConfig)
from aether_primitives_tpu_torch.ops import fec, rs, sequence  # noqa: E402
from aether_primitives_tpu_torch.ops.cuda import rx_frame  # noqa: E402

CCSDS = dict(fec="ccsds", payload_bits=1768, crc="crc16-ccitt", modulation="qpsk",
             rs_n=255, rs_k=223, ccsds_interleave_rows=8, ccsds_interleaver="block")


@pytest.mark.parametrize("dec,fft_len", [(4, 2048), (2, 256), (4, 64)])
def test_rx_reference_matches_the_ports_float64_chain(dec, fft_len):
    chain = {"fft_len": fft_len, "decimation": dec, "packed_bits": True}
    taps = ref.chain_taps(chain)
    assert np.array_equal(taps, RxChain(RxChainConfig(**chain), device="cpu").taps)
    x = cli.capture(3 * dec * fft_len, seed=7)
    k = taps.shape[-1]
    n = 2 * dec * fft_len
    hist = torch.from_numpy(x[n - (k - 1):n])[None]
    got = ref.spectra(torch.from_numpy(x[n:])[None], hist, taps, dec, fft_len)
    want = cli.numpy_reference_spectra(x, taps, dec, fft_len)[-got.shape[1]:]
    assert np.abs(got[0].numpy() - want).max() < 1e-5
    bits = ref.qpsk_bits(got)
    assert np.array_equal(bits[0].numpy(), cli.numpy_reference_bits(x, taps, dec, fft_len)[-bits.shape[1]:])
    packed = ref.pack(bits)
    assert torch.equal(packed, rx_frame.pack_bits(bits))


def test_rx_reference_agrees_with_the_chain_and_its_margins():
    chain_cfg = {"fft_len": 256, "decimation": 4, "packed_bits": True}
    chain = RxChain(RxChainConfig(**chain_cfg), device="cpu")
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 2, 4096, dtype=torch.complex64, generator=g)
    state = chain.init_state((2,))
    _, state = chain.streaming_step(x[0], state)
    bits, _ = chain.streaming_step(x[1], state)
    spec = ref.spectra(x[1], x[0][:, -64:], ref.chain_taps(chain_cfg), 4, 256)
    flips, total, worst, _rows = ref.compare(bits, ref.pack(ref.qpsk_bits(spec)), ref.margins(spec))
    assert total == bits.numel() * 8 and flips <= 2 and worst < 1e-5
    low = ref.pack(ref.qpsk_bits(ref.spectra(x[1], x[0][:, -64:], ref.chain_taps(chain_cfg),
                                             4, 256, bf16)))
    _f, _t, worst_bf16, _r = ref.compare(low, ref.pack(ref.qpsk_bits(spec)), ref.margins(spec))
    assert worst_bf16 > 1e-4


def test_transmitter_matches_the_ports_bit_for_bit():
    link = burst_tx.Link(CCSDS)
    pm = PacketModem(PacketConfig(**CCSDS), device="cpu")
    assert (link.burst_len, link.coded_bits) == (pm.burst_len, pm.coded_bits) == (2174, 4092)
    g = torch.Generator().manual_seed(11)
    pay = torch.randint(0, 2, (3, 1768), dtype=torch.uint8, generator=g)
    assert torch.equal(link.tx(pay), pm.tx(pay))
    assert np.array_equal(link.preamble, pm.preamble)


def test_codes_match_the_ports():
    g = torch.Generator().manual_seed(12)
    bits = torch.randint(0, 2, (4, 200), dtype=torch.uint8, generator=g)
    assert torch.equal(burst_tx.crc(bits, "crc16-ccitt"), fec.crc_bits(bits, "crc16-ccitt"))
    assert torch.equal(burst_tx.scramble(bits), sequence.scramble_multiplicative(bits, (14, 15)))
    assert torch.equal(burst_tx.descramble(burst_tx.scramble(bits)), bits)
    assert torch.equal(burst_tx.conv_encode(bits), fec.conv_encode(bits))
    assert torch.equal(burst_tx.interleave(bits, 8), fec.interleave(bits, 8))
    assert torch.equal(burst_tx.deinterleave(bits, 8), fec.deinterleave(bits, 8))
    assert np.array_equal(burst_tx.gold(0x1234, 128), sequence.lte_gold(0x1234, 128))
    msg = torch.randint(0, 256, (4, 223), dtype=torch.uint8, generator=g)
    assert torch.equal(burst_tx.rs_encode(msg, 255, 223), rs.rs_255_223().encode(msg))


@pytest.mark.parametrize("errors", [0, 1, 7, 16, 17])
def test_rs_decoder_corrects_up_to_t_as_the_ports(errors):
    rng = np.random.default_rng(errors)
    msg = torch.from_numpy(rng.integers(0, 256, (3, 223)).astype(np.uint8))
    cw = burst_tx.rs_encode(msg, 255, 223).to(torch.int64)
    for row in range(3):
        pos = rng.choice(255, errors, replace=False)
        cw[row, pos] ^= torch.from_numpy(rng.integers(1, 256, errors))
    got, ok, corrected = burst_rx.rs_decode(cw, 255, 223)
    port, port_ok, _ = rs.rs_255_223().decode(cw.to(torch.uint8))
    assert torch.equal(ok, port_ok)
    if errors <= 16:
        assert bool(ok.all()) and torch.equal(got.to(torch.uint8), msg)
        assert corrected.tolist() == [errors] * 3


def test_viterbi_matches_the_ports_full_block_decoder():
    g = torch.Generator().manual_seed(13)
    bits = torch.randint(0, 2, (3, 300), dtype=torch.uint8, generator=g)
    coded = burst_tx.conv_encode(bits)
    llr = (1.0 - 2.0 * coded.to(torch.float64)) * 2.0 + torch.randn(coded.shape, generator=g,
                                                                     dtype=torch.float64) * 1.2
    got = burst_rx.viterbi(llr)
    port = fec.viterbi_decode(llr.to(torch.float32), backend="reference")
    assert torch.equal(got, port)


def test_reference_receiver_agrees_with_rx_batch():
    link = burst_tx.Link(CCSDS)
    pm = PacketModem(PacketConfig(**CCSDS), device="cpu")
    g = torch.Generator().manual_seed(2**31 + 5)
    pay = torch.randint(0, 2, (6, 1768), dtype=torch.uint8, generator=g)
    sigma = channel.noise_sigma(4.0, 1768, link.coded_bits, 2, 2.0)
    caps, truth = channel.captures(link.tx(pay), 16384, sigma, 1e-3, g)
    rpay, rok, est = burst_rx.decode(caps, link)
    ppay, pok, diag = pm.rx_batch(caps)
    assert bool(rok.all()) and torch.equal(rpay, pay)
    assert torch.equal(pok, rok) and torch.equal(ppay, rpay)
    assert torch.equal(est["offset"], truth["offset"]) and torch.equal(diag["offset"], est["offset"])
    assert float(((diag["gain"].to(torch.complex128) - est["gain"]).abs()
                  / est["gain"].abs()).max()) < 1e-5
    assert float((diag["cfo"].double() - est["cfo"]).abs().max()) < 3e-8


def test_roofline_copies_match_the_port_chip_script():
    import chip_smoke

    assert (roofline.PEAK_FP32, roofline.PEAK_BYTES) == (chip_smoke.PEAK_FP32, chip_smoke.PEAK_BYTES)
    assert roofline.viterbi_bound(2048, 2046, 2, 64, 4) == chip_smoke.viterbi_bound_of(2048, 2046, 2, 64, 4)
    n, dec, fft_len, k = 1 << 22, 4, 2048, 65
    frames = n // (dec * fft_len)
    want = chip_smoke.bound(4.0 * frames * fft_len * k + 5.0 * frames * fft_len * np.log2(fft_len),
                            n * 8 + n // 16 + (k - 1) * 8)
    got = roofline.rx_frame_bound(1, n, dec, fft_len, k)
    assert got["bound_by"] == want["bound_by"] == "bytes"
    assert got["bound_ms"] == pytest.approx(want["bound_ms"], rel=1e-12)
    sixteen = roofline.rx_frame_bound(16, n, dec, fft_len, k)
    assert sixteen["bound_ms"] == pytest.approx(16 * want["bound_ms"], rel=1e-12)
