"""The rest of the port's ``ops/sequence.py`` against the JAX package's:
``generate``, ``lfsr_generate``, ``lfsr_matrix_generate``,
``scramble_additive``, ``bits_to_chips``, ``dsss_spread``, ``zadoff_chu``
and ``gps_ca_code`` are bit-identical (tolerance: none); ``dsss_despread``
is held at RMS EVM <= -120 dB (float32 sums, taken in another order).
"""

import numpy as np
import pytest
import torch

from aether_primitives_tpu_torch.evm import evm_rms_db
from aether_primitives_tpu_torch.ops import sequence as tseq

torch.set_num_threads(1)

EVM_DB = -120.0
CPU = "cpu"


@pytest.fixture(scope="module")
def jseq():
    pytest.importorskip("jax")
    from aether_primitives_tpu.ops import sequence

    return sequence


def test_generate_identical(jseq):
    def gen(p, s):
        return (s[p - 28] ^ s[p - 31]) & 1

    init = [1] + [0] * 30
    assert np.array_equal(tseq.generate(init, gen, 100), jseq.generate(init, gen, 100))
    assert np.array_equal(tseq.generate([1, 0, 1], gen, 2), jseq.generate([1, 0, 1], gen, 2))


@pytest.mark.parametrize("delays,seed,length", [((28, 31), 1, 1600), ((28, 29, 30, 31), 0x1234, 3000),
                                                ((3, 10), 0x3FF, 1023), ((28, 31), 1, 20)])
def test_lfsr_identical(jseq, delays, seed, length):
    init = tseq.expand(seed, max(delays))
    want = np.asarray(jseq.lfsr_generate(init, delays, length))
    got = tseq.lfsr_generate(init, delays, length, device=CPU)
    assert got.dtype == torch.uint8 and got.device.type == "cpu"
    assert np.array_equal(got.numpy(), want)
    for block in (64, 1024):
        m = tseq.lfsr_matrix_generate(torch.from_numpy(init), delays, length, block=block)
        assert np.array_equal(m.numpy(), np.asarray(jseq.lfsr_matrix_generate(
            init, delays, length, block=block)))
    with pytest.raises(ValueError, match="init length"):
        tseq.lfsr_generate(init[:-1], delays, length, device=CPU)


@pytest.mark.parametrize("length,block", [(0, 1024), (7, 1024), (31, 1024), (32, 1024),
                                          (5000, 64), (2049, 1024)])
def test_lfsr_lengths_and_blocks_match_jax(jseq, length, block):
    # the matrix form's doubling over 1, 2 and 79 blocks; a head of init only
    delays = (28, 29, 30, 31)
    init = tseq.expand(0x2F1B37A, 31)
    got = tseq.lfsr_generate(torch.from_numpy(init), delays, length)
    assert got.device.type == "cpu" and got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), np.asarray(jseq.lfsr_generate(init, delays, length)))
    m = tseq.lfsr_matrix_generate(init, delays, length, block=block, device=CPU)
    assert np.array_equal(m.numpy(), np.asarray(jseq.lfsr_matrix_generate(
        init, delays, length, block=block)))


@pytest.mark.parametrize("matrix", [False, True], ids=["lfsr_generate", "lfsr_matrix_generate"])
def test_lfsr_copies_nothing_to_the_host(monkeypatch, matrix):
    init = torch.from_numpy(tseq.expand(1, 31))
    run = ((lambda: tseq.lfsr_matrix_generate(init, (28, 31), 3000, block=256)) if matrix
           else (lambda: tseq.lfsr_generate(init, (28, 31), 3000)))
    want = run()

    def refuse(self, *args, **kwargs):
        raise AssertionError("a tensor was copied to the host")

    for name in ("cpu", "numpy", "tolist", "item"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    got = run()
    monkeypatch.undo()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_lfsr_runs_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    init = tseq.expand(0x1234, 31)
    for fn in (tseq.lfsr_generate, tseq.lfsr_matrix_generate):
        got = fn(torch.from_numpy(init).cuda(), (28, 29, 30, 31), 3000)
        assert got.device.type == "cuda"
        assert np.array_equal(got.cpu().numpy(), tseq._lfsr(init, (28, 29, 30, 31), 3000))


def test_scramble_additive_and_chips_identical(jseq):
    rng = np.random.default_rng(30)
    bits = rng.integers(0, 2, (3, 500)).astype(np.uint8)
    seq = tseq.lte_gold(0x51, 600)
    got = tseq.scramble_additive(torch.from_numpy(bits), seq)
    assert np.array_equal(got.numpy(), np.asarray(jseq.scramble_additive(bits, seq)))
    assert torch.equal(tseq.scramble_additive(got, seq), torch.from_numpy(bits))
    chips = tseq.bits_to_chips(torch.from_numpy(seq[:31]))
    assert chips.dtype == torch.float32
    assert np.array_equal(chips.numpy(), np.asarray(jseq.bits_to_chips(seq[:31])))


def test_dsss_against_jax(jseq):
    rng = np.random.default_rng(31)
    sym = (rng.normal(size=(2, 40)) + 1j * rng.normal(size=(2, 40))).astype(np.complex64)
    chips = np.array(jseq.bits_to_chips(jseq.gps_ca_code(3)[:127]))
    spread = tseq.dsss_spread(torch.from_numpy(sym), torch.from_numpy(chips))
    jspread = np.asarray(jseq.dsss_spread(sym, chips))
    assert np.array_equal(spread.numpy(), jspread)
    noisy = jspread + 0.5 * (rng.normal(size=jspread.shape)
                             + 1j * rng.normal(size=jspread.shape)).astype(np.complex64)
    got = tseq.dsss_despread(torch.from_numpy(noisy), torch.from_numpy(chips)).numpy()
    want = np.asarray(jseq.dsss_despread(noisy, chips))
    assert got.shape == want.shape == (2, 40)
    assert evm_rms_db(got, want) <= EVM_DB
    # complex chips (a ZC code) too
    zc = tseq.zadoff_chu(7, 61)
    back = tseq.dsss_despread(tseq.dsss_spread(torch.from_numpy(sym), torch.from_numpy(zc)),
                              torch.from_numpy(zc)).numpy()
    assert evm_rms_db(back, np.asarray(jseq.dsss_despread(jseq.dsss_spread(sym, zc), zc))) <= EVM_DB


@pytest.mark.parametrize("root,length,shift", [(25, 139, 0), (29, 839, 5), (1, 63, 0)])
def test_zadoff_chu_identical(jseq, root, length, shift):
    got = tseq.zadoff_chu(root, length, shift)
    want = jseq.zadoff_chu(root, length, shift)
    assert got.dtype == np.complex64 and got.tobytes() == want.tobytes()


def test_zadoff_chu_validation():
    with pytest.raises(ValueError, match="odd"):
        tseq.zadoff_chu(1, 64)
    with pytest.raises(ValueError, match="coprime"):
        tseq.zadoff_chu(3, 63)


def test_gps_ca_codes_identical(jseq):
    assert tseq._GPS_CA_TAPS == jseq._GPS_CA_TAPS
    for prn in range(1, 33):
        assert np.array_equal(tseq.gps_ca_code(prn), jseq.gps_ca_code(prn))
    with pytest.raises(ValueError, match="PRN"):
        tseq.gps_ca_code(33)


def test_lfsr_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tseq.lfsr_generate(tseq.expand(1, 31), (28, 31), 100)
