"""The RX frame op: its plain PyTorch version against the JAX package's
Pallas kernel (``rx_frame_qpsk_bits``, in interpret mode) and the float64
chain, and the CUDA kernel against the plain version on a card.

Tolerances: hard bits are exact wherever the float64 reference's decision
component exceeds ``MARGIN`` x its RMS, and agree >= ``AGREEMENT`` overall
(two float32 implementations may split a sign only on near-zero bins);
spectra hold RMS EVM <= -80 dB. The CUDA cases carry the ``cuda`` marker
and skip without a card; on one, run them with
``python -m pytest --noconftest -m cuda tests/test_torch_rx_frame.py``.
"""

import numpy as np
import pytest
import torch

from aether_primitives_tpu_torch.cli import numpy_reference_spectra
from aether_primitives_tpu_torch.evm import evm_rms_db
from aether_primitives_tpu_torch.models.modem import _default_lowpass
from aether_primitives_tpu_torch.ops.cuda import rx_frame as rf

torch.set_num_threads(1)

AGREEMENT = 0.99999
MARGIN = 1e-4
EVM_DB = -80.0
TAPS = _default_lowpass(65, 1.0 / 8)
unpack = rf.unpack_bits


@pytest.fixture(scope="module")
def pallas_bits():
    pytest.importorskip("jax")
    from aether_primitives_tpu.ops.pallas.rx_frame import rx_frame_qpsk_bits

    return rx_frame_qpsk_bits


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


def _decisions(spec, epilogue):
    """float64 reference bits and each bit's decision margin."""
    if epilogue == "bpsk":
        s = spec.real + spec.imag
        return (s < 0).astype(np.uint8).reshape(-1), np.abs(s).reshape(-1)
    comp = np.stack([spec.real, spec.imag], axis=-1).reshape(-1)
    return (comp < 0).astype(np.uint8), np.abs(comp)


def _check_bits(got, want, margin):
    got, want = np.asarray(got).reshape(-1), np.asarray(want).reshape(-1)
    assert got.shape == want.shape
    clear = margin > MARGIN * np.sqrt(np.mean(margin ** 2))
    assert np.array_equal(got[clear], want[clear])
    assert (got == want).mean() >= AGREEMENT


def _halves(x, k, device="cpu"):
    """The capture as two blocks, the second with the first's tail as history."""
    h = x.shape[-1] // 2
    t = torch.from_numpy(x).to(device)
    return [(t[..., :h].contiguous(), None),
            (t[..., h:].contiguous(), t[..., h - (k - 1):h].contiguous())]


@pytest.mark.parametrize("history", [False, True], ids=["one-block", "two-blocks"])
def test_plain_matches_pallas_interpret(pallas_bits, history):
    dec, n_fft = 4, 256
    x = _signal(dec * n_fft * 8, 100)
    k = TAPS.shape[-1]
    ref_bits, margin = _decisions(numpy_reference_spectra(x, TAPS, dec, n_fft), "qpsk")
    if history:
        got, want = [], []
        for blk, hist in _halves(x, k):
            got.append(unpack(rf.rx_frame(blk, TAPS, dec, n_fft, hist, "qpsk")).numpy())
            b = blk.numpy()
            h = None if hist is None else (hist.numpy().real.copy(), hist.numpy().imag.copy())
            want.append(np.asarray(pallas_bits(b.real.copy(), b.imag.copy(), TAPS, dec,
                                               n_fft, history=h, interpret=True)))
        got, want = np.concatenate(got), np.concatenate(want)
    else:
        got = unpack(rf.rx_frame(torch.from_numpy(x), TAPS, dec, n_fft)).numpy()
        want = np.asarray(pallas_bits(x.real.copy(), x.imag.copy(), TAPS, dec, n_fft,
                                      interpret=True))
    _check_bits(got, want, margin)
    _check_bits(got, ref_bits, margin)
    _check_bits(want, ref_bits, margin)


def test_plain_identity_taps_matches_pallas_interpret(pallas_bits):
    # K = 1: no wrap correction and no history
    ident = np.ones(1, np.complex64)
    x = _signal(256 * 4, 101)
    got = unpack(rf.rx_frame(torch.from_numpy(x), ident, 1, 256)).numpy()
    want = np.asarray(pallas_bits(x.real.copy(), x.imag.copy(), ident, 1, 256,
                                  interpret=True))
    ref_bits, margin = _decisions(numpy_reference_spectra(x, ident, 1, 256), "qpsk")
    _check_bits(got, want, margin)
    _check_bits(got, ref_bits, margin)


@pytest.mark.parametrize("history", [False, True], ids=["one-block", "two-blocks"])
def test_plain_bpsk_and_spectrum_match_float64(history):
    dec, n_fft = 4, 256
    x = _signal(dec * n_fft * 8, 102)
    k = TAPS.shape[-1]
    ref = numpy_reference_spectra(x, TAPS, dec, n_fft)
    blocks = _halves(x, k) if history else [(torch.from_numpy(x), None)]
    bits = np.concatenate([unpack(rf.rx_frame(b, TAPS, dec, n_fft, h, "bpsk")).numpy()
                           for b, h in blocks])
    _check_bits(bits, *_decisions(ref, "bpsk"))
    spec = np.concatenate([rf.rx_frame(b, TAPS, dec, n_fft, h, "spectrum").numpy()
                           for b, h in blocks])
    assert spec.shape == ref.shape and spec.dtype == np.complex64
    assert evm_rms_db(spec, ref) <= EVM_DB


def test_plain_batched_rows_equal_row_calls():
    dec, n_fft, k = 4, 256, TAPS.shape[-1]
    x = torch.from_numpy(np.stack([_signal(dec * n_fft * 4, s) for s in (5, 6)]))
    hist = torch.from_numpy(np.stack([_signal(k - 1, s) for s in (7, 8)]))
    for epi in ("qpsk", "bpsk", "spectrum"):
        both = rf.rx_frame(x, TAPS, dec, n_fft, hist, epi)
        for row in range(2):
            one = rf.rx_frame(x[row], TAPS, dec, n_fft, hist[row], epi)
            assert torch.equal(both[row], one)


def test_kernel_supports():
    assert rf.kernel_supports(4, 2048)  # n1 128, n2 64: the main path
    assert rf.kernel_supports(4, 256)
    assert rf.kernel_supports(1, 2048)
    assert not rf.kernel_supports(1, 256)  # n2 = 2
    assert not rf.kernel_supports(4, 4096)  # a frame over 64 KB
    assert not rf.kernel_supports(4, 8192)  # no two-stage split


def test_wrapper_rejects_what_it_does_not_take():
    x = torch.zeros(4 * 256, dtype=torch.complex64)
    with pytest.raises(ValueError):
        rf.rx_frame(x, TAPS, 4, 256, epilogue="qam16")
    with pytest.raises(TypeError):
        rf.rx_frame(x.real.contiguous(), TAPS, 4, 256)
    with pytest.raises(TypeError):
        rf.rx_frame(x.numpy(), TAPS, 4, 256)
    with pytest.raises(ValueError):
        rf.rx_frame(torch.zeros(4 * 256, dtype=torch.complex64, device="meta"),
                    TAPS, 4, 256)
    with pytest.raises(ValueError):
        rf.rx_frame(x[:-1], TAPS, 4, 256)
    with pytest.raises(ValueError, match="whole bytes"):
        rf.rx_frame(torch.zeros(12, dtype=torch.complex64), np.ones(1), 1, 12,
                    epilogue="bpsk")


def test_plain_packs_natural_order_for_any_n1():
    # n1 = 12 is no multiple of 4: bytes still hold natural-order bits
    taps, dec, n_fft = _default_lowpass(9, 0.25), 2, 12
    x = _signal(dec * n_fft * 6, 104)
    got = rf.rx_frame(torch.from_numpy(x), taps, dec, n_fft, epilogue="qpsk")
    assert got.shape == (6 * 3,)  # 24 bits per frame
    ref = numpy_reference_spectra(x, taps, dec, n_fft)
    _check_bits(unpack(got).numpy(), *_decisions(ref, "qpsk"))


# ------------------------------------------------------------ on the card


@pytest.mark.cuda
@pytest.mark.parametrize("epilogue", ["qpsk", "bpsk", "spectrum"])
@pytest.mark.parametrize("n_fft", [256, 2048])
@pytest.mark.parametrize("history", [False, True], ids=["one-block", "two-blocks"])
def test_kernel_matches_plain(cuda, epilogue, n_fft, history):
    dec, k = 4, TAPS.shape[-1]
    x = _signal(dec * n_fft * 16, 103)
    ref = numpy_reference_spectra(x, TAPS, dec, n_fft)
    blocks = _halves(x, k, cuda) if history else [(torch.from_numpy(x).to(cuda), None)]
    before = rf.launches
    got = [rf.rx_frame(b, TAPS, dec, n_fft, h, epilogue) for b, h in blocks]
    torch.cuda.synchronize()
    assert rf.launches == before + len(blocks)
    plain = [rf.rx_frame_reference(b, TAPS, dec, n_fft, h, epilogue) for b, h in blocks]
    if epilogue == "spectrum":
        got = np.concatenate([g.cpu().numpy() for g in got])
        plain = np.concatenate([p.cpu().numpy() for p in plain])
        assert np.isfinite(got).all()
        assert evm_rms_db(got, plain) <= EVM_DB
        assert evm_rms_db(got, ref) <= EVM_DB
    else:
        got = np.concatenate([unpack(g).cpu().numpy() for g in got])
        plain = np.concatenate([unpack(p).cpu().numpy() for p in plain])
        want, margin = _decisions(ref, epilogue)
        _check_bits(got, plain, margin)
        _check_bits(got, want, margin)


@pytest.mark.cuda
def test_kernel_batched_rows_and_identity_taps(cuda):
    dec, n_fft, k = 4, 2048, TAPS.shape[-1]
    x = torch.from_numpy(np.stack([_signal(dec * n_fft * 3, s) for s in (9, 10)])).to(cuda)
    hist = torch.from_numpy(np.stack([_signal(k - 1, s) for s in (11, 12)])).to(cuda)
    both = rf.rx_frame(x, TAPS, dec, n_fft, hist, "spectrum")
    for row in range(2):
        one = rf.rx_frame(x[row], TAPS, dec, n_fft, hist[row], "spectrum")
        assert torch.equal(both[row], one)
    ident = np.ones(1, np.complex64)
    y = _signal(2048 * 4, 13)
    spec = rf.rx_frame(torch.from_numpy(y).to(cuda), ident, 1, 2048, None, "spectrum")
    ref = numpy_reference_spectra(y, ident, 1, 2048)
    assert evm_rms_db(spec.cpu().numpy(), ref) <= EVM_DB


@pytest.mark.cuda
def test_kernel_raises_instead_of_falling_back(cuda):
    before = rf.launches
    with pytest.raises(ValueError):
        rf.rx_frame(torch.zeros(4 * 4096, dtype=torch.complex64, device=cuda),
                    TAPS, 4, 4096)
    strided = torch.zeros(2 * 4 * 256 * 2, dtype=torch.complex64, device=cuda)[::2]
    with pytest.raises(ValueError):
        rf.rx_frame(strided, TAPS, 4, 256)
    assert rf.launches == before
