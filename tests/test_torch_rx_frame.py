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

import types

import numpy as np
import pytest
import torch

from aether_primitives_tpu_torch.cli import numpy_reference_spectra
from aether_primitives_tpu_torch.evm import evm_rms_db
from aether_primitives_tpu_torch.models import RxChainConfig
from aether_primitives_tpu_torch.models.modem import _chain_taps, _default_lowpass
from aether_primitives_tpu_torch.ops.fft import Scale
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
    assert rf.kernel_supports(4, 2048) == "direct"  # the main path
    assert rf.kernel_supports(4, 256) == "direct"
    assert rf.kernel_supports(1, 2048) == "direct"
    assert rf.kernel_supports(1, 256) == "direct"
    assert rf.kernel_supports(4, 4096) == "direct"  # a frame over 64 KB
    assert rf.kernel_supports(4, 192) == "direct"  # not a power of two: radix 8, 8, 3
    assert rf.kernel_supports(4, 3072) == "direct"
    assert rf.kernel_supports(5, 30) == "direct"  # radix 2, 3, 5
    assert rf.kernel_supports(16, 2048) == "chunked"  # 257 taps
    assert rf.kernel_supports(4, 8192) == "cluster"  # 256 KB a frame over 2 CTAs
    assert rf.kernel_supports(1, 65536) == "cluster"  # 8 CTAs of 8,192 points


@pytest.mark.parametrize("dec,fft_len,stage_n1,want", [
    (4, 2048, None, ("direct", 128)),  # the main path; n1 is the twin's split
    (4, 4096, None, ("direct", 128)),
    (4, 64, None, ("direct", 64)),  # the heuristic's n1 64 (n2 = 4) serves the twin
    (1, 128, None, ("direct", 128)),
    (2, 8192, None, ("cluster", None)),  # no split (G' over 4 MB): the twin's FFT route
    (5, 30, None, ("direct", 30)),  # outputs padded to whole groups of 8
    (1, 32, None, ("chunked", 32)),  # fft_len under 64
    (4, 64, 64, ("direct", 64)),  # the route does not depend on stage_n1
    (4, 2048, 64, ("direct", 64)),
    (4, 192, None, ("direct", 96)),  # not a power of two: the mixed-radix FFT
    (8, 32, None, ("chunked", 32)),
    (4, 3072, None, ("direct", 128)),
    (16, 3000, None, ("chunked", None)),  # 257 taps, past 2,048 points: 512 threads
    (1, 16384, None, ("cluster", None)),  # two CTAs of 8,192 points
    (16, 2048, None, ("chunked", 128)),  # 257 taps: past the direct instance's 256
    (4, 131, None, ("direct", 1)),  # a prime fft_len
    (64, 1024, None, ("cluster", 128)),  # a 65,536-sample span over 2 CTAs
    (4, 8192, 64, ("cluster", 64)),  # a caller's split for the twin
    (4, 4099, None, ("global", None)),  # a prime past 4,096 points: Bluestein
    (2, 8198, None, ("global", None)),  # 2 x 4,099: no cluster split
    (4, 16411, None, ("global", None)),
    (1, 131072, None, ("global", None)),  # past a cluster of 8 CTAs
    (4, 262144, None, ("global", None)),
    (1, 4194304, None, ("global", None)),  # one 4M block as one frame
])
def test_kernel_plan_picks_instance_and_split(dec, fft_len, stage_n1, want):
    assert rf.kernel_plan(dec, fft_len, stage_n1, 16 * dec + 1) == want


GRID_DECS = (1, 2, 3, 4, 5, 8, 16, 32, 64)
GRID_FFT_LENS = (16, 30, 32, 48, 64, 128, 131, 192, 256, 512, 1024, 1536, 2048, 3072, 4096,
                 8192, 16384, 32768, 65536)


@pytest.mark.parametrize("fft_len", GRID_FFT_LENS)
@pytest.mark.parametrize("dec", GRID_DECS)
def test_kernel_takes_every_geometry_of_the_grid(dec, fft_len):
    # every geometry of the chain at its default 16 dec + 1 taps has an
    # instance, and its launch geometry fits the card
    k = 16 * dec + 1
    plan = rf.kernel_plan(dec, fft_len, None, k)
    assert plan is not None
    if plan[0] == "direct":
        fpc, wp, nb = rf.direct_layout(dec, fft_len, k)
        assert fpc * max(wp, nb) * 8 <= rf.SMEM_LIMIT
        return
    lay = rf.general_layout(dec, fft_len, k)
    assert lay["instance"] == plan[0]
    assert 8 * (lay["fbuf"] + 2 * lay["win"]) <= rf.SMEM_LIMIT
    assert lay["a"] * lay["b"] == fft_len and lay["lp"] % 8 == 0
    assert int(np.prod(lay["rad1"] + lay["rad2"])) == fft_len
    if lay["q"] == 1:
        cap = rf._capacity(lay["threads"], lay["rad1"], rf.GEN_POINTS)
        assert lay["fpc"] * fft_len <= cap <= lay["threads"] * rf.GEN_POINTS
    else:
        q, per = lay["q"], rf.CLUSTER_POINTS_A_THREAD
        assert lay["a"] % (8 * q) == 0 and lay["b"] % q == 0 and lay["lp"] == fft_len // q
        assert lay["threads"] == rf.CLUSTER_THREADS
        assert fft_len // q <= min(rf._capacity(lay["threads"], r, per) for r in
                                   (lay["rad1"], lay["rad2"])) <= lay["threads"] * per
    assert lay["chunk"] * lay["split"] == 8 * lay["threads"] and 32 % lay["split"] == 0
    assert lay["kt"] == k  # the default taps fit one staged range


def test_direct_layout():
    assert rf.direct_layout(4, 2048, 65) == (1, 8513, 2304)  # 68,104 B: three CTAs an SM
    assert rf.direct_layout(4, 64, 65) == (32, 329, 72)  # 2,048 outputs a CTA
    assert rf.direct_layout(4, 4096, 65) == (1, 16961, 4608)  # one CTA an SM
    assert rf.direct_layout(1, 64, 1) == (32, 65, 72)  # the FFT buffer is the larger
    assert rf.direct_layout(4, 2048, rf.DIRECT_MAX_TAPS + 1) is None
    assert rf.direct_layout(4, 2048 + 8, 65) == (1, 8546, 2313)  # the mixed-radix FFT
    assert rf.direct_layout(4, 2048 + 4, 65) == (1, 8546, 2308)  # 2,056 outputs a frame
    assert rf.direct_layout(4, 8, 9) is None  # under 12 points
    assert rf.direct_layout(4, 32, 65) is None  # under 64 points
    assert rf.direct_layout(8, 4096, 65) is None  # 270 KB a frame
    assert rf.kernel_plan(4, 2048, None, 300) == ("chunked", 128)  # too many taps
    for dec in (1, 2, 4, 8):  # frames a CTA: a power of two that divides 256 threads
        for n in [1 << log2n for log2n in range(6, 13)] + [30, 96, 120, 131, 192, 1536, 3072]:
            layout = rf.direct_layout(dec, n, 65)
            if layout is not None:  # outputs rounded up to whole groups of 8
                assert 256 % layout[0] == 0 and layout[0] * -(-n // 8) * 8 <= 4096


def test_kernel_plan_refuses_frames_beyond_shared_memory():
    assert rf.kernel_plan(8, 4096) == ("chunked", None)  # span 32,768: one CTA
    assert rf.kernel_plan(4, 3750) == ("direct", 125)  # radix 2, 3, 5, 5, 5, 5, 60 KB
    assert rf.kernel_plan(8, 3750) == ("chunked", None)  # 235 KB a frame: in chunks
    assert rf.kernel_plan(4, 1 << 16) == ("cluster", None)  # 8 CTAs of 8,192 points
    # past shared memory the global instance: 16,384 points a CTA of a
    # cluster of 8 (a power of two: its own FFT, two levels of 64 x 2,048), a
    # prime past 4,096 points (no split: Bluestein over a power of two >= 2 n
    # - 1, one scratch buffer of m points a frame past a tile)
    assert rf.kernel_plan(1, 1 << 17) == ("global", None)
    lay = rf.global_layout(1, 1 << 17)
    assert {key: lay[key] for key in ("n", "m", "bluestein", "dec", "k", "lp", "lt")} == dict(
        n=1 << 17, m=1 << 17, bluestein=False, dec=1, k=1, lp=[6, 11], lt=[8, 3])
    assert rf.kernel_plan(1, 16411) == ("global", None)
    lay = rf.global_layout(1, 16411)
    assert lay["bluestein"] and lay["m"] == 65536 and lay["lp"] == [5, 11]
    assert rf.global_bytes(lay, 3) == 8 * (3 * 65536 + 64 + 32 + 256 + 256 + 16411 + 65536)
    lay = rf.global_layout(1, 4099)  # m 16,384: whole frames a tile, no scratch
    assert lay["lp"] == [14] and rf.global_bytes(lay, 3) == 8 * (128 + 128 + 4099 + 16384)
    # the limit is the card's memory: 3^20 points take m = 2^33 a frame, 69 GB
    # of scratch beside a filter spectrum as large
    assert rf.kernel_plan(1, 3 ** 20) is None
    assert rf.kernel_plan(4, 3500, n_taps=1500) == ("chunked", 125)  # any tap count
    lay = rf.general_layout(64, 512, 32769)  # K - 1 = span: taps in staged ranges
    assert lay["kt"] < 32769 and 8 * (lay["fbuf"] + 2 * lay["win"]) <= rf.SMEM_LIMIT


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
def test_kernel_raises_instead_of_falling_back(cuda, monkeypatch):
    before = rf.launches
    # the global instance's scratch past the card's memory (a card of 1 MB
    # here: two buffers of 2^18 points are 4 MB) raises; no twin runs
    x = torch.zeros(1 << 18, dtype=torch.complex64, device=cuda)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: types.SimpleNamespace(total_memory=1 << 20))
    with pytest.raises(ValueError, match="card's memory"):
        rf.rx_frame(x, TAPS, 1, 1 << 18)
    monkeypatch.undo()
    strided = torch.zeros(2 * 4 * 256 * 2, dtype=torch.complex64, device=cuda)[::2]
    with pytest.raises(ValueError):
        rf.rx_frame(strided, TAPS, 4, 256)
    assert rf.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dec,n_fft,instance", [
    (4, 4096, "direct"), (4, 64, "direct"), (1, 128, "direct"), (5, 30, "direct"),
    (2, 12, "direct"), (4, 192, "direct"), (4, 3072, "direct"), (1, 16384, "cluster"),
    (16, 2048, "chunked"), (4, 8192, "cluster"), (8, 4096, "chunked"), (64, 512, "chunked"),
    (4, 131, "direct"), (3, 1536, "direct"), (1, 65536, "cluster"), (64, 1024, "cluster"),
    (8, 32, "chunked"), (64, 16, "chunked"), (16, 3000, "chunked"),
    (5, 8192, "cluster"),
])
@pytest.mark.parametrize("epilogue", ["qpsk", "bpsk", "spectrum"])
def test_kernel_instances_match_the_twin_at_the_same_split(cuda, dec, n_fft, instance, epilogue):
    # every instance against the plain twin at the twin's split
    # the chain's default taps, cut to fit the 24-sample frame of dec 2, fft_len 12
    ntaps = 16 * dec + 1 if dec * n_fft > 16 * dec else 9
    taps = _default_lowpass(ntaps, 1.0 / (2 * dec)) if dec > 1 else TAPS[:1]
    k = taps.shape[-1]
    plan = rf.kernel_plan(dec, n_fft, None, k)
    assert plan[0] == instance
    bits = {"qpsk": 2, "bpsk": 1}.get(epilogue)
    if bits and n_fft * bits % 8:
        pytest.skip("the bit epilogues write whole bytes per frame")
    x = _signal(dec * n_fft * 12, 105)
    ref = numpy_reference_spectra(x, taps, dec, n_fft)
    blocks = _halves(x, k, cuda)
    before = rf.launches
    got = [rf.rx_frame(b, taps, dec, n_fft, h, epilogue) for b, h in blocks]
    torch.cuda.synchronize()
    assert rf.launches == before + len(blocks)
    plain = [rf.rx_frame_reference(b, taps, dec, n_fft, h, epilogue, plan[1]) for b, h in blocks]
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


# ------------------------------------------- the direct instance's schedule
#
# A float32 numpy model of ``csrc/rx_frame.cu``'s direct instance: each
# frame's staged window (the previous frame's tail, the carried history or
# zeros, then the frame), the decimating FIR at the kept outputs phase by
# phase and tap by tap as a thread accumulates it, and the Stockham
# radix-8/4/2 FFT in the kernel's pass order with the kernel's float32
# twiddle table (``rf.twiddles``). Held against the JAX package on the CPU
# and against the plain twin at the chain's bars.

_S8 = np.float32(np.sqrt(0.5))
_I = np.complex64(1j)


def _negi(a):
    return np.complex64(-1j) * a


def _dft(v):
    """The kernel's in-register DFT_R (R = 2, 4, 8), natural order."""
    if len(v) == 2:
        return [v[0] + v[1], v[0] - v[1]]
    if len(v) == 4:
        a0, a2, a1, a3 = v[0] + v[2], v[0] - v[2], v[1] + v[3], _negi(v[1] - v[3])
        return [a0 + a1, a2 + a3, a0 - a1, a2 - a3]
    d5, d7 = v[1] - v[5], v[3] - v[7]
    a = [v[i] + v[i + 4] for i in range(4)] + [
        v[0] - v[4],
        (d5.real + d5.imag) * _S8 + _I * ((d5.imag - d5.real) * _S8),
        _negi(v[2] - v[6]),
        (d7.imag - d7.real) * _S8 + _I * (-(d7.real + d7.imag) * _S8),
    ]
    b0, b1, b2, b3 = a[0] + a[2], a[1] + a[3], a[0] - a[2], _negi(a[1] - a[3])
    b4, b5, b6, b7 = a[4] + a[6], a[5] + a[7], a[4] - a[6], _negi(a[5] - a[7])
    return [b0 + b1, b4 + b5, b2 + b3, b6 + b7, b0 - b1, b4 - b5, b2 - b3, b6 - b7]


def _stockham(buf, tw):
    """The kernel's FFT passes over ``[frames, n]`` complex64 buffers."""
    n = buf.shape[-1]
    log2n = n.bit_length() - 1
    radices = [8] * (log2n // 3) + ([1 << log2n % 3] if log2n % 3 else [])
    ns = 1
    for rdx in radices:
        nbf = n // rdx
        j = np.arange(nbf)
        v = [buf[:, j + r * nbf] for r in range(rdx)]
        if ns > 1:
            e = (j % ns) * (n // (ns * rdx))
            v = [v[0]] + [v[r] * tw[e * r] for r in range(1, rdx)]
        v = _dft(v)
        d = (j // ns) * ns * rdx + j % ns
        out = np.empty_like(buf)
        for r in range(rdx):
            out[:, d + r * ns] = v[r]
        buf, ns = out, ns * rdx
    return buf


def direct_model(x, taps, dec, n, history=None, epilogue="spectrum"):
    """One block row through the direct instance's schedule: SN-scaled
    spectra ``[nsym, n]`` or packed bytes, as ``rx_frame``."""
    x = np.asarray(x, np.complex64)
    taps = np.asarray(taps, np.complex64)
    k, span = taps.size, dec * n
    ku, nsym = k - 1, x.size // span
    frames = x.reshape(nsym, span)
    win = np.zeros((nsym, ku + span), np.complex64)
    win[:, ku:] = frames
    if ku:
        win[1:, :ku] = frames[:-1, span - ku:]
        if history is not None:
            win[0, :ku] = np.asarray(history, np.complex64)
    m = np.arange(n)
    real = not taps.imag.any()
    ar = np.zeros((nsym, n), np.float32)
    ai = np.zeros((nsym, n), np.float32)
    for p in range(min(dec, k)):
        for q in range((k - p + dec - 1) // dec):
            h = taps[dec * q + p]
            v = win[:, dec * (m - q) - p + ku]
            if real:
                ar = ar + h.real * v.real
                ai = ai + h.real * v.imag
            else:
                ar = (ar + -h.imag * v.imag) + h.real * v.real
                ai = (ai + h.imag * v.real) + h.real * v.imag
    z = ar + _I * ai
    if n & (n - 1):  # the mixed-radix variant: the chunked instance's passes
        nb = n + n // 8
        buf = np.zeros(nsym * nb, np.complex64)
        idx = np.arange(nsym)[:, None] * nb + (m + (m >> 3))[None, :]
        buf[idx] = z
        z = _gen_fft(buf, n, nb, nsym, rf.radices(n), rf.twiddles(n, "cpu").numpy(), 1)[idx]
    else:
        z = _stockham(z, rf.twiddles(n, "cpu").numpy())
    if epilogue == "spectrum":
        return z * np.float32(Scale.SN.factor_for(n))
    return rf.pack_bits(rf.sign_bits(torch.from_numpy(z), epilogue)).numpy()


@pytest.fixture(scope="module")
def jax_front():
    pytest.importorskip("jax")
    from aether_primitives_tpu.models import modem as jax_modem
    from aether_primitives_tpu.ops import fir as jax_fir
    from aether_primitives_tpu.ops.fft import Scale as JaxScale

    return jax_fir, jax_modem, JaxScale


@pytest.mark.parametrize("n_fft", [2048, 64])
def test_direct_model_fft_is_the_dft(n_fft):
    rng = np.random.default_rng(n_fft)
    x = (rng.normal(size=(3, n_fft)) + 1j * rng.normal(size=(3, n_fft))).astype(np.complex64)
    got = _stockham(x, rf.twiddles(n_fft, "cpu").numpy())
    assert got.dtype == np.complex64
    assert evm_rms_db(got, np.fft.fft(x.astype(np.complex128), axis=-1)) <= -120.0


@pytest.mark.parametrize("n_fft", [2048, 64])
def test_direct_model_matches_jax(jax_front, n_fft):
    # 8 frames a block: block 1 from a zero history, block 2 with block 1's tail
    jax_fir, jax_modem, jax_scale = jax_front
    dec, k = 4, TAPS.shape[-1]
    x = _signal(2 * 8 * dec * n_fft, 106)
    ref = numpy_reference_spectra(x, TAPS, dec, n_fft)
    jchain = jax_modem.RxChain(jax_modem.RxChainConfig(
        fft_len=n_fft, decimation=dec, fir_mode="fused", modulation="qpsk"))
    assert jchain.taps.tobytes() == TAPS.tobytes()
    state = jchain.init_state()
    half = ref.shape[0] // 2
    for i, (blk, hist) in enumerate(_halves(x, k)):
        b, h = blk.numpy(), None if hist is None else hist.numpy()
        spec = direct_model(b, TAPS, dec, n_fft, h)
        want = np.asarray(jax_fir.fir_decimate_fft(b, TAPS, dec, n_fft, jax_scale.SN,
                                                   history=h))
        rs = ref[i * half:(i + 1) * half]
        assert evm_rms_db(spec, want) <= EVM_DB
        assert evm_rms_db(spec, rs) <= EVM_DB
        jbits, state = jchain.streaming_step(b, state)
        bits = unpack(torch.from_numpy(direct_model(b, TAPS, dec, n_fft, h, "qpsk"))).numpy()
        _check_bits(bits, np.asarray(jbits), _decisions(rs, "qpsk")[1])
        _check_bits(bits, *_decisions(rs, "qpsk"))


@pytest.mark.parametrize("taps", ["real", "complex"])
@pytest.mark.parametrize("n_fft", [2048, 64, 192, 3072])
def test_direct_model_bytes_match_the_twin(n_fft, taps):
    dec = 4
    h = TAPS if taps == "real" else (TAPS * np.exp(0.3j)).astype(np.complex64)
    x = _signal(2 * 8 * dec * n_fft, 107)
    ref = numpy_reference_spectra(x, h, dec, n_fft)
    half = ref.shape[0] // 2
    for i, (blk, hist) in enumerate(_halves(x, h.shape[-1])):
        rs = ref[i * half:(i + 1) * half]
        hn = None if hist is None else hist.numpy()
        for epi in ("qpsk", "bpsk"):
            got = unpack(torch.from_numpy(direct_model(blk.numpy(), h, dec, n_fft, hn, epi)))
            twin = unpack(rf.rx_frame_reference(blk, h, dec, n_fft, hist, epi))
            margin = _decisions(rs, epi)[1]
            _check_bits(got.numpy(), twin.numpy(), margin)
            _check_bits(got.numpy(), *_decisions(rs, epi))
        spec = direct_model(blk.numpy(), h, dec, n_fft, hn)
        twin = rf.rx_frame_reference(blk, h, dec, n_fft, hist, "spectrum").numpy()
        assert evm_rms_db(spec, twin) <= EVM_DB


# ------------------------------- the chunked and cluster instances' schedule
#
# A numpy model of ``csrc/rx_frame.cu``'s rx_frame_general_kernel at the
# launch geometry of ``rf.general_layout``: each CTA's chunks and tap ranges
# staged as the kernel stages them (one window per frame a chunk touches, at
# the kernel's slot of each sample, zeros past the frame and before a row's
# first frame without history), the FIR read back at the kernel's slots, the
# outputs stored where the kernel stores them (a frame's FFT buffer, or the
# cluster CTA that owns the column), the mixed-radix Stockham passes and the
# prime pass by their index formulas on padded buffers, the cluster's
# twiddled gather of rows, and the epilogue's bin order. Held against the
# float64 chain, the JAX package and the plain twin.


def _gen_fft(buf, n, nb, nf, rads, tw, tstride):
    """The kernel's gen_fft over ``nf`` frames of ``n`` points (stride ``nb``,
    fslot padding) in a flat complex64 buffer, in place."""
    fs = lambda i: i + (i >> 3)  # noqa: E731
    ns = 1
    f = np.arange(nf)[:, None] * nb
    for r in rads:
        new = buf.copy()
        if r in rf.SMALL_RADICES:
            nbf = n // r
            j = np.arange(nbf)[None, :]
            v = [buf[f + fs(j + q * nbf)] for q in range(r)]
            jd, jm = j // ns, j % ns
            if ns > 1:
                e = jm * (n // (ns * r) * tstride)
                v = [v[0]] + [v[q] * tw[e * q] for q in range(1, r)]
            v = np.fft.fft(np.stack(v, -1).astype(np.complex128), axis=-1).astype(np.complex64)
            d = jd * ns * r + jm
            for q in range(r):
                new[f + fs(d + q * ns)] = v[..., q]
        else:
            np_ = n // r
            w = np.arange(n)[None, :]
            j, kk = w // r, w % r
            jd, jm = j // ns, j % ns
            step = np_ // ns * (jm + kk * ns)
            acc = np.zeros((nf, n), np.complex64)
            for q in range(r):
                acc = acc + buf[f + fs(j + q * np_)] * tw[(q * step % n) * tstride]
            new[f + fs(jd * ns * r + jm + kk * ns)] = acc
        buf[:] = new
        ns *= r
    return buf


def general_model(x, taps, dec, n, history=None, epilogue="spectrum"):
    """One block row through the chunked or cluster instance's schedule:
    SN-scaled spectra ``[nsym, n]`` or packed bytes, as ``rx_frame``."""
    x = np.asarray(x, np.complex64)
    taps = np.asarray(taps, np.complex64)
    k, span = taps.size, dec * n
    ku, nsym = k - 1, x.size // span
    lay = rf.general_layout(dec, n, k)
    tw = rf.twiddles(n, "cpu").numpy()
    ws = lambda e: e + (e >> 5)  # noqa: E731
    fs = lambda i: i + (i >> 3)  # noqa: E731
    q, lp, chunk, kt = lay["q"], lay["lp"], lay["chunk"], lay["kt"]
    nkr = -(-k // kt)

    def sample(fi, i):
        # sample i of frame fi, as the kernel stages it
        out = np.zeros(i.shape, np.complex64)
        ok = i < span
        inside = ok & ((i >= 0) | (fi % nsym != 0))
        out[inside] = x[fi * span + i[inside]]
        if history is not None:
            hs = ok & ~inside
            out[hs] = np.asarray(history, np.complex64)[ku + i[hs]]
        return out

    ctas = nsym * q if q > 1 else -(-nsym // lay["fpc"])
    bufs = np.zeros((ctas, lay["fbuf"]), np.complex64)
    for cta in range(ctas):
        f0, nf, rank = (cta // q, 1, cta % q) if q > 1 else (
            cta * lay["fpc"], min(lay["fpc"], nsym - cta * lay["fpc"]), 0)
        total = nf * lp
        for o0 in range(0, total, chunk):
            o1 = min(o0 + chunk, total)
            o = np.arange(o0, o1)
            acc = np.zeros(o.shape, np.complex64)
            for kr in range(nkr):
                k0, k1 = kr * kt, min(k, kr * kt + kt)
                win = np.zeros(lay["win"], np.complex64)
                jf, t = o0 // lp, 0
                while jf * lp < o1:
                    ps, pe = max(o0, jf * lp), min(o1, (jf + 1) * lp)
                    base = dec * (ps - o0) + t * (k1 - k0 - dec)
                    wl = dec * (pe - ps - 1) + (k1 - k0)
                    e = np.arange(wl)
                    i0 = dec * (rank * lp + ps - jf * lp) - (k1 - 1)
                    win[ws(base + e)] = sample(f0 + jf, i0 + e)
                    jf, t = jf + 1, t + 1
                t = o // lp - o0 // lp
                ob = dec * (o - o0) + t * (k1 - k0 - dec) + (k1 - 1)
                kk = np.arange(k0, k1)
                acc = acc + (win[ws(ob[:, None] - kk[None, :])] * taps[kk]).sum(-1)
            jf = o // lp
            m = o - jf * lp + rank * lp
            if q > 1:
                m1, m2 = m // lay["b"], m % lay["b"]
                bq = lay["b"] // q
                dst = cta - rank + m2 // bq
                bufs[dst, (m2 % bq) * lay["nb1"] + fs(m1)] = acc
            else:
                keep = m < n
                bufs[cta, jf[keep] * lay["nb1"] + fs(m[keep])] = acc[keep]
    spec = np.zeros((nsym, n), np.complex64)
    if q == 1:
        for cta in range(ctas):
            f0 = cta * lay["fpc"]
            nf = min(lay["fpc"], nsym - f0)
            _gen_fft(bufs[cta], n, lay["nb1"], nf, lay["rad1"], tw, 1)
            for j in range(nf):
                spec[f0 + j] = bufs[cta, j * lay["nb1"] + fs(np.arange(n))]
    else:
        a, b = lay["a"], lay["b"]
        aq, bq = a // q, b // q
        for cta in range(ctas):
            _gen_fft(bufs[cta], a, lay["nb1"], bq, lay["rad1"], tw, b)
        gathered = np.zeros_like(bufs)
        pt = np.arange(aq * b)
        k1l, m2 = pt // b, pt % b
        for cta in range(ctas):
            rank = cta % q
            k1 = rank * aq + k1l
            src = cta - rank + m2 // bq
            v = bufs[src, (m2 % bq) * lay["nb1"] + fs(k1)] * tw[k1 * m2]
            gathered[cta, k1l * lay["nb2"] + fs(m2)] = v
        bufs = gathered
        for cta in range(ctas):
            rank = cta % q
            _gen_fft(bufs[cta], b, lay["nb2"], aq, lay["rad2"], tw, a)
            i = np.arange(aq * b)
            k2, k1l = i // aq, i % aq
            spec[cta // q, rank * aq + k1l + a * k2] = bufs[cta, k1l * lay["nb2"] + fs(k2)]
    if epilogue == "spectrum":
        return spec * np.float32(Scale.SN.factor_for(n))
    return rf.pack_bits(rf.sign_bits(torch.from_numpy(spec), epilogue)).numpy()


@pytest.mark.parametrize("n_fft", [192, 30, 131, 3072, 48, 1536, 1 << 12, 8 * 9 * 5 * 7])
def test_general_model_fft_is_the_dft(n_fft):
    rng = np.random.default_rng(n_fft)
    nf, nb = 3, n_fft + (n_fft - 1) // 8 + 1
    x = (rng.normal(size=(nf, n_fft)) + 1j * rng.normal(size=(nf, n_fft))).astype(np.complex64)
    buf = np.zeros(nf * nb, np.complex64)
    idx = np.arange(nf)[:, None] * nb + (lambda i: i + (i >> 3))(np.arange(n_fft))[None, :]
    buf[idx] = x
    _gen_fft(buf, n_fft, nb, nf, rf.radices(n_fft), rf.twiddles(n_fft, "cpu").numpy(), 1)
    assert evm_rms_db(buf[idx], np.fft.fft(x.astype(np.complex128), axis=-1)) <= -110.0


@pytest.mark.parametrize("dec,n_fft,ntaps", [
    (4, 192, 65), (5, 30, 81), (4, 131, 65), (16, 128, 257), (64, 16, 1025),
    (3, 48, 49), (2, 12, 9), (4, 128, 300), (1, 8192, 17),
    (8, 4096, 129), (1, 32768, 17), (64, 1024, 1025), (3, 16384, 49),
    (64, 64, 4097),  # taps staged in two ranges
])
def test_general_model_matches_float64_and_the_twin(dec, n_fft, ntaps):
    # two blocks, the second with the first's tail as history; every
    # instance the plan picks: one CTA, several frames a CTA, clusters
    taps = _default_lowpass(ntaps, 1.0 / (2 * dec)) if dec > 1 else _default_lowpass(ntaps, 0.4)
    k = taps.shape[-1]
    span = dec * n_fft
    x = _signal(2 * span * max(2, 4096 // span), 108 + n_fft)
    ref = numpy_reference_spectra(x, taps, dec, n_fft)
    half = ref.shape[0] // 2
    for i, (blk, hist) in enumerate(_halves(x, k)):
        hn = None if hist is None else hist.numpy()
        spec = general_model(blk.numpy(), taps, dec, n_fft, hn)
        rs = ref[i * half:(i + 1) * half] * np.sqrt(n_fft) * Scale.SN.factor_for(n_fft)
        assert evm_rms_db(spec, rs) <= EVM_DB
        twin = rf.rx_frame_reference(blk, taps, dec, n_fft, hist, "spectrum").numpy()
        assert evm_rms_db(spec, twin) <= EVM_DB
        for epi, bits in (("qpsk", 2), ("bpsk", 1)):
            if n_fft * bits % 8 == 0:
                got = unpack(torch.from_numpy(general_model(blk.numpy(), taps, dec, n_fft, hn,
                                                            epi))).numpy()
                _check_bits(got, *_decisions(rs, epi))



# --------------------------------------------- the global instance on the CPU
#
# A numpy model of ``csrc/rx_frame.cu rx_frame_global_kernel``'s schedule:
# the FIR at the frame's outputs, times Bluestein's chirp
# (``rf.bluestein_chirp``, its square reduced mod 2 n in integers) where
# fft_len is no power of two; tiles of T sequences of P points (point r of
# sequence c at r T + c), each sequence's in-place radix-8/4/2 DIF (natural
# in, digit-reversed out, ``_difpos``) or DIT with the float32 table W_Q.
# One level (m <= a tile): whole frames a tile, the FFT, the filter's
# spectrum, conjugated, the DIT, conjugated, times the chirp. More levels:
# the four-step split of ``rf.global_levels`` through a scratch of m points
# a frame, each level's tiles addressed as ``_tile_at`` (the kernel's
# ``tile_at``), the twiddle W_m^{k c L} from ``rf.split_twiddles``, the last
# level's bins k_0 + P_0 k_1 + ..., Bluestein's levels run back by DIT. Held
# against the DFT, the float64 chain and the plain twin at the chain's bars,
# also at small tiles that give small m two and three levels.


def _difpos(k, lp):
    """The slot of bin ``k`` after the DIF of a ``2^lp``-point sequence."""
    k = np.asarray(k, np.int64)
    pos, b = np.zeros_like(k), lp
    while b > 0:
        lr = min(3, b)
        pos, k, b = pos + ((k & ((1 << lr) - 1)) << (b - lr)), k >> lr, b - 3
    return pos


def _twq(log2q):
    """W_Q^e for every e < Q as the kernel forms it: the product of the two
    float32 tables of :func:`rf.split_twiddles`."""
    hq = (log2q + 1) // 2
    lo, hi = rf.split_twiddles(1 << log2q, hq)
    e = np.arange(1 << log2q)
    return lo[e & ((1 << hq) - 1)] * hi[e >> hq]


def _tile_fft(t, lp, lt, tws, log2q, dit):
    """The kernel's DIF (or DIT) of every tile ``t[tiles, P T]`` in place
    (``tws``: :func:`_twq`)."""
    stages = (lp + 2) // 3
    for i in range(stages):
        b = lp - 3 * (stages - 1 - i if dit else i)
        lr = min(3, b)
        rdx, lq = 1 << lr, b - lr
        bi = np.arange(1 << (lp + lt - lr))
        c, rest = bi & ((1 << lt) - 1), bi >> lt
        j = rest & ((1 << lq) - 1)
        r0 = ((rest >> lq) << b) + j
        idx = [((r0 + (q << lq)) << lt) + c for q in range(rdx)]
        w = [tws[(j << (log2q - b)) * q] for q in range(rdx)]
        v = [t[:, ix] for ix in idx]
        if dit:
            v = _dft([v[0]] + [v[q] * w[q] for q in range(1, rdx)])
        else:
            v = _dft(v)
            v = [v[0]] + [v[q] * w[q] for q in range(1, rdx)]
        for q in range(rdx):
            t[:, idx[q]] = v[q]
    return t


def _tile_at(lps, lts, i, tl, m):
    """Level ``i``'s tiles ``tl``: frame, base, row and column strides, the
    first column, the last level's first bin, log2 s and log2 L."""
    last, lp, lt = len(lps) - 1, lps[i], lts[i]
    ls, ll = sum(lps[i + 1:]), sum(lps[:i])
    tpf = m >> (lp + lt)
    f, rem = tl // tpf, tl % tpf
    if i < last:
        c0 = (rem & ((1 << (ls - lt)) - 1)) << lt
        return f, f * m + ((rem >> (ls - lt)) << (lp + ls)) + c0, 1 << ls, 1, c0, 0, ls, ll
    lbs = ll - lps[0]
    g, rest = rem >> lbs, rem & ((1 << lbs) - 1)
    dr, tmp, sh = np.zeros_like(rest), rest, lbs
    for lev in range(last - 1, 0, -1):
        sh -= lps[lev]
        dr, tmp = dr | ((tmp & ((1 << lps[lev]) - 1)) << sh), tmp >> lps[lev]
    return (f, f * m + ((((g << lt) << lbs) + rest) << lp), 1, 1 << (lbs + lp), 0,
            (g << lt) + (dr << lps[0]), ls, ll)


def _global_levels(buf, lay, n, frames, chirp=None, filt=None):
    """The levels of the global instance over the scratch ``buf[frames m]``
    (the FIR's outputs, times the chirp, at t < n): the spectra ``[frames,
    n]`` (Bluestein: conj(z_t) w[t])."""
    lps, lts, m = lay["lp"], lay["lt"], lay["m"]
    last = len(lps) - 1
    tws = _twq(lay["log2q"])
    lo, hi = rf.split_twiddles(m, lay["h"])
    tw_m = lambda e: lo[e & ((1 << lay["h"]) - 1)] * hi[e >> lay["h"]]  # noqa: E731
    spec = np.zeros(frames * n, np.complex64)
    for i in list(range(last + 1)) + (list(range(last - 1, -1, -1)) if filt is not None else []):
        inverse = filt is not None and i < last and lay.get("_fwd_done", False)
        lp, lt = lps[i], lts[i]
        e = np.arange(1 << (lp + lt))
        f, base, rs, cs, c0, binbase, ls, ll = _tile_at(
            lps, lts, i, np.arange((frames * m) >> (lp + lt))[:, None], m)
        kb, c = e >> lt, e & ((1 << lt) - 1)
        if inverse:  # the twiddle, then the DIT
            t = np.zeros((f.shape[0], e.size), np.complex64)
            t[:, (_difpos(kb, lp) << lt) + c] = buf[base + kb * rs + c] * tw_m(
                (kb * (c0 + c)) << ll)
            _tile_fft(t, lp, lt, tws, lay["log2q"], True)
            if i > 0:
                buf[base + kb * rs + c] = t[:, e]
            else:
                q = (kb << ls) + c0 + c
                keep = np.broadcast_to(q < n, t.shape)
                fq = np.broadcast_to(f * n + q, t.shape)
                z = np.conj(t[:, e])
                spec[fq[keep]] = (z * chirp[np.minimum(q, n - 1)])[keep]
            continue
        r = kb if i < last else e & ((1 << lp) - 1)
        cc = c if i < last else e >> lp
        pos = base + r * rs + cc * cs
        t = np.zeros((f.shape[0], e.size), np.complex64)
        t[:, (r << lt) + cc] = np.where((i == 0) & (pos - f * m >= n), 0, buf[pos % buf.size])
        _tile_fft(t, lp, lt, tws, lay["log2q"], False)
        slot = (_difpos(kb, lp) << lt) + c
        if i < last:
            buf[base + kb * rs + c] = t[:, slot] * tw_m((kb * (c0 + c)) << ll)
        elif filt is None:
            spec[f * n + binbase + c + (kb << ll)] = t[:, slot]
        else:
            t[:, slot] = np.conj(t[:, slot] * filt[binbase + c + (kb << ll)])
            _tile_fft(t, lp, lt, tws, lay["log2q"], True)
            rr, cc = e & ((1 << lp) - 1), e >> lp
            buf[base + rr + cc * cs] = t[:, (rr << lt) + cc]
            lay = dict(lay, _fwd_done=True)
    return spec.reshape(frames, n)


def global_model(x, taps, dec, n, history=None, epilogue="spectrum", lay=None):
    """One block row through the global instance's schedule (``lay``, the
    plan's by default): SN-scaled spectra ``[nsym, n]`` or packed bytes."""
    x = np.asarray(x, np.complex64)
    taps = np.asarray(taps, np.complex64)
    k, span = taps.size, dec * n
    lay = lay or rf.global_layout(dec, n, k)
    m = lay["m"]
    xe = np.concatenate([np.zeros(k - 1, np.complex64) if history is None
                         else np.asarray(history, np.complex64), x])
    nsym = x.size // span
    y = np.zeros((nsym, n), np.complex64)
    for f in range(nsym):
        pos = k - 1 + f * span + dec * np.arange(n)
        y[f] = sum(taps[t] * xe[pos - t] for t in range(k))
    chirp = filt = None
    if lay["bluestein"]:
        chirp = rf.bluestein_chirp(n).astype(np.complex64)
        filt = rf.bluestein_filter(n, m).astype(np.complex64)
        y = y * chirp
    if lay.get("sub", 1) > 1:  # a frame a CTA, its sub-transforms in turn
        spec = _global_sub(y, lay, n, chirp, filt)
    elif len(lay["lp"]) == 1:  # whole frames a tile
        lp, lt = lay["lp"][0], lay["lt"][0]
        tws = _twq(lay["log2q"])
        tiles = -(-nsym // (1 << lt))
        t = np.zeros((tiles, m << lt), np.complex64)
        fr = np.arange(tiles * (1 << lt))
        o = np.arange(n)
        tl, c = fr[:nsym, None] >> lt, fr[:nsym, None] & ((1 << lt) - 1)
        t[tl, (o << lt) + c] = y
        _tile_fft(t, lp, lt, tws, lay["log2q"], False)
        kb = np.arange(m)
        if lay["bluestein"]:
            slot = (_difpos(kb, lp) << lt) + c
            t[tl, slot] = np.conj(t[tl, slot] * filt)
            _tile_fft(t, lp, lt, tws, lay["log2q"], True)
            spec = np.conj(t[tl, (o << lt) + c]) * chirp
        else:
            spec = t[tl, (_difpos(kb, lp) << lt) + c]
    else:
        buf = np.zeros(nsym * m, np.complex64)
        buf.reshape(nsym, m)[:, :n] = y
        spec = _global_levels(buf, lay, n, nsym, chirp, filt)
    if epilogue == "spectrum":
        return spec * np.float32(Scale.SN.factor_for(n))
    return rf.pack_bits(rf.sign_bits(torch.from_numpy(spec), epilogue)).numpy()


def _global_sub(y, lay, n, chirp, filt):
    """The ``sub`` route over the frames' FIR outputs ``y[f, t]`` (times the
    chirp): sub-transform u of P points holds sum_j x[t + P j] W_m^{u (t + P
    j)}, its DIF is X[q k + u]; times the filter's spectrum, conjugated, the
    DIT gives z_u; the spectra are conj(sum_u W_m^{u t} z_u[t mod P]) w[t]."""
    lp, m = lay["lp"][0], lay["m"]
    p_, q = 1 << lp, m >> lp
    tws = _twq(lay["log2q"])
    lo, hi = rf.split_twiddles(m, lay["h"])
    tw_m = lambda e: lo[e & ((1 << lay["h"]) - 1)] * hi[e >> lay["h"]]  # noqa: E731
    t = np.arange(n)
    acc = np.zeros(y.shape, np.complex64)
    for u in range(q):
        tile = np.zeros((y.shape[0], p_), np.complex64)
        for j in range(0, n, p_):  # the blocks of x the tile folds
            tt = t[j:j + p_]
            tile[:, tt - j] += y[:, tt] if u == 0 else y[:, tt] * tw_m((u * tt) % m)
        _tile_fft(tile, lp, 0, tws, lay["log2q"], False)
        slot = _difpos(np.arange(p_), lp)
        tile[:, slot] = np.conj(tile[:, slot] * filt[q * np.arange(p_) + u])
        _tile_fft(tile, lp, 0, tws, lay["log2q"], True)
        z = tile[:, t & (p_ - 1)]
        acc = acc + (z if u == 0 else z * tw_m((u * t) % m))
    return np.conj(acc) * chirp


def _small_tiles(lay, tile=256, level=32):
    """``lay`` with the levels of a small tile: two or three levels at small m."""
    lps, lts = rf.global_levels(lay["m"], tile, level)
    return dict(lay, lp=lps, lt=lts, log2q=max(lps))


def test_bluestein_chirp_reduces_the_square_in_integers():
    n = 4_194_301  # a prime near a 4M-point frame
    j = np.array([0, 1, 4_000, 2_000_003, n - 1], np.int64)
    w = rf.bluestein_chirp(n)[j]
    exact = np.exp(-1j * np.pi * np.array([(int(v) ** 2) % (2 * n) for v in j]) / n)
    assert np.abs(w - exact).max() < 1e-12
    # the square in float32 loses the phase this far out
    naive = np.exp(-1j * np.pi * (j.astype(np.float32) ** 2).astype(np.float64) / n)
    assert np.abs(naive - exact).max() > 1e-2
    # Bluestein over m >= 2 n - 1 is the n-point DFT (float64, n = 4,099)
    n, m = 4099, 16384
    y = _signal(n, 91).astype(np.complex128)
    a = np.zeros(m, np.complex128)
    a[:n] = y * rf.bluestein_chirp(n)
    z = np.conj(np.fft.fft(np.conj(np.fft.fft(a) * rf.bluestein_filter(n, m))))
    assert np.abs(z[:n] * rf.bluestein_chirp(n) - np.fft.fft(y)).max() < 1e-9 * np.sqrt(n)


@pytest.mark.parametrize("m,tile,level", [
    (16, 16384, 2048), (2048, 16384, 2048), (16384, 16384, 2048), (1 << 17, 16384, 2048),
    (1 << 10, 256, 32), (1 << 12, 256, 32), (1 << 14, 256, 32), (1 << 14, 1024, 32),
])
def test_global_model_fft_is_the_dft(m, tile, level):
    # the levels of every split the planner makes: one tile of whole frames,
    # a = b = 32 with 8-row tiles as a 4M frame's 2,048 x 2,048, three levels
    lps, lts = rf.global_levels(m, tile, level)
    assert sum(lps) == m.bit_length() - 1 and all(p_ + t_ <= tile.bit_length() - 1
                                                   for p_, t_ in zip(lps, lts))
    # past a tile: whole bytes of bins in the last level's rows, k_0 over them
    assert len(lps) == 1 or (lps[-1] == level.bit_length() - 1 and lps[0] >= lts[-1] >= 3
                             and 1 << (lps[-1] + lts[-1]) == tile)
    lay = dict(m=m, lp=lps, lt=lts, log2q=max(lps), h=m.bit_length() // 2)
    x = _signal(2 * m, m).reshape(2, m)
    if len(lps) == 1:
        t = np.zeros((1, m << lts[0]), np.complex64)
        t[0, (np.arange(m) << lts[0])] = x[0]
        _tile_fft(t, lps[0], lts[0], _twq(lps[0]), lps[0], False)
        got = t[:, _difpos(np.arange(m), lps[0]) << lts[0]]
        x = x[:1]
    else:
        got = _global_levels(x.reshape(-1).copy(), lay, m, 2)
    assert evm_rms_db(got, np.fft.fft(x.astype(np.complex128), axis=-1)) <= -120


@pytest.mark.parametrize("dec,n_fft", [(4, 4099), (2, 8198), (4, 16411), (1, 131072),
                                       (4, 262144), (1, 4194304)])
def test_global_plan_of_each_phase3_geometry(dec, n_fft):
    # the planner's split: whole frames on the chip up to 16,384 points,
    # else 2,048-point rows of 8-row tiles under columns of up to 2,048
    taps = _chain_taps(RxChainConfig(fft_len=n_fft, decimation=dec))
    lay = rf.global_layout(dec, n_fft, taps.size)
    m = lay["m"]
    assert rf.kernel_plan(dec, n_fft, None, taps.size)[0] == "global"
    want = {4099: ([14], [0]), 8198: ([4, 11], [10, 3]), 16411: ([5, 11], [9, 3]),
            131072: ([6, 11], [8, 3]), 262144: ([7, 11], [7, 3]),
            4194304: ([11, 11], [3, 3])}[n_fft]
    assert (lay["lp"], lay["lt"]) == want
    assert lay["win"] > 0 and lay["kt"] == taps.size  # the FIR staged, taps in one range
    assert lay["twoff"] == (lay["tile"] + 2 * lay["win"] if len(want[0]) == 1 else
                            max(lay["tile"], 2 * lay["win"] + lay["chunk"]))
    tables = (1 << lay["hq"]) + ((1 << lay["log2q"]) >> lay["hq"])
    assert 8 * (lay["twoff"] + tables) <= rf.SMEM_LIMIT
    # scratch: none on the chip, one buffer of m points a frame past it
    frames = 4
    scratch = rf.global_bytes(lay, frames) - rf.global_bytes(lay, 0)
    assert scratch == (0 if len(want[0]) == 1 else 8 * frames * m)
    # the split's FFT against numpy on one frame (m up to 2^18; a 4M frame's
    # levels are those of the small-tile case above, 32 x 32)
    if len(want[0]) > 1 and m <= 1 << 18:
        x = _signal(m, n_fft).reshape(1, m)
        got = _global_levels(x.reshape(-1).copy(), lay, m, 1)
        assert evm_rms_db(got, np.fft.fft(x.astype(np.complex128), axis=-1)) <= -120
    # Bluestein over two tiles: one CTA a frame where a call has 100 frames or more
    alt = lay["alt"]
    assert (alt is not None) == (n_fft == 8198)
    if alt is not None:
        assert alt["sub"] == 2 and alt["lp"] == [14] and alt["win"] > 0
        assert rf.global_route(lay, 99) is lay and rf.global_route(lay, 100) is alt
        assert rf.global_bytes(alt, frames) - rf.global_bytes(alt, 0) == 8 * frames * 2 * n_fft
        assert 8 * (alt["twoff"] + (1 << alt["hq"]) + ((1 << alt["log2q"]) >> alt["hq"])) <= (
            rf.SMEM_LIMIT)


@pytest.mark.parametrize("dec,n_fft,ntaps,small", [
    (4, 4099, 65, False), (2, 8198, 33, False), (1, 131072, 17, False), (1, 3000, 17, False),
    (1, 3000, 17, True), (2, 4096, 33, True), (4, 1 << 13, 65, True), (2, 8198, 33, "alt"),
    (1, 200, 17, "alt"),
])
def test_global_model_matches_float64_and_the_twin(dec, n_fft, ntaps, small):
    # two blocks of two frames, the second with the first's tail as history;
    # small: the levels of a 256-point tile (three levels at m 4,096-8,192);
    # "alt": the sub route (two 16,384-point sub-transforms of m 32,768; of
    # 256 points at n 200)
    taps = _default_lowpass(ntaps, 1.0 / (2 * dec)) if dec > 1 else _default_lowpass(ntaps, 0.4)
    k = taps.shape[-1]
    span = dec * n_fft
    lay = rf.global_layout(dec, n_fft, k)
    if small == "alt":
        lay = lay["alt"] or dict(lay, lp=[8], lt=[0], sub=2, log2q=8)
        assert lay["sub"] == 2 and lay["m"] == 2 << lay["lp"][0]
    elif small:
        lay = _small_tiles(lay)
        assert len(lay["lp"]) == 3
    x = _signal(4 * span, 208 + n_fft)
    ref = numpy_reference_spectra(x, taps, dec, n_fft)
    for i, (blk, hist) in enumerate(_halves(x, k)):
        hn = None if hist is None else hist.numpy()
        spec = global_model(blk.numpy(), taps, dec, n_fft, hn, lay=lay)
        rs = ref[2 * i:2 * i + 2] * np.sqrt(n_fft) * Scale.SN.factor_for(n_fft)
        assert evm_rms_db(spec, rs) <= EVM_DB
        twin = rf.rx_frame_reference(blk, taps, dec, n_fft, hist, "spectrum").numpy()
        assert evm_rms_db(spec, twin) <= EVM_DB
        if n_fft * 2 % 8 == 0:
            got = unpack(torch.from_numpy(global_model(blk.numpy(), taps, dec, n_fft, hn,
                                                       "qpsk", lay=lay))).numpy()
            _check_bits(got, *_decisions(rs, "qpsk"))


@pytest.mark.cuda
@pytest.mark.parametrize("dec,n_fft", [(4, 4099), (2, 8198), (4, 16411), (1, 131072),
                                       (4, 262144), (1, 3000 * 49)])
@pytest.mark.parametrize("epilogue", ["qpsk", "bpsk", "spectrum"])
def test_global_instance_matches_the_twin(cuda, dec, n_fft, epilogue):
    # one cooperative launch a call, with and without history, a batch of rows
    if epilogue != "spectrum" and n_fft * (2 if epilogue == "qpsk" else 1) % 8:
        pytest.skip("frames of fft_len that are not whole bytes take the spectrum epilogue")
    taps = _default_lowpass(16 * dec + 1, 1.0 / (2 * dec)) if dec > 1 else TAPS[:1]
    k = taps.shape[-1]
    assert rf.kernel_plan(dec, n_fft, None, k)[0] == "global"
    span = dec * n_fft
    x = torch.from_numpy(_signal(2 * 2 * span, n_fft).reshape(2, 2 * span)).to(cuda)
    hist = x[:, :k - 1].contiguous() if k > 1 else None
    for h in (None, hist):
        before = rf.launches
        got = rf.rx_frame(x, taps, dec, n_fft, h, epilogue)
        want = rf.rx_frame_reference(x, taps, dec, n_fft, h, epilogue)
        torch.cuda.synchronize()
        assert rf.launches == before + 1
        if epilogue == "spectrum":
            assert evm_rms_db(got.cpu().numpy(), want.cpu().numpy()) <= EVM_DB
        else:
            assert (unpack(got) == unpack(want)).float().mean().item() >= AGREEMENT


@pytest.mark.cuda
def test_global_instance_sub_route_matches_the_twin(cuda):
    # Bluestein over two tiles (2 / 8,198, frames of no whole bytes: the
    # spectrum): a call of 100 frames or more takes the sub route, one CTA a
    # frame; fewer take the levels
    dec, n_fft = 2, 8198
    epilogue = "spectrum"
    taps = _default_lowpass(33, 0.25)
    lay = rf.global_layout(dec, n_fft, 33)
    span = dec * n_fft
    x = torch.from_numpy(_signal(2 * 60 * span, 8198).reshape(2, 60 * span)).to(cuda)
    assert rf.global_route(lay, 120) is lay["alt"]
    for h in (None, x[:, :32].contiguous()):
        got = rf.rx_frame(x, taps, dec, n_fft, h, epilogue)
        want = rf.rx_frame_reference(x, taps, dec, n_fft, h, epilogue)
        torch.cuda.synchronize()
        assert evm_rms_db(got.cpu().numpy(), want.cpu().numpy()) <= EVM_DB

