"""The rest of the port's ``ops/fec.py`` against the JAX package's: CRC,
the convolutional interleavers, ``hard_to_llr`` and ``conv_decode_soft``,
on the same seeded numpy inputs.

Tolerances (the reference's own bars):
- integers (CRC bits, ``crc32``, interleaved streams and states, hard
  decisions): exact;
- windowed ``conv_decode_soft``: ``array_equal`` to JAX ``backend="xla"``
  and to its Pallas kernel in interpret mode (the port's plain version has
  the scan's expression tree);
- full-block ``conv_decode_soft``: signs equal and RMS EVM <= FULL_DB
  (-120 dB; the branch metrics of rate 1/3 sum three terms in another
  order).
The ``cuda`` cases hold the windowed form on the card (the BCJR kernel's
``lanes`` instance) ``torch.equal`` to its plain version; they skip
without a card.
"""

import zlib

import numpy as np
import pytest
import torch

from aether_primitives_tpu_torch.evm import evm_rms_db
from aether_primitives_tpu_torch.ops import fec
from aether_primitives_tpu_torch.ops.cuda import bcjr as bk

torch.set_num_threads(1)

FULL_DB = -120.0


@pytest.fixture(scope="module")
def jfec():
    pytest.importorskip("jax")
    from aether_primitives_tpu.ops import fec as jfec

    return jfec


def _jit(fn, **fixed):
    """``fn`` traced once by ``jax.jit`` with the keyword arguments
    ``fixed``: one XLA program compiles several times faster than the JAX
    package's op-by-op calls."""
    import functools

    import jax

    return jax.jit(functools.partial(fn, **fixed))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _coded_llrs(rng, polys, k, shape, snr=2.0, sigma=1.0):
    bits = rng.integers(0, 2, shape).astype(np.uint8)
    enc = fec.conv_encode(torch.from_numpy(bits), polys, k).numpy()
    llr = (1 - 2.0 * enc) * snr + sigma * rng.normal(size=enc.shape)
    return bits, llr.astype(np.float32)


# ------------------------------------------------------------------ CRC


@pytest.mark.parametrize("kind", sorted(fec.CRC_PARAMS))
@pytest.mark.parametrize("n", [3, 8, 611])
def test_crc_compute_matches_jax(jfec, kind, n):
    # n < width takes the JAX package's affine branch, the rest its block scan
    poly, width, init, _refin, refout, xorout = fec.CRC_PARAMS[kind]
    bits = np.random.default_rng(n).integers(0, 2, n).astype(np.uint8)
    got = fec.crc_compute(torch.from_numpy(bits), poly, width, init, xorout, refout)
    want = np.asarray(jfec.crc_compute(bits, poly, width, init, xorout, refout))
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), want)
    # the named form agrees with the affine matrix the packet path uses
    assert np.array_equal(got.numpy(), fec.crc_bits(torch.from_numpy(bits), kind).numpy())


def test_crc_compute_odd_registers_match_jax(jfec):
    rng = np.random.default_rng(11)
    for poly, width, init, xorout, refl in ((0x5, 3, 0x7, 0x2, False), (0x1D, 5, 0, 0x1F, True),
                                            (0x3D65, 16, 0x1234, 0xFFFF, True)):
        for n in (2, 5, 64, 203):
            bits = rng.integers(0, 2, n).astype(np.uint8)
            got = fec.crc_compute(torch.from_numpy(bits), poly, width, init, xorout, refl)
            want = jfec.crc_compute(bits, poly, width, init, xorout, refl)
            assert np.array_equal(got.numpy(), np.asarray(want)), (poly, width, n)
    with pytest.raises(ValueError, match="flat"):
        fec.crc_compute(torch.zeros(2, 8, dtype=torch.uint8), 0x07, 8)


def test_crc32_equals_zlib_and_jax(jfec):
    rng = np.random.default_rng(12)
    for data in (b"123456789", bytes(rng.integers(0, 256, 777, dtype=np.uint8))):
        assert fec.crc32(data) == zlib.crc32(data) == jfec.crc32(data)
    assert fec.crc32(b"") == zlib.crc32(b"")  # the JAX package's raises on no bytes


# CRC registers of widths 8-32 with a nonzero init, reflected and inverted
# outputs (poly, width, init, xorout, reflect_out)
_CRC_WIDTHS = {8: (0x07, 8, 0xA5, 0x00, True), 16: (0x8005, 16, 0xFFFF, 0xFFFF, True),
               24: (0x864CFB, 24, 0xB704CE, 0x0, False),
               32: (0x04C11DB7, 32, 0xFFFFFFFF, 0xFFFFFFFF, True)}


@pytest.mark.parametrize("n", [0, 1, 5, 511, 512, 1537, 4099])
@pytest.mark.parametrize("width", sorted(_CRC_WIDTHS))
def test_crc_compute_block_fold_matches_jax(jfec, width, n):
    # n < width takes the one affine step; n % 512 != 0 the leading zero pad;
    # 4,099 bits fold 9 blocks in four pairwise levels (an odd count twice)
    poly, width, init, xorout, refl = _CRC_WIDTHS[width]
    bits = np.random.default_rng(width * 10_000 + n).integers(0, 2, n).astype(np.uint8)
    got = fec.crc_compute(torch.from_numpy(bits), poly, width, init, xorout, refl)
    assert got.dtype == torch.uint8 and got.shape == (width,)
    if n == 0:  # the JAX package's block matrices take no empty stream
        want = fec._msb_bits(init, width)[::-1] if refl else fec._msb_bits(init, width)
        assert np.array_equal(got.numpy(), want ^ fec._msb_bits(xorout, width))
        return
    want = np.asarray(jfec.crc_compute(bits, poly, width, init, xorout, refl))
    assert np.array_equal(got.numpy(), want)
    # other block sizes give the same bits
    for block in (64, 3):
        again = fec.crc_compute(torch.from_numpy(bits), poly, width, init, xorout, refl, block)
        assert torch.equal(again, got)


@pytest.mark.parametrize("size", [0, 1, 9, 64, 1000, 4101])
def test_crc32_equals_zlib_at_lengths(size):
    data = bytes(np.random.default_rng(size).integers(0, 256, size, dtype=np.uint8))
    assert fec.crc32(data) == zlib.crc32(data)


def _no_host_copies(monkeypatch):
    """Every way a tensor's data reaches the host raises from here on."""
    def refuse(self, *args, **kwargs):
        raise AssertionError("a tensor was copied to the host")

    for name in ("cpu", "numpy", "tolist", "item"):
        monkeypatch.setattr(torch.Tensor, name, refuse)


@pytest.mark.parametrize("n", [20, 3000])
def test_crc_compute_copies_nothing_to_the_host(monkeypatch, n):
    bits = torch.from_numpy(np.random.default_rng(n).integers(0, 2, n).astype(np.uint8))
    want = fec.crc_compute(bits, 0x04C11DB7, 32, 0xFFFFFFFF, 0xFFFFFFFF, True)
    _no_host_copies(monkeypatch)
    got = fec.crc_compute(bits, 0x04C11DB7, 32, 0xFFFFFFFF, 0xFFFFFFFF, True)
    monkeypatch.undo()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_crc_compute_matches_zlib(cuda):
    data = bytes(np.random.default_rng(14).integers(0, 256, 1 << 17, dtype=np.uint8))
    bits = torch.from_numpy(np.unpackbits(np.frombuffer(data, np.uint8), bitorder="little"))
    poly, width, init, _refin, refout, xorout = fec.CRC_PARAMS["crc32"]
    out = fec.crc_compute(bits.to(cuda), poly, width, init, xorout, refout)
    assert out.device.type == "cuda"
    got = int(np.packbits(out.cpu().numpy()[::-1], bitorder="little").view(np.uint32)[0])
    assert got == zlib.crc32(data)


# -------------------------------------------------------- interleavers


def test_hard_to_llr_matches_jax(jfec):
    bits = np.random.default_rng(13).integers(0, 2, (3, 50)).astype(np.uint8)
    got = fec.hard_to_llr(torch.from_numpy(bits))
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), np.asarray(jfec.hard_to_llr(bits)))


@pytest.mark.parametrize("branches,cell", [(12, 17), (4, 3), (1, 5)])
def test_conv_interleave_streaming_matches_jax(jfec, branches, cell):
    rng = np.random.default_rng(branches * 100 + cell)
    x = rng.normal(size=branches * 40).astype(np.float32)
    y, st = fec.conv_interleave(torch.from_numpy(x), branches, cell)
    jy, jst = jfec.conv_interleave(x, branches, cell)
    assert np.array_equal(y.numpy(), np.asarray(jy)) and np.array_equal(st.numpy(), np.asarray(jst))
    # a second chunk carries the state, as in the JAX package
    x2 = rng.integers(0, 2, branches * 9).astype(np.uint8)
    jst2 = np.asarray(jst).astype(np.uint8)
    y2, st2 = fec.conv_interleave(torch.from_numpy(x2), branches, cell, torch.from_numpy(jst2))
    jy2, jst3 = jfec.conv_interleave(x2, branches, cell, jst2)
    assert np.array_equal(y2.numpy(), np.asarray(jy2)) and np.array_equal(st2.numpy(), np.asarray(jst3))
    d, dst = fec.conv_deinterleave(y, branches, cell)
    jd, jdst = jfec.conv_deinterleave(np.asarray(jy), branches, cell)
    assert np.array_equal(d.numpy(), np.asarray(jd)) and np.array_equal(dst.numpy(), np.asarray(jdst))
    # the cascade is a pure delay of (I-1) cell I samples
    delay = (branches - 1) * cell * branches
    if delay < x.size:
        assert np.array_equal(d.numpy()[delay:], x[: x.size - delay])


def test_conv_interleave_block_matches_jax(jfec):
    rng = np.random.default_rng(14)
    x = rng.integers(0, 256, (2, 3, 8 * 24)).astype(np.uint8)
    for branches, cell in ((8, 17), (12, 5), (3, 1)):
        got = fec.conv_interleave_block(torch.from_numpy(x), branches, cell)
        assert np.array_equal(got.numpy(), np.asarray(jfec.conv_interleave_block(x, branches, cell)))
        back = fec.conv_deinterleave_block(got, branches, cell)
        want = jfec.conv_deinterleave_block(np.asarray(got), branches, cell)
        assert np.array_equal(back.numpy(), np.asarray(want)) and np.array_equal(back.numpy(), x)
    with pytest.raises(ValueError, match="divisible"):
        fec.conv_interleave_block(torch.zeros(10), 3)
    with pytest.raises(ValueError, match="flat"):
        fec.conv_interleave(torch.zeros(2, 12), 12)


# ------------------------------------------------------- soft decoding


@pytest.fixture(scope="module")
def windowed_case(jfec):
    """B = 3 streams of 500 bits, K=7 rate 1/2, and the JAX package's
    windowed decode of each (XLA scan and Pallas interpret)."""
    rng = np.random.default_rng(21)
    bits, llr = _coded_llrs(rng, (0o171, 0o133), 7, (3, 500))
    out = {"bits": bits, "llr": llr}
    for terminated in (True, False):
        x = llr if terminated else llr[:, : llr.shape[1] - 12]
        out[terminated] = {
            "x": x,
            "xla": np.asarray(_jit(jfec.conv_decode_soft, terminated=terminated, window=96,
                                   guard=64, backend="xla")(x)),
        }
    return out


@pytest.mark.parametrize("terminated", [True, False])
def test_windowed_soft_decode_matches_jax_scan(windowed_case, terminated):
    case = windowed_case[terminated]
    got = fec.conv_decode_soft(torch.from_numpy(case["x"]), terminated=terminated,
                               window=96, guard=64)
    assert got.dtype == torch.float32 and got.shape == case["xla"].shape
    assert np.array_equal(got.numpy(), case["xla"])
    ref = fec.conv_decode_soft(torch.from_numpy(case["x"]), terminated=terminated,
                               window=96, guard=64, backend="reference")
    assert torch.equal(got, ref)
    if terminated:
        assert np.array_equal((got.numpy() < 0).astype(np.uint8), windowed_case["bits"])


def test_windowed_soft_decode_matches_jax_kernel_in_interpret_mode(jfec, windowed_case):
    x = windowed_case[True]["x"][0]
    got = fec.conv_decode_soft(torch.from_numpy(x), window=96, guard=64)
    want = np.asarray(jfec.conv_decode_soft(x, window=96, guard=64,
                                            backend="pallas_interpret"))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("window,guard,steps", [(16, 8, 45), (32, 24, 64), (7, 3, 30)])
def test_windowed_soft_decode_small_windows_match_jax(jfec, window, guard, steps):
    # ragged last windows, guards longer than the stream's tail, a window of 7
    rng = np.random.default_rng(window)
    _, llr = _coded_llrs(rng, (0o7, 0o5), 3, (2, steps - 2), sigma=1.5)
    got = fec.conv_decode_soft(torch.from_numpy(llr), (0o7, 0o5), 3, window=window, guard=guard)
    want = np.asarray(_jit(jfec.conv_decode_soft, polys=(0o7, 0o5), constraint=3,
                           window=window, guard=guard, backend="xla")(llr))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("code", [((0o171, 0o133), 7), ((0o7, 0o5), 3), ((0o25, 0o33, 0o37), 5)])
@pytest.mark.parametrize("terminated", [True, False])
def test_full_block_soft_decode_matches_jax(jfec, code, terminated):
    polys, k = code
    rng = np.random.default_rng(k * 10 + terminated)
    _, llr = _coded_llrs(rng, polys, k, (2, 3, 60), sigma=1.2)
    if not terminated:
        llr = llr[..., : llr.shape[-1] - len(polys) * (k - 1)]
    got = fec.conv_decode_soft(torch.from_numpy(llr), polys, k, terminated=terminated)
    want = np.asarray(_jit(jfec.conv_decode_soft, polys=polys, constraint=k,
                           terminated=terminated)(llr))
    assert got.shape == want.shape == (2, 3, 60)
    assert np.array_equal(got.numpy() < 0, want < 0)
    assert evm_rms_db(got.numpy(), want) <= FULL_DB


def test_soft_decode_rejects_what_the_reference_rejects():
    with pytest.raises(ValueError, match="rate-1/2"):
        fec.conv_decode_soft(torch.zeros(300), (0o7, 0o5, 0o7), 3, window=32)
    with pytest.raises(ValueError, match="backend"):
        fec.conv_decode_soft(torch.zeros(64), window=16, guard=8, backend="xla")
    with pytest.raises(ValueError, match="backend"):
        fec.conv_decode_soft(torch.zeros(64), backend="palas")
    with pytest.raises(ValueError, match="multiple"):
        fec.conv_decode_soft(torch.zeros(63))


def test_windowed_soft_decode_takes_the_generic_instance():
    # the generic table set takes the lanes instance, in its shuffle form
    tables = fec._conv_soft_coeffs((0o171, 0o133), 7)
    assert bk.kernel_plan(tables, 224) == ("lanes", 1) and bk.shift_register(tables)


# ------------------------------------------------------------ on the card


@pytest.mark.cuda
@pytest.mark.parametrize("terminated", [True, False])
def test_cuda_windowed_soft_decode_equals_its_twin(cuda, terminated):
    rng = np.random.default_rng(31)
    _, llr = _coded_llrs(rng, (0o171, 0o133), 7, (8, 632 * 3))
    x = torch.from_numpy(llr).to(cuda)
    b0 = bk.launches
    got = fec.conv_decode_soft(x, terminated=terminated, window=96, guard=64)
    torch.cuda.synchronize()
    assert bk.launches - b0 == 1
    want = fec.conv_decode_soft(x.cpu(), terminated=terminated, window=96, guard=64)
    assert torch.equal(got.cpu(), want)
    plain = fec.conv_decode_soft(x, terminated=terminated, window=96, guard=64,
                                 backend="reference")
    assert torch.equal(got, plain)
