"""The fused complex multiply (``cmul``, ``cmul_c64``) and the streamed
chunk-broadcast multiply (``streamed_cmul``) of the port against the JAX
package's Pallas kernels in interpret mode and their jnp references, on the
shapes of ``tests/test_pallas.py``.

Tolerances: atol 1e-6 (cmul) and 1e-5 (streamed_cmul) against JAX, as
``tests/test_pallas.py`` holds the Pallas kernels to their references. The
plain twins are bit-identical to a float32 numpy evaluation of the same
expression (each op rounded on its own), and on a card the kernels are
``torch.equal`` to the twins; those cases carry the ``cuda`` marker and
skip without a card.
"""

import numpy as np
import pytest
import torch

from aether_primitives_tpu_torch.ops.cuda import cmul as tc
from aether_primitives_tpu_torch.ops.cuda import stream as ts

torch.set_num_threads(1)

SHAPES = [(128,), (8, 256), (3, 5, 128)]
MODES = [(False, 1.0), (True, 0.5)]


@pytest.fixture(scope="module")
def pallas():
    pytest.importorskip("jax")
    from aether_primitives_tpu.ops.pallas import cmul as pk
    from aether_primitives_tpu.ops.pallas import stream as st

    return pk, st


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _planes(shape, seed, n=4):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(n)]


def _numpy_cmul(ar, ai, br, bi, conj_b, scale):
    """float32 numpy, each op rounded on its own, in the kernel's order."""
    s = np.float32(scale)
    if conj_b:
        bi = -bi
    return (ar * br - ai * bi) * s, (ar * bi + ai * br) * s


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("conj_b,scale", MODES)
def test_cmul_matches_pallas(pallas, shape, conj_b, scale):
    pk, _ = pallas
    args = _planes(shape, 11)
    got = tc.cmul(*(torch.from_numpy(a) for a in args), conj_b=conj_b, scale=scale)
    want = pk.cmul(*args, conj_b=conj_b, scale=scale, interpret=True)
    ref = pk.cmul_reference(*args, conj_b=conj_b, scale=scale)
    for g, w, r in zip(got, want, ref):
        assert g.shape == shape and g.dtype == torch.float32
        assert np.allclose(g.numpy(), np.asarray(w), atol=1e-6)
        assert np.allclose(g.numpy(), np.asarray(r), atol=1e-6)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("conj_b,scale", MODES)
def test_cmul_c64_matches_pallas(pallas, shape, conj_b, scale):
    pk, _ = pallas
    ar, ai, br, bi = _planes(shape, 12)
    a = (ar + 1j * ai).astype(np.complex64)
    b = (br + 1j * bi).astype(np.complex64)
    got = tc.cmul_c64(torch.from_numpy(a), torch.from_numpy(b), conj_b=conj_b, scale=scale)
    want = np.asarray(pk.cmul_c64(a, b, conj_b=conj_b, scale=scale, interpret=True))
    assert got.dtype == torch.complex64 and got.shape == shape
    assert np.allclose(got.numpy(), want, atol=1e-6)


@pytest.mark.parametrize("shape", SHAPES + [(7,), (2, 1001)])
@pytest.mark.parametrize("conj_b,scale", MODES + [(True, 3.0e-3)])
def test_cmul_twin_rounds_every_op(shape, conj_b, scale):
    # the twin is the kernel's contract: each product and sum rounded to
    # float32 on its own, no contraction
    args = _planes(shape, 13)
    got = tc.cmul_reference(*(torch.from_numpy(a) for a in args), conj_b=conj_b, scale=scale)
    want = _numpy_cmul(*args, conj_b, scale)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), w)
    a = torch.complex(torch.from_numpy(args[0]), torch.from_numpy(args[1]))
    b = torch.complex(torch.from_numpy(args[2]), torch.from_numpy(args[3]))
    c = tc.cmul_c64(a, b, conj_b=conj_b, scale=scale)
    assert np.array_equal(c.real.numpy(), want[0]) and np.array_equal(c.imag.numpy(), want[1])


def test_cmul_rejects_mismatched_shapes():
    a = torch.zeros(8)
    with pytest.raises(ValueError, match="one shape"):
        tc.cmul(a, a, a, torch.zeros(9))
    with pytest.raises(ValueError, match="one shape"):
        tc.cmul_c64(torch.zeros(4, dtype=torch.complex64), torch.zeros(5, dtype=torch.complex64))


def test_streamed_cmul_matches_pallas(pallas):
    _, st = pallas
    rows, lanes, chunk = 1024, 256, 256
    xr, xi = _planes((rows, lanes), 14, 2)
    rr, ri = _planes((chunk, lanes), 15, 2)
    got = ts.streamed_cmul(*(torch.from_numpy(a) for a in (xr, xi, rr, ri)), chunk_rows=chunk)
    want = st.streamed_cmul(xr, xi, rr, ri, chunk_rows=chunk, interpret=True)
    ref = st.streamed_cmul_reference(xr, xi, rr, ri)
    for g, w, r in zip(got, want, ref):
        assert g.shape == (rows, lanes)
        assert np.allclose(g.numpy(), np.asarray(w), atol=1e-5)
        assert np.allclose(g.numpy(), np.asarray(r), atol=1e-5)
    # the twin rounds every op as the kernel does
    tile_r, tile_i = np.tile(rr, (rows // chunk, 1)), np.tile(ri, (rows // chunk, 1))
    assert np.array_equal(got[0].numpy(), xr * tile_r - xi * tile_i)
    assert np.array_equal(got[1].numpy(), xr * tile_i + xi * tile_r)


def test_streamed_cmul_rejects_indivisible(pallas):
    _, st = pallas
    rng = np.random.default_rng(16)
    x = rng.normal(size=(100, 128)).astype(np.float32)
    r = rng.normal(size=(64, 128)).astype(np.float32)
    with pytest.raises(ValueError, match="divisible"):
        st.streamed_cmul(x, x, r, r, chunk_rows=64, interpret=True)
    xt, rt = torch.from_numpy(x), torch.from_numpy(r)
    with pytest.raises(ValueError, match="divisible"):
        ts.streamed_cmul(xt, xt, rt, rt, chunk_rows=64)


def test_streamed_cmul_rejects_bad_r():
    x = torch.zeros(64, 32)
    with pytest.raises(ValueError, match="chunk_rows, lanes"):
        ts.streamed_cmul(x, x, torch.zeros(16, 16), torch.zeros(16, 16), chunk_rows=16)
    with pytest.raises(TypeError, match="float32"):
        ts.streamed_cmul(x.double(), x.double(), x[:16], x[:16], chunk_rows=16)


def test_cpu_wrappers_count_no_launch():
    before = (tc.launches, ts.launches)
    a = torch.ones(16)
    tc.cmul(a, a, a, a)
    tc.cmul_c64(torch.ones(4, dtype=torch.complex64), torch.ones(4, dtype=torch.complex64))
    ts.streamed_cmul(torch.ones(8, 4), torch.ones(8, 4), torch.ones(4, 4), torch.ones(4, 4), 4)
    assert (tc.launches, ts.launches) == before


# -- on the card: kernels bit-identical to their twins ------------------------


def _dev(arrays, device, offset=0):
    """numpy arrays on ``device``; with ``offset``, as views that start
    ``offset`` elements into a larger buffer (not 16-byte aligned)."""
    out = []
    for a in arrays:
        flat = torch.zeros(a.size + offset, dtype=torch.from_numpy(a).dtype, device=device)
        flat[offset:] = torch.from_numpy(a.reshape(-1)).to(device)
        out.append(flat[offset:].view(a.shape))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("shape,offset", [((2048, 2048), 0), ((1001,), 0), ((3, 5, 127), 1),
                                          ((4099,), 3), ((2,), 0)])
@pytest.mark.parametrize("conj_b,scale", MODES)
def test_cmul_kernel_equals_twin(cuda, shape, offset, conj_b, scale):
    args = _dev(_planes(shape, 17), cuda, offset)
    before = tc.launches
    got = tc.cmul(*args, conj_b=conj_b, scale=scale)
    want = tc.cmul_reference(*args, conj_b=conj_b, scale=scale)
    torch.cuda.synchronize()
    assert tc.launches == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("shape,offset", [((2048, 2048), 0), ((1001,), 0), ((3, 5, 127), 1),
                                          ((4099,), 1), ((1,), 0)])
@pytest.mark.parametrize("conj_b,scale", MODES)
def test_cmul_c64_kernel_equals_twin(cuda, shape, offset, conj_b, scale):
    ar, ai, br, bi = _planes(shape, 18)
    a, b = _dev([(ar + 1j * ai).astype(np.complex64), (br + 1j * bi).astype(np.complex64)],
                cuda, offset)
    before = tc.launches
    got = tc.cmul_c64(a, b, conj_b=conj_b, scale=scale)
    want = tc.cmul_c64_reference(a, b, conj_b=conj_b, scale=scale)
    torch.cuda.synchronize()
    assert tc.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,lanes,chunk,offset", [(2048, 2048, 128, 0), (1024, 256, 256, 0),
                                                     (96, 130, 32, 0), (64, 33, 16, 0),
                                                     (256, 512, 64, 1)])
def test_streamed_cmul_kernel_equals_twin(cuda, rows, lanes, chunk, offset):
    xr, xi = _dev(_planes((rows, lanes), 19, 2), cuda, offset)
    rr, ri = _dev(_planes((chunk, lanes), 20, 2), cuda, offset)
    before = ts.launches
    got = ts.streamed_cmul(xr, xi, rr, ri, chunk_rows=chunk)
    want = ts.streamed_cmul_reference(xr, xi, rr, ri)
    torch.cuda.synchronize()
    assert ts.launches == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_streamed_cmul_rejects_indivisible_on_card(cuda):
    x = torch.zeros(100, 128, device=cuda)
    r = torch.zeros(64, 128, device=cuda)
    with pytest.raises(ValueError, match="divisible"):
        ts.streamed_cmul(x, x, r, r, chunk_rows=64)
