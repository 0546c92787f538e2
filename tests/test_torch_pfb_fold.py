"""The PFB fold's plain twin against the JAX package's folds, and the CUDA
kernel against the twin.

The twin ``pfb_fold_os_reference`` is held against the Pallas kernel
``pfb_fold_os`` (interpret mode, its input padded to whole 8-frame tiles as
the JAX callers pad it) and against the XLA fold of
``pfb_channelize_os(pallas=False)`` at relative RMS error <= 1e-6, the bar
of ``tests/test_pfb.py`` for the Pallas fold against XLA (both sides add the
same products in the same order; the JAX side may contract to FMAs). The
CUDA kernel is held bit for bit (``torch.equal``) against the twin on a card
(``cuda`` marker; skipped without one; run with ``python -m pytest
--noconftest -p no:cacheprovider -m cuda tests/test_torch_pfb_fold.py``):
both use correctly rounded multiplies and adds in ``p`` order.
"""

import numpy as np
import pytest
import torch

from aether_primitives_tpu_torch.models import channelizer as tch
from aether_primitives_tpu_torch.ops.cuda import pfb_fold as pf

torch.set_num_threads(1)

REL = 1e-6
# (M, os, P, t_cls): the test sizes of tests/test_pfb.py and smaller
SHAPES = [(256, 2, 8, 37), (128, 4, 4, 29), (64, 1, 3, 20), (16, 2, 5, 9), (32, 4, 8, 3)]
IDS = [f"m{m}-os{o}-p{p}-t{t}" for m, o, p, t in SHAPES]


@pytest.fixture(scope="module")
def jax_fold():
    pytest.importorskip("jax")
    from aether_primitives_tpu.ops.pallas.pfb_fold import pfb_fold_os

    return pfb_fold_os


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _need(m, os, p, t_cls):
    return (os - 1) * (m // os) + (t_cls - 1 + p) * m


def _case(m, os, p, t_cls, seed, batch=(), extra=0):
    rng = np.random.default_rng(seed)
    n = _need(m, os, p, t_cls) + extra
    xr = rng.normal(size=batch + (n,)).astype(np.float32)
    xi = rng.normal(size=batch + (n,)).astype(np.float32)
    hb = rng.normal(size=(p, m)).astype(np.float32)
    return xr, xi, hb


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.sqrt(np.mean((got - ref) ** 2) / np.mean(ref ** 2)))


def _twin(xr, xi, hb, os, t_cls):
    o_r, o_i = pf.pfb_fold_os_reference(torch.from_numpy(xr), torch.from_numpy(xi),
                                        torch.from_numpy(hb), os, t_cls)
    return o_r.numpy(), o_i.numpy()


@pytest.mark.parametrize("m,os,p,t_cls", SHAPES, ids=IDS)
def test_twin_matches_the_pallas_kernel_interpret(jax_fold, m, os, p, t_cls):
    xr, xi, hb = _case(m, os, p, t_cls, seed=m + p)
    got_r, got_i = _twin(xr, xi, hb, os, t_cls)
    tile = 8
    need_k = _need(m, os, p, -(-t_cls // tile) * tile)
    pad = (0, need_k - xr.shape[-1])
    want_r, want_i = jax_fold(np.pad(xr, pad), np.pad(xi, pad), hb, os, t_cls,
                              tile_t=tile, interpret=True)
    assert got_r.shape == np.asarray(want_r).shape == (os, t_cls, m)
    assert _rel(got_r, want_r) <= REL and _rel(got_i, want_i) <= REL


@pytest.mark.parametrize("m,os,p,t_cls", SHAPES, ids=IDS)
def test_twin_matches_the_xla_fold(m, os, p, t_cls):
    jnp = pytest.importorskip("jax.numpy")
    xr, xi, hb = _case(m, os, p, t_cls, seed=2 * m + p)
    got_r, got_i = _twin(xr, xi, hb, os, t_cls)
    # channelizer.py's XLA fold: per class, P slice products in p order, roll
    x = jnp.asarray(xr + 1j * xi)
    hop = m // os
    for j in range(os):
        fr = x[j * hop:j * hop + (t_cls - 1 + p) * m].reshape(t_cls - 1 + p, m)
        acc = None
        for q in range(p):
            term = fr[q:q + t_cls] * jnp.asarray(hb[q].astype(np.complex64))
            acc = term if acc is None else acc + term
        want = np.roll(np.asarray(acc), (j * hop) % m, axis=-1)
        assert _rel(got_r[j], want.real) <= REL and _rel(got_i[j], want.imag) <= REL


def test_twin_against_float64_and_the_roll_direction():
    m, os, p, t_cls = 16, 4, 3, 5
    xr, xi, hb = _case(m, os, p, t_cls, seed=7)
    got_r, got_i = _twin(xr, xi, hb, os, t_cls)
    x = xr.astype(np.float64) + 1j * xi
    hop = m // os
    for j in range(os):
        for t in range(t_cls):
            seg = x[j * hop + t * m:j * hop + (t + p) * m].reshape(p, m)
            acc = (seg * hb).sum(axis=0)
            a = (j * hop) % m
            for c in range(m):  # out[c] = acc[(c - a) mod M]
                want = acc[(c - a) % m]
                assert abs(got_r[j, t, c] - want.real) < 1e-5
                assert abs(got_i[j, t, c] - want.imag) < 1e-5


def test_wrapper_runs_the_twin_for_a_cpu_tensor_and_takes_a_batch():
    m, os, p, t_cls = 32, 2, 4, 11
    xr, xi, hb = _case(m, os, p, t_cls, seed=8, batch=(3,), extra=5)
    before = pf.launches
    got = pf.pfb_fold_os(torch.from_numpy(xr), torch.from_numpy(xi),
                         torch.from_numpy(hb), os, t_cls)
    assert pf.launches == before
    assert got[0].shape == (3, os, t_cls, m)
    for b in range(3):
        r, i = _twin(xr[b], xi[b], hb, os, t_cls)
        assert np.array_equal(got[0][b].numpy(), r) and np.array_equal(got[1][b].numpy(), i)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    m, os, p, t_cls = 16, 2, 3, 4
    xr, xi, hb = (torch.from_numpy(a) for a in _case(m, os, p, t_cls, seed=9))
    with pytest.raises(ValueError, match="input too short"):
        pf.pfb_fold_os(xr[:-1], xi[:-1], hb, os, t_cls)
    with pytest.raises(TypeError, match="float32"):
        pf.pfb_fold_os(xr.double(), xi.double(), hb, os, t_cls)
    with pytest.raises(ValueError, match="os must divide"):
        pf.pfb_fold_os(xr, xi, hb, 3, t_cls)
    with pytest.raises(ValueError, match="\\[P, M\\]"):
        pf.pfb_fold_os(xr, xi, hb[0], os, t_cls)
    assert pf.kernel_supports(2048, 33, 2)
    assert pf.kernel_supports(2048, 260, 2) and not pf.kernel_supports(2048, 261, 2)
    assert not pf.kernel_supports(64, 4, 2, batch=70_000)


# ------------------------------------------------------------ on the card


@pytest.mark.cuda
@pytest.mark.parametrize("m,os,p,t_cls,batch", [
    (2048, 2, 33, 300, ()),       # the channelizer's analysis geometry, fewer frames
    (2048, 1, 33, 161, ()),       # a synthesis spread (reversed branches, os 1)
    (200, 2, 7, 131, ()),         # ragged: t_cls % 64 and M % 64 both nonzero
    (96, 4, 5, 70, (3, 2)),       # a batch axis
    (64, 2, 1, 5, ()),            # P = 1
], ids=["analysis", "spread", "ragged", "batch", "p1"])
def test_cuda_kernel_matches_twin(cuda, m, os, p, t_cls, batch):
    xr, xi, hb = (torch.from_numpy(a).to(cuda)
                  for a in _case(m, os, p, t_cls, seed=m + t_cls, batch=batch, extra=3))
    before = pf.launches
    got = pf.pfb_fold_os(xr, xi, hb, os, t_cls)
    plain = pf.pfb_fold_os_reference(xr, xi, hb, os, t_cls)
    torch.cuda.synchronize()
    assert pf.launches == before + 1
    assert torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])


@pytest.mark.cuda
def test_cuda_channelizer_launches_the_kernel(cuda):
    rng = np.random.default_rng(11)
    x = torch.from_numpy((rng.normal(size=(2, 6000)) + 1j * rng.normal(size=(2, 6000)))
                         .astype(np.complex64)).to(cuda)
    before = pf.launches
    y = tch.pfb_channelize_os(x, 64, os=2, taps_per_branch=4)
    assert pf.launches == before + 1
    plain = tch.pfb_channelize_os(x, 64, os=2, taps_per_branch=4, backend="reference")
    assert torch.equal(y, plain)
    back = tch.pfb_synthesize_os(y, 64, os=2, taps_per_branch=4)
    assert pf.launches == before + 3  # one launch per class
    assert torch.equal(back, tch.pfb_synthesize_os(y, 64, os=2, taps_per_branch=4,
                                                   backend="reference"))
    g = tch.pfb_synthesis_taps(tch.pfb_prototype(64, 4), 64)
    z = torch.from_numpy(rng.normal(size=(40, 64)).astype(np.complex64)).to(cuda)
    spread = tch.pfb_synthesize(z, 64, taps=g, backend="auto")
    assert pf.launches == before + 4
    slice_sum = tch.pfb_synthesize(z, 64, taps=g)  # the default: no kernel
    assert pf.launches == before + 4
    assert _rel(spread.cpu().numpy().view(np.float32),
                slice_sum.cpu().numpy().view(np.float32)) <= REL
    h = (rng.normal(size=3 * 64) + 1j * rng.normal(size=3 * 64)).astype(np.complex64)
    with pytest.raises(NotImplementedError, match="row 6"):
        tch.pfb_channelize_os(x, 64, os=2, taps=h)
    with pytest.raises(NotImplementedError, match="row 6"):
        tch.pfb_synthesize_os(y, 64, os=2, taps=h)
    assert pf.launches == before + 4


@pytest.mark.cuda
def test_cuda_kernel_raises_on_what_it_does_not_take(cuda):
    m, os, p, t_cls = 64, 2, 3, 10
    xr, xi, hb = (torch.from_numpy(a).to(cuda) for a in _case(m, os, p, t_cls, seed=12))
    before = pf.launches
    with pytest.raises(ValueError, match="contiguous"):
        pf.pfb_fold_os(xr, xi, hb.t().contiguous().t(), os, t_cls)
    long = torch.zeros(_need(m, os, 300, 1), device=cuda)
    with pytest.raises(ValueError, match="does not take"):
        pf.pfb_fold_os(long, long, torch.zeros(300, m, device=cuda), os, 1)
    with pytest.raises(ValueError, match="one device"):
        pf.pfb_fold_os(xr, xi, hb.cpu(), os, t_cls)
    assert pf.launches == before
