"""The PFB fold's plain twins against the JAX package's folds, and the CUDA
kernel's layouts against the twins.

The planes twin ``pfb_fold_os_reference`` is held against the Pallas kernel
``pfb_fold_os`` (interpret mode, its input padded to whole 8-frame tiles as
the JAX callers pad it) and against the XLA fold of
``pfb_channelize_os(pallas=False)`` at relative RMS error <= 1e-6, the bar
of ``tests/test_pfb.py`` for the Pallas fold against XLA (both sides add the
same products in the same order; the JAX side contracts to FMAs, so the two
are not bit-equal). The analysis twin (complex64 in, two sources, frames in
frame order) is held against the Pallas kernel at that bar and
``torch.equal`` to the planes twin moved to frame order; the synthesis twin
``torch.equal`` to the composition the channelizer ran before (kept here as
``_parent_synthesis``). The CUDA kernel is held bit for bit
(``torch.equal``) against the twins on a card (``cuda`` marker; skipped
without one; run with ``python -m pytest --noconftest -p no:cacheprovider
-m cuda tests/test_torch_pfb_fold.py``): both use correctly rounded
multiplies and adds in ``p`` order.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

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
    # one slab of (tile + P) x 64 complex64 samples must fit (tile 128, or
    # 44 synthesis rows) beside a chunk of the weights (64 branches, or 44),
    # so the bound is the same at every os: the previous kernel's P 260 and
    # more, with either tap type
    last = {("planes", False): 294, ("analysis", False): 294, ("analysis", True): 262,
            ("synthesis", False): 388, ("synthesis", True): 366}
    for os in (1, 2, 4, 8, 32):
        for (mode, cplx), p_max in last.items():
            assert pf.kernel_supports(2048, 260, os, mode=mode, complex_taps=cplx)
            assert pf.kernel_supports(2048, p_max, os, mode=mode, complex_taps=cplx)
            assert not pf.kernel_supports(2048, p_max + 1, os, mode=mode, complex_taps=cplx)
    assert pf.kernel_supports(2048, 260, 2) and not pf.kernel_supports(2048, 295, 2)
    assert not pf.kernel_supports(64, 4, 2, batch=70_000)
    # the path: a ring of two slabs, the weights in shared memory
    for mode in ("analysis", "synthesis"):
        for cplx in (False, True):
            assert pf.launch_plan(mode, 33, 2, cplx) == (2, True)
    # the card's tests' other plans: one slab with the weights beside it
    # (two slabs do not fit); the weights a chunk at a time, with one slab
    # or two
    for cases, plans in ((ONE_STAGE, {(1, True)}), (CHUNKED, {(1, False), (2, False)})):
        seen = set()
        for name, (m, os, p, _, _) in cases.items():
            mode = name.split("-")[0]
            for cplx in ((False, True) if mode == "analysis" else (name.endswith("-c"),)):
                assert pf.kernel_supports(m, p, os, mode=mode, complex_taps=cplx)
                seen.add(pf.launch_plan(mode, p, os, cplx))
        assert seen == plans


# ------------------------------------------- the complex64 analysis layout


def _c64(shape, rng):
    return torch.from_numpy((rng.normal(size=shape) + 1j * rng.normal(size=shape))
                            .astype(np.complex64))


def _branches(p, m, rng, cplx=False):
    w = rng.normal(size=(p, m)).astype(np.float32)
    if cplx:
        w = (w + 1j * rng.normal(size=(p, m))).astype(np.complex64)
    return torch.from_numpy(w)


def _frame_order(o_r, o_i, t_frames):
    """Planes ``[..., os, t_cls, M]`` -> complex ``[..., t_frames, M]`` in
    frame order ``t = i*os + j``."""
    u = torch.complex(o_r, o_i)
    os, t_cls, m = u.shape[-3:]
    return u.transpose(-3, -2).reshape(u.shape[:-3] + (t_cls * os, m))[..., :t_frames, :]


# (M, os, P, t_frames, batch): ragged M (not a multiple of 64), odd frame counts
ANALYSIS = [(80, 2, 5, 25, (2,)), (96, 4, 3, 30, ()), (200, 2, 7, 13, (3,)), (64, 1, 4, 9, ())]
ANALYSIS_IDS = [f"m{m}-os{o}-p{p}-t{t}-b{len(b)}" for m, o, p, t, b in ANALYSIS]


@pytest.mark.parametrize("m,os,p,t_frames,batch", ANALYSIS, ids=ANALYSIS_IDS)
def test_analysis_twin_matches_the_pallas_kernel_in_frame_order(jax_fold, m, os, p,
                                                                t_frames, batch):
    rng = np.random.default_rng(m + t_frames)
    t_cls = -(-t_frames // os)
    x = _c64(batch + (_need(m, os, p, t_cls),), rng)
    w = _branches(p, m, rng)
    got = pf.pfb_analysis_reference(x, None, w, os, t_frames)
    assert got.shape == batch + (t_frames, m) and got.dtype == torch.complex64
    planes = pf.pfb_fold_os_reference(x.real.contiguous(), x.imag.contiguous(), w, os, t_cls)
    assert torch.equal(got, _frame_order(*planes, t_frames))
    tile = 8
    pad = (0, _need(m, os, p, -(-t_cls // tile) * tile) - x.shape[-1])
    xn = x.reshape(-1, x.shape[-1]).numpy()
    for row in range(xn.shape[0]):
        want_r, want_i = jax_fold(np.pad(xn[row].real, pad), np.pad(xn[row].imag, pad),
                                  w.numpy(), os, t_cls, tile_t=tile, interpret=True)
        want = _frame_order(torch.from_numpy(np.array(want_r)),
                            torch.from_numpy(np.array(want_i)), t_frames)
        g = got.reshape(-1, t_frames, m)[row]
        assert _rel(g.real, want.real) <= REL and _rel(g.imag, want.imag) <= REL


@pytest.mark.parametrize("cut", [0, 1, 37, 80 * 3, 80 * 3 + 41, 80 * 9 - 1])
def test_analysis_two_sources_equal_their_concatenation(cut):
    # seams at a row start, inside a row and at odd offsets; the body past
    # the span the frames need is read as is
    m, os, p, t_frames = 80, 2, 5, 11
    rng = np.random.default_rng(cut)
    x = _c64((2, _need(m, os, p, 6) + 13), rng)
    w = _branches(p, m, rng, cplx=cut % 2 == 1)
    whole = pf.pfb_analysis_reference(x, None, w, os, t_frames)
    parts = pf.pfb_analysis(x[..., :cut], x[..., cut:], w, os, t_frames)
    assert torch.equal(parts, whole)


def test_analysis_implicit_zero_tail_equals_padding():
    m, os, p, t_frames = 32, 4, 3, 17
    rng = np.random.default_rng(5)
    need = _need(m, os, p, -(-t_frames // os))
    x = _c64((need - 70,), rng)
    w = _branches(p, m, rng, cplx=True)
    padded = F.pad(x, (0, 70))
    want = pf.pfb_analysis_reference(padded, None, w, os, t_frames)
    assert torch.equal(pf.pfb_analysis(x, None, w, os, t_frames), want)
    assert torch.equal(pf.pfb_analysis(x[:10], x[10:], w, os, t_frames), want)


def test_complex_branches_against_float64():
    m, os, p, t_frames = 16, 2, 3, 7
    rng = np.random.default_rng(6)
    x = _c64((_need(m, os, p, 4),), rng)
    w = _branches(p, m, rng, cplx=True)
    got = pf.pfb_analysis_reference(x, None, w, os, t_frames).numpy()
    xx, ww = x.numpy().astype(np.complex128), w.numpy().astype(np.complex128)
    hop = m // os
    for t in range(t_frames):
        i, j = divmod(t, os)
        acc = (xx[j * hop + i * m:j * hop + (i + p) * m].reshape(p, m) * ww).sum(0)
        want = np.roll(acc, j * hop)
        assert np.abs(got[t] - want).max() < 1e-5


# ------------------------------------------------ the synthesis layout


def _parent_synthesis(v, w_rev, os):
    """The channelizer's synthesis before the one-launch layout: per class
    its frames rolled by -(j*hop), the spread by the planes fold at os = 1
    with reversed branches over P - 1 zero frames each side, padded to the
    class's hop offset, and summed in class order."""
    p, m = w_rev.shape
    hop = m // os
    t = v.shape[-2]
    t_cls = -(-t // os)
    if t_cls * os > t:
        v = F.pad(v, (0, 0, 0, t_cls * os - t))
    batch = tuple(v.shape[:-2])
    wg = v.reshape(batch + (t_cls, os, m))
    m_slabs = t_cls + p - 1
    n_slabs = m_slabs * os + os - 1
    wr, wi = (w_rev.real.contiguous(), w_rev.imag.contiguous()) if w_rev.is_complex() \
        else (w_rev, None)
    acc = None
    for j in range(os):
        wj = wg[..., j, :]
        if j * hop % m:
            wj = torch.roll(wj, -(j * hop % m), dims=-1)
        flat = F.pad(wj, (0, 0, p - 1, p - 1)).reshape(batch + (-1,))
        o_r, o_i = pf.pfb_fold_os_reference(flat.real.contiguous(), flat.imag.contiguous(),
                                            wr, 1, m_slabs, wi)
        oj = torch.complex(o_r, o_i)[..., 0, :, :]
        oh = F.pad(oj.reshape(batch + (m_slabs * os, hop)),
                   (0, 0, j, n_slabs - m_slabs * os - j))
        acc = oh if acc is None else acc + oh
    return acc.reshape(batch + (n_slabs * hop,))


def _parent_epilogue(raw, tail, divisor, emit, hop):
    """The synthesis stage's epilogue before it ran in the kernel: the
    carried tail added in place, the first ``emit`` samples divided plane
    by plane by the periodic divisor, the rest kept."""
    raw = raw.clone()
    raw[..., :tail.shape[-1]] += tail
    head = raw[..., :emit]
    shape = head.shape[:-1] + (emit // hop, hop)
    out = torch.complex(head.real.reshape(shape) / divisor, head.imag.reshape(shape) / divisor)
    return out.reshape(head.shape), raw[..., emit:].clone()


def _epilogue_case(v, w_rev, os, rng):
    """(tail, divisor, emit) of a streaming step over frames ``v``."""
    p, m = w_rev.shape
    hop = m // os
    t = v.shape[-2] - v.shape[-2] % os
    tail = _with_negative_zeros(_c64(tuple(v.shape[:-2]) + (p * m - hop,), rng), rng)
    divisor = torch.from_numpy(rng.uniform(0.5, 3.0, hop).astype(np.float32))
    return tail.to(v.device), divisor.to(v.device), t * hop


def _with_negative_zeros(v, rng):
    """``v`` with about a third of its components set to -0.0 or +0.0."""
    a = torch.view_as_real(v).clone()
    mask = torch.from_numpy(rng.random(a.shape) < 0.3)
    a[mask] = torch.from_numpy(np.where(rng.random(a.shape) < 0.5, -0.0, 0.0)
                               .astype(np.float32))[mask]
    return torch.view_as_complex(a)


# (M, os, P, T, batch, complex branches)
SYNTHESIS = [(64, 1, 4, 9, (), False), (80, 2, 5, 13, (2,), False), (96, 4, 3, 10, (), True),
             (32, 2, 6, 8, (), True), (48, 4, 2, 1, (), False)]
SYNTHESIS_IDS = [f"m{m}-os{o}-p{p}-t{t}-b{len(b)}-{'c' if c else 'r'}"
                 for m, o, p, t, b, c in SYNTHESIS]


@pytest.mark.parametrize("m,os,p,t,batch,cplx", SYNTHESIS, ids=SYNTHESIS_IDS)
def test_synthesis_twin_equals_the_parent_composition(m, os, p, t, batch, cplx):
    rng = np.random.default_rng(m * os + t)
    v = _with_negative_zeros(_c64(batch + (t, m), rng), rng)
    w_rev = _branches(p, m, rng, cplx)
    w_rev[0, :m // 4] = -0.0  # zero products of both signs at the edges
    got = pf.pfb_synthesis(v, w_rev, os)
    assert got.shape == batch + (pf.synthesis_length(t, m, p, os),)
    want = _parent_synthesis(v, w_rev, os)
    assert torch.equal(got, want)
    assert torch.equal(torch.signbit(torch.view_as_real(got)),
                       torch.signbit(torch.view_as_real(want)))
    # the streaming stage's epilogue, fused in the same call
    tail, divisor, emit = _epilogue_case(v, w_rev, os, rng)
    out, rest = pf.pfb_synthesis(v, w_rev, os, tail, divisor, emit)
    want_out, want_rest = _parent_epilogue(want, tail, divisor, emit, m // os)
    assert torch.equal(out, want_out) and torch.equal(rest, want_rest)


def test_wrappers_refuse_bad_arguments():
    rng = np.random.default_rng(7)
    x = _c64((400,), rng)
    w = _branches(3, 16, rng)
    with pytest.raises(TypeError, match="complex64"):
        pf.pfb_analysis(x.real.contiguous(), None, w, 2, 4)
    with pytest.raises(TypeError, match="float32 or complex64"):
        pf.pfb_analysis(x, None, w.double(), 2, 4)
    with pytest.raises(ValueError, match="os must divide"):
        pf.pfb_analysis(x, None, w, 3, 4)
    with pytest.raises(ValueError, match="leading axes"):
        pf.pfb_analysis(x[None], _c64((2, 5), rng), w, 2, 4)
    with pytest.raises(ValueError, match="complex64 frames"):
        pf.pfb_synthesis(_c64((4, 8), rng), w, 2)
    before = pf.launches
    pf.pfb_analysis(x, None, w, 2, 4)
    pf.pfb_synthesis(_c64((4, 16), rng), w, 2)
    assert pf.launches == before  # CPU tensors run the twins


# ------------------------------------------------------------ on the card


@pytest.mark.cuda
@pytest.mark.parametrize("m,os,p,t_cls,batch", [
    (2048, 2, 33, 300, ()),       # the channelizer's analysis geometry, fewer frames
    (2048, 1, 33, 161, ()),       # a synthesis spread (reversed branches, os 1)
    (200, 2, 7, 131, ()),         # ragged: t_cls % 64 and M % 64 both nonzero
    (96, 4, 5, 70, (3, 2)),       # a batch axis
    (64, 2, 1, 5, ()),            # P = 1
    (256, 8, 260, 40, ()),        # the previous kernel's limit: the weights a chunk at a time
    (256, 4, 260, 37, (2,)),
], ids=["analysis", "spread", "ragged", "batch", "p1", "p260-os8", "p260-os4"])
def test_cuda_kernel_matches_twin(cuda, m, os, p, t_cls, batch):
    xr, xi, hb = (torch.from_numpy(a).to(cuda)
                  for a in _case(m, os, p, t_cls, seed=m + t_cls, batch=batch, extra=3))
    before = pf.launches
    got = pf.pfb_fold_os(xr, xi, hb, os, t_cls)
    plain = pf.pfb_fold_os_reference(xr, xi, hb, os, t_cls)
    torch.cuda.synchronize()
    assert pf.launches == before + 1
    assert torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])


# where two slabs do not fit, the kernel runs a ring of one (no overlap)
ONE_STAGE = {"analysis": (256, 2, 100, 300, ()), "synthesis": (256, 2, 150, 40, ()),
             "synthesis-c": (256, 2, 120, 40, ())}
# where the weights of every class do not fit beside a slab, the block
# stages one class's a chunk of branches at a time: os 4 and 8 near the
# previous kernel's limit (P 260), and os 32 at the default taps_per_branch
# (P 33)
CHUNKED = {"analysis-os8": (256, 8, 260, 300, ()), "analysis-os4": (512, 4, 258, 203, (2,)),
           "analysis-os32": (2048, 32, 33, 640, ()), "synthesis-os4-c": (256, 4, 260, 40, ()),
           "synthesis-os8": (256, 8, 200, 41, (2,))}


@pytest.mark.cuda
@pytest.mark.parametrize("m,os,p,t_frames,batch",
                         ANALYSIS + [(2048, 2, 33, 600, ()), ONE_STAGE["analysis"]]
                         + [v for k, v in CHUNKED.items() if k.startswith("analysis")],
                         ids=ANALYSIS_IDS + ["path", "one-stage"]
                         + [k for k in CHUNKED if k.startswith("analysis")])
@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
def test_cuda_analysis_matches_twin(cuda, m, os, p, t_frames, batch, cplx):
    rng = np.random.default_rng(m + t_frames + cplx)
    t_cls = -(-t_frames // os)
    x = _c64(batch + (_need(m, os, p, t_cls) + 5,), rng).to(cuda)
    w = _branches(p, m, rng, cplx).to(cuda)
    want = pf.pfb_analysis_reference(x, None, w, os, t_frames)
    # one source; two with a seam inside a row (odd: 8-byte copies) and at
    # a row start; a short input whose zero tail is implicit
    cases = [(x, None), (x[..., :m + 3], x[..., m + 3:]), (x[..., :2 * m], x[..., 2 * m:])]
    for head, body in cases:
        before = pf.launches
        got = pf.pfb_analysis(head, body, w, os, t_frames)
        torch.cuda.synchronize()
        assert pf.launches == before + 1
        assert torch.equal(got, want)
    short = x[..., :x.shape[-1] - 3 * m]
    assert torch.equal(pf.pfb_analysis(short, None, w, os, t_frames),
                       pf.pfb_analysis_reference(short, None, w, os, t_frames))


@pytest.mark.cuda
@pytest.mark.parametrize("m,os,p,t,batch,cplx", SYNTHESIS + [
    (2048, 2, 33, 300, (), False), (2048, 2, 33, 300, (), True),
    ONE_STAGE["synthesis"] + (False,), ONE_STAGE["synthesis-c"] + (True,)]
    + [v + (k.endswith("-c"),) for k, v in CHUNKED.items() if k.startswith("synthesis")],
    ids=SYNTHESIS_IDS + ["path-r", "path-c", "one-stage-r", "one-stage-c"]
    + [k for k in CHUNKED if k.startswith("synthesis")])
def test_cuda_synthesis_matches_twin(cuda, m, os, p, t, batch, cplx):
    rng = np.random.default_rng(m * os + t)
    v = _with_negative_zeros(_c64(batch + (t, m), rng), rng).to(cuda)
    w_rev = _branches(p, m, rng, cplx)
    w_rev[0, :m // 4] = -0.0
    w_rev = w_rev.to(cuda)
    want = _parent_synthesis(v, w_rev, os)
    before = pf.launches
    got = pf.pfb_synthesis(v, w_rev, os)
    torch.cuda.synchronize()
    assert pf.launches == before + 1
    assert torch.equal(got, want)
    assert torch.equal(torch.signbit(torch.view_as_real(got)),
                       torch.signbit(torch.view_as_real(want)))
    tail, divisor, emit = _epilogue_case(v, w_rev, os, rng)
    out, rest = pf.pfb_synthesis(v, w_rev, os, tail, divisor, emit)
    want_out, want_rest = _parent_epilogue(want, tail, divisor, emit, m // os)
    torch.cuda.synchronize()
    assert torch.equal(out, want_out) and torch.equal(rest, want_rest)
    assert torch.equal(torch.signbit(torch.view_as_real(out)),
                       torch.signbit(torch.view_as_real(want_out)))


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
    assert pf.launches == before + 2  # one launch for all classes
    assert torch.equal(back, tch.pfb_synthesize_os(y, 64, os=2, taps_per_branch=4,
                                                   backend="reference"))
    g = tch.pfb_synthesis_taps(tch.pfb_prototype(64, 4), 64)
    z = torch.from_numpy(rng.normal(size=(40, 64)).astype(np.complex64)).to(cuda)
    spread = tch.pfb_synthesize(z, 64, taps=g, backend="auto")
    assert pf.launches == before + 3
    slice_sum = tch.pfb_synthesize(z, 64, taps=g)  # the default: no kernel
    assert pf.launches == before + 3
    assert _rel(spread.cpu().numpy().view(np.float32),
                slice_sum.cpu().numpy().view(np.float32)) <= REL
    # a complex prototype runs on the card through the complex-tap layouts
    h = (rng.normal(size=3 * 64) + 1j * rng.normal(size=3 * 64)).astype(np.complex64)
    yc = tch.pfb_channelize_os(x, 64, os=2, taps=h)
    assert torch.equal(yc, tch.pfb_channelize_os(x, 64, os=2, taps=h, backend="reference"))
    bc = tch.pfb_synthesize_os(yc, 64, os=2, taps=h)
    assert torch.equal(bc, tch.pfb_synthesize_os(yc, 64, os=2, taps=h, backend="reference"))
    assert pf.launches == before + 5
    ana = tch.PfbChannelizerOs(64, os=2, taps=h, device=cuda)
    syn = tch.PfbSynthesizerOs(64, os=2, taps=h, device=cuda)
    cpu_ana = tch.PfbChannelizerOs(64, os=2, taps=h, device="cpu")
    for blk in (x[0, :2500], x[0, 2500:]):
        fr = ana.step(blk)
        want = cpu_ana.step(blk.cpu())  # cuFFT and the CPU FFT differ in rounding
        assert _rel(fr.cpu().numpy().view(np.float32), want.numpy().view(np.float32)) <= 3e-6
        syn.step(fr)
    assert pf.launches == before + 9


@pytest.mark.cuda
def test_cuda_kernel_raises_on_what_it_does_not_take(cuda):
    m, os, p, t_cls = 64, 2, 3, 10
    xr, xi, hb = (torch.from_numpy(a).to(cuda) for a in _case(m, os, p, t_cls, seed=12))
    before = pf.launches
    with pytest.raises(ValueError, match="contiguous"):
        pf.pfb_fold_os(xr, xi, hb.t().contiguous().t(), os, t_cls)
    long = torch.zeros(_need(m, os, 295, 1), device=cuda)  # a slab and a chunk too many
    with pytest.raises(ValueError, match="does not take"):
        pf.pfb_fold_os(long, long, torch.zeros(295, m, device=cuda), os, 1)
    with pytest.raises(ValueError, match="one device"):
        pf.pfb_fold_os(xr, xi, hb.cpu(), os, t_cls)
    assert pf.launches == before
