"""The port's windowed BCJR and turbo decoder against the JAX package's.

The plain twin ``bcjr_windowed_llr_reference`` is held against the Pallas
kernel ``bcjr_windowed_llr`` (interpret mode) with the turbo RSC-8 tables
and the K=7 conv tables; the windowed constituent decoder and the whole
turbo decode (window 64, guard 16, 4 iterations) against JAX's XLA scans;
the encoder and interleaver against JAX's. The reference decoders are exact
(max-log, fixed expression tree), so LLRs and bits are compared with
``np.array_equal``: no tolerance. The wrapper's choice of kernel instance
and the compile-time RSC-8 trellis in ``csrc/bcjr.cu`` are checked on the
CPU, and so is the meet-in-the-middle schedule of that instance (a numpy
model of its order of operations, bit for bit against the twin). The CUDA
kernel is held against the twin on a card (``cuda`` marker; skipped without
one; run with ``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_bcjr.py``).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from aether_primitives_tpu_torch.ops import fec, turbo
from aether_primitives_tpu_torch.ops.cuda import bcjr as bk

torch.set_num_threads(1)

CONV_K7 = fec._conv_soft_coeffs((0o171, 0o133), 7)


@pytest.fixture(scope="module")
def jturbo():
    pytest.importorskip("jax")
    from aether_primitives_tpu.ops import turbo as jax_turbo

    return jax_turbo


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _spans(lw, n, seed):
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=(lw, n)) * 3).astype(np.float32),
            (rng.normal(size=(lw, n)) * 3).astype(np.float32))


def _channel_llrs(n_bits, b, seed, sigma=0.8):
    """Turbo-encoded random bits through BPSK + AWGN, as the five LLR
    streams (float32), and the bits."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (b, n_bits)).astype(np.uint8)
    enc = [s.numpy() for s in turbo.turbo_encode(torch.from_numpy(bits))]
    llrs = tuple(((2.0 / sigma ** 2) * ((1.0 - 2.0 * s.astype(np.float64))
                                        + sigma * rng.normal(size=s.shape)))
                 .astype(np.float32) for s in enc)
    return bits, llrs


def test_encoder_interleaver_and_tables_match_jax(jturbo):
    bits = np.random.default_rng(1).integers(0, 2, (3, 300)).astype(np.uint8)
    got = turbo.turbo_encode(torch.from_numpy(bits))
    for i in range(3):
        want = jturbo.turbo_encode(bits[i])
        for g, w in zip(got, want):
            assert np.array_equal(g[i].numpy(), np.asarray(w))
    for n in (632, 635, 1000):
        assert np.array_equal(turbo.turbo_interleaver(n), jturbo.turbo_interleaver(n))
    from aether_primitives_tpu.ops.pallas.bcjr import _rsc8_tables

    assert bk.rsc8_tables() == _rsc8_tables()
    from aether_primitives_tpu.ops import fec as jfec

    assert CONV_K7 == jfec._conv_soft_coeffs((0o171, 0o133), 7)


@pytest.mark.parametrize("tables", [None, CONV_K7], ids=["rsc8", "conv_k7"])
def test_twin_matches_bcjr_windowed_llr_interpret(jturbo, tables):
    from aether_primitives_tpu.ops.pallas.bcjr import bcjr_windowed_llr

    lw, n = 40, 128
    ls, lp = _spans(lw, n, 2)
    got = bk.bcjr_windowed_llr_reference(torch.from_numpy(ls), torch.from_numpy(lp),
                                         lw, tables).numpy()
    want = np.asarray(bcjr_windowed_llr(ls, lp, lw, tables=tables, tile_n=128,
                                        interpret=True))
    assert np.array_equal(got, want)
    # a ragged N: columns are independent, so the first 93 match too
    ragged = bk.bcjr_windowed_llr(torch.from_numpy(ls[:, :93].copy()),
                                  torch.from_numpy(lp[:, :93].copy()), lw, tables)
    assert np.array_equal(ragged.numpy(), want[:, :93])


def test_windowed_constituent_matches_jax(jturbo):
    rng = np.random.default_rng(3)
    b, n = 3, 1000
    ls = (rng.normal(size=(b, n)) * 3).astype(np.float32)
    lp = (rng.normal(size=(b, n)) * 3).astype(np.float32)
    la = rng.normal(size=(b, n)).astype(np.float32)
    got = turbo._bcjr_maxlog_windowed(torch.from_numpy(ls), torch.from_numpy(lp),
                                      torch.from_numpy(la), 64, 16).numpy()
    want = np.asarray(jturbo._bcjr_maxlog_windowed(ls, lp, la, 64, 16, backend="xla"))
    assert np.array_equal(got, want)
    ref = turbo._bcjr_maxlog_windowed(torch.from_numpy(ls), torch.from_numpy(lp),
                                      torch.from_numpy(la), 64, 16, backend="reference")
    assert np.array_equal(ref.numpy(), want)


@pytest.mark.parametrize("window", [64, 0], ids=["windowed", "exact"])
def test_turbo_decode_matches_jax(jturbo, window):
    bits, llrs = _channel_llrs(512, 2, 4)
    got_bits, got_llr = turbo.turbo_decode(*(torch.from_numpy(v) for v in llrs),
                                           iterations=4, window=window, guard=16)
    want_bits, want_llr = jturbo.turbo_decode(*llrs, iterations=4, window=window,
                                              guard=16, bcjr_backend="xla")
    assert np.array_equal(got_llr.numpy(), np.asarray(want_llr))
    assert np.array_equal(got_bits.numpy(), np.asarray(want_bits))
    assert np.array_equal(got_bits.numpy(), bits)


def test_turbo_decode_matches_the_pallas_kernel(jturbo):
    _, llrs = _channel_llrs(300, 2, 5, sigma=1.0)
    got_bits, got_llr = turbo.turbo_decode(*(torch.from_numpy(v) for v in llrs),
                                           iterations=2, window=64, guard=16)
    want_bits, want_llr = jturbo.turbo_decode(*llrs, iterations=2, window=64, guard=16,
                                              bcjr_backend="pallas_interpret")
    assert np.array_equal(got_llr.numpy(), np.asarray(want_llr))
    assert np.array_equal(got_bits.numpy(), np.asarray(want_bits))


def test_backends_and_argument_checks():
    _, llrs = _channel_llrs(100, 1, 6)
    args = tuple(torch.from_numpy(v) for v in llrs)
    a = turbo.turbo_decode(*args, iterations=1, window=64, guard=16)
    b = turbo.turbo_decode(*args, iterations=1, window=64, guard=16,
                           bcjr_backend="reference")
    assert torch.equal(a[1], b[1])
    for bad in ("xla", "pallas", "bogus"):
        with pytest.raises(ValueError, match="unknown bcjr_backend"):
            turbo.turbo_decode(*args, iterations=1, window=64, bcjr_backend=bad)
    with pytest.raises(ValueError, match="bad spans"):
        bk.bcjr_windowed_llr(torch.zeros(4, 5), torch.zeros(4, 6), 4)
    with pytest.raises(TypeError):
        bk.bcjr_windowed_llr(torch.zeros(4, 5, dtype=torch.float64),
                             torch.zeros(4, 5, dtype=torch.float64), 4)


def _swapped_rsc8():
    """The RSC-8 tables with one ``nxt`` entry swapped (and ``prev_s``
    left as it is): a table set outside the meet instance's pattern."""
    nxt, *rest = bk.rsc8_tables()
    rows = [list(r) for r in nxt]
    rows[1] = rows[1][::-1]
    return (tuple(map(tuple, rows)), *rest)


def _cu_table(name):
    src = (Path(bk.__file__).resolve().parents[2] / "csrc" / "bcjr.cu").read_text()
    body = re.search(rf"static constexpr int {name}\[16\] = \{{([^}}]*)\}};", src).group(1)
    return np.array([int(v) for v in body.split(",")]).reshape(8, 2)


def test_kernel_plan_picks_the_instance():
    assert bk.kernel_plan(None, 96) == ("rsc8", 16)
    assert bk.kernel_plan(bk.rsc8_tables(), 96) == ("rsc8", 16)
    assert bk.kernel_plan(CONV_K7, 96) == ("generic", 0)
    assert bk.kernel_plan(_swapped_rsc8(), 96) == ("generic", 0)
    # other coefficients on the RSC-8 pattern stay in the meet instance
    # where they factor through its classes, and take the generic one where
    # they do not
    nxt, prev_s, *coef = bk.rsc8_tables()
    scaled = tuple(tuple(tuple(2.0 * v for v in row) for row in c) for c in coef)
    assert bk.kernel_plan((nxt, prev_s, *scaled), 96)[0] == "rsc8"
    assert bk.kernel_plan(random_tables(8, 1, pattern=(nxt, prev_s)), 96) == ("generic", 0)
    # spans and history of Lw x cols x 40 bytes within 227 KB at 16 columns
    # a CTA, else at 8, else the generic instance
    assert bk.kernel_plan(None, 1) == ("rsc8", 16)
    assert bk.kernel_plan(None, 363) == ("rsc8", 16)
    assert bk.kernel_plan(None, 364) == ("rsc8", 8)
    assert bk.kernel_plan(None, 726) == ("rsc8", 8)
    assert bk.kernel_plan(None, 727) == ("generic", 0)


def test_meet_instance_tables_pinned_to_the_trellis(jturbo):
    # the compile-time copy in csrc/bcjr.cu against the port's trellis and
    # the JAX package's tables
    nxt, par, _, prev_s, _ = turbo._trellis()
    assert np.array_equal(_cu_table("kNxt"), nxt)
    assert np.array_equal(_cu_table("kPrev"), prev_s)
    assert np.array_equal(_cu_table("kClass"), 2 * np.arange(2)[None, :] + par)
    jnxt, jprev, *_ = jturbo._step_coeffs()
    assert np.array_equal(_cu_table("kNxt"), jnxt)
    assert np.array_equal(_cu_table("kPrev"), jprev)
    assert np.array_equal(_cu_table("kClass"), 2 * np.arange(2)[None, :] + jturbo._trellis()[1])
    from aether_primitives_tpu.ops.pallas.bcjr import _rsc8_tables

    jt = _rsc8_tables()
    assert np.array_equal(_cu_table("kNxt"), np.array(jt[0]))
    assert np.array_equal(_cu_table("kPrev"), np.array(jt[1]))


def _meet_model(ls, lp, coef):
    """numpy model of ``bcjr_kernel_meet``'s order of operations: forward
    to mid storing alpha_t, backward to mid storing beta_t, then each half's
    LLRs from the other's history; the state maximum as a three-level
    tree. float32 throughout."""
    nxt, prev = _cu_table("kNxt").reshape(-1), _cu_table("kPrev").reshape(-1)
    fw0, fw1, bw0, bw1 = (c.reshape(-1) for c in coef)
    lw, n = ls.shape
    mid = lw // 2

    def g(c0, c1, t):
        return [c0[i] * ls[t] + c1[i] * lp[t] for i in range(16)]

    def tree(v):
        m = list(v)
        for w in (4, 2, 1):
            m = [np.maximum(m[s], m[s + w]) for s in range(w)]
        return m[0]

    def update(m, gg, idx):
        v = [np.maximum(m[idx[2 * s]] + gg[2 * s], m[idx[2 * s + 1]] + gg[2 * s + 1])
             for s in range(8)]
        mx = tree(v)
        return [x - mx for x in v]

    def llr(a, b, gb):
        c = [[(a[s] + gb[2 * s + u]) + b[nxt[2 * s + u]] for s in range(8)] for u in (0, 1)]
        m0, m1 = c[0][0], c[1][0]
        for s in range(1, 8):
            m0, m1 = np.maximum(m0, c[0][s]), np.maximum(m1, c[1][s])
        return m0 - m1

    zero = [np.zeros(n, np.float32)] * 8
    hist, out, a, b = [None] * lw, np.empty((lw, n), np.float32), zero, zero
    for t in range(mid):
        hist[t], a = a, update(a, g(fw0, fw1, t), prev)
    for t in range(lw - 1, mid - 1, -1):
        hist[t], b = b, update(b, g(bw0, bw1, t), nxt)
    for t in range(mid, lw):
        out[t] = llr(a, hist[t], g(bw0, bw1, t))
        a = update(a, g(fw0, fw1, t), prev)
    for t in range(mid - 1, -1, -1):
        gb = g(bw0, bw1, t)
        out[t] = llr(hist[t], b, gb)
        b = update(b, gb, nxt)
    return out


def _tie_spans(lw, n, seed):
    """Integer-valued LLRs (exact ties between paths) with -0.0 among the
    zeros."""
    rng = np.random.default_rng(seed)
    ls, lp = (rng.integers(-2, 3, (lw, n)).astype(np.float32) for _ in range(2))
    ls[ls == 0] = -0.0
    lp[(lp == 0) & (rng.random((lw, n)) < 0.5)] = -0.0
    return ls, lp


@pytest.mark.parametrize("lw", [1, 2, 3, 95, 96, 97])
@pytest.mark.parametrize("kind", ["normal", "ties"])
def test_meet_schedule_equals_twin(lw, kind):
    # the kernel's schedule reorders the recursions and the state maxima;
    # its model must equal the twin bit for bit (signed zeros included)
    ls, lp = _spans(lw, 64, 30 + lw) if kind == "normal" else _tie_spans(lw, 64, 30 + lw)
    _, coef, _, _ = bk._host_tables(bk.rsc8_tables())
    want = bk.bcjr_windowed_llr_reference(torch.from_numpy(ls), torch.from_numpy(lp), lw)
    got = _meet_model(ls, lp, coef)
    assert np.array_equal(got.view(np.uint32), want.numpy().view(np.uint32))


@pytest.mark.parametrize("tables", [None, CONV_K7], ids=["rsc8", "conv_k7"])
def test_twin_matches_pallas_at_ties_and_signed_zeros(jturbo, tables):
    from aether_primitives_tpu.ops.pallas.bcjr import bcjr_windowed_llr

    lw, n = 24, 128
    ls, lp = _tie_spans(lw, n, 9)
    got = bk.bcjr_windowed_llr_reference(torch.from_numpy(ls), torch.from_numpy(lp),
                                         lw, tables).numpy()
    want = np.asarray(bcjr_windowed_llr(ls, lp, lw, tables=tables, tile_n=128,
                                        interpret=True))
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def random_tables(s_count, seed, pattern=None):
    """A random valid binary trellis of ``s_count`` states (every state has
    two successors and two predecessors) with random float coefficients, as
    hashable tables; ``pattern`` keeps that ``(nxt, prev_s)`` instead."""
    rng = np.random.default_rng(seed)
    if pattern is None:
        nxt = rng.permutation(np.repeat(np.arange(s_count), 2)).reshape(s_count, 2)
        prev_s = np.zeros((s_count, 2), np.int64)
        fill = np.zeros(s_count, np.int64)
        for s in range(s_count):
            for u in (0, 1):
                prev_s[nxt[s, u], fill[nxt[s, u]]] = s
                fill[nxt[s, u]] += 1
    else:
        nxt, prev_s = (np.asarray(p) for p in pattern)
    coef = [np.round(rng.normal(size=(s_count, 2)), 3) for _ in range(4)]
    return tuple(tuple(map(tuple, a.tolist())) for a in (nxt, prev_s, *coef))


def test_branch_metric_classes_are_found():
    # the turbo tables factor through the trellis's four branch-metric
    # classes (forward and backward alike); random coefficients and a flipped
    # sign do not, and the K=7 tables are not the meet instance's: those
    # take the generic instance
    _, _, instance, cls = bk._host_tables(bk.rsc8_tables())
    assert instance == "rsc8"
    assert cls is not None and cls.shape == (2, 4) and np.isfinite(cls).all()
    assert bk._host_tables(CONV_K7)[2:] == ("generic", None)
    assert bk._host_tables(random_tables(8, 1, pattern=bk.rsc8_tables()[:2]))[2:] == (
        "generic", None)
    nxt, prev_s, fw0, fw1, bw0, bw1 = bk.rsc8_tables()
    bad = [list(r) for r in fw1]
    bad[3][1] = -bad[3][1]
    assert bk._host_tables((nxt, prev_s, fw0, tuple(map(tuple, bad)), bw0, bw1))[2:] == (
        "generic", None)
    # each class's pair is the coefficients of its transitions
    _, coef, _, _ = bk._host_tables(bk.rsc8_tables())
    klass = _cu_table("kClass")
    for s in range(8):
        for u in (0, 1):
            assert (cls[0, klass[s, u]], cls[1, klass[s, u]]) == (coef[2, s, u], coef[3, s, u])


def test_random_tables_are_valid_and_planned():
    for s_count in bk.KERNEL_STATES:
        t = random_tables(s_count, s_count)
        nxt, prev_s = np.array(t[0]), np.array(t[1])
        assert sorted(nxt.reshape(-1).tolist()) == sorted(list(range(s_count)) * 2)
        for sp in range(s_count):
            for j in (0, 1):
                assert sp in nxt[prev_s[sp, j]]
        assert bk.kernel_plan(t, 96)[0] == "generic"
    t = random_tables(8, 1, pattern=bk.rsc8_tables()[:2])
    assert bk.kernel_plan(t, 96) == ("generic", 0)  # not through the classes


# ------------------------------------------------------------ on the card


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2560, 1000, 77])
@pytest.mark.parametrize("tables", [None, CONV_K7], ids=["rsc8", "conv_k7"])
def test_cuda_kernel_matches_twin(cuda, tables, n):
    ls, lp = (torch.from_numpy(a).to(cuda) for a in _spans(96, n, 7))
    before = bk.launches
    got = bk.bcjr_windowed_llr(ls, lp, 96, tables)
    want = bk.bcjr_windowed_llr_reference(ls, lp, 96, tables)
    torch.cuda.synchronize()
    assert bk.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_turbo_decode_matches_twin(cuda):
    bits, llrs = _channel_llrs(632, 16, 8)
    args = tuple(torch.from_numpy(v).to(cuda) for v in llrs)
    before = bk.launches
    got = turbo.turbo_decode(*args, iterations=8, window=64, guard=16)
    want = turbo.turbo_decode(*args, iterations=8, window=64, guard=16,
                              bcjr_backend="reference")
    torch.cuda.synchronize()
    assert bk.launches == before + 16
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    assert np.array_equal(got[0].cpu().numpy(), bits)


@pytest.mark.cuda
@pytest.mark.parametrize("lw", [1, 2, 95, 96, 97])
@pytest.mark.parametrize("n", [1, 77, 1000, 2560, 2570])
def test_cuda_meet_instance_matches_twin(cuda, lw, n):
    ls, lp = (torch.from_numpy(a).to(cuda) for a in _spans(lw, n, 40 + lw))
    assert bk.kernel_plan(None, lw)[0] == "rsc8"
    before = bk.launches
    got = bk.bcjr_windowed_llr(ls, lp, lw)
    want = bk.bcjr_windowed_llr_reference(ls, lp, lw)
    torch.cuda.synchronize()
    assert bk.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("tables", [None, CONV_K7], ids=["rsc8", "conv_k7"])
@pytest.mark.parametrize("n", [2560, 1001])
def test_cuda_kernel_at_ties_and_signed_zeros(cuda, tables, n):
    ls, lp = (torch.from_numpy(a).to(cuda) for a in _tie_spans(96, n, 11))
    got = bk.bcjr_windowed_llr(ls, lp, 96, tables)
    want = bk.bcjr_windowed_llr_reference(ls, lp, 96, tables)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert np.array_equal(got.cpu().numpy().view(np.uint32), want.cpu().numpy().view(np.uint32))


@pytest.mark.cuda
@pytest.mark.parametrize("s_count", [4, 8, 16, 32, 64, "rsc8-pattern"])
def test_cuda_kernel_random_tables(cuda, s_count):
    tables = (random_tables(8, 3, pattern=bk.rsc8_tables()[:2]) if s_count == "rsc8-pattern"
              else random_tables(s_count, 5 + s_count))
    ls, lp = (torch.from_numpy(a).to(cuda) for a in _spans(96, 1000, 12))
    got = bk.bcjr_windowed_llr(ls, lp, 96, tables)
    want = bk.bcjr_windowed_llr_reference(ls, lp, 96, tables)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("cols", bk.MEET_COLS)
@pytest.mark.parametrize("offset", [0, 1])
def test_cuda_meet_every_column_count(cuda, cols, offset):
    # both CTA widths the meet instance ships; offset 1 takes the 4-byte
    # copies
    lw, n = 96, 2560 - offset
    ls, lp = (torch.from_numpy(a).to(cuda) for a in _spans(lw, n + offset, 13))
    ls, lp = ls[:, offset:].contiguous(), lp[:, offset:].contiguous()
    flat = [torch.zeros(lw * n + offset, device=cuda) for _ in range(2)]
    for f, src in zip(flat, (ls, lp)):
        f[offset:] = src.reshape(-1)
    ls_o, lp_o = (f[offset:].view(lw, n) for f in flat)
    cls = bk._host_tables(bk.rsc8_tables())[3]
    want = bk.bcjr_windowed_llr_reference(ls, lp, lw)
    out = torch.empty((lw, n), device=cuda)
    bk._launch_meet(ls_o, lp_o, out, lw, cols, cls)
    torch.cuda.synchronize()
    assert torch.equal(out, want)
