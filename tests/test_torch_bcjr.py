"""The port's windowed BCJR and turbo decoder against the JAX package's.

The plain twin ``bcjr_windowed_llr_reference`` is held against the Pallas
kernel ``bcjr_windowed_llr`` (interpret mode) with the turbo RSC-8 tables
and the K=7 conv tables; the windowed constituent decoder and the whole
turbo decode (window 64, guard 16, 4 iterations) against JAX's XLA scans;
the encoder and interleaver against JAX's. The reference decoders are exact
(max-log, fixed expression tree), so LLRs and bits are compared with
``np.array_equal``: no tolerance. The wrapper's choice of kernel instance
and the compile-time RSC-8 trellis in ``csrc/bcjr.cu`` are checked on the
CPU, and so are the meet-in-the-middle schedules of the ``rsc8``, ``lanes``
and ``block`` instances (numpy models of their order of operations, bit for
bit against the twin); the windowed conv decode's twin is held against the JAX
package's XLA scan at K = 5, 6 and 7. The CUDA
kernel is held against the twin on a card (``cuda`` marker; skipped without
one; run with ``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_bcjr.py``).
"""

import os
import re
import types
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


def _conv_llrs(polys, k, b, n_bits, seed=31):
    """Conv-encoded random bits as LLRs ``2 (1 - 2 c) + N(0, 1)`` (float32),
    and the bits."""
    rng = np.random.default_rng(seed + k)
    bits = rng.integers(0, 2, (b, n_bits)).astype(np.uint8)
    enc = fec.conv_encode(torch.from_numpy(bits), polys, k).numpy()
    return bits, ((1 - 2.0 * enc) * 2 + rng.normal(size=enc.shape)).astype(np.float32)


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
    assert bk.kernel_plan(CONV_K7, 96) == ("lanes", 1)
    assert bk.kernel_plan(_swapped_rsc8(), 96) == ("lanes", 4)
    # other coefficients on the RSC-8 pattern stay in the meet instance
    # where they factor through its classes, and take the lanes instance
    # where they do not
    nxt, prev_s, *coef = bk.rsc8_tables()
    scaled = tuple(tuple(tuple(2.0 * v for v in row) for row in c) for c in coef)
    assert bk.kernel_plan((nxt, prev_s, *scaled), 96)[0] == "rsc8"
    assert bk.kernel_plan(random_tables(8, 1, pattern=(nxt, prev_s)), 96) == ("lanes", 4)
    # spans and history of Lw x cols x 40 bytes within 227 KB at 16 columns
    # a CTA, else at 8, else the lanes instance
    assert bk.kernel_plan(None, 1) == ("rsc8", 16)
    assert bk.kernel_plan(None, 363) == ("rsc8", 16)
    assert bk.kernel_plan(None, 364) == ("rsc8", 8)
    assert bk.kernel_plan(None, 726) == ("rsc8", 8)
    assert bk.kernel_plan(None, 727) == ("lanes", 4)


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
    # take the lanes instance
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
        assert bk.kernel_plan(t, 96) == ("lanes", 32 // min(s_count, 32))
    t = random_tables(8, 1, pattern=bk.rsc8_tables()[:2])
    assert bk.kernel_plan(t, 96) == ("lanes", 4)  # not through the classes


# shift-register codes a constraint length, K = 3..7 (S = 4..64)
SR_CODES = {3: (0o5, 0o7), 4: (0o13, 0o17), 5: (0o23, 0o35), 6: (0o53, 0o75),
            7: (0o171, 0o133)}


@pytest.mark.parametrize("k", sorted(SR_CODES))
def test_kernel_plan_takes_the_lanes_instance_for_codes(k):
    tables = fec._conv_soft_coeffs(SR_CODES[k], k)
    s_count = 1 << (k - 1)
    assert bk._host_tables(tables)[2] == "generic"
    for lw in (1, 96, 224):
        assert bk.kernel_plan(tables, lw) == ("lanes", 32 // min(s_count, 32))


@pytest.mark.parametrize("s_count", bk.KERNEL_STATES)
def test_lanes_span_limit(s_count):
    # the lanes instance takes Lw up to its shared memory (spans, histories
    # and exchange buffers within 227 KB); one step more takes the block
    # instance
    tables = random_tables(s_count, 20 + s_count)
    limit = bk.lanes_span_limit(s_count)
    g = 32 // min(s_count, 32)
    assert limit == {4: 1208, 8: 1449, 16: 1610, 32: 1705, 64: 876}[s_count]
    smem = lambda lw: 4 * (lw * g * (s_count + 2) + 4 * g * s_count)  # noqa: E731
    assert smem(limit) <= 232448 < smem(limit + 1)
    assert bk.kernel_plan(tables, limit) == ("lanes", g)
    assert bk.kernel_plan(tables, limit + 1) == ("block", 32 // max(4, s_count) if s_count <= 32
                                                 else 1)


def test_kernel_plan_raises_on_other_state_counts():
    # every state count has an instance now: any outside 4-64 the block
    # instance (2 and 3 a column a lane, 32 columns a CTA; 5 and 7 eight
    # lanes a column, 4 columns a CTA; from 33 states one column a CTA); the
    # plan raises only where one column's scratch exceeds the card's memory
    for s_count in (2, 3):
        assert bk.kernel_plan(random_tables(s_count, 3), 96) == ("block", 32)
    for s_count, cols in ((5, 4), (7, 4), (128, 1), (256, 1), (1000, 1)):
        assert bk.kernel_plan(random_tables(s_count, 3), 96) == ("block", cols)
    assert bk.scratch_bytes(256, 96, 10) == 4 * 96 * 256 * 10
    big = 131072  # the cluster route's exchange goes to the scratch (4 P a column)
    assert bk.cluster_layout(big, 10)[3] == "global" and bk.block_layout(big)[5] == big
    assert bk.scratch_bytes(big, 96, 10) == 4 * (96 * big * 10 + 4 * big * 10)
    with pytest.raises(ValueError, match="card's memory"):  # 96 GB of beta history
        bk.kernel_plan(random_tables(4, 3), 6 * 10 ** 9)


# --------------------------------------------- the block instance on the CPU
#
# A numpy model of ``csrc/bcjr.cu bcjr_kernel_block`` and
# ``bcjr_kernel_thin``: forward to mid = Lw // 2 and backward to mid side
# by side, a step taking its metrics m = n - mx and its gathered ends v =
# n[at] - mx from the last update's values n (before normalisation) and
# their maximum mx, storing m in the history; then each direction on
# through the other half, the LLR of step t from the other's history row:
# forward (m + g_bw) + row[nxt], backward (row + g_bw) + v. The maxima over
# the states are taken on order-preserving uint32 keys (the kernel's
# redux.sync and its warps' partials), in no particular order. Held bit for
# bit against the twin.


def _keys_max(a, axis=0):
    u = np.asarray(a, np.float32).view(np.uint32)
    k = np.where(u & np.uint32(0x80000000), ~u, u | np.uint32(0x80000000)).max(axis=axis)
    return np.where(k & np.uint32(0x80000000), k & np.uint32(0x7fffffff), ~k).astype(
        np.uint32).view(np.float32)


def _block_model(ls, lp, lw, tables):
    idx, coef, _, _ = bk._host_tables(tables)
    nxt, prv = idx[0], idx[1]
    fw0, fw1, bw0, bw1 = coef
    s_count, n = nxt.shape[0], ls.shape[1]
    mid = lw // 2

    def g(c0, c1, t):  # [S, 2, N]
        return c0[:, :, None] * ls[t] + c1[:, :, None] * lp[t]

    def step(nv, at):  # the step's metrics and gathered ends
        mx = _keys_max(nv)
        return nv - mx, nv[at] - mx

    def update(v, gg):
        return np.maximum(v[:, 0] + gg[:, 0], v[:, 1] + gg[:, 1])

    def llr(c):
        return _keys_max(c[:, 0]) - _keys_max(c[:, 1])

    hist = np.empty((lw, s_count, n), np.float32)
    out = np.empty((lw, n), np.float32)
    nf = nb = np.zeros((s_count, n), np.float32)
    for t in range(mid):
        hist[t], v = step(nf, prv)
        nf = update(v, g(fw0, fw1, t))
    for t in range(lw - 1, mid - 1, -1):
        hist[t], v = step(nb, nxt)
        nb = update(v, g(bw0, bw1, t))
    for t in range(mid, lw):
        m, v = step(nf, prv)
        out[t] = llr((m[:, None] + g(bw0, bw1, t)) + hist[t][nxt])
        nf = update(v, g(fw0, fw1, t))
    for t in range(mid - 1, -1, -1):
        _, v = step(nb, nxt)
        gb = g(bw0, bw1, t)
        out[t] = llr((hist[t][:, None] + gb) + v)
        nb = update(v, gb)
    return out


def _model_case(s_count, lw, n, seed):
    """Random tables and spans rounded to 0.1 (ties between paths) with
    signed zeros among them; the model and the twin on them."""
    rng = np.random.default_rng(seed)
    tables = random_tables(s_count, 7 + s_count)
    ls, lp = (np.round(rng.normal(size=(lw, n)) * 2, 1).astype(np.float32) for _ in range(2))
    ls[0, 0] = lp[min(1, lw - 1), min(1, n - 1)] = -0.0
    got = _block_model(ls, lp, lw, tables)
    want = bk.bcjr_windowed_llr_reference(torch.from_numpy(ls), torch.from_numpy(lp), lw,
                                          tables)
    return got, want


@pytest.mark.parametrize("s_count", [2, 3, 5, 128, 300])
def test_block_model_matches_twin(s_count):
    got, want = _model_case(s_count, 23, 6, 40 + s_count)
    assert torch.equal(torch.from_numpy(got), want)


@pytest.mark.parametrize("s_count", [4, 64])
def test_block_model_past_the_lanes_limit(s_count):
    # the spans the lanes instance's shared memory does not hold (S 4 from
    # 1,209 steps, S 64 from 877) take the block instance
    lw = bk.lanes_span_limit(s_count) + 1
    assert bk.kernel_plan(random_tables(s_count, 7 + s_count), lw)[0] == "block"
    got, want = _model_case(s_count, lw, 3, 70 + s_count)
    assert torch.equal(torch.from_numpy(got), want)


@pytest.mark.parametrize("lw", [1, 2, 3])
@pytest.mark.parametrize("s_count", [3, 9])
def test_block_model_short_spans(s_count, lw):
    # the meeting point at its edges: no forward first half at Lw 1, no
    # backward second half below Lw 2
    got, want = _model_case(s_count, lw, 5, 80 + lw)
    assert torch.equal(torch.from_numpy(got), want)


@pytest.mark.parametrize("s_count", [2, 5, 33, 300, 1000, 1025, 2048, 9000, 131072])
def test_block_layout_covers_the_states(s_count):
    # the route's lanes, states a lane and warps hold every state, padded
    # to P, whole columns a warp, at most 4 warps a direction, and the
    # scratch is Lw x P floats a column of whole CTAs (past 1,024 states
    # over the q CTAs of a cluster, and the exchange's 4 P in its global
    # placement)
    route, r, lanes, warps, cols, p, q = bk.block_layout(s_count)
    if route == "cluster":
        q_, r_, w_, place, rl = bk.cluster_layout(s_count)
        assert s_count > bk.BLOCK_STATES and cols == 1 and lanes == 32
        assert (q, r, warps) == (q_, rl, w_) and 2 <= q <= bk.CLUSTER_MAX and warps in (3, 4)
        assert q * warps <= 32  # the partial keys a direction
        assert p == 32 * q * warps * r >= s_count > p - 32 * q * r
        assert (place == "registers") == (s_count <= bk.CLUSTER_REG_STATES)
        assert place == "registers" or (r_, warps, q) == (1, 4, bk.CLUSTER_MAX)
        assert bk.cluster_smem(r_, warps, place, p // q, q) <= 232448
        p77 = bk.block_layout(s_count, 77)[5]  # the scratch at 77 columns' geometry
        xg = 4 * p77 * 77 if place == "global" else 0
        assert p77 >= s_count and bk.scratch_bytes(s_count, 96, 77) == 4 * (96 * p77 * 77 + xg)
        return
    assert q == 1 and p >= s_count
    assert cols * p == (32 * r * warps if route == "block" else 32 * s_count)
    if route == "block":
        assert lanes * r * warps == p and lanes * cols == 32 and 1 <= warps <= 4
        assert p < 2 * s_count or p == 4
    lw = 96 if route == "block" else bk.thin_resident_span(s_count) + 1
    assert bk.scratch_bytes(s_count, lw, 77) == 4 * lw * p * cols * -(-77 // cols)
    if route == "thin":  # shorter spans stay in shared memory
        assert bk.scratch_bytes(s_count, lw - 1, 77) == 0


@pytest.mark.parametrize("s_count, n, layout", [
    (1025, 1, (8, 2, 3)), (1500, 7, (8, 2, 3)), (1500, 33, (4, 4, 3)), (1500, 34, (1, 8, 8)),
    (2048, 512, (1, 8, 8)), (3000, 20, (4, 8, 3)), (4096, 100, (4, 8, 4)), (8192, 1, (8, 8, 4))])
def test_cluster_layout_sizes_the_cluster_by_the_columns(s_count, n, layout):
    # few columns: clusters of up to 8 while the columns' CTAs fill at most
    # half the SMs; many: the fewest CTAs whose registers hold the tables,
    # or, where that is 2 at up to 2,048 states, the shared route's one CTA
    # of 8 warps a direction
    q, r, w = layout
    place = "shared" if q == 1 else "registers"
    assert bk.cluster_layout(s_count, n) == (q, r, w, place, r)
    assert 32 * q * r * w >= s_count and q * w <= 32
    if place == "registers":
        assert bk.cluster_smem(r, w, place, 32 * r * w, q) <= 232448
    assert bk.scratch_bytes(s_count, 96, n) == 4 * 96 * 32 * q * r * w * n


# ------------------------------------------- the cluster route on the CPU
#
# A numpy model of ``csrc/bcjr.cu bcjr_kernel_cluster``: a column's P = q SC
# padded states over q CTAs (state s in CTA s // SC at s % SC), W warps a
# direction of rl states a lane in each; a step's metrics gathered at a
# transition's other end from the CTA that updated it (owner, local: its
# own exchange in the global placement, every CTA's pushed copy in the
# registers placement hold the same floats); the state maximum from
# the q W warps' partial keys; padded states pointing at themselves with
# zero coefficients, holding -inf; the first half's metrics to the history
# rows [Lw][P], the second half's LLR terms forward (m + g_bw) + row[nxt],
# backward (row + g_bw) + v, their maxima from the warps' partials at rank
# 0. Held bit for bit against the twin.


def _cluster_model(ls, lp, lw, tables, q, w, rl):
    idx, coef, _, _ = bk._host_tables(tables)
    s_count, n = idx.shape[1], ls.shape[1]
    sc = 32 * w * rl
    p = q * sc
    assert p >= s_count
    states = np.arange(p)
    real = states < s_count

    def padded(a, fill):  # padded states: themselves, or zero coefficients
        out = np.zeros((p, 2), a.dtype) + np.asarray(fill, a.dtype).reshape(-1, 1)
        out[:s_count] = a
        return out

    nxt, prv = padded(idx[0], states), padded(idx[1], states)
    fw0, fw1, bw0, bw1 = (padded(c, np.float32(0)) for c in coef)
    warp = (states // sc) * w + (states % sc) // (32 * rl)  # a direction's key slot

    def g(c0, c1, t):  # [P, 2, N]
        return c0[:, :, None] * ls[t] + c1[:, :, None] * lp[t]

    def slot_max(v):  # the warps' partial keys, then their maximum
        parts = [_keys_max(v[warp == k]) for k in range(q * w)]
        return _keys_max(np.stack(parts))

    def gather(buf, a):  # [q, SC, N] exchange buffers: the owner's, at its local index
        return buf[a // sc, a % sc]

    hist = np.empty((lw, p, n), np.float32)
    out = np.empty((lw, n), np.float32)
    mid = lw // 2
    dirs = ((True, prv, fw0, fw1), (False, nxt, bw0, bw1))
    start = np.where(real[:, None], np.float32(0), np.float32(-np.inf)).astype(np.float32)
    nvs = [np.broadcast_to(start, (p, n)).copy() for _ in dirs]
    for half in (0, 1):  # each half of both directions (the meet between them)
        for d, (fwd, at, c0, c1) in enumerate(dirs):
            nv = nvs[d]
            if half == 0:
                ts = range(mid) if fwd else range(lw - 1, mid - 1, -1)
            else:
                ts = range(mid, lw) if fwd else range(mid - 1, -1, -1)
            for t in ts:
                mx = slot_max(nv)
                buf = nv.reshape(q, sc, n)
                m = nv - mx
                v = np.stack([gather(buf, at[:, 0]), gather(buf, at[:, 1])], axis=1) - mx
                gg = g(c0, c1, t)
                if half == 0:
                    hist[t] = m
                else:
                    if fwd:
                        c = (m[:, None] + g(bw0, bw1, t)) + hist[t][nxt]
                    else:
                        c = (hist[t][:, None] + gg) + v
                    k0, k1 = (_keys_max(np.stack([_keys_max(c[warp == k, u])
                                                  for k in range(q * w)])) for u in (0, 1))
                    out[t] = k0 - k1
                nv = np.maximum(v[:, 0] + gg[:, 0], v[:, 1] + gg[:, 1])
            nvs[d] = nv
    return out


def _cluster_geometry(s_count, q):
    """A cluster geometry ``(w, rl)`` at ``q`` CTAs: the registers
    placement's (the least R with 4 warps of 32 R states holding S / q) or,
    past 8 states a lane, 4 warps of rl states a lane."""
    sc = -(-s_count // q)
    for r in (1, 2, 4, 8):
        if 128 * r >= sc:
            return -(-sc // (32 * r)), r
    return 4, -(-sc // 128)


@pytest.mark.parametrize("q", [2, 4, 8])
@pytest.mark.parametrize("s_count", [300, 1025, 1500, 3000])
def test_cluster_model_matches_twin(s_count, q):
    w, rl = _cluster_geometry(s_count, q)
    rng = np.random.default_rng(90 + s_count + q)
    tables = random_tables(s_count, 11 + s_count)
    lw, n = 17, 3  # odd: one direction waits a barrier in each half
    ls, lp = (np.round(rng.normal(size=(lw, n)) * 2, 1).astype(np.float32) for _ in range(2))
    ls[0, 0] = lp[1, 1] = -0.0
    got = _cluster_model(ls, lp, lw, tables, q, w, rl)
    want = bk.bcjr_windowed_llr_reference(torch.from_numpy(ls), torch.from_numpy(lp), lw,
                                          tables)
    assert np.array_equal(got.view(np.uint32), want.numpy().view(np.uint32))


@pytest.mark.parametrize("s_count, n, lw", [(1500, 7, 1), (1500, 7, 2), (2048, 512, 6),
                                            (9000, 1, 5)])
def test_cluster_model_at_the_plan(s_count, n, lw):
    # the plan's own geometry (the registers placement at few and many
    # columns, the global one past 8,192 states) at the meeting point's
    # edges, ties with -0.0
    q, _, w, _, rl = bk.cluster_layout(s_count, n)
    ls, lp = _tie_spans(lw, 3, s_count + lw)
    tables = random_tables(s_count, 13 + s_count)
    got = _cluster_model(ls, lp, lw, tables, q, w, rl)
    want = bk.bcjr_windowed_llr_reference(torch.from_numpy(ls), torch.from_numpy(lp), lw,
                                          tables)
    assert np.array_equal(got.view(np.uint32), want.numpy().view(np.uint32))


class _CountingTables(tuple):
    hashes = 0

    def __hash__(self):
        type(self).hashes += 1
        return super().__hash__()


def test_a_call_hashes_its_tables_at_most_once():
    # the table set is found by the tables object's identity: no hashing
    # when a caller passes the same tables again, at any span (the instance
    # comes from the state count, kind and span), once for an equal new
    # object
    base = random_tables(1500, 5)
    tables = _CountingTables(base)
    ts = bk._tables_of(tables)
    assert ts.plan(96) == ("block", 1) and ts.s_count == 1500 and ts.kind == "generic"
    before = _CountingTables.hashes
    for lw in (96, 97, 224):
        assert bk._tables_of(tables) is ts
        assert bk.kernel_plan(tables, lw) == ("block", 1)
    assert _CountingTables.hashes == before
    again = _CountingTables(base)
    assert bk._tables_of(again) is ts  # equal tables: the cached table set
    assert _CountingTables.hashes == before + 1


def test_shared_route_takes_many_columns_to_2048_states():
    # past 1,024 states to 2,048, where the cluster would be 2 CTAs a column
    # (34 columns and more), one CTA a column of 8 warps a direction with
    # the tables in shared memory; fewer columns, and more states, take the
    # cluster route
    for s_count in (1025, 1500, 2048):
        for n in (34, 64, 512):
            assert bk.cluster_layout(s_count, n) == (1, 8, 8, "shared", 8)
            assert bk.block_layout(s_count, n) == ("shared", 8, 32, 8, 1, 2048, 1)
            assert bk.scratch_bytes(s_count, 224, n) == 4 * 224 * 2048 * n
        for n in (1, 7, 33):
            assert bk.block_layout(s_count, n)[0] == "cluster"
            assert bk.cluster_layout(s_count, n)[0] >= 4
    assert bk.block_layout(2049, 512)[0] == "cluster"
    assert bk.block_layout(1024, 512)[0] == "block"
    k12 = fec._conv_soft_coeffs((0o4335, 0o5723), 12)
    assert bk.kernel_plan(k12, 224) == ("block", 1)


@pytest.mark.parametrize("tables", ["k12", "random"])
@pytest.mark.parametrize("lw", [1, 2, 9])
def test_block_model_at_the_shared_route(tables, lw):
    # the block kernel's schedule (the shared route's: the same steps, its
    # coefficients from shared memory) at 2,048 states, the K 12 code and
    # random tables, at the meeting point's edges, ties with -0.0
    t = (fec._conv_soft_coeffs((0o4335, 0o5723), 12) if tables == "k12"
         else random_tables(2048, 17))
    ls, lp = _tie_spans(lw, 3, 2048 + lw)
    got = _block_model(ls, lp, lw, t)
    want = bk.bcjr_windowed_llr_reference(torch.from_numpy(ls), torch.from_numpy(lp), lw, t)
    assert np.array_equal(got.view(np.uint32), want.numpy().view(np.uint32))


def dyadic_tables(s_count, seed):
    """Random valid tables (:func:`random_tables`' structure) whose
    coefficients are 0 or +-2^e (-1 <= e <= 1): their products with the spans
    are exact, so a contracted multiply-add rounds as the separate ones do."""
    rng = np.random.default_rng(seed)
    coef = [rng.choice(np.array([-2.0, -1.0, -0.5, 0.0, 0.5, 1.0, 2.0]), size=(s_count, 2))
            for _ in range(4)]
    return random_tables(s_count, seed)[:2] + tuple(tuple(map(tuple, c.tolist()))
                                                    for c in coef)


def test_twin_matches_pallas_on_random_tables(jturbo):
    # a random trellis (not the shift-register pattern, S no power of two)
    # through the JAX package's Pallas kernel in interpret mode. Its XLA
    # CPU build contracts c0 ls + c1 lp into a fused multiply-add, so
    # coefficients whose products round (random_tables') differ from the
    # twin's separately rounded products in the last bits (ROADMAP.md §3);
    # dyadic ones do not. The twin's code takes every state count alike;
    # the JAX functions unroll the states, so past 1,024 states a call
    # costs minutes here: BCJR_PALLAS_STATES=1500 runs this body at the
    # cluster route's state count (PERF.md §7 gives its time)
    from aether_primitives_tpu.ops.pallas.bcjr import bcjr_windowed_llr

    tables = dyadic_tables(int(os.environ.get("BCJR_PALLAS_STATES", "40")), 7)
    rng = np.random.default_rng(8)
    lw, n = 15, 3
    ls, lp = (np.zeros((lw, 128), np.float32) for _ in range(2))
    for a in (ls, lp):
        a[:, :n] = np.round(rng.normal(size=(lw, n)) * 2, 1)
    got = bk.bcjr_windowed_llr_reference(torch.from_numpy(ls[:, :n].copy()),
                                         torch.from_numpy(lp[:, :n].copy()), lw, tables)
    want = np.asarray(bcjr_windowed_llr(ls, lp, lw, tables=tables, tile_n=128,
                                        interpret=True))[:, :n]
    assert np.array_equal(got.numpy().view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("k", sorted(SR_CODES))
def test_shift_gather_lanes_match_the_tables(k):
    # the lanes instance's shuffle form (csrc/bcjr.cu gather): the source
    # lane and slot of each transition's other end, by its formulas, against
    # the tables (state li + r L in lane li, slot r; 32 / L columns a warp)
    tables = fec._conv_soft_coeffs(SR_CODES[k], k)
    assert bk.shift_register(tables)
    idx = bk._host_tables(tables)[0]
    s_count = 1 << (k - 1)
    lanes = min(s_count, 32)
    m = np.arange(s_count, dtype=np.float32) + 100  # metric of state s
    slot = lambda lane, r: m[lane + r * lanes]  # noqa: E731
    for li in range(lanes):
        if s_count < 64:
            fwd = [[slot(li >> 1, 0), slot((li >> 1) + s_count // 2, 0)]]
            bwd = [[slot((2 * li) % s_count, 0), slot((2 * li + 1) % s_count, 0)]]
        else:
            l0, l1 = li >> 1, 16 + (li >> 1)
            fwd = [[slot(l0, 0), slot(l0, 1)], [slot(l1, 0), slot(l1, 1)]]
            hi = int(li >= 16)
            pair = [slot((2 * li) & 31, hi), slot((2 * li + 1) & 31, hi)]
            bwd = [pair, pair]
        for r in range(s_count // lanes):
            s = li + r * lanes
            assert fwd[r] == [m[idx[1, s, 0]], m[idx[1, s, 1]]]
            assert bwd[r] == [m[idx[0, s, 0]], m[idx[0, s, 1]]]
    for other in (None, random_tables(16, 2), random_tables(64, 2)):
        assert not bk.shift_register(other)


def _lanes_model(ls, lp, tables):
    """numpy model of ``bcjr_kernel_lanes``'s order of operations: forward
    to mid storing alpha_t, backward to mid storing beta_t, then each half's
    LLRs from the other's history; every maximum over all states at once
    (the kernel's lane maxima and warp reduction in another order).
    float32 throughout."""
    idx, coef, _, _ = bk._host_tables(tables)
    nxt, prev = idx[0], idx[1]
    fw0, fw1, bw0, bw1 = coef
    lw, n = ls.shape
    mid = lw // 2

    def g(c0, c1, t):  # [S, 2, N]
        return c0[:, :, None] * ls[t] + c1[:, :, None] * lp[t]

    def update(m, gg, at):
        v = np.maximum(m[at[:, 0]] + gg[:, 0], m[at[:, 1]] + gg[:, 1])
        return v - v.max(axis=0)

    def llr(a, bn, gb):
        return (((a + gb[:, 0]) + bn[:, 0]).max(axis=0)
                - ((a + gb[:, 1]) + bn[:, 1]).max(axis=0))

    zero = np.zeros((nxt.shape[0], n), np.float32)
    hist, out, a, b = [None] * lw, np.empty((lw, n), np.float32), zero, zero
    for t in range(mid):
        hist[t], a = a, update(a, g(fw0, fw1, t), prev)
    for t in range(lw - 1, mid - 1, -1):
        hist[t], b = b, update(b, g(bw0, bw1, t), nxt)
    for t in range(mid, lw):
        out[t] = llr(a, hist[t][nxt], g(bw0, bw1, t))
        a = update(a, g(fw0, fw1, t), prev)
    for t in range(mid - 1, -1, -1):
        gb = g(bw0, bw1, t)
        out[t] = llr(hist[t], b[nxt], gb)
        b = update(b, gb, nxt)
    return out


@pytest.mark.parametrize("lw", [1, 2, 3, 96, 97])
@pytest.mark.parametrize("code", ["k7", "k3", "random-16", "ties-k7"])
def test_lanes_schedule_equals_twin(lw, code):
    tables = {"k7": CONV_K7, "ties-k7": CONV_K7, "k3": fec._conv_soft_coeffs(SR_CODES[3], 3),
              "random-16": random_tables(16, 4)}[code]
    ls, lp = (_tie_spans(lw, 40, 50 + lw) if code.startswith("ties")
              else _spans(lw, 40, 50 + lw))
    want = bk.bcjr_windowed_llr_reference(torch.from_numpy(ls), torch.from_numpy(lp), lw,
                                          tables)
    got = _lanes_model(ls, lp, tables)
    assert np.array_equal(got.view(np.uint32), want.numpy().view(np.uint32))


@pytest.mark.parametrize("k", [5, 6, 7])
def test_windowed_conv_decode_twin_matches_jax_scan(k):
    # the port's windowed soft decode through the BCJR twin against the JAX
    # package's XLA scan of the same trellis (fec._conv_soft_windowed: the
    # turbo decoder's _bcjr_maxlog_windowed takes the RSC-8 trellis only)
    pytest.importorskip("jax")
    from aether_primitives_tpu.ops import fec as jfec

    rng = np.random.default_rng(60 + k)
    polys = SR_CODES[k]
    bits = rng.integers(0, 2, (2, 150)).astype(np.uint8)
    enc = fec.conv_encode(torch.from_numpy(bits), polys, k).numpy()
    llr = ((1 - 2.0 * enc) * 2 + 1.5 * rng.normal(size=enc.shape)).astype(np.float32)
    got = fec.conv_decode_soft(torch.from_numpy(llr), polys, k, window=32, guard=16,
                               backend="reference")
    want = jfec.conv_decode_soft(llr, polys, k, window=32, guard=16, backend="xla")
    assert np.array_equal(got.numpy(), np.asarray(want))


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
@pytest.mark.parametrize("s_count", [2, 3, 5, 128, 256, 1000])
def test_cuda_column_and_block_instances_match_twin(cuda, s_count):
    # the state counts outside 4-64, all in the block instance (2 and 3 a
    # column a lane), one launch a call
    rng = np.random.default_rng(90 + s_count)
    tables = random_tables(s_count, 11 + s_count)
    for lw, n in ((1, 3), (96, 77), (224, 257)):
        ls, lp = (torch.from_numpy((rng.normal(size=(lw, n)) * 3).astype(np.float32)).to(cuda)
                  for _ in range(2))
        before = bk.launches
        got = bk.bcjr_windowed_llr(ls, lp, lw, tables)
        want = bk.bcjr_windowed_llr_reference(ls, lp, lw, tables)
        torch.cuda.synchronize()
        assert bk.launches == before + 1
        assert torch.equal(got, want), (s_count, lw, n)


@pytest.mark.cuda
@pytest.mark.parametrize("s_count", [2, 3, 4, 5, 8, 9, 17, 33, 64, 100, 300, 600, 1025, 1500,
                                     2048])
def test_cuda_block_instance_every_route(cuda, s_count):
    # the block instance through its private entry at every route and
    # layout (thin, its spans and half-histories in shared memory or, at Lw
    # 500, through the scratch; a state a lane at 4-32 lanes a column; 2, 4
    # and 8 states a lane; 2-4 warps a direction; the cluster route past
    # 1,024 states), at the meeting point's edges (Lw 1-3), ragged N, ties
    # with -0.0
    tables = random_tables(s_count, 50 + s_count)
    for lw, n in ((1, 5), (2, 33), (3, 7), (97, 77), (224, 130), (500, 40)):
        make = _tie_spans if lw % 2 else _spans
        ls, lp = (torch.from_numpy(a).to(cuda) for a in make(lw, n, s_count + lw))
        out = torch.full((lw, n), float("nan"), device=cuda)
        before = bk.launches
        bk._launch_block(ls, lp, out, lw, tables)
        want = bk.bcjr_windowed_llr_reference(ls, lp, lw, tables)
        torch.cuda.synchronize()
        assert bk.launches == before + 1
        assert torch.equal(out, want), (s_count, lw, n)
        assert np.array_equal(out.cpu().numpy().view(np.uint32),
                              want.cpu().numpy().view(np.uint32))


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", [(2, 8, 3, "registers", 8), (4, 4, 3, "registers", 4),
                                      (8, 2, 3, "registers", 2), (8, 1, 4, "global", 2)],
                         ids=["q2", "q4", "q8", "global"])
def test_cuda_cluster_route_every_geometry(cuda, geometry):
    # the cluster route at S 1,500 forced into clusters of 2, 4 and 8 with
    # the tables in registers, and into its global placement (the tables
    # through L1, the exchange in the scratch)
    tables = random_tables(1500, 61)
    for lw, n in ((1, 5), (2, 3), (3, 7), (97, 9)):
        ls, lp = (torch.from_numpy(a).to(cuda) for a in _tie_spans(lw, n, lw + 1500))
        out = torch.full((lw, n), float("nan"), device=cuda)
        before = bk.launches
        bk._launch_block(ls, lp, out, lw, tables, cluster=geometry)
        want = bk.bcjr_windowed_llr_reference(ls, lp, lw, tables)
        torch.cuda.synchronize()
        assert bk.launches == before + 1
        assert np.array_equal(out.cpu().numpy().view(np.uint32),
                              want.cpu().numpy().view(np.uint32)), (geometry, lw, n)


@pytest.mark.cuda
@pytest.mark.parametrize("tables", ["k12", "random 2048", "random 1025"])
@pytest.mark.parametrize("n", [7, 64])
def test_cuda_shared_route_matches_twin(cuda, tables, n):
    # the shared route (one CTA a column, the tables in shared memory; 1,025
    # states padded to 2,048) forced at 7 columns and through the plan at
    # 64, at the meeting point's edges, ragged N, ties with -0.0
    t = (fec._conv_soft_coeffs((0o4335, 0o5723), 12) if tables == "k12"
         else random_tables(int(tables.split()[1]), 19))
    s_count = bk._tables_of(t).s_count
    geo = (1, *bk.SHARED_GEOMETRY, "shared", bk.SHARED_GEOMETRY[0])
    assert (bk.block_layout(s_count, n)[0] == "shared") == (n == 64)
    for lw in (1, 2, 3, 97, 224):
        ls, lp = (torch.from_numpy(a).to(cuda) for a in _tie_spans(lw, n, s_count + lw))
        out = torch.full((lw, n), float("nan"), device=cuda)
        before = bk.launches
        bk._launch_block(ls, lp, out, lw, t, cluster=geo)
        got = bk.bcjr_windowed_llr(ls, lp, lw, t)
        want = bk.bcjr_windowed_llr_reference(ls, lp, lw, t)
        torch.cuda.synchronize()
        assert bk.launches == before + 2
        for a in (out, got):
            assert np.array_equal(a.cpu().numpy().view(np.uint32),
                                  want.cpu().numpy().view(np.uint32)), (tables, n, lw)


@pytest.mark.cuda
def test_cuda_cluster_route_past_the_registers(cuda):
    # 9,000 states: the global placement of the plan (8 CTAs, 9 states a
    # lane), and a call hashes its tables at most once
    tables = _CountingTables(random_tables(9000, 62))
    assert bk.cluster_layout(9000, 3)[3] == "global"
    ls, lp = (torch.from_numpy(a).to(cuda) for a in _spans(40, 3, 90))
    got = bk.bcjr_windowed_llr(ls, lp, 40, tables)
    before = _CountingTables.hashes
    got = bk.bcjr_windowed_llr(ls, lp, 40, tables)
    assert _CountingTables.hashes == before
    want = bk.bcjr_windowed_llr_reference(ls, lp, 40, tables)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [2, 8, 9])
def test_cuda_conv_decode_soft_at_other_state_counts(cuda, k):
    polys = {2: (0o3, 0o1), 8: (0o247, 0o371), 9: (0o561, 0o753)}[k]
    bits, llrs = _conv_llrs(polys, k, 5, 300)
    x = torch.from_numpy(llrs).to(cuda)
    before = bk.launches
    got = fec.conv_decode_soft(x, polys, k, window=96, guard=64)
    want = fec.conv_decode_soft(x, polys, k, window=96, guard=64, backend="reference")
    torch.cuda.synchronize()
    assert bk.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_kernel_raises_past_the_card_memory(cuda, monkeypatch):
    # a card of 64 KB: the block instance's beta history (96 x 256 x 10
    # floats) does not fit, so the call raises; neither kernel nor twin runs
    ls = torch.zeros((96, 10), device=cuda)
    tables = random_tables(256, 5)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: types.SimpleNamespace(total_memory=1 << 16))
    before = bk.launches
    with pytest.raises(ValueError, match="card's memory"):
        bk.bcjr_windowed_llr(ls, ls, 96, tables)
    monkeypatch.undo()
    assert bk.launches == before


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
@pytest.mark.parametrize("k", sorted(SR_CODES))
@pytest.mark.parametrize("n", [77, 2570])
def test_cuda_lanes_instance_codes(cuda, k, n):
    tables = fec._conv_soft_coeffs(SR_CODES[k], k)
    ls, lp = (torch.from_numpy(a).to(cuda) for a in _spans(224, n, 14 + k))
    before = bk.launches
    got = bk.bcjr_windowed_llr(ls, lp, 224, tables)
    want = bk.bcjr_windowed_llr_reference(ls, lp, 224, tables)
    torch.cuda.synchronize()
    assert bk.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("s_count", bk.KERNEL_STATES)
def test_cuda_at_the_lanes_span_limit(cuda, s_count):
    # the last span the lanes instance takes and the first the block one does
    tables = random_tables(s_count, 30 + s_count)
    limit = bk.lanes_span_limit(s_count)
    for lw, instance in ((limit, "lanes"), (limit + 1, "block")):
        assert bk.kernel_plan(tables, lw)[0] == instance
        ls, lp = (torch.from_numpy(a).to(cuda) for a in _spans(lw, 37, lw))
        got = bk.bcjr_windowed_llr(ls, lp, lw, tables)
        want = bk.bcjr_windowed_llr_reference(ls, lp, lw, tables)
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
