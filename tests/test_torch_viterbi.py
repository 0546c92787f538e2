"""The port's Viterbi decoder against the JAX package's.

The plain twin ``viterbi_lanes_reference`` is held against the Pallas
kernel ``viterbi_lanes`` (interpret mode), and ``viterbi_decode`` against
JAX ``viterbi_decode(backend="xla")`` and ``backend="pallas_interpret"``:
full-block and windowed, batched and single, K=7 rate 1/2 and K=5 rate
1/3, on noisy soft LLRs and on hard +-1 LLRs (many exact ties). Hard
decisions with defined tie-breaks are exact in the reference, so every
comparison is ``np.array_equal``: no tolerance. The CUDA kernel is held
against the twin on a card (``cuda`` marker; skipped without one; run
with ``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_viterbi.py``).
"""

import types

import numpy as np
import pytest
import torch

from aether_primitives_tpu_torch.ops import fec
from aether_primitives_tpu_torch.ops.cuda import viterbi as vk

torch.set_num_threads(1)

K7 = ((0o171, 0o133), 7)
K5 = ((0o25, 0o33, 0o37), 5)
MODES = {"full": {}, "windowed": {"window": 64, "guard": 48}}


@pytest.fixture(scope="module")
def jfec():
    pytest.importorskip("jax")
    from aether_primitives_tpu.ops import fec as jax_fec

    return jax_fec


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _llrs(code, shape, seed, hard=False):
    """Encoded random bits as LLRs: ``3 (1 - 2 c) + N(0, 1)``, or hard
    ``+-1`` with 4% of the signs flipped."""
    polys, k = code
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, shape).astype(np.uint8)
    enc = fec.conv_encode(torch.from_numpy(bits), polys, k).numpy()
    if hard:
        flip = rng.random(enc.shape) < 0.04
        return bits, (1.0 - 2.0 * (enc ^ flip)).astype(np.float32)
    return bits, ((1 - 2.0 * enc) * 3 + rng.normal(size=enc.shape)).astype(np.float32)


@pytest.mark.parametrize("code", [K7, K5], ids=["k7r2", "k5r3"])
def test_conv_encode_matches_jax(jfec, code):
    polys, k = code
    bits = np.random.default_rng(1).integers(0, 2, (3, 200)).astype(np.uint8)
    for terminate in (True, False):
        got = fec.conv_encode(torch.from_numpy(bits), polys, k, terminate).numpy()
        want = np.stack([np.asarray(jfec.conv_encode(b, polys, k, terminate)) for b in bits])
        assert np.array_equal(got, want)
    assert fec._trellis(polys, k)[0].tobytes() == jfec._trellis(polys, k)[0].tobytes()
    assert fec._trellis(polys, k)[1].tobytes() == jfec._trellis(polys, k)[1].tobytes()


@pytest.mark.parametrize("hard", [False, True], ids=["soft", "hard"])
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("code", [K7, K5], ids=["k7r2", "k5r3"])
def test_viterbi_decode_matches_jax_scans(jfec, code, mode, hard):
    polys, k = code
    bits, llr = _llrs(code, (3, 300), 10 + k, hard)
    got = fec.viterbi_decode(torch.from_numpy(llr), polys, k, **MODES[mode]).numpy()
    assert got.dtype == np.uint8 and got.shape == bits.shape
    want = np.asarray(jfec.viterbi_decode(llr, polys, k, backend="xla", **MODES[mode]))
    assert np.array_equal(got, want)
    if not hard:
        assert np.array_equal(got, bits)
    # one stream (no leading axis) decodes as one row of the batch
    single = fec.viterbi_decode(torch.from_numpy(llr[1]), polys, k, **MODES[mode]).numpy()
    assert np.array_equal(single, want[1])


@pytest.mark.parametrize("mode", sorted(MODES))
def test_viterbi_decode_matches_the_pallas_kernel(jfec, mode):
    _, llr = _llrs(K7, (2, 400), 21, hard=True)
    got = fec.viterbi_decode(torch.from_numpy(llr), **MODES[mode]).numpy()
    want = np.asarray(jfec.viterbi_decode(llr, backend="pallas_interpret", **MODES[mode]))
    assert np.array_equal(got, want)


def test_unterminated_decode_matches_jax(jfec):
    _, llr = _llrs(K7, (2, 250), 22, hard=True)
    for kw in MODES.values():
        got = fec.viterbi_decode(torch.from_numpy(llr), terminated=False, **kw).numpy()
        want = np.asarray(jfec.viterbi_decode(llr, terminated=False, backend="xla", **kw))
        assert np.array_equal(got, want)


@pytest.mark.parametrize("ends", [(True, True), (True, False), (False, False)],
                         ids=["state0-state0", "state0-argmin", "uniform-argmin"])
@pytest.mark.parametrize("code", [K7, K5], ids=["k7r2", "k5r3"])
def test_twin_matches_viterbi_lanes_interpret(jfec, code, ends):
    from aether_primitives_tpu.ops.pallas.viterbi import viterbi_lanes

    polys, k = code
    n = len(polys)
    rng = np.random.default_rng(30 + k)
    lw, n_tr = 90, 200  # N not a multiple of the TPU's 128-lane tile
    sym = np.round(rng.normal(size=(n_tr, lw, n)) * 2).astype(np.float32)  # ties
    got = vk.viterbi_lanes_reference(torch.from_numpy(sym), lw, n, polys, k, *ends).numpy()
    lanes = np.zeros((lw, n, 256), np.float32)
    lanes[:, :, :n_tr] = sym.transpose(1, 2, 0)
    want = np.asarray(viterbi_lanes(lanes, lw, n, polys, k, *ends, tile_n=128,
                                    interpret=True))[:, :n_tr].T
    assert np.array_equal(got, want.astype(np.uint8))
    # the wrapper runs the twin for a CPU tensor
    assert np.array_equal(vk.viterbi_lanes(torch.from_numpy(sym), lw, n, polys, k,
                                           *ends).numpy(), got)


def test_reference_backend_and_unknown_backends():
    _, llr = _llrs(K7, (2, 100), 40)
    x = torch.from_numpy(llr)
    assert torch.equal(fec.viterbi_decode(x, backend="reference"), fec.viterbi_decode(x))
    for bad in ("xla", "pallas", "pallas_interpret", "bogus"):
        with pytest.raises(ValueError, match="unknown backend"):
            fec.viterbi_decode(x, backend=bad)


def test_kernel_limits():
    assert vk.kernel_supports(638, 2, 7)
    assert vk.kernel_supports(160, 3, 5)
    assert vk.kernel_supports(29_000, 2, 7)  # one trellis per block
    assert vk.kernel_supports(30_000, 2, 7)  # the history in a device scratch
    assert vk.kernel_supports(2 ** 20, 2, 7)
    # every code: 2 states in the warp instance, more than 256 states or 8
    # generators in the block instance; the limit is the card's memory
    assert vk.kernel_supports(100, 2, 2) and vk.instance(2, 2) == "warp"
    assert vk.kernel_supports(100, 2, 10) and vk.instance(2, 10) == "block"  # 512 states
    assert vk.kernel_supports(100, 9, 7) and vk.instance(9, 7) == "block"  # 9 generators
    # the cluster route keeps a trellis's decisions in shared memory where
    # they fit (K 15 and 17 over 3 spans: clusters of 8), else the scratch
    assert vk.kernel_supports(100, 2, 15) and vk.scratch_words(100, 15, 3) == 0
    assert vk.scratch_words(100, 17, 3) == 0
    assert vk.scratch_words(100, 15, 256) == 256 * 100 * 512  # one CTA a span: past it
    # past CLUSTER_MAX_STATES the grid route: the path metrics, three keys
    # and the first argmin a trellis join the decisions in the scratch
    assert vk.scratch_words(100, 19, 3) == 3 * (100 * 8192 + 2 * 262144 + 4)
    assert not vk.kernel_supports(2 ** 20, 2, 30)  # 8 TB of decisions
    assert not vk.kernel_supports(100, 2, 1)  # no trellis
    with pytest.raises(ValueError, match="bad span shape"):
        vk.viterbi_lanes_reference(torch.zeros(2, 10, 3), 10, 2, K7[0], 7, True, True)
    with pytest.raises(TypeError):
        vk.viterbi_lanes(torch.zeros(2, 10, 2, dtype=torch.float64), 10, 2, K7[0], 7,
                         True, True)


# ------------------------------------------------------------ on the card


@pytest.mark.cuda
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("code", [K7, K5], ids=["k7r2", "k5r3"])
def test_cuda_kernel_matches_twin(cuda, code, mode):
    polys, k = code
    bits, llr = _llrs(code, (37, 500), 50 + k)
    x = torch.from_numpy(llr).to(cuda)
    before = vk.launches
    got = fec.viterbi_decode(x, polys, k, **MODES[mode])
    plain = fec.viterbi_decode(x, polys, k, backend="reference", **MODES[mode])
    torch.cuda.synchronize()
    assert vk.launches == before + 1
    assert np.array_equal(got.cpu().numpy(), plain.cpu().numpy())
    assert np.array_equal(got.cpu().numpy(), bits)


@pytest.mark.cuda
def test_cuda_kernel_matches_twin_on_ties_and_every_state_count(cuda):
    rng = np.random.default_rng(60)
    for k in range(3, 10):
        polys = tuple(int(p) for p in rng.integers(1 << (k - 1), 1 << k, 2))
        sym = torch.from_numpy(np.round(rng.normal(size=(45, 120, 2)) * 2)
                               .astype(np.float32)).to(cuda)
        for ends in ((True, True), (False, False)):
            got = vk.viterbi_lanes(sym, 120, 2, polys, k, *ends)
            want = vk.viterbi_lanes_reference(sym, 120, 2, polys, k, *ends)
            assert torch.equal(got, want), (k, ends)


@pytest.mark.cuda
def test_cuda_kernel_raises_on_spans_it_does_not_take(cuda, monkeypatch):
    before = vk.launches
    # past the card's memory (a card of 64 KB here): the call raises, and
    # neither the kernel nor the twin runs
    sym = torch.zeros(16, 10_000, 2, device=cuda)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: types.SimpleNamespace(total_memory=1 << 16))
    # 512 states over 10,000 steps: 640 KB of decisions a trellis, past shared
    # memory, in the scratch
    with pytest.raises(ValueError, match="card's memory"):
        vk.viterbi_lanes(sym, 10_000, 2, (0o1171, 0o1233), 10, True, True)
    monkeypatch.undo()
    with pytest.raises(ValueError, match="contiguous"):
        vk.viterbi_lanes(torch.zeros(10, 4, 2, device=cuda).transpose(0, 1), 10, 2,
                         K7[0], 7, True, True)
    assert vk.launches == before


# --------------------------------------------- the kernel's schedule on the CPU
#
# A numpy model of ``csrc/viterbi.cu``: float32 branch metrics in the
# kernel's order, decisions packed into S/32 ballot words a step (state s at
# word s >> 5, bit s & 31), the minimum over the states taken on
# order-preserving uint32 keys (the kernel's redux.sync), the first argmin
# by the smallest state index at the minimum key, and the traceback from the
# last step down in groups of 8 steps whose words are read first. Held bit
# for bit against the twin and, through ``viterbi_decode``, against JAX.

CODES = {
    "k3r2": ((0o5, 0o7), 3), "k3r3": ((0o5, 0o7, 0o7), 3),
    "k5r2": ((0o23, 0o35), 5), "k5r3": K5,
    "k7r2": K7, "k7r3": ((0o133, 0o145, 0o175), 7),
    "k9r2": ((0o561, 0o753), 9), "k9r3": ((0o557, 0o663, 0o711), 9),
}


def _keys(f):
    u = np.asarray(f, np.float32).view(np.uint32)
    return np.where(u & np.uint32(0x80000000), ~u, u | np.uint32(0x80000000))


def _unkeys(k):
    k = np.asarray(k, np.uint32)
    return np.where(k & np.uint32(0x80000000), k & np.uint32(0x7FFFFFFF), ~k).view(np.float32)


def kernel_model(sym, lw, n, polys, k, init_state0, end_state0):
    """``sym [N, Lw, n]`` float32 -> uint8 bits ``[N, Lw]`` as the kernel
    computes them."""
    sym = np.asarray(sym, np.float32)
    pred, _ = fec._trellis(tuple(polys), k)
    s_count = 1 << (k - 1)
    masks = vk._out_masks(tuple(polys), k).reshape(s_count, 2)
    one = lambda b: np.where(b, np.float32(1.0), np.float32(0.0))  # noqa: E731
    n_tr = sym.shape[0]
    pm = np.zeros((n_tr, s_count), np.float32)
    if init_state0:
        pm[:, 1:] = np.float32(1e9)
    words = np.zeros((lw, n_tr, max(1, s_count // 32)), np.uint64)
    states = np.arange(s_count)
    for t in range(lw):
        g = []
        for j in (0, 1):
            acc = one(masks[:, j] & 1) * sym[:, t, 0:1]
            for m in range(1, n):
                acc = acc + one((masks[:, j] >> m) & 1) * sym[:, t, m:m + 1]
            g.append(acc)
        c0 = pm[:, pred[:, 0]] + g[0]
        c1 = pm[:, pred[:, 1]] + g[1]
        d = c1 < c0
        nw = np.where(d, c1, c0)
        for s in states:  # the ballot words
            words[t, :, s >> 5] |= d[:, s].astype(np.uint64) << np.uint64(s & 31)
        mn = _unkeys(_keys(nw).min(axis=1))
        pm = nw - mn[:, None]
    if end_state0:
        state = np.zeros(n_tr, np.int64)
    else:
        mn = _unkeys(_keys(pm).min(axis=1))
        state = np.where(pm == mn[:, None], states, s_count).min(axis=1)
    bits = np.zeros((n_tr, lw), np.uint8)
    rows = np.arange(n_tr)

    def step(t, word):
        nonlocal state
        bits[:, t] = state & 1
        d = (word >> (state & 31).astype(np.uint64)) & np.uint64(1)
        state = (state >> 1) | (d.astype(np.int64) << (k - 2))

    t = lw - 1
    while t >= 7:  # groups of 8 steps (the kernel reads a group's words first)
        group = words[t - 7:t + 1][::-1]  # steps t, t-1, ..., t-7
        for i in range(8):
            step(t - i, group[i][rows, state >> 5])
        t -= 8
    for t in range(t, -1, -1):  # the remainder, one step at a time
        step(t, words[t, rows, state >> 5])
    return bits


def _tie_llrs(rng, shape):
    """Integer-valued LLRs (many exact ties) with half of the zeros -0.0."""
    x = np.round(rng.normal(size=shape) * 1.5).astype(np.float32)
    x[(x == 0) & (rng.random(shape) < 0.5)] = -0.0
    return x


def test_key_order_is_the_float_order():
    vals = np.array([-1e9, -3.5, -1.0, -1e-30, -0.0, 0.0, 1e-30, 1.0, 2.0, 1e9, np.inf,
                     -np.inf], np.float32)
    keys = _keys(vals)
    order = np.argsort(keys, kind="stable")
    assert np.array_equal(np.sort(vals, kind="stable")[1:], vals[order][1:])  # -0 before +0
    assert np.array_equal(_unkeys(keys).view(np.uint32), vals.view(np.uint32))
    assert keys[vals.tolist().index(-0.0)] < keys[5]


@pytest.mark.parametrize("ends", [(True, True), (True, False), (False, False)],
                         ids=["state0-state0", "state0-argmin", "uniform-argmin"])
@pytest.mark.parametrize("code", sorted(CODES))
def test_kernel_model_matches_twin_on_ties(code, ends):
    polys, k = CODES[code]
    n = len(polys)
    rng = np.random.default_rng(70 + k + n)
    lw = 37  # four groups of 8 and a remainder of 5
    sym = _tie_llrs(rng, (9, lw, n))
    want = vk.viterbi_lanes_reference(torch.from_numpy(sym), lw, n, polys, k, *ends).numpy()
    assert np.array_equal(kernel_model(sym, lw, n, polys, k, *ends), want)


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("code", sorted(CODES))
def test_kernel_model_decode_matches_jax(jfec, monkeypatch, code, mode):
    polys, k = CODES[code]
    rng = np.random.default_rng(80 + k)
    bits, llr = _llrs((polys, k), (2, 150), 90 + k, hard=True)
    llr[rng.random(llr.shape) < 0.05] = -0.0  # exact ties on -0.0
    monkeypatch.setattr(vk, "viterbi_lanes", lambda sym, *a: torch.from_numpy(
        kernel_model(sym.numpy(), *a)))
    got = fec.viterbi_decode(torch.from_numpy(llr), polys, k, **MODES[mode]).numpy()
    want = np.asarray(jfec.viterbi_decode(llr, polys, k, backend="xla", **MODES[mode]))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("code", sorted(CODES))
def test_kernel_span_limit_is_the_decision_history(code):
    # the LLRs take no shared memory: one trellis a block holds max(1, S/32)
    # decision words a step, whatever the rate
    polys, k = CODES[code]
    n = len(polys)
    limit = vk.MAX_SMEM // (4 * max(1, (1 << (k - 1)) // 32))
    assert limit == {3: 58_112, 5: 58_112, 7: 29_056, 9: 7_264}[k]
    assert vk.kernel_supports(limit, n, k)
    assert vk.kernel_supports(limit + 1, n, k)  # past it, the device scratch
    assert vk.scratch_words(limit, k, 3) == 0
    assert vk.scratch_words(limit + 1, k, 3) == 3 * (limit + 1) * max(1, (1 << (k - 1)) // 32)
    assert vk.warps_per_block(limit, k) == 1
    assert vk.warps_per_block(limit + 1, k) is None
    assert vk.warps_per_block(limit // 4, k) == 4


@pytest.mark.cuda
@pytest.mark.parametrize("code", ["k5r2", "k7r3"])
def test_cuda_kernel_at_the_span_limit(cuda, code):
    polys, k = CODES[code]
    n = len(polys)
    lw = {5: 58_000, 7: 29_000}[k]
    rng = np.random.default_rng(110 + k)
    sym = np.round(rng.normal(size=(2, lw, n)) * 2).astype(np.float32)
    got = vk.viterbi_lanes(torch.from_numpy(sym).to(cuda), lw, n, polys, k, True, False)
    want = vk.viterbi_lanes_reference(torch.from_numpy(sym), lw, n, polys, k, True, False)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("lw", [29_057, 65_536])
@pytest.mark.parametrize("code", ["k5r2", "k7r2", "k9r3"])
def test_cuda_kernel_past_the_span_limit(cuda, code, lw):
    # a full block whose decision history does not fit shared memory: one
    # launch, the histories in the device scratch, equal to the twin
    polys, k = CODES[code]
    n = len(polys)
    assert vk.scratch_words(lw, k, 2) > 0 or k < 7
    rng = np.random.default_rng(120 + k + lw)
    sym = _tie_llrs(rng, (2, lw, n))
    before = vk.launches
    got = vk.viterbi_lanes(torch.from_numpy(sym).to(cuda), lw, n, polys, k, True, False)
    torch.cuda.synchronize()
    assert vk.launches == before + 1
    want = vk.viterbi_lanes_reference(torch.from_numpy(sym), lw, n, polys, k, True, False)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("code", sorted(CODES))
def test_cuda_kernel_every_launch_shape_on_ties(cuda, code):
    # exact ties and -0.0 at every block width the wrapper takes (WARPS),
    # a ragged last block, both starts and ends
    polys, k = CODES[code]
    n = len(polys)
    rng = np.random.default_rng(100 + k + n)
    for lw, n_tr in ((638, 37), (160, 21), (1, 3), (9, 5)):
        sym = torch.from_numpy(_tie_llrs(rng, (n_tr, lw, n))).to(cuda)
        for ends in ((True, True), (False, False), (True, False)):
            want = vk.viterbi_lanes_reference(sym, lw, n, polys, k, *ends)
            assert np.array_equal(kernel_model(sym.cpu().numpy(), lw, n, polys, k, *ends),
                                  want.cpu().numpy())
            for warps in vk.WARPS:
                got = torch.full_like(want, 7)
                vk.launch(sym, got, lw, n, polys, k, *ends, warps)
                assert torch.equal(got, want), (lw, ends, warps)


# ------------------------------------- the block instance's schedule on the CPU
#
# A numpy model of ``csrc/viterbi.cu viterbi_cta_kernel`` (the block
# instance's cluster route): the states split by range over the q CTAs of a
# trellis, each CTA's two metric buffers holding a step's metrics before the
# subtraction of their minimum, which the next step subtracts as it reads
# them; a thread a pair of states (2i, 2i + 1) reading predecessors i and i
# + S/2 from the CTA that holds them; the branch metrics of every output
# pattern a step (at most 8 generators; by the transition's byte) or of each
# transition from its ceil(n / 32) mask words; the decisions packed from the
# warps' even and odd ballots (``_spread16``); the first argmin the first
# state whose buffered metric equals the minimum; the traceback five steps
# a round from 31 candidate words. Held bit for bit against the twin at
# codes the warp instance does not take, at every cluster size.

BLOCK_CODES = {
    "k2r2": ((0o3, 0o1), 2), "k10r2": ((0o1171, 0o1233), 10), "k11r2": ((0o2467, 0o3565), 11),
    "k12r2": ((0o4335, 0o5723), 12), "k15r2": ((0o46321, 0o51271), 15),
    "k7r9": ((0o171, 0o133, 0o165, 0o117, 0o127, 0o155, 0o135, 0o147, 0o173), 7),
    "k3r33": (tuple([0o7, 0o5, 0o3] * 11), 3),
    # 512 distinct output patterns: each transition's own branch metric
    "k10r10": ((0o1171, 0o1233, 0o1365, 0o1047, 0o1523, 0o1711, 0o1357, 0o1131, 0o1463,
                0o1275), 10),
}


def _spread16(x):
    x = x & np.uint64(0xFFFF)
    for sh, mask in ((8, 0x00FF00FF), (4, 0x0F0F0F0F), (2, 0x33333333), (1, 0x55555555)):
        x = (x | (x << np.uint64(sh))) & np.uint64(mask)
    return x


def block_model(sym, lw, n, polys, k, init_state0, end_state0, q=None):
    sym = np.asarray(sym, np.float32)
    n_tr = sym.shape[0]
    s_count = 1 << (k - 1)
    q = q or vk.block_plan(lw, n, k, n_tr)["q"]
    sc, pc = s_count // q, s_count // q // 2
    one = lambda b: np.where(b, np.float32(1.0), np.float32(0.0))  # noqa: E731
    npat, codes = vk.patterns(tuple(polys), k)  # the card's table
    table = npat <= vk.MAX_PATTERNS
    if table:  # a pattern byte a transition row, then the patterns' bits
        nwords = -(-2 * s_count // 4)
        rows = codes[:nwords].view(np.uint8)[:2 * s_count].astype(np.int64)
        words_in = codes[nwords:].reshape(npat, -1).astype(np.uint64)
    else:
        words_in = codes.reshape(2 * s_count, -1).astype(np.uint64)
    bufs = np.zeros((2, q, n_tr, sc), np.float32)  # [buffer, rank, trellis, state]
    if init_state0:
        bufs[0, :, :, :] = np.float32(1e9)
        bufs[0, 0, :, 0] = 0.0
    mn = np.zeros(n_tr, np.float32)
    n_words = max(1, s_count // 32)
    words = np.zeros((lw, n_tr, n_words), np.uint64)
    lanes = np.uint64(1) << np.arange(32, dtype=np.uint64)
    for t in range(lw):
        lt = sym[:, t, :]
        # the step's metric of every pattern (or transition row), m in order
        g = one(words_in[:, 0] & np.uint64(1))[None, :] * lt[:, 0:1]
        for m in range(1, n):
            bit = (words_in[:, m // 32] >> np.uint64(m % 32)) & np.uint64(1)
            g = g + one(bit)[None, :] * lt[:, m:m + 1]
        if table:
            g = g[:, rows]
        rd = t & 1
        for rank in range(q):
            g0, g1 = rank * pc, rank * pc + s_count // 2
            u = np.arange(pc)
            i = g0 + u
            a0 = bufs[rd, g0 // sc][:, g0 % sc + u] - mn[:, None]
            a1 = bufs[rd, g1 // sc][:, g1 % sc + u] - mn[:, None]
            c0e, c1e = a0 + g[:, 4 * i], a1 + g[:, 4 * i + 1]
            c0o, c1o = a0 + g[:, 4 * i + 2], a1 + g[:, 4 * i + 3]
            de, dodd = c1e < c0e, c1o < c0o
            out = bufs[rd ^ 1, rank]
            out[:, 0::2] = np.where(de, c1e, c0e)
            out[:, 1::2] = np.where(dodd, c1o, c0o)
            for base in range(0, pc, 32):  # a warp's 32 pairs: two words
                e = (de[:, base:base + 32].astype(np.uint64) * lanes[:min(32, pc - base)]).sum(1)
                o = (dodd[:, base:base + 32].astype(np.uint64) * lanes[:min(32, pc - base)]).sum(1)
                for lane in range(2):
                    if base + 16 * lane < pc:
                        half_e = e & np.uint64(0xFFFF) if lane == 0 else e >> np.uint64(16)
                        half_o = o & np.uint64(0xFFFF) if lane == 0 else o >> np.uint64(16)
                        words[t, :, (g0 + base) // 16 + lane] = (
                            _spread16(half_e) | (_spread16(half_o) << np.uint64(1)))
        mn = _unkeys(_keys(bufs[rd ^ 1].transpose(1, 0, 2).reshape(n_tr, -1)).min(axis=1))
    fin = bufs[lw & 1].transpose(1, 0, 2).reshape(n_tr, -1)
    states = np.arange(s_count)
    if end_state0:
        state = np.zeros(n_tr, np.int64)
    else:
        state = np.where(fin == mn[:, None], states, s_count).min(axis=1)
    return _trace5(words, state, k, lw)


def _trace5(words, state, k, lw):
    """The block instance's traceback from ``state`` over the decision
    words ``[lw, N, words]``: five steps a round, the candidates' words
    loaded first (lane l: the candidate j = floor(log2(l + 1)) steps back
    whose decisions on the way are the bits of l + 1 - 2^j)."""
    n_tr = state.shape[0]
    bits = np.zeros((n_tr, lw), np.uint8)
    rows_ = np.arange(n_tr)
    lane = np.arange(31)
    lj = np.floor(np.log2(lane + 1)).astype(np.int64)
    lb = lane + 1 - (1 << lj)
    t = lw - 1
    while t >= 0:  # a round: the candidates' words, then five steps by them
        steps = min(5, t + 1)
        cand = np.zeros((n_tr, 31), np.uint64)
        for ln in range(2 ** steps - 1):
            st = state.copy()
            for i in range(lj[ln]):
                st = (st >> 1) | (((lb[ln] >> i) & 1) << (k - 2))
            cand[:, ln] = words[t - lj[ln], rows_, st >> 5]
        taken = np.zeros(n_tr, np.int64)
        for j in range(steps):
            w = cand[rows_, (1 << j) - 1 + taken]
            bits[:, t - j] = state & 1
            b = ((w >> (state & 31).astype(np.uint64)) & np.uint64(1)).astype(np.int64)
            state = (state >> 1) | (b << (k - 2))
            taken |= b << j
        t -= steps
    return bits


@pytest.mark.parametrize("ends", [(True, True), (True, False), (False, False)],
                         ids=["state0-state0", "state0-argmin", "uniform-argmin"])
@pytest.mark.parametrize("code", sorted(BLOCK_CODES))
def test_block_model_matches_twin_on_ties(code, ends):
    # the plan's cluster size for 4 spans and every other one a CTA keeps
    # 64 states or more at
    polys, k = BLOCK_CODES[code]
    n = len(polys)
    assert vk.instance(n, k) == ("warp" if k == 2 else "block")
    rng = np.random.default_rng(170 + k + n)
    lw = 21
    sym = _tie_llrs(rng, (4, lw, n))
    want = vk.viterbi_lanes_reference(torch.from_numpy(sym), lw, n, polys, k, *ends).numpy()
    plan = vk.block_plan(lw, n, k, 4, vk.patterns(polys, k)[0])
    assert plan["q"] == {12: 2, 15: 8}.get(k, 1) and plan["dec_smem"]
    assert (vk.patterns(polys, k)[0] > vk.MAX_PATTERNS) == (code == "k10r10")
    for q in sorted({plan["q"]} | {q for q in (2, 8) if (1 << (k - 1)) // q >= 64}):
        assert np.array_equal(block_model(sym, lw, n, polys, k, *ends, q=q), want), q


@pytest.mark.parametrize("k, n, q", [(3, 800, 1), (3, 900, None), (2, 2000, None),
                                     (18, 380, 8), (18, 400, None), (8, 700, 1)])
def test_block_plan_takes_the_scratch_route_where_a_cta_does_not_fit(k, n, q):
    # a CTA stages two chunks of LLRs, 256 bytes a generator, which no
    # cluster size divides: past the shared memory the grid route, whose
    # kernel takes any n, with its metrics, keys and first argmins in the
    # scratch
    plan = vk.block_plan(100, n, k, 4)
    assert (plan and plan["q"]) == q
    if plan is not None:
        sc = (1 << (k - 1)) // q
        assert vk._cta_smem(1 << (k - 1), n, q, vk.CTA_THREADS, 100, False) <= vk.CTA_SMEM
        assert q == 1 or sc >= 64
    assert vk.kernel_supports(100, n, k) and vk.instance(n, k) == "block"
    words = 4 * 100 * max(1, (1 << (k - 1)) // 32)
    assert vk.scratch_words(100, k, 4, n) == (
        words + 4 * 2 * (1 << (k - 1)) + 4 * 4 if plan is None
        else (0 if plan["dec_smem"] else words))


# -------------------------------------- the block instance's grid route on the CPU
#
# A numpy model of ``csrc/viterbi.cu viterbi_grid_kernel``: a batch's
# decision words (units of min(S, 32) states, U = min(S/2, 16) pairs) split
# in ragged ranges over G CTAs (CTA b takes [b T_u / G, (b + 1) T_u / G)), a
# thread a pair (2i, 2i + 1) from the unit's trellis and word; the two metric
# buffers a trellis holding the step's metrics before the subtraction of
# their minimum; every transition row's metric from its output bits (the
# kernel's pattern table holds the same floats); the minimum a trellis over
# every CTA's keys; each unit's decision word from its U pairs' ballots;
# the first argmin and the five-step traceback. Trellises past ``batch`` go
# in turn. Held bit for bit against the twin with ties and -0.0.

GRID_CODES = {
    "k8r2": ((0o247, 0o371), 8), "k10r2": ((0o1171, 0o1233), 10),
    "k12r2": ((0o4335, 0o5723), 12), "k2r2": ((0o3, 0o1), 2),
    # many generators: 40 (patterns in the table), 33 (two mask words)
    "k9r40": (tuple(0o400 + 7 * i for i in range(40)), 9),
    "k3r33": (tuple([0o7, 0o5, 0o3] * 11), 3),
    # 512 distinct output patterns: each transition's own output bits
    "k10r10": BLOCK_CODES["k10r10"],
}


def grid_model(sym, lw, n, polys, k, init_state0, end_state0, ctas, batch=None):
    sym = np.asarray(sym, np.float32)
    n_tr = sym.shape[0]
    s_count = 1 << (k - 1)
    p_half, ws = s_count // 2, max(1, s_count // 32)
    u = min(p_half, 16)
    batch = batch or vk.GRID_BATCH
    one = lambda b: np.where(b, np.float32(1.0), np.float32(0.0))  # noqa: E731
    npat, codes = vk.patterns(tuple(polys), k)  # the card's table
    if npat <= vk.MAX_PATTERNS:  # a row's bits through its pattern byte
        nwords = -(-2 * s_count // 4)
        ids = codes[:nwords].view(np.uint8)[:2 * s_count].astype(np.int64)
        rows = codes[nwords:].reshape(npat, -1)[ids].astype(np.uint64)
    else:
        rows = codes.reshape(2 * s_count, -1).astype(np.uint64)
    bits = np.zeros((n_tr, lw), np.uint8)
    lanes = np.uint64(1) << np.arange(u, dtype=np.uint64)
    for b0 in range(0, n_tr, batch):
        nb = min(batch, n_tr - b0)
        units = nb * ws
        g_ctas = min(ctas, units)
        y = sym[b0:b0 + nb]
        pm = np.zeros((2, nb, s_count), np.float32)
        mn = np.zeros(nb, np.float32)
        words = np.zeros((lw, nb, ws), np.uint64)
        for t in range(lw):
            g = one(rows[:, 0] & np.uint64(1))[None, :] * y[:, t, 0:1]
            for m in range(1, n):
                bit = (rows[:, m // 32] >> np.uint64(m % 32)) & np.uint64(1)
                g = g + one(bit)[None, :] * y[:, t, m:m + 1]
            rd = t & 1
            keys = np.full(nb, 0xFFFFFFFF, np.uint64)
            for b in range(g_ctas):  # a CTA's ragged range of words
                u0, u1 = b * units // g_ctas, (b + 1) * units // g_ctas
                j = np.arange((u1 - u0) * u)
                f = u0 + j // u
                tr, wd = f // ws, f % ws
                i = wd * u + j % u
                if t == 0:
                    a0 = np.where(init_state0 & (i != 0), np.float32(1e9), np.float32(0))
                    a1 = np.full(i.shape, np.float32(1e9 if init_state0 else 0))
                else:
                    a0, a1 = pm[rd, tr, i], pm[rd, tr, i + p_half]
                a0, a1 = a0 - mn[tr], a1 - mn[tr]
                c0e, c1e = a0 + g[tr, 4 * i], a1 + g[tr, 4 * i + 1]
                c0o, c1o = a0 + g[tr, 4 * i + 2], a1 + g[tr, 4 * i + 3]
                de, dodd = c1e < c0e, c1o < c0o
                ne, no = np.where(de, c1e, c0e), np.where(dodd, c1o, c0o)
                pm[rd ^ 1, tr, 2 * i], pm[rd ^ 1, tr, 2 * i + 1] = ne, no
                np.minimum.at(keys, tr, np.minimum(_keys(ne), _keys(no)).astype(np.uint64))
                half_e = (de.reshape(-1, u).astype(np.uint64) * lanes).sum(1)
                half_o = (dodd.reshape(-1, u).astype(np.uint64) * lanes).sum(1)
                words[t, tr[::u], wd[::u]] = _spread16(half_e) | (_spread16(half_o) << np.uint64(1))
            mn = _unkeys(keys.astype(np.uint32))
        fin = pm[lw & 1]
        if end_state0:
            state = np.zeros(nb, np.int64)
        else:
            state = np.where(fin == mn[:, None], np.arange(s_count), s_count).min(axis=1)
        bits[b0:b0 + nb] = _trace5(words, state, k, lw)
    return bits


@pytest.mark.parametrize("ctas, batch", [(3, None), (4, None), (5, 3)],
                         ids=["3ctas", "4ctas", "5ctas-batches"])
@pytest.mark.parametrize("ends", [(True, True), (True, False), (False, False)],
                         ids=["state0-state0", "state0-argmin", "uniform-argmin"])
@pytest.mark.parametrize("code", sorted(GRID_CODES))
def test_grid_model_matches_twin_on_ties(code, ends, ctas, batch):
    # the grid route forced on codes of K 2-12 and of many generators, its
    # words split over 3-5 model CTAs in ragged ranges (a CTA holding part
    # of a trellis or several), and in batches of 3 trellises
    polys, k = GRID_CODES[code]
    n = len(polys)
    rng = np.random.default_rng(230 + k + n)
    lw = 19
    sym = _tie_llrs(rng, (4, lw, n))
    want = vk.viterbi_lanes_reference(torch.from_numpy(sym), lw, n, polys, k, *ends).numpy()
    got = grid_model(sym, lw, n, polys, k, *ends, ctas=ctas, batch=batch)
    assert np.array_equal(got, want)


def test_twin_matches_jax_past_the_cluster_route(jfec):
    # K 19 (262,144 states: the grid route) over 2 trellises of 24 steps,
    # through the JAX package's scan, full block and unterminated, ties in
    polys, k = (0o1351753, 0o1746321), 19
    assert vk.block_plan(24, 2, k, 2) is None
    rng = np.random.default_rng(19)
    bits = rng.integers(0, 2, (2, 24 - (k - 1))).astype(np.uint8)
    enc = fec.conv_encode(torch.from_numpy(bits), polys, k).numpy()
    llr = np.round((1 - 2.0 * enc) * 2 + rng.normal(size=enc.shape)).astype(np.float32)
    for kw in ({}, {"terminated": False}):
        got = fec.viterbi_decode(torch.from_numpy(llr), polys, k, **kw).numpy()
        want = np.asarray(jfec.viterbi_decode(llr, polys, k, backend="xla", **kw))
        assert np.array_equal(got, want), kw
    assert np.array_equal(fec.viterbi_decode(torch.from_numpy(llr), polys, k).numpy(), bits)


@pytest.mark.cuda
@pytest.mark.parametrize("code", sorted(BLOCK_CODES) + ["k17r2", "k19r2", "k3r900", "k2r2000"])
def test_cuda_block_and_two_state_instances_match_twin(cuda, code):
    # K 2 in the warp instance; past 256 states or 8 generators the block
    # instance: to 131,072 states its cluster route, past it (K 19) and
    # where a CTA's LLRs of many generators outgrow its shared memory (900
    # and 2,000 generators) the grid route; one launch
    many = {"k3r900": (tuple([0o7, 0o5, 0o3] * 300), 3),
            "k2r2000": (tuple([0o3, 0o1] * 1000), 2)}
    polys, k = BLOCK_CODES.get(code) or many.get(code) or (
        {12: (0o4335, 0o5723), 15: (0o46321, 0o51271), 17: (0o234567, 0o312345),
         19: (0o1351753, 0o1746321)}[int(code[1:3])], int(code[1:3]))
    n = len(polys)
    rng = np.random.default_rng(190 + k + n)
    lw, n_tr = (120, 9) if k < 15 else (24, 2)
    assert (vk.block_plan(lw, n, k, n_tr) is None) == (code in ("k19r2", *many))
    sym = torch.from_numpy(_tie_llrs(rng, (n_tr, lw, n))).to(cuda)
    for ends in ((True, True), (False, False), (True, False)):
        before = vk.launches
        got = vk.viterbi_lanes(sym, lw, n, polys, k, *ends)
        want = vk.viterbi_lanes_reference(sym, lw, n, polys, k, *ends)
        torch.cuda.synchronize()
        assert vk.launches == before + 1
        assert torch.equal(got, want), (code, ends)


@pytest.mark.cuda
@pytest.mark.parametrize("code", ["k3r900", "k10r10"])
def test_cuda_grid_route_in_batches(cuda, code, monkeypatch):
    # more trellises than a batch: the grid route takes them in turn inside
    # its one launch, reusing the scratch (a batch of 3 here)
    polys, k = {"k3r900": (tuple([0o7, 0o5, 0o3] * 300), 3),
                "k10r10": BLOCK_CODES["k10r10"]}[code]
    n = len(polys)
    monkeypatch.setattr(vk, "GRID_BATCH", 3)
    monkeypatch.setattr(vk, "block_plan", lambda *a, **kw: None)  # the grid route forced
    rng = np.random.default_rng(300 + k)
    lw, n_tr = 45, 8
    sym = torch.from_numpy(_tie_llrs(rng, (n_tr, lw, n))).to(cuda)
    for ends in ((True, True), (False, False)):
        before = vk.launches
        got = vk.viterbi_lanes(sym, lw, n, polys, k, *ends)
        want = vk.viterbi_lanes_reference(sym, lw, n, polys, k, *ends)
        torch.cuda.synchronize()
        assert vk.launches == before + 1
        assert torch.equal(got, want), (code, ends)
