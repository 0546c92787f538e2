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
    assert not vk.kernel_supports(30_000, 2, 7)
    assert not vk.kernel_supports(100, 2, 10)  # 512 states
    assert not vk.kernel_supports(100, 9, 7)  # 9 generators
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
def test_cuda_kernel_raises_on_spans_it_does_not_take(cuda):
    before = vk.launches
    with pytest.raises(ValueError, match="windowed decoder"):
        vk.viterbi_lanes(torch.zeros(1, 30_000, 2, device=cuda), 30_000, 2, K7[0], 7,
                         True, True)
    with pytest.raises(ValueError, match="contiguous"):
        vk.viterbi_lanes(torch.zeros(10, 4, 2, device=cuda).transpose(0, 1), 10, 2,
                         K7[0], 7, True, True)
    assert vk.launches == before
