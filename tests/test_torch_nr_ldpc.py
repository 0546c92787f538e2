"""The port's NR-structured QC-LDPC (``ops/nr_ldpc.py``) and the QC
decoder's edge tables (``ops/ldpc.py _qc_edges``) against the JAX package's,
on ``tests/test_nr_ldpc.py``'s smallest cases.

Tolerances: none. Base graphs, codewords, bit selections and rate-matched
bits are equal integer arrays; de-rate-matched buffers equal float32 arrays
(repeated positions are summed pass by pass in the reference's order, up
to four passes here); decoded bits and ``ok`` flags equal, at a noise that
corrects every frame and one that leaves some undecoded. The JAX side runs
under ``jax.jit``, but for the rate matching's cases, which share the ops'
compiles op by op.
"""

import functools

import numpy as np
import pytest
import torch

from aether_primitives_tpu_torch.ops import ldpc, nr_ldpc
from aether_primitives_tpu_torch.ops.nr_ldpc import NrLdpc, NrTransportBlock

torch.set_num_threads(1)

K = 500  # tests/test_nr_ldpc.py's shortened BG2 code at z 64: 140 filler bits


@pytest.fixture(scope="module")
def jnr():
    pytest.importorskip("jax")
    from aether_primitives_tpu.ops import nr_ldpc as jnr

    return jnr


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _jit(fn, **fixed):
    import jax

    return jax.jit(functools.partial(fn, **fixed))


def _usable(code):
    return code.ncb - code.n_filler


def _noisy(tx, rng, sigma):
    llr = (2.0 / sigma ** 2) * ((1.0 - 2.0 * tx) + sigma * rng.normal(size=tx.shape))
    return llr.astype(np.float32)


@pytest.mark.parametrize("bg", [1, 2])
def test_base_graphs_equal_jax(jnr, bg):
    for z in (2, 27, 64, 384):
        got = nr_ldpc.make_nr_base_graph(bg, z)
        assert got.dtype == np.int64 and np.array_equal(got, jnr.make_nr_base_graph(bg, z))
    assert np.array_equal(nr_ldpc.make_nr_base_graph(bg, 64, seed=99),
                          jnr.make_nr_base_graph(bg, 64, seed=99))
    assert nr_ldpc.LIFTING_SIZES == jnr.LIFTING_SIZES
    for z in (2, 24, 52, 384):
        assert nr_ldpc.lifting_set(z) == jnr.lifting_set(z)
        assert [nr_ldpc.rv_start(bg, z, r) for r in range(4)] == [
            jnr.rv_start(bg, z, r) for r in range(4)]


@pytest.mark.parametrize("bg,z,k", [(1, 16, None), (2, 32, None), (2, 64, K)])
def test_codewords_equal_jax(jnr, bg, z, k):
    code, jcode = NrLdpc(z=z, bg=bg, k=k), jnr.NrLdpc(z=z, bg=bg, k=k)
    bits = np.random.default_rng(z).integers(0, 2, (2, 2, code.k)).astype(np.uint8)
    cw = code.codeword(torch.from_numpy(bits))
    assert cw.dtype == torch.uint8 and cw.shape == (2, 2, code.nb * z)
    assert np.array_equal(cw.numpy(), np.asarray(_jit(jcode.codeword)(bits)))
    assert not ((cw.numpy().astype(np.int64) @ code.parity_check().T) % 2).any()
    assert np.array_equal(code.parity_check(), jcode.parity_check())


@pytest.mark.parametrize("case", ["puncture", "shorten", "repeat", "repeat x4"])
def test_selection_encode_and_dematch_equal_jax(jnr, case):
    code, jcode = NrLdpc(z=64, bg=2, k=K), jnr.NrLdpc(z=64, bg=2, k=K)
    e = {"puncture": 700, "shorten": _usable(code), "repeat": _usable(code) + 500,
         "repeat x4": 3 * _usable(code) + 77}[case]
    rng = np.random.default_rng(e)
    bits = rng.integers(0, 2, (3, K)).astype(np.uint8)
    for rv in range(4):
        sel = code._selection(e, rv)
        assert sel.dtype == np.int32 and np.array_equal(sel, jcode._selection(e, rv))
        tx = code.encode(torch.from_numpy(bits), e, rv)
        # op by op: the ops compile once for all four cases (one program a
        # case and rv under jit)
        assert np.array_equal(tx.numpy(), np.asarray(jcode.encode(bits, e, rv)))
        llr = _noisy(tx.numpy(), rng, 0.9)
        buf = code.dematch(torch.from_numpy(llr), rv)
        assert buf.shape == (3, code.ncb)
        assert np.array_equal(buf.numpy(), np.asarray(jcode.dematch(llr, rv)))


@pytest.mark.parametrize("sigma,rv,e", [(0.95, 3, 1400), (0.9, 0, 1000)])
def test_decode_equals_jax(jnr, sigma, rv, e):
    # rv 3 at rate 0.36 decodes every frame; rv 0 at rate 1/2 and sigma 0.9
    # (Eb/N0 0.9 dB) leaves 4 of the 6 undecoded
    code, jcode = NrLdpc(z=64, bg=2, k=K), jnr.NrLdpc(z=64, bg=2, k=K)
    rng = np.random.default_rng(int(sigma * 100))
    bits = rng.integers(0, 2, (6, K)).astype(np.uint8)
    tx = code.encode(torch.from_numpy(bits), e, rv=rv).numpy()
    llr = _noisy(tx, rng, sigma)
    got = code.decode(torch.from_numpy(llr.reshape(2, 3, -1)), rv=rv, iters=25)
    want = _jit(jcode.decode, rv=rv, iters=25)(llr)
    assert got[0].shape == (2, 3, K) and got[1].shape == (2, 3)
    assert np.array_equal(got[0].numpy().reshape(6, K), np.asarray(want[0]))
    assert np.array_equal(got[1].numpy().reshape(6), np.asarray(want[1]))
    ok = got[1].numpy().reshape(6)
    assert ok.any() and np.array_equal(got[0].numpy().reshape(6, K)[ok], bits[ok])
    assert ok.all() == (rv == 3)


@pytest.mark.parametrize("tb_bits,blocks", [(1000, 1), (9000, 3)])
def test_transport_block_equals_jax(jnr, tb_bits, blocks):
    tb, jtb = NrTransportBlock(tb_bits=tb_bits), jnr.NrTransportBlock(tb_bits=tb_bits)
    assert (tb.n_blocks, tb.k_per_block, tb.pad, tb.code.z) == (
        jtb.n_blocks, jtb.k_per_block, jtb.pad, jtb.code.z)
    assert tb.n_blocks == blocks
    rng = np.random.default_rng(tb_bits)
    payload = rng.integers(0, 2, (2, tb_bits)).astype(np.uint8)
    e = 2 * tb.k_per_block
    segs = tb._segments(torch.from_numpy(payload))
    assert segs.shape == (2, blocks, tb.k_per_block)
    tx = tb.encode(torch.from_numpy(payload), e)
    assert tx.shape == (2, blocks * e)
    assert np.array_equal(tx.numpy(), np.asarray(_jit(jtb.encode, e=e)(payload)))
    llr = _noisy(tx.numpy(), rng, 0.7)
    llr[1, : e // 3] *= -1  # one transport block beyond repair
    got = tb.decode(torch.from_numpy(llr))
    want = _jit(jtb.decode)(llr)
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert got[1].tolist() == [True, False] and np.array_equal(got[0][0].numpy(), payload[0])


def test_external_base_graph_is_normalised_as_in_jax(jnr):
    base = nr_ldpc.make_nr_base_graph(2, 64, seed=99)
    code = NrLdpc(z=52, bg=2, base_graph=base)
    jcode = jnr.NrLdpc(z=52, bg=2, base_graph=base)
    assert code.base_graph == jcode.base_graph and hash(code) == hash(code)
    assert np.array_equal(code._base, jcode._base) and code._base.max() < 52
    for kw, match in (({"z": 100}, "lifting"), ({"z": 32, "base_graph": ((0, 1), (1, 0))},
                                                "base graph"), ({"z": 32, "k": 5000}, "k must")):
        with pytest.raises(ValueError, match=match):
            NrLdpc(**kw)


@pytest.mark.parametrize("code", ["ldpc11n", "nr bg2 z64", "nr bg1 z16"])
def test_qc_edge_tables_equal_the_dense_route(code):
    # the tables from the base matrix against those of the dense matrix,
    # and the QC decoder against the min-sum on the dense tables
    if code == "ldpc11n":
        base, z = ldpc._WIFI_648_R12, 27
    else:
        bg, z = (2, 64) if "bg2" in code else (1, 16)
        base = nr_ldpc.make_nr_base_graph(bg, z)
    h = ldpc.qc_expand(base, z)
    dense = ldpc._edges(h.shape, np.packbits(h).tobytes())
    tables = ldpc._qc_edges(tuple(map(tuple, base.tolist())), z)
    for a, b in zip(dense, tables):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    rng = np.random.default_rng(z)
    llr = torch.from_numpy(_noisy(np.zeros((4, h.shape[1])), rng, 0.8))  # the zero codeword
    for iters in (1, 8):
        got = ldpc.qc_ldpc_decode(llr, base, z, iters=iters)
        want = ldpc._min_sum(llr, dense, h.shape[1], iters, 0.75)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_cuda_nr_chain_equals_the_cpu_run(cuda):
    # a transport block of 3 code blocks, and soft combining at 4 passes
    tb = NrTransportBlock(tb_bits=9000)
    rng = np.random.default_rng(21)
    payload = torch.from_numpy(rng.integers(0, 2, (8, 9000)).astype(np.uint8))
    e = 2 * tb.k_per_block
    tx = tb.encode(payload.to(cuda), e)
    assert torch.equal(tx.cpu(), tb.encode(payload, e))
    llr = torch.from_numpy(_noisy(tx.cpu().numpy(), rng, 0.8))
    got, want = tb.decode(llr.to(cuda)), tb.decode(llr)
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
    code = NrLdpc(z=64, bg=2, k=K)
    e = 3 * _usable(code) + 77
    bits = torch.from_numpy(rng.integers(0, 2, (8, K)).astype(np.uint8))
    bufs = []
    for dev in (cuda, torch.device("cpu")):
        buf = 0
        for rv in (0, 2):
            tx = code.encode(bits.to(dev), e, rv).cpu().numpy()
            llr = torch.from_numpy(_noisy(tx, np.random.default_rng(rv), 1.2)).to(dev)
            buf = buf + code.dematch(llr, rv)
        bufs.append(buf)
    assert torch.equal(bufs[0].cpu(), bufs[1])
    got, want = code.decode_buffer(bufs[0]), code.decode_buffer(bufs[1])
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
