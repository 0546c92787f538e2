"""The port's mesh, sharded FIR and sharded RX chain against the JAX
package's on the 8-virtual-device CPU mesh (the cases of
``tests/test_parallel.py``), with the port on ``devices=["cpu"] * 8``.

Tolerances. The port's sharded results are held **exactly** to its own
unsharded ones wherever ``tests/test_parallel.py`` asserts exact (bits,
bytes, the carried state): the halo supplies the true history, so every
shard computes what one device would. Against JAX the FIR is held to the
JAX bar (RMS EVM <= -110 dB) and hard bits to agreement >= 0.99999, never
byte for byte: two float32 implementations may differ on the sign of a bin
at zero (ROADMAP.md §3.5). States are copies of samples and compare exact.
"""

import numpy as np
import pytest
import torch

from aether_primitives_tpu_torch.evm import evm_rms_db
from aether_primitives_tpu_torch.models import RxChain, RxChainConfig, pad_to_frames
from aether_primitives_tpu_torch.ops import fir
from aether_primitives_tpu_torch.ops.cuda import halo as hk
from aether_primitives_tpu_torch.ops.cuda import rx_frame as rf
from aether_primitives_tpu_torch.parallel import halo, mesh as mesh_mod

torch.set_num_threads(1)

AGREEMENT = 0.99999
FIR_DB = -110.0
CPU8 = ["cpu"] * 8


def rand_c(rng, shape):
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    from aether_primitives_tpu import models as jmodels
    from aether_primitives_tpu.ops import fir as jfir
    from aether_primitives_tpu.parallel import halo as jhalo
    from aether_primitives_tpu.parallel import mesh as jmesh

    return {"models": jmodels, "fir": jfir, "halo": jhalo, "mesh": jmesh}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


# ------------------------------------------------------------------ the mesh


def test_make_mesh_infer(jx, eight_devices):
    m = mesh_mod.make_mesh({"time": -1}, devices=CPU8)
    assert m.shape["time"] == 8 == jx["mesh"].make_mesh({"time": -1}).shape["time"]
    assert mesh_mod.make_mesh(devices=CPU8).axis_names == (mesh_mod.TIME_AXIS,)


def test_make_mesh_two_axes(jx, eight_devices):
    m = mesh_mod.make_mesh({"channel": 2, "time": 4}, devices=CPU8)
    assert m.shape == {"channel": 2, "time": 4}
    assert m.shape == dict(jx["mesh"].make_mesh({"channel": 2, "time": 4}).shape)
    assert m.axis_names == ("channel", "time") and m.size == 8
    assert m.devices.shape == (2, 4) and m.devices[1, 3] == torch.device("cpu")


def test_make_mesh_bad_sizes(jx, eight_devices):
    for make in (lambda: mesh_mod.make_mesh({"time": 3}, devices=CPU8),
                 lambda: jx["mesh"].make_mesh({"time": 3})):
        with pytest.raises(ValueError, match="devices"):
            make()


def test_make_mesh_defaults_to_the_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mesh_mod.make_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mesh_mod.make_mesh(devices=["cuda:0", "cuda:0"])


def test_time_sharding_and_init_distributed():
    m = mesh_mod.make_mesh({"channel": 2, "time": 4}, devices=CPU8)
    s = mesh_mod.time_sharding(m)
    assert s.mesh is m and s.spec == ("time",)
    assert mesh_mod.time_sharding(m, "channel").spec == ("channel",)
    with pytest.raises(ValueError, match="not in mesh axes"):
        mesh_mod.time_sharding(m, "frequency")
    with pytest.raises(NotImplementedError, match="item 17b"):
        mesh_mod.init_distributed(num_processes=2)


# --------------------------------------------------------------- sharded FIR


@pytest.mark.parametrize("use_os", [False, True])
def test_sharded_fir_matches_jax_and_single_device(jx, eight_devices, use_os):
    rng = np.random.default_rng(0)
    x, taps = rand_c(rng, 8 * 1024), rand_c(rng, 33)
    kw = dict(use_os=use_os, block_len=256 if use_os else None)
    got = np.asarray(halo.sharded_fir(x, taps, mesh_mod.make_mesh({"time": 8}, devices=CPU8),
                                      **kw))
    single = fir.fir_filter(torch.from_numpy(x), taps).numpy()
    want = np.asarray(jx["halo"].sharded_fir(x, taps, jx["mesh"].make_mesh({"time": 8}), **kw))
    assert got.shape == single.shape == want.shape
    assert evm_rms_db(got, single.astype(np.complex128)) < FIR_DB
    assert evm_rms_db(got, want.astype(np.complex128)) < FIR_DB
    assert evm_rms_db(got, np.asarray(jx["fir"].fir_filter(x, taps)).astype(np.complex128)) < FIR_DB


def test_sharded_fir_batched_rows():
    rng = np.random.default_rng(9)
    x, taps = rand_c(rng, (3, 4 * 512)), rand_c(rng, 17)
    m = mesh_mod.make_mesh({"time": 4}, devices=["cpu"] * 4)
    got = halo.sharded_fir(x, taps, m).gather()
    assert torch.equal(got, fir.fir_filter(torch.from_numpy(x), taps))


# ------------------------------------------------------------ sharded RxChain


def _chains(jx, **cfg):
    jchain = jx["models"].RxChain(jx["models"].RxChainConfig(fir_mode="fused", **cfg))
    return RxChain(RxChainConfig(**cfg), device="cpu"), jchain


def _agreement(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    return float((a == b).mean())


@pytest.mark.parametrize("modulation", ["qpsk", "bpsk", "qam16"])
def test_sharded_streaming_matches_contiguous(jx, eight_devices, modulation):
    """Carried FIR state x time-axis halo x (channel, time) mesh: four
    consecutive sharded streaming blocks equal ONE contiguous step of the
    concatenated capture, and every block equals ``streaming_step``."""
    chain, jchain = _chains(jx, fft_len=128, decimation=4, modulation=modulation)
    m = mesh_mod.make_mesh({"channel": 2, "time": 4}, devices=CPU8)
    jm = jx["mesh"].make_mesh({"channel": 2, "time": 4})
    rng = np.random.default_rng(3)
    C, B, n = 2, 4, 4 * 4 * 128  # per-shard span 512 = dec * fft_len
    cap = rand_c(rng, (C, B * n))
    contiguous = chain.step(cap)
    state, state_1, jstate = chain.init_state((C,)), chain.init_state((C,)), jchain.init_state((C,))
    outs, jouts = [], []
    for i in range(B):
        blk = cap[:, i * n:(i + 1) * n]
        bits, state = chain.sharded_streaming_step_2d(blk, state, m)
        bits_1, state_1 = chain.streaming_step(blk, state_1)
        jbits, jstate = jchain.sharded_streaming_step_2d(blk, jstate, jm)
        assert isinstance(bits, mesh_mod.Sharded) and bits.spec == ("channel", "time")
        assert state.spec == ("channel", None)
        assert torch.equal(bits.gather(), bits_1), i
        assert torch.equal(state.gather(), state_1), i
        assert np.array_equal(np.asarray(state), np.asarray(jstate)), i
        outs.append(bits.gather())
        jouts.append(np.asarray(jbits))
    got = torch.cat(outs, dim=-1)
    assert torch.equal(got, contiguous)
    assert _agreement(got, np.concatenate(jouts, axis=-1)) >= AGREEMENT
    k = chain.taps.shape[-1]
    assert np.array_equal(np.asarray(state), cap[:, -(k - 1):])
    assert hk.launches == 0 and rf.launches == 0  # CPU shards: the plain versions


@pytest.mark.parametrize("modulation", ["qpsk", "bpsk", "qam16"])
def test_sharded_step_matches_single(jx, eight_devices, modulation):
    chain, jchain = _chains(jx, fft_len=256, decimation=4, modulation=modulation)
    rng = np.random.default_rng(2)
    x = rand_c(rng, 8 * 4 * 256 * 2)
    sharded = chain.sharded_step(x, mesh_mod.make_mesh({"time": 8}, devices=CPU8))
    assert sharded.spec == ("time",)
    assert torch.equal(sharded.gather(), chain.step(x))
    want = jchain.sharded_step(x, jx["mesh"].make_mesh({"time": 8}))
    assert _agreement(sharded, want) >= AGREEMENT


@pytest.mark.parametrize("modulation", ["qpsk", "bpsk", "qam16"])
def test_sharded_step_2d_matches_single(jx, eight_devices, modulation):
    chain, jchain = _chains(jx, fft_len=128, decimation=4, modulation=modulation)
    rng = np.random.default_rng(7)
    m = mesh_mod.make_mesh({"channel": 2, "time": 4}, devices=CPU8)
    x = rand_c(rng, (4, 4 * 4 * 128))  # two channels and one frame per shard
    sharded = chain.sharded_step_2d(x, m)
    assert torch.equal(sharded.gather(), chain.step(x))
    want = jchain.sharded_step_2d(x, jx["mesh"].make_mesh({"channel": 2, "time": 4}))
    assert _agreement(sharded, want) >= AGREEMENT
    # a value that is already laid out passes straight in
    placed = mesh_mod.shard(torch.from_numpy(x), m, ("channel", "time"))
    assert torch.equal(chain.sharded_step_2d(placed, m).gather(), chain.step(x))


def test_sharded_packed_bits_matches_single(jx, eight_devices):
    """packed_bits composes with the (channel, time) mesh: the per-shard
    byte streams concatenate to exactly the single-device packed output."""
    chain, jchain = _chains(jx, fft_len=128, decimation=4, packed_bits=True)
    m = mesh_mod.make_mesh({"channel": 2, "time": 4}, devices=CPU8)
    rng = np.random.default_rng(6)
    x = rand_c(rng, (2, 4 * 4 * 128))
    single = chain.step(x)
    sharded = chain.sharded_step_2d(x, m).gather()
    assert sharded.dtype == torch.uint8 and torch.equal(sharded, single)
    bits_s, _ = chain.sharded_streaming_step_2d(x, chain.init_state((2,)), m)
    bits_1, _ = chain.streaming_step(x, chain.init_state((2,)))
    assert torch.equal(bits_s.gather(), bits_1)
    want = np.asarray(jchain.sharded_step_2d(x, jx["mesh"].make_mesh({"channel": 2, "time": 4})))
    assert _agreement(np.unpackbits(sharded.numpy(), bitorder="little"),
                      np.unpackbits(want, bitorder="little")) >= AGREEMENT


def test_sharded_single_tap_chain_keeps_its_state():
    chain = RxChain(RxChainConfig(fft_len=64, decimation=1), device="cpu")
    m = mesh_mod.make_mesh({"channel": 2, "time": 4}, devices=CPU8)
    x = rand_c(np.random.default_rng(8), (2, 4 * 64))
    bits, state = chain.sharded_streaming_step_2d(x, chain.init_state((2,)), m)
    assert torch.equal(bits.gather(), chain.step(x)) and state.shape == (2, 0)


def test_sharded_span_errors_mirror_jax(jx, eight_devices):
    chain, jchain = _chains(jx, fft_len=128, decimation=4)
    m, jm = mesh_mod.make_mesh({"time": 8}, devices=CPU8), jx["mesh"].make_mesh({"time": 8})
    x = np.zeros(8 * 512 + 4, np.complex64)
    for step, mesh in ((chain.sharded_step, m), (jchain.sharded_step, jm)):
        with pytest.raises(ValueError, match=r"must divide over 8 time shards; pad with "
                                             r"pad_to_frames\(x, 4096\)"):
            step(x, mesh)
        with pytest.raises(ValueError, match="per-shard span 256 is not a multiple of "
                                             "frame_span 512"):
            step(x[:8 * 256], mesh)
    padded = pad_to_frames(torch.from_numpy(x), 8 * chain.frame_span)
    assert chain.sharded_step(padded, m).shape == (2 * 8 * 128 * 2,)
    with pytest.raises(ValueError, match="block length 100 is not a multiple"):
        chain.step(np.zeros(100, np.complex64))  # the unsharded message is unchanged
    # taps longer than a shard's span: the halo reaches one neighbour only
    long_taps = RxChain(RxChainConfig(fft_len=16, decimation=1,
                                      fir_taps=np.ones(40, np.complex64)), device="cpu")
    with pytest.raises(ValueError, match="exceeds the per-device span"):
        long_taps.sharded_step(np.zeros(8 * 16, np.complex64), m)


# ------------------------------------------------------------------ on a card


@pytest.mark.cuda
@pytest.mark.parametrize("modulation", ["qpsk", "bpsk"])
def test_cuda_sharded_streaming_goes_through_the_kernels(cuda, modulation):
    chain = RxChain(RxChainConfig(fft_len=512, decimation=4, modulation=modulation,
                                  packed_bits=True), device=cuda)
    m = mesh_mod.make_mesh({"channel": 2, "time": 4}, devices=[cuda] * 8)
    x = torch.from_numpy(rand_c(np.random.default_rng(11), (2, 2 * 4 * 4 * 2048))).to(cuda)
    n = x.shape[-1] // 2
    state, outs = chain.init_state((2,)), []
    h0, r0 = hk.launches, rf.launches
    for i in range(2):
        bits, state = chain.sharded_streaming_step_2d(x[:, i * n:(i + 1) * n], state, m)
        outs.append(bits.gather())
    torch.cuda.synchronize()
    assert (hk.launches - h0, rf.launches - r0) == (2, 16)  # halo: one per call on one card
    assert torch.equal(torch.cat(outs, dim=-1), chain.step(x))
    assert torch.equal(state.gather(), x[:, -(chain.taps.shape[-1] - 1):])


@pytest.mark.cuda
def test_cuda_sharded_streaming_across_cards(cuda):
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        pytest.skip("needs two CUDA devices")
    chain = RxChain(RxChainConfig(fft_len=512, decimation=4, packed_bits=True), device=cuda)
    m = mesh_mod.make_mesh({"channel": 2, "time": 4},
                           devices=[f"cuda:{i % n_cards}" for i in range(8)])
    x = rand_c(np.random.default_rng(12), (2, 2 * 4 * 4 * 2048))
    n = x.shape[-1] // 2
    state, outs = chain.init_state((2,)), []
    for i in range(2):
        bits, state = chain.sharded_streaming_step_2d(x[:, i * n:(i + 1) * n], state, m)
        outs.append(bits.gather(cuda))
    assert torch.equal(torch.cat(outs, dim=-1), chain.step(x))
