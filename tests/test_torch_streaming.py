"""The port's streaming executors and block pool against the JAX package's
(``tests/test_streaming.py``'s cases, and ``tests/test_models.py``'s
stateful-executor cases), on ``device="cpu"``.

Every case runs the same blocks through the port and the JAX executor.
Stage outputs are compared exactly. RX chain bits are compared with the JAX
chain by bit agreement (>= ``AGREEMENT``) plus the RMS EVM of the chains'
spectra (<= -80 dB), never byte for byte (ROADMAP.md §3.5: the two float
implementations may differ on the sign of bins at zero); the port's own
streamed bits are held byte-exact to its one contiguous ``step``. CUDA cases
carry the ``cuda`` marker and skip without a card.
"""

import threading

import numpy as np
import pytest
import torch

from aether_primitives_tpu_torch import convert
from aether_primitives_tpu_torch.boundary import Split
from aether_primitives_tpu_torch.evm import evm_rms_db
from aether_primitives_tpu_torch.models import RxChain, RxChainConfig
from aether_primitives_tpu_torch.ops.cuda import rx_frame as rf
from aether_primitives_tpu_torch.parallel import streaming

torch.set_num_threads(1)

AGREEMENT = 0.999
EVM_DB = -80.0
CPU = "cpu"


@pytest.fixture(scope="module")
def jax_streaming():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from aether_primitives_tpu.parallel import streaming as js

    return js, jnp


@pytest.fixture(scope="module")
def jax_models():
    pytest.importorskip("jax")
    from aether_primitives_tpu import models

    return models


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _capture(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)


def _same(port_out, jax_out):
    """Port results equal the JAX executor's, one by one, exactly."""
    assert len(port_out) == len(jax_out)
    for p, j in zip(port_out, jax_out):
        assert np.array_equal(p.numpy(), np.asarray(j))


def _bits_agree(port_bits, jax_bits, packed=False):
    p = np.asarray(port_bits).reshape(-1)
    j = np.asarray(jax_bits).reshape(-1)
    if packed:
        p, j = np.unpackbits(p, bitorder="little"), np.unpackbits(j, bitorder="little")
    assert p.shape == j.shape
    agree = float((p == j).mean())
    assert agree >= AGREEMENT, agree
    return agree


def test_pipeline_two_stages_matches_reference_example(jax_streaming):
    js, jnp = jax_streaming
    blocks = [np.full(64, -2.0, np.float32), np.full(64, 3.0, np.float32)]
    ex = streaming.new("Abs", torch.abs).add_stage("Mul 20", lambda b: b * 20.0).finish(
        depth=2, donate=False, printer=None, device=CPU)
    out = ex.run(blocks)
    assert np.allclose(out[0].numpy(), 40.0) and np.allclose(out[1].numpy(), 60.0)
    jex = js.new("Abs", jnp.abs).add_stage("Mul 20", lambda b: b * 20.0).finish(
        depth=2, donate=False, printer=None)
    _same(out, jex.run(blocks))


def test_pipeline_order_preserved(jax_streaming):
    js, _ = jax_streaming
    blocks = [np.full(8, float(i), np.float32) for i in range(10)]
    ex = streaming.new("id", lambda b: b + 0.0).finish(depth=3, donate=False, printer=None,
                                                       device=CPU)
    out = ex.run(blocks)
    assert [float(o[0]) for o in out] == list(range(10))
    _same(out, js.new("id", lambda b: b + 0.0).finish(depth=3, donate=False,
                                                      printer=None).run(blocks))


def test_send_recv_api(jax_streaming):
    js, _ = jax_streaming
    got = []
    for ex in (streaming.new("x2", lambda b: b * 2).finish(depth=2, donate=False,
                                                           printer=None, device=CPU),
               js.new("x2", lambda b: b * 2).finish(depth=2, donate=False, printer=None)):
        ex.send(np.ones(4, np.float32))
        ex.send(np.full(4, 2.0, np.float32))
        got.append([np.asarray(ex.recv()), np.asarray(ex.recv())])
    assert float(got[0][0][0]) == 2.0 and float(got[0][1][0]) == 4.0
    for p, j in zip(*got):
        assert np.array_equal(p, j) and p.dtype == j.dtype


def test_profile_mode_per_stage_stats(jax_streaming):
    js, _ = jax_streaming
    blocks = [np.zeros(16, np.float32)] * 3
    ex = streaming.new("a", lambda b: b + 1).add_stage("b", lambda b: b * 2).finish(
        depth=1, donate=False, profile=True, printer=None, device=CPU)
    out = ex.run(blocks)
    assert np.allclose(out[0].numpy(), 2.0)
    assert ex.stats[0].total_n == 3 and ex.stats[1].total_n == 3
    assert ex.stats[0].total_active_s > 0
    assert ex.stats[0].total_samples == 3 * 16
    jex = js.new("a", lambda b: b + 1).add_stage("b", lambda b: b * 2).finish(
        depth=1, donate=False, profile=True, printer=None)
    _same(out, jex.run(blocks))
    for p, j in zip(ex.stats + [ex.chain_stats], jex.stats + [jex.chain_stats]):
        assert (p.total_n, p.total_samples) == (j.total_n, j.total_samples)


def test_stats_reporting(jax_streaming):
    js, _ = jax_streaming
    for mod, kw in ((streaming, {"device": CPU}), (js, {})):
        msgs = []
        ex = mod.new("s", lambda b: b).finish(depth=1, donate=False, report_every_s=0.0,
                                              printer=msgs.append, **kw)
        ex.run([np.zeros(4, np.float32)] * 2)
        assert any("chain" in m and "Utilisation" in m for m in msgs)


def test_executor_with_sharding(jax_streaming, eight_devices):
    # blocks laid out across the 8-device mesh before the chain runs
    # (tests/test_streaming.py): the JAX chain sees a sharded array, the
    # port's a Sharded value
    import jax

    from aether_primitives_tpu.parallel import mesh as jmesh
    from aether_primitives_tpu_torch.parallel import mesh as tmesh

    js, _ = jax_streaming
    blocks = [np.arange(64, dtype=np.float32) + i for i in range(3)]
    sharding = tmesh.time_sharding(tmesh.make_mesh({"time": 8}, devices=["cpu"] * 8))
    ex = streaming.new("x2", lambda b: b.map(lambda t: t * 2.0)).finish(
        depth=2, donate=False, sharding=sharding, printer=None)
    out = ex.run(blocks)
    jsharding = jax.sharding.NamedSharding(jmesh.make_mesh({"time": 8}),
                                           jax.sharding.PartitionSpec("time"))
    jout = js.new("x2", lambda b: b * 2.0).finish(
        depth=2, donate=False, sharding=jsharding, printer=None).run(blocks)
    for o, jo, b in zip(out, jout, blocks):
        assert isinstance(o, tmesh.Sharded) and o.spec == ("time",)
        assert o.shards[3].shape == (8,)
        assert np.array_equal(np.asarray(o), np.asarray(jo))
        assert np.array_equal(np.asarray(o), b * 2.0)
    assert ex.chain_stats.total_n == 3 and ex.chain_stats.total_samples == 3 * 64
    assert ex.device == torch.device("cpu")  # the mesh's, not the default card


def test_stateful_executor_with_sharding():
    # the flagship composition as a stream: blocks placed (channel, time),
    # the carried state handed from call to call as a Sharded value
    from aether_primitives_tpu_torch.parallel import mesh as tmesh

    chain = RxChain(RxChainConfig(fft_len=128, decimation=4, packed_bits=True), device=CPU)
    mesh = tmesh.make_mesh({"channel": 2, "time": 4}, devices=["cpu"] * 8)
    rng = np.random.default_rng(21)
    n = 4 * 4 * 128
    cap = (rng.normal(size=(2, 3 * n)) + 1j * rng.normal(size=(2, 3 * n))).astype(np.complex64)
    ex = streaming.StatefulExecutor(
        lambda b, s: chain.sharded_streaming_step_2d(b, s, mesh), chain.init_state((2,)),
        depth=2, sharding=tmesh.Sharding(mesh, ("channel", "time")), printer=None)
    outs = ex.run([cap[:, i * n:(i + 1) * n] for i in range(3)])
    assert torch.equal(torch.cat([o.gather() for o in outs], dim=-1), chain.step(cap))
    state = ex.state
    assert isinstance(state, tmesh.Sharded) and state.spec == ("channel", None)
    assert np.array_equal(np.asarray(state), cap[:, -(chain.taps.shape[-1] - 1):])
    assert ex.chain_stats.total_samples == 3 * 2 * n


def test_executor_with_sharding_not_ported():
    # (the name is from when a mesh that spans processes was refused) the
    # executors take such a mesh: they stage this process's shards on its
    # own devices and run the chain on them; a sharding must be a (mesh,
    # spec) pair
    from aether_primitives_tpu_torch.parallel import mesh as tmesh

    m = tmesh.make_mesh({"time": 8}, devices=[CPU] * 8)
    x = torch.arange(8 * 16, dtype=torch.float32)
    for rank in (0, 1):
        spanning = tmesh.Mesh(m.devices, m.axis_names, np.repeat([0, 1], 4), rank=rank)
        ex = streaming.new("x2", lambda b: b.map(lambda t: 2 * t)).finish(
            sharding=(spanning, ("time",)), device=CPU, printer=None)
        assert ex.device == torch.device(CPU)
        (y,) = ex.run([x])
        assert torch.equal(y.gather(local=True), 2 * x[64 * rank:64 * (rank + 1)])
        sx = streaming.StatefulExecutor(lambda b, s: (b, s), np.zeros(2),
                                        sharding=(spanning, ("time",)), device=CPU,
                                        printer=None)
        assert sx.device == torch.device(CPU)
    with pytest.raises(TypeError):
        streaming.new("x2", lambda b: b).finish(sharding=object(), device=CPU)
    with pytest.raises(TypeError):
        streaming.StatefulExecutor(lambda b, s: (b, s), np.zeros(2), sharding=object(),
                                   device=CPU)


def test_executor_runs_rx_chain_blocks(jax_streaming, jax_models):
    js, _ = jax_streaming
    cfg = dict(fft_len=128, decimation=4)
    chain = RxChain(RxChainConfig(**cfg), device=CPU)
    jchain = jax_models.RxChain(jax_models.RxChainConfig(**cfg))
    blocks = [_capture(4 * 128 * 2, i) for i in range(4)]
    outs = streaming.new("rx", chain.step).finish(depth=2, donate=False, printer=None,
                                                 device=CPU).run(blocks)
    jouts = js.new("rx", jchain.step).finish(depth=2, donate=False, printer=None).run(blocks)
    assert len(outs) == 4
    for b, o, j in zip(blocks, outs, jouts):
        assert torch.equal(o, chain.step(b))
        _bits_agree(o, j)
        assert evm_rms_db(chain.spectra(b).numpy(), np.asarray(jchain.spectra(b))) <= EVM_DB


# -- pool (reference src/pool.rs:223-297 tests) -----------------------------


@pytest.mark.parametrize("which", ["port", "jax"])
def test_pool_taking(jax_streaming, which):
    mod = streaming if which == "port" else jax_streaming[0]
    pool = mod.make(1, lambda: bytearray(50))
    assert pool.len() == 1 and pool.cap() == 1
    e1 = pool.take()
    assert e1 is not None
    assert pool.len() == 0 and pool.cap() == 1
    e1.release()
    assert pool.len() == 1 and pool.cap() == 1
    e1 = pool.take()
    e2 = pool.take()
    assert e1 is not None and e2 is None
    e1.release()
    assert pool.len() == 1 and pool.cap() == 1


def test_pool_resetting():
    pool = streaming.make(1, lambda: [], resetter=lambda b: b.clear())
    with pool.take() as buf:
        buf.extend(range(50))
        assert len(buf) == 50
    with pool.take() as buf:
        assert len(buf) == 0  # resetter ran on return


def test_pool_taking_or_making():
    pool = streaming.make(0, lambda: torch.empty(50))
    e1 = pool.take_or_make()
    assert pool.len() == 0 and pool.cap() == 1
    e2 = pool.take_or_make()
    assert pool.len() == 0 and pool.cap() == 2
    e1.release()
    e2.release()
    assert pool.len() == 2 and pool.cap() == 2


def test_pool_is_empty_and_threads():
    pool = streaming.make(0, lambda: np.zeros(8))
    assert pool.is_empty() and pool.is_emtpy()
    out = []
    t = threading.Thread(target=lambda: out.append(pool.take_or_make()))
    t.start()
    t.join()
    assert pool.cap() == 1 and pool.len() == 0
    out[0].release()
    assert pool.len() == 1


def test_pool_doctest():
    import doctest

    finder = doctest.DocTestFinder()
    runner = doctest.DocTestRunner()
    for test in finder.find(streaming.BlockPool, "BlockPool", globs={"BlockPool": streaming.BlockPool}):
        runner.run(test)
    assert runner.failures == 0 and runner.tries >= 6


def test_send_does_not_donate_caller_arrays():
    ex = streaming.new("x2", lambda b: b * 2.0).finish(depth=2, donate=True, printer=None,
                                                      device=CPU)
    b = torch.ones(8)
    h = np.ones(8, np.float32)
    ex.send(b)
    ex.send(h)
    assert float(ex.recv().sum()) == 16.0 and float(ex.recv().sum()) == 16.0
    assert float(b.sum()) == 8.0 and float(h.sum()) == 8.0  # the caller's buffers survive


def test_send_backlog_cap(jax_streaming):
    js, _ = jax_streaming
    ex = streaming.new("id", lambda b: b).finish(depth=1, donate=False, printer=None,
                                                 device=CPU)
    jex = js.new("id", lambda b: b).finish(depth=1, donate=False, printer=None)
    cap = ex.depth * ex.MAX_BACKLOG_FACTOR
    assert cap == jex.depth * jex.MAX_BACKLOG_FACTOR
    for _ in range(cap):
        ex.send(np.zeros(4, np.float32))
    with pytest.raises(RuntimeError, match="backlog"):
        ex.send(np.zeros(4, np.float32))
    for _ in range(cap):
        ex.recv()
    with pytest.raises(IndexError):
        ex.recv()
    ex.close()
    with pytest.raises(RuntimeError, match="closed"):
        ex.send(np.zeros(4, np.float32))


def test_default_mode_samples_per_stage_stats(jax_streaming):
    js, _ = jax_streaming
    port = streaming.new("a", lambda b: b + 1.0).add_stage("b", lambda b: b * 2.0)
    jax_pipe = js.new("a", lambda b: b + 1.0).add_stage("b", lambda b: b * 2.0)
    ex = port.finish(depth=2, donate=False, printer=None, profile_every=4, device=CPU)
    jex = jax_pipe.finish(depth=2, donate=False, printer=None, profile_every=4)
    for e in (ex, jex):
        for _ in range(9):
            e.send(np.zeros(64, np.float32))
        for _ in e:
            pass
    # blocks 0, 4, 8 sampled
    assert all(st.total_n == 3 for st in ex.stats)
    assert all(st.total_active_s > 0 for st in ex.stats)
    assert ex.chain_stats.total_n == 9
    assert [s.total_n for s in ex.stats] == [s.total_n for s in jex.stats]
    # sampled blocks still produce correct results through the stage path
    out = port.finish(donate=False, profile_every=1, printer=None, device=CPU).run(
        [np.ones(8, np.float32)])
    assert np.allclose(out[0].numpy(), 4.0)


def test_profile_every_zero_disables_sampling():
    ex = streaming.new("a", lambda b: b + 1.0).finish(depth=2, donate=False, printer=None,
                                                      profile_every=0, device=CPU)
    ex.send(np.zeros(8, np.float32))
    for _ in ex:
        pass
    assert ex.stats[0].total_n == 0
    assert ex.chain_stats.total_n == 1


def test_host_blocks_staged_as_jax_stages_them(jax_streaming):
    # numpy float64 becomes float32 and a tuple of planes stacks, as
    # jnp.asarray does (the file-fed example sends (re, im) tuples)
    js, _ = jax_streaming
    re, im = np.arange(6.0), -np.arange(6.0)
    power = lambda b: b[0] * b[0] + b[1] * b[1]  # noqa: E731
    out = streaming.new("Power", power).finish(donate=False, printer=None, device=CPU).run(
        [(re, im)])
    jout = js.new("Power", power).finish(donate=False, printer=None).run([(re, im)])
    assert out[0].dtype == torch.float32
    _same(out, jout)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        streaming.new("a", lambda b: b).finish()
    with pytest.raises(RuntimeError, match="CUDA"):
        streaming.StatefulExecutor(lambda b, s: (b, s), np.zeros(2))


# -- the stateful executor (tests/test_models.py:426-470) -------------------


def test_stateful_executor_contiguous_capture(jax_models):
    from aether_primitives_tpu.parallel.streaming import StatefulExecutor as JaxStateful

    nblk, nblocks = 2 * 256 * 4, 6
    x = _capture(nblk * nblocks, 24)
    cfg = dict(fft_len=256, decimation=4)
    chain = RxChain(RxChainConfig(**cfg), device=CPU)
    ex = streaming.StatefulExecutor(chain.streaming_step, chain.init_state(), depth=2,
                                    printer=None, device=CPU)
    blocks = [x[i * nblk:(i + 1) * nblk] for i in range(nblocks)]
    outs = ex.run(blocks)
    ex.close()
    streamed = torch.cat(outs)
    assert torch.equal(streamed, chain.step(x))
    assert ex.chain_stats.total_n == nblocks
    assert ex.chain_stats.total_samples == nblk * nblocks
    jchain = jax_models.RxChain(jax_models.RxChainConfig(**cfg))
    jex = JaxStateful(jchain.streaming_step, jchain.init_state(), depth=2, printer=None)
    jstreamed = np.concatenate([np.asarray(o) for o in jex.run(blocks)])
    _bits_agree(streamed, jstreamed)
    assert evm_rms_db(chain.spectra(x).numpy(), np.asarray(jchain.spectra(x))) <= EVM_DB
    assert np.array_equal(ex.state.numpy(), np.asarray(jex.state))


@pytest.mark.parametrize("depth", [1, 2, 3, 4])
def test_stateful_executor_depths_packed(depth):
    nblk, nblocks = 4 * 128 * 2, 5
    x = _capture(nblk * nblocks, 27)
    chain = RxChain(RxChainConfig(fft_len=128, decimation=4, packed_bits=True), device=CPU)
    ex = streaming.StatefulExecutor(chain.streaming_step, chain.init_state(), depth=depth,
                                    printer=None, device=CPU)
    outs = ex.run([x[i * nblk:(i + 1) * nblk] for i in range(nblocks)])
    assert torch.equal(torch.cat(outs), chain.step(x))
    assert torch.equal(ex.state, torch.from_numpy(x[-(chain.taps.shape[-1] - 1):]))


def test_stateful_executor_checkpoint_survives_later_sends():
    nblk = 2 * 256 * 4
    chain = RxChain(RxChainConfig(fft_len=256, decimation=4), device=CPU)
    ex = streaming.StatefulExecutor(chain.streaming_step, chain.init_state(), depth=2,
                                    printer=None, device=CPU)
    blocks = [_capture(nblk, 25 + i) for i in range(3)]
    ex.send(blocks[0])
    ex.recv()
    ckpt = ex.state  # checkpoint mid-stream
    ckpt_before = ckpt.clone()
    ex.send(blocks[1])
    ex.recv()
    assert torch.equal(ckpt, ckpt_before)  # a copy: later sends leave it alone
    ex.close()
    # resuming from the checkpoint replays block 1 bit-exactly
    ex2 = streaming.StatefulExecutor(chain.streaming_step, ckpt.numpy(), depth=2,
                                     printer=None, device=CPU)
    replay = ex2.run([blocks[1]])
    direct, _ = chain.streaming_step(blocks[1], ckpt)
    assert torch.equal(replay[0], direct)


def test_stateful_executor_split_sample_count():
    # the JAX executor counts the leaves of a pytree block: a Split block of
    # n samples counts 2n (ROADMAP.md §3 notes this quirk of the reference)
    nblk, nblocks = 4 * 128 * 2, 3
    x = _capture(nblk * nblocks, 28)
    chain = RxChain(RxChainConfig(fft_len=128, decimation=4), device=CPU)
    ex = streaming.StatefulExecutor(chain.streaming_step_split, chain.init_state_split(),
                                    depth=2, printer=None, device=CPU)
    blocks = [Split(x.real[i * nblk:(i + 1) * nblk].copy(), x.imag[i * nblk:(i + 1) * nblk].copy())
              for i in range(nblocks)]
    outs = ex.run(blocks)
    assert torch.equal(torch.cat(outs), chain.step(x))
    assert ex.chain_stats.total_samples == 2 * nblk * nblocks
    assert isinstance(ex.state, Split)


def test_stateful_executor_resumes_jax_stream(jax_models):
    # stop the JAX executor mid-capture, carry np.asarray(ex.state) across,
    # and resume the same capture in the port
    from aether_primitives_tpu.parallel.streaming import StatefulExecutor as JaxStateful

    nblk, nblocks, cut = 4 * 256 * 2, 6, 3
    x = _capture(nblk * nblocks, 29)
    blocks = [x[i * nblk:(i + 1) * nblk] for i in range(nblocks)]
    cfg = dict(fft_len=256, decimation=4, packed_bits=True)
    jchain = jax_models.RxChain(jax_models.RxChainConfig(**cfg))
    jex = JaxStateful(jchain.streaming_step, jchain.init_state(), depth=2, printer=None)
    jhead = jex.run(blocks[:cut])
    carried = np.asarray(jex.state)
    jtail = jex.run(blocks[cut:])
    chain = RxChain(RxChainConfig(**cfg), device=CPU)
    ex = streaming.StatefulExecutor(chain.streaming_step, carried, depth=2, printer=None,
                                    device=CPU)
    tail = ex.run(blocks[cut:])
    _bits_agree(torch.cat(tail), np.concatenate([np.asarray(o) for o in jtail]), packed=True)
    spec = chain._frames_spectra(torch.from_numpy(blocks[cut]),
                                 history=convert.state_from_numpy(carried, CPU)).numpy()
    jspec = np.asarray(jchain._frames_spectra(blocks[cut], history=carried))
    assert evm_rms_db(spec, jspec) <= EVM_DB
    # the port's own stream from the start is byte-exact to its contiguous step,
    # and the resumed part equals it
    full = streaming.StatefulExecutor(chain.streaming_step, chain.init_state(), depth=2,
                                      printer=None, device=CPU).run(blocks)
    assert torch.equal(torch.cat(full), chain.step(x))
    assert torch.equal(torch.cat(tail), torch.cat(full[cut:]))
    assert len(jhead) == cut


# -- on the card ---------------------------------------------------------------


def _card_chain(cuda):
    return RxChain(RxChainConfig(fft_len=256, decimation=4, packed_bits=True), device=cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("source", ["pinned", "pageable", "device"])
@pytest.mark.parametrize("depth", [1, 2, 4])
def test_stateful_executor_on_card_equals_resident(cuda, source, depth):
    nblk, nblocks = 4 * 256 * 16, 8
    x = _capture(nblk * nblocks, 30)
    chain = _card_chain(cuda)
    pool = streaming.make(2, lambda: torch.empty(nblk, dtype=torch.complex64).pin_memory())
    ex = streaming.StatefulExecutor(chain.streaming_step, chain.init_state(), depth=depth,
                                    printer=None, device=cuda)
    launches = rf.launches
    outs = []
    for i in range(nblocks):
        part = x[i * nblk:(i + 1) * nblk]
        if len(ex._inflight) >= ex.depth:
            outs.append(ex.recv())
        if source == "pinned":
            elem = pool.take()
            elem.value.copy_(torch.from_numpy(part))
            ex.send(elem.value)
            elem.release()  # send has returned: the copy has read the buffer
        elif source == "pageable":
            ex.send(part)
        else:
            ex.send(torch.from_numpy(part).to(cuda))
    outs.extend(ex)
    assert rf.launches == launches + nblocks
    state = chain.init_state()
    for i, o in enumerate(outs):
        want, state = chain.streaming_step(torch.from_numpy(x[i * nblk:(i + 1) * nblk]).to(cuda),
                                           state)
        assert torch.equal(o, want)
    assert torch.equal(ex.state, state)
    assert ex.chain_stats.total_samples == nblk * nblocks


@pytest.mark.cuda
def test_stream_executor_on_card_leaves_caller_tensor(cuda):
    ex = streaming.new("Abs", torch.abs).add_stage("Mul 20", lambda b: b * 20.0).finish(
        depth=2, printer=None, device=cuda)
    b = -torch.ones(1 << 20, device=cuda)
    h = -np.ones(1 << 20, np.float32)
    out = ex.run([b, h, torch.from_numpy(h).pin_memory()])
    assert all(bool((o == 20.0).all()) for o in out)
    assert bool((b == -1.0).all()) and bool((h == -1.0).all())
