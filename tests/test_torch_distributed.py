"""The port's mesh across processes: two processes over ``torch.distributed``
(gloo, ``tcp://`` on localhost), four CPU shards each, one process-spanning
8-shard mesh, the port's counterpart of ``tests/test_distributed.py`` and
``tests/distributed_worker.py``.

Each process builds its part of the capture with ``shard_process_local``
(or passes the whole of it, which ``shard`` cuts to its own pieces) and
runs every sharded entry point across the two processes:
``RxChain.sharded_step``, ``sharded_step_2d``, ``sharded_fir``,
``sharded_ddc`` and ``TPC.sharded_decode``; ``sharded_streaming_step_2d``
over three blocks with time across the ranks (the halo and the carried
state cross) and with channels across them (nothing crosses), and through a
``StatefulExecutor`` with ``sharding=``; ``rx_batch_sharded``,
``sharded_pfb``, ``sharded_pfb_os``, ``sharded_waterfall``,
``sharded_duc``, ``sharded_ambiguity``, ``sharded_estimate_doa`` and
``sharded_estimate_delay_doppler``. Each holds its own shards to the JAX
package's unsharded function on the same inputs at the one-process tests'
bars: the chain's bits equal to the port's own one-process ``step`` of the
concatenation and at >= 0.99999 agreement with the JAX ``step``; payloads
and CRC flags exact; the channelizer and DUC at -110 dB; CAF surface -100
dB, delay 1e-3, Doppler 1e-7 (both ranks' estimates identical); DOA
bearings 1e-4 rad. The test computes the JAX outputs (and the bursts' JAX
captures) and writes them to a folder that the workers read; the worker is
this file's ``__main__`` block and imports no JAX. The two workers run once
(a module fixture); each writes one verdict per path, which a test
parametrised over the paths reads.

The cases in one process: ``init_distributed``'s backend check, a mesh of
one process unchanged, and a mesh whose coordinates record two ranks
(built by hand) for ``gather``, ``addressable_shards``, the entry points
that exchange nothing (each rank's part equal to the one-process run) and
the halo paths, which raise without a process group.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from aether_primitives_tpu_torch.parallel import mesh as mesh_mod

torch.set_num_threads(1)

CPU8 = ["cpu"] * 8
DDC_RMS = 1e-5  # tests/distributed_worker.py's bar, relative RMS error
NPROC, FFT_LEN, DEC = 2, 256, 4  # the worker's chain: tests/distributed_worker.py's
DDC_FREQ = 0.1375
AGREEMENT, DB, CAF_DB, DOA_ATOL = 0.99999, -110.0, -100.0, 1e-4
DELAY_ATOL, DOPPLER_ATOL, METRIC_RTOL = 1e-3, 1e-7, 1e-4  # tests/test_torch_caf.py's
STREAM_BLOCKS, STREAM_SPAN = 3, 4 * FFT_LEN * DEC  # 4 time shards of one frame span a block
PFB_M, PFB_P = 16, 4
WATERFALL_LEN = 32
DUC_FREQ, DUC_L = 0.27, 4
CAF_DOPPLER = 5e-3
BURST_PAYLOAD, BURST_WINDOW = 120, 2048
#: the entry points run across the two processes, one verdict each
PATHS = ("sharded_streaming_step_2d[time across ranks]",
         "sharded_streaming_step_2d[channel across ranks]",
         "StatefulExecutor(sharding=)", "rx_batch_sharded", "sharded_pfb", "sharded_pfb_os",
         "sharded_waterfall", "sharded_duc", "sharded_ambiguity", "sharded_estimate_doa",
         "sharded_estimate_delay_doppler")


def _capture(nproc: int) -> np.ndarray:
    """The capture every process builds: 4 x nproc shards of two spans."""
    n = 4 * nproc * FFT_LEN * DEC * 2
    rng = np.random.default_rng(815)
    return (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)


def _cn(rng, *shape):
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)


def _inputs() -> dict:
    """The other entry points' inputs, the same in every process: a
    two-channel capture of STREAM_BLOCKS blocks, the channelizer's, DUC's
    and CAF's captures (8 shards of whole frames or rows), the CAF's
    reference and Doppler grid, and 16 DOA windows of two sources."""
    rng = np.random.default_rng(816)
    x_caf = 0.05 * _cn(rng, 2048)
    ref = _cn(rng, 256)
    x_caf[700:956] += ref * np.exp(2j * np.pi * 3.3e-3 * np.arange(700, 956))
    t = np.arange(512)
    steer = [np.exp(-1j * np.pi * np.arange(8) * np.sin(np.deg2rad(d))) for d in (-20.0, 25.0)]
    wins = np.stack([sum(a[:, None] * np.exp(2j * np.pi * (rng.uniform(0.01, 0.45) * t
                                                           + rng.uniform()))[None, :]
                         for a in steer) + 0.3 * _cn(rng, 8, 512) for _ in range(16)])
    return {
        "stream": _cn(rng, 2, STREAM_BLOCKS * STREAM_SPAN),
        "pfb": _cn(rng, 8 * PFB_M * 4), "pfb_os": _cn(rng, 8 * PFB_M * 12),
        "waterfall": _cn(rng, 8 * 4 * WATERFALL_LEN), "duc": _cn(rng, 8 * 128),
        "caf": x_caf.astype(np.complex64), "caf_ref": ref,
        "dopplers": np.linspace(-CAF_DOPPLER, CAF_DOPPLER, 64).astype(np.float32),
        "doa": wins.astype(np.complex64),
    }


def _jax_entry_references(folder: Path) -> None:
    """The JAX package's unsharded functions on :func:`_inputs` (under
    ``jax.jit`` where the one-process tests jit them), and the bursts'
    captures from its modem, saved under ``folder``."""
    import jax

    from aether_primitives_tpu.models import RxChain as JRxChain, RxChainConfig as JConfig
    from aether_primitives_tpu.models import caf as jcaf, channelizer as jch, doa as jdoa
    from aether_primitives_tpu.models.ddc import Duc as JDuc, DucConfig as JDucConfig
    from aether_primitives_tpu.models.packet import PacketConfig, PacketModem

    inp = _inputs()
    refs = {
        "stream": JRxChain(JConfig(fft_len=FFT_LEN, decimation=DEC, fir_mode="fused")).step(
            inp["stream"]),
        "pfb": jch.pfb_channelize(inp["pfb"], PFB_M, taps_per_branch=PFB_P),
        "pfb_os": jch.pfb_channelize_os(inp["pfb_os"], PFB_M, os=2, taps_per_branch=PFB_P),
        "waterfall": jch.waterfall_spectra(inp["waterfall"], WATERFALL_LEN),
        "duc": JDuc(JDucConfig(freq=DUC_FREQ, interpolation=DUC_L)).step(inp["duc"]),
        "caf": jax.jit(jcaf.ambiguity)(inp["caf"], inp["caf_ref"], inp["dopplers"]),
        "caf_est": _floats(jax.jit(lambda a, r: jcaf.estimate_delay_doppler(
            a, r, CAF_DOPPLER))(inp["caf"], inp["caf_ref"])),
        "doa": jax.jit(lambda w: jdoa.estimate_doa(w, 2))(inp["doa"]),
    }
    pm = PacketModem(PacketConfig(payload_bits=BURST_PAYLOAD, fec="viterbi"))
    rng = np.random.default_rng(817)
    payloads = rng.integers(0, 2, (8, BURST_PAYLOAD)).astype(np.uint8)
    tx = jax.jit(pm.tx)
    caps = 0.02 * _cn(rng, 8, BURST_WINDOW)
    for i, p in enumerate(payloads):
        burst = np.asarray(tx(p))
        caps[i, 40 + 16 * i:40 + 16 * i + burst.size] += burst
    bits, ok, _ = jax.jit(pm.rx_batch)(caps)
    refs.update(burst_caps=caps, burst_payloads=payloads, burst_bits=bits, burst_ok=ok)
    for name, v in refs.items():
        np.save(folder / f"ref_{name}.npy", np.asarray(v))


def _floats(values):
    return np.array([float(v) for v in values], np.float64)


def _jax_references(folder: Path, nproc: int) -> None:
    """The JAX package's FIR (the chain's taps), DDC and TPC decode on the
    workers' inputs, saved under ``folder``: the TPC LLRs and their
    decode, the FIR output and ``Ddc.step`` on the whole capture."""
    pytest.importorskip("jax")
    import jax

    from aether_primitives_tpu.models import RxChain as JRxChain, RxChainConfig as JConfig
    from aether_primitives_tpu.models.ddc import Ddc as JDdc, DdcConfig as JDdcConfig
    from aether_primitives_tpu.ops import fir as jfir
    from aether_primitives_tpu.ops.tpc import TPC as JTPC

    x = _capture(nproc)
    taps = np.asarray(JRxChain(JConfig(fft_len=FFT_LEN, decimation=DEC, fir_mode="fused")).taps)
    np.save(folder / "fir.npy", np.asarray(jfir.fir_filter(x, taps)))
    np.save(folder / "ddc.npy",
            np.asarray(JDdc(JDdcConfig(freq=DDC_FREQ, decimation=DEC)).step(x)))
    t = JTPC(m=4, p=3, iters=2)
    trng = np.random.default_rng(7)
    tdata = trng.integers(0, 2, (8 * nproc, t.k, t.k)).astype(np.uint8)
    tcw = np.asarray(t.encode(tdata)).astype(np.float64)
    tllr = ((1 - 2 * tcw) * 5.0 + 0.4 * trng.normal(size=tcw.shape)).astype(np.float32)
    dec, ok = jax.jit(t.decode)(tllr)
    np.save(folder / "tpc_llr.npy", tllr)
    np.save(folder / "tpc_dec.npy", np.asarray(dec))
    np.save(folder / "tpc_ok.npy", np.asarray(ok))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The two workers, run once: their exit codes, outputs and verdicts."""
    pytest.importorskip("jax")
    folder = tmp_path_factory.mktemp("two_ranks")
    _jax_references(folder, NPROC)
    _jax_entry_references(folder)
    port = _free_port()
    env = dict(os.environ)
    repo_root = str(Path(__file__).resolve().parent.parent)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (repo_root, env.get("PYTHONPATH")) if p)
    procs = [
        subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), str(i), str(NPROC), str(port),
             str(folder)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True,
        )
        for i in range(NPROC)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    verdicts = []
    for i in range(NPROC):
        f = folder / f"verdicts_{i}.json"
        verdicts.append(json.loads(f.read_text()) if f.exists() else {})
    return {"rcs": [p.returncode for p in procs], "outs": outs, "verdicts": verdicts}


def test_two_process_gloo_sharded_paths(two_ranks):
    for i, (rc, out) in enumerate(zip(two_ranks["rcs"], two_ranks["outs"])):
        assert rc == 0, f"process {i} failed:\n{out}"
        assert "verified OK" in out, f"process {i} output:\n{out}"


@pytest.mark.parametrize("path", PATHS)
def test_two_process_entry_point(two_ranks, path):
    for i, verdicts in enumerate(two_ranks["verdicts"]):
        assert verdicts.get(path) == "ok", (
            f"process {i}, {path}: {verdicts.get(path)}\n{two_ranks['outs'][i][-3000:]}")


@pytest.mark.parametrize("backend", [None, "mpi", "NCCL"])
def test_init_distributed_refuses_other_backends(backend):
    with pytest.raises(ValueError, match="backend"):
        mesh_mod.init_distributed(coordinator_address="localhost:1", num_processes=2,
                                  process_id=0, backend=backend)
    assert not torch.distributed.is_initialized()


def test_one_process_mesh_unchanged():
    m = mesh_mod.make_mesh({"channel": 2, "time": 4}, devices=CPU8)
    assert not m.spans_processes and m.rank == 0 and (m.ranks == 0).all()
    assert m.local_mesh() is m and len(m.local_coords()) == 8
    x = torch.arange(2 * 32, dtype=torch.float32).reshape(2, 32)
    s = mesh_mod.shard(x, m, ("channel", "time"))
    assert s.local_view() is s
    assert torch.equal(s.gather(), x) and torch.equal(s.gather(local=True), x)
    p = mesh_mod.shard_process_local(x, m, ("channel", "time"), (2, 32))
    assert all(torch.equal(a, b) for a, b in zip(p.shards.flat, s.shards.flat))
    for sh in s.addressable_shards:
        assert torch.equal(x[sh.index], sh.data)
    assert len(s.addressable_shards) == 8
    with pytest.raises(ValueError, match="process-local data"):
        mesh_mod.shard_process_local(x[:, :16], m, ("channel", "time"), (2, 32))


def _two_rank_mesh(axes, rank):
    """``make_mesh(axes)`` over eight CPU shards as a process of rank
    ``rank`` sees it when two processes hold four each."""
    m = mesh_mod.make_mesh(axes, devices=CPU8)
    return mesh_mod.Mesh(m.devices, m.axis_names, np.repeat([0, 1], 4).reshape(m.devices.shape),
                         rank)


@pytest.mark.parametrize("rank", [0, 1])
def test_two_rank_mesh_local_part(rank):
    m = _two_rank_mesh({"time": 4, "channel": 2}, rank)
    assert m.spans_processes
    assert m.local_box() == (slice(2 * rank, 2 * rank + 2), slice(0, 2))
    x = torch.arange(2 * 64, dtype=torch.float32).reshape(2, 64)
    s = mesh_mod.shard(x, m, ("channel", "time"))
    assert sum(t is not None for t in s.shards.flat) == 4 and s.shape == (2, 64)
    with pytest.raises(ValueError, match="spans processes"):
        s.gather()
    with pytest.raises(ValueError, match="spans processes"):
        np.asarray(s)
    mine = x[:, 32 * rank:32 * (rank + 1)]
    assert torch.equal(s.gather(local=True), mine)
    p = mesh_mod.shard_process_local(mine, m, ("channel", "time"), (2, 64))
    assert [sh.index for sh in p.addressable_shards] == [sh.index for sh in s.addressable_shards]
    for sh in p.addressable_shards:
        assert torch.equal(x[sh.index], sh.data)
    doubled = s.map(lambda t: 2 * t)
    assert torch.equal(doubled.gather(local=True), 2 * mine)


def _burst_captures(pm, n: int = 8):
    """``n`` bursts of the port's modem in noise, one a capture."""
    rng = np.random.default_rng(818)
    payloads = rng.integers(0, 2, (n, BURST_PAYLOAD)).astype(np.uint8)
    caps = 0.02 * _cn(rng, n, BURST_WINDOW)
    for i, p in enumerate(payloads):
        burst = pm.tx(torch.from_numpy(p)).numpy()
        caps[i, 40 + 16 * i:40 + 16 * i + burst.size] += burst
    return payloads, torch.from_numpy(caps)


NO_EXCHANGE = ("rx_batch_sharded", "sharded_ambiguity", "sharded_estimate_doa",
               "sharded_waterfall")


@pytest.mark.parametrize("path", NO_EXCHANGE)
@pytest.mark.parametrize("rank", [0, 1])
def test_paths_without_an_exchange_on_a_two_rank_mesh(rank, path):
    # in one process, with no process group: this rank's part of the
    # result equals the one-process run's
    from aether_primitives_tpu_torch.models import caf, channelizer, doa
    from aether_primitives_tpu_torch.models.packet import PacketConfig, PacketModem

    inp = _inputs()
    if path == "rx_batch_sharded":
        pm = PacketModem(PacketConfig(payload_bits=BURST_PAYLOAD, fec="viterbi"), device="cpu")
        payloads, caps = _burst_captures(pm)
        m = _two_rank_mesh({"channel": 8}, rank)
        bits, ok, diag = pm.rx_batch_sharded(caps, m)
        one = pm.rx_batch(caps)
        got, want = (bits, ok, diag["offset"]), (one[0], one[1], one[2]["offset"])
        assert np.array_equal(one[0].numpy(), payloads) and bool(one[1].all())
    elif path == "sharded_ambiguity":
        x, ref, nu = (torch.from_numpy(inp[k]) for k in ("caf", "caf_ref", "dopplers"))
        got = (caf.sharded_ambiguity(x, ref, nu, _two_rank_mesh({"time": 8}, rank)),)
        want = (caf.ambiguity(x, ref, nu),)
    elif path == "sharded_estimate_doa":
        wins = torch.from_numpy(inp["doa"])
        got = (doa.sharded_estimate_doa(wins, 2, _two_rank_mesh({"channel": 8}, rank)),)
        want = (doa.estimate_doa(wins, 2),)
    else:
        x = torch.from_numpy(inp["waterfall"])
        got = (channelizer.sharded_waterfall(x, WATERFALL_LEN,
                                             _two_rank_mesh({"channel": 8}, rank)),)
        want = (channelizer.waterfall_spectra(x, WATERFALL_LEN),)
    for g, w in zip(got, want):
        assert g.mesh.spans_processes and len(g.addressable_shards) == 4
        for sh in g.addressable_shards:
            assert torch.equal(sh.data, w[sh.index]), sh.index
        half = w.shape[0] // 2
        assert torch.equal(g.gather(local=True), w[rank * half:(rank + 1) * half])


HALO_PATHS = ("sharded_streaming_step_2d", "sharded_pfb", "sharded_pfb_os", "sharded_duc",
              "sharded_estimate_delay_doppler")


@pytest.mark.parametrize("path", HALO_PATHS)
def test_exchanging_paths_without_a_process_group_raise(path):
    from aether_primitives_tpu_torch.models import RxChain, RxChainConfig, caf, channelizer, ddc

    assert not torch.distributed.is_initialized()
    m = _two_rank_mesh({"time": 8}, 0)
    inp = _inputs()
    chain = RxChain(RxChainConfig(fft_len=FFT_LEN, decimation=DEC), device="cpu")
    calls = {
        "sharded_streaming_step_2d": lambda: chain.sharded_streaming_step_2d(
            inp["stream"][:, :STREAM_SPAN], chain.init_state((2,)),
            _two_rank_mesh({"time": 4, "channel": 2}, 0)),
        "sharded_pfb": lambda: channelizer.sharded_pfb(inp["pfb"], PFB_M, m,
                                                       taps_per_branch=PFB_P),
        "sharded_pfb_os": lambda: channelizer.sharded_pfb_os(inp["pfb_os"], PFB_M, m,
                                                             taps_per_branch=PFB_P),
        "sharded_duc": lambda: ddc.sharded_duc(inp["duc"], ddc.DucConfig(freq=DUC_FREQ), m),
        "sharded_estimate_delay_doppler": lambda: caf.sharded_estimate_delay_doppler(
            inp["caf"], inp["caf_ref"], CAF_DOPPLER, m),
    }
    with pytest.raises(RuntimeError, match="joined no process group"):
        calls[path]()


# ------------------------------------------------------------- the worker


def _rel_rms(got, want) -> float:
    got, want = np.asarray(got, np.complex128), np.asarray(want, np.complex128)
    return float(np.sqrt(np.mean(np.abs(got - want) ** 2) / np.mean(np.abs(want) ** 2)))


def _part(a, mesh, spec):
    """This process's part of ``a`` laid out by ``spec`` on ``mesh``: the
    block that its coordinates (``mesh.local_box()``) cover."""
    box = mesh.local_box()
    cut = []
    for d, name in enumerate(tuple(spec) + (None,) * (a.ndim - len(spec))):
        if name is None:
            cut.append(slice(None))
            continue
        j = mesh.axis(name)
        n = a.shape[d] // mesh.devices.shape[j]
        cut.append(slice(box[j].start * n, box[j].stop * n))
    return a[tuple(cut)]


def _entry_points(pid: int, folder: str) -> dict:
    """The entry points of :data:`PATHS` across the processes, each held to
    the JAX references and to the port's one-process run; returns one
    verdict a path ("ok" or what failed). Every exchange runs before the
    checks, so a failed check leaves the ranks in step."""
    from aether_primitives_tpu_torch.evm import evm_rms_db
    from aether_primitives_tpu_torch.models import RxChain, RxChainConfig, caf, channelizer, doa
    from aether_primitives_tpu_torch.models.ddc import DucConfig, sharded_duc
    from aether_primitives_tpu_torch.models.packet import PacketConfig, PacketModem
    from aether_primitives_tpu_torch.parallel import streaming

    inp = _inputs()
    ref = {p.stem[4:]: np.load(p) for p in Path(folder).glob("ref_*.npy")}
    verdicts = {}

    def check(path, fn):
        try:
            fn()
            verdicts[path] = "ok"
        except Exception as e:  # the verdict carries what failed
            verdicts[path] = f"{type(e).__name__}: {e}"

    def placed(a, mesh, spec):
        return mesh_mod.shard_process_local(_part(a, mesh, spec), mesh, spec, a.shape)

    def shards_close(out, want, db, one=None):
        """Each local shard within ``db`` of ``want`` (and equal to the
        one-process run ``one``)."""
        for sh in out.addressable_shards:
            err = evm_rms_db(sh.data.numpy(), want[sh.index])
            assert err <= db, (sh.index, err)
            if one is not None:
                assert torch.equal(sh.data, one[sh.index]), sh.index

    # 1: the 2-D streaming step over three blocks, in two layouts; block 0
    # is the whole capture in every process, blocks 1-2 this process's part
    chain = RxChain(RxChainConfig(fft_len=FFT_LEN, decimation=DEC, fir_mode="fused"),
                    device="cpu")
    cap = inp["stream"]
    contiguous = chain.step(torch.from_numpy(cap)).numpy()
    nb = contiguous.shape[-1] // STREAM_BLOCKS
    k = chain.taps.shape[-1]
    spec2 = ("channel", "time")
    direct = {}
    for label, axes, moving in (("time across ranks", {"time": 4, "channel": 2}, "time"),
                                ("channel across ranks", {"channel": 2, "time": 4}, "channel")):
        mesh = mesh_mod.make_mesh(axes, devices=["cpu"] * 4)
        state, outs = chain.init_state((2,)), []
        for i in range(STREAM_BLOCKS):
            blk = cap[:, i * STREAM_SPAN:(i + 1) * STREAM_SPAN]
            bits, state = chain.sharded_streaming_step_2d(placed(blk, mesh, spec2) if i else blk,
                                                          state, mesh)
            outs.append(bits)
        direct[label] = (mesh, outs, state)

        def verdict(mesh=mesh, outs=outs, state=state, moving=moving):
            j = mesh.axis(moving)
            half = mesh.devices.shape[j] // 2
            assert mesh.local_box()[j] == slice(pid * half, (pid + 1) * half)
            same = total = 0
            for i, bits in enumerate(outs):
                assert bits.spec == spec2
                for sh in bits.addressable_shards:
                    cut = (sh.index[0], slice(i * nb + sh.index[1].start,
                                              i * nb + sh.index[1].stop))
                    got = sh.data.numpy()
                    assert np.array_equal(got, contiguous[cut]), (i, sh.index)
                    same += int((got == ref["stream"][cut]).sum())
                    total += got.size
            assert same / total >= AGREEMENT, same / total
            assert state.spec == ("channel", None) and len(state.addressable_shards) == 4
            for sh in state.addressable_shards:
                assert np.array_equal(sh.data.numpy(), cap[:, cap.shape[-1] - (k - 1):][sh.index])

        check(f"sharded_streaming_step_2d[{label}]", verdict)

    # 2: the same blocks through a StatefulExecutor with a sharding
    mesh, outs, state = direct["time across ranks"]
    ex = streaming.StatefulExecutor(lambda b, s: chain.sharded_streaming_step_2d(b, s, mesh),
                                    chain.init_state((2,)), sharding=(mesh, spec2),
                                    device="cpu", printer=None)
    ys = ex.run([cap[:, i * STREAM_SPAN:(i + 1) * STREAM_SPAN] for i in range(STREAM_BLOCKS)])

    def executor_verdict():
        assert ex.device == torch.device("cpu") and len(ys) == STREAM_BLOCKS
        for y, o in zip(ys + [ex.state], outs + [state]):
            for a, b in zip(y.addressable_shards, o.addressable_shards, strict=True):
                assert a.index == b.index and torch.equal(a.data, b.data), a.index

    check("StatefulExecutor(sharding=)", executor_verdict)

    # 3: bursts data-parallel (viterbi); the JAX modem's captures
    pm = PacketModem(PacketConfig(payload_bits=BURST_PAYLOAD, fec="viterbi"), device="cpu")
    bmesh = mesh_mod.make_mesh({"channel": 8}, devices=["cpu"] * 4)
    b_bits, b_ok, _ = pm.rx_batch_sharded(ref["burst_caps"], bmesh)

    def burst_verdict():
        for got, want in ((b_bits, ref["burst_bits"]), (b_ok, ref["burst_ok"]),
                          (b_bits, ref["burst_payloads"])):
            assert len(got.addressable_shards) == 4
            for sh in got.addressable_shards:
                assert np.array_equal(sh.data.numpy(), want[sh.index]), sh.index

    check("rx_batch_sharded", burst_verdict)

    # 4: the channelizers over a time mesh (halos across the ranks) and the
    # waterfall's rows over a channel mesh
    tmesh = mesh_mod.make_mesh({"time": 8}, devices=["cpu"] * 4)
    cmesh = mesh_mod.make_mesh({"channel": 8}, devices=["cpu"] * 4)
    pfb = channelizer.sharded_pfb(placed(inp["pfb"], tmesh, ("time",)), PFB_M, tmesh,
                                  taps_per_branch=PFB_P)
    check("sharded_pfb", lambda: shards_close(
        pfb, ref["pfb"], DB, channelizer.pfb_channelize(torch.from_numpy(inp["pfb"]), PFB_M,
                                                        taps_per_branch=PFB_P)))
    pfb_os = channelizer.sharded_pfb_os(placed(inp["pfb_os"], tmesh, ("time",)), PFB_M, tmesh,
                                        os=2, taps_per_branch=PFB_P)

    def pfb_os_verdict():
        # the one-shot emits the frames whose windows fit: compare those
        one = channelizer.pfb_channelize_os(torch.from_numpy(inp["pfb_os"]), PFB_M, os=2,
                                            taps_per_branch=PFB_P)
        t = ref["pfb_os"].shape[0]
        assert one.shape[0] == t
        for sh in pfb_os.addressable_shards:
            lo, hi = sh.index[0].start, min(sh.index[0].stop, t)
            if lo < hi:
                assert evm_rms_db(sh.data[:hi - lo].numpy(), ref["pfb_os"][lo:hi]) <= DB
                assert torch.equal(sh.data[:hi - lo], one[lo:hi])
            assert bool(torch.isfinite(sh.data.abs()).all())

    check("sharded_pfb_os", pfb_os_verdict)
    rows = inp["waterfall"].reshape(-1, WATERFALL_LEN)
    wf = channelizer.sharded_waterfall(placed(rows, cmesh, ("channel", None)), WATERFALL_LEN,
                                       cmesh)
    check("sharded_waterfall", lambda: shards_close(
        wf, ref["waterfall"], DB,
        channelizer.waterfall_spectra(torch.from_numpy(inp["waterfall"]), WATERFALL_LEN)))

    # 5: the DUC (the left halo across the ranks, rotators by global index)
    duc = sharded_duc(placed(inp["duc"], tmesh, ("time",)),
                      DucConfig(freq=DUC_FREQ, interpolation=DUC_L), tmesh)
    check("sharded_duc", lambda: shards_close(duc, ref["duc"], DB))

    # 6-7: the CAF's Doppler rows, the DOA windows, and the CAF estimate
    # from the surface all-gathered in every process
    x_c, r_c, nu = (torch.from_numpy(inp[k]) for k in ("caf", "caf_ref", "dopplers"))
    surf = caf.sharded_ambiguity(x_c, r_c, nu, tmesh)
    check("sharded_ambiguity", lambda: shards_close(surf, ref["caf"], CAF_DB,
                                                    caf.ambiguity(x_c, r_c, nu)))
    wins = doa.sharded_estimate_doa(placed(inp["doa"], cmesh, ("channel",)), 2, cmesh)

    def doa_verdict():
        one = doa.estimate_doa(torch.from_numpy(inp["doa"]), 2)
        for sh in wins.addressable_shards:
            assert np.abs(sh.data.numpy() - ref["doa"][sh.index]).max() <= DOA_ATOL
            assert torch.equal(sh.data, one[sh.index])

    check("sharded_estimate_doa", doa_verdict)
    est = caf.sharded_estimate_delay_doppler(x_c, r_c, CAF_DOPPLER, tmesh)
    everyone = [None] * torch.distributed.get_world_size()
    torch.distributed.all_gather_object(everyone, [float(v) for v in est])

    def estimate_verdict():
        assert all(e == everyone[0] for e in everyone), everyone
        one = caf.estimate_delay_doppler(x_c, r_c, CAF_DOPPLER)
        assert all(torch.equal(a, b) for a, b in zip(est, one))
        (d, f, m), (jd, jf, jm) = everyone[pid], ref["caf_est"]
        assert abs(d - jd) <= DELAY_ATOL and abs(f - jf) <= DOPPLER_ATOL, (d, f, jd, jf)
        assert abs(m - jm) <= METRIC_RTOL * abs(jm), (m, jm)

    check("sharded_estimate_delay_doppler", estimate_verdict)
    return verdicts


def worker(pid: int, nproc: int, port: str, folder: str) -> None:
    from aether_primitives_tpu_torch.cli import numpy_reference_bits
    from aether_primitives_tpu_torch.models import RxChain, RxChainConfig
    from aether_primitives_tpu_torch.models.ddc import DdcConfig, sharded_ddc
    from aether_primitives_tpu_torch.ops.tpc import TPC
    from aether_primitives_tpu_torch.parallel import halo

    address = f"127.0.0.1:{port}"
    mesh_mod.init_distributed(coordinator_address=address, num_processes=nproc,
                              process_id=pid, backend="gloo")
    mesh_mod.init_distributed(coordinator_address=address, num_processes=nproc,
                              process_id=pid, backend="gloo")  # a no-op
    assert torch.distributed.get_world_size() == nproc
    mesh = mesh_mod.make_mesh({"time": 4 * nproc}, devices=["cpu"] * 4)
    ndev = mesh.size
    assert ndev == 4 * nproc and mesh.spans_processes and mesh.rank == pid

    cfg = RxChainConfig(fft_len=FFT_LEN, decimation=DEC, fir_mode="fused")
    chain = RxChain(cfg, device="cpu")
    # the same capture in every process (fixed seed); each passes its part
    x = _capture(nproc)
    n = x.size
    local = x[pid * n // nproc:(pid + 1) * n // nproc]
    xg = mesh_mod.shard_process_local(local, mesh, ("time",), (n,))

    out = chain.sharded_step(xg, mesh)
    ref = numpy_reference_bits(x, chain.taps, cfg.decimation, cfg.fft_len)
    checked = 0
    for sh in out.addressable_shards:
        got = sh.data.numpy()
        want = ref[sh.index[-1]]
        assert got.shape == want.shape
        agree = float((got == want).mean())
        assert agree == 1.0, f"process {pid} shard {sh.index}: {agree}"
        checked += got.size
    assert checked == ref.size // nproc, (checked, ref.size)
    try:
        out.gather()
        raise AssertionError("gather of a value that spans processes did not raise")
    except ValueError:
        pass
    half = ref.size // nproc
    assert np.array_equal(out.gather(local=True).numpy(), ref[pid * half:(pid + 1) * half])

    # two axes: time split over the ranks, both channels in each
    mesh2 = mesh_mod.make_mesh({"time": 2 * nproc, "channel": 2}, devices=["cpu"] * 4)
    x2 = np.stack([x, x[::-1].copy()])
    part = x2[:, pid * n // nproc:(pid + 1) * n // nproc]
    out2 = chain.sharded_step_2d(mesh_mod.shard_process_local(part, mesh2, ("channel", "time"),
                                                              x2.shape), mesh2)
    for ch in range(2):
        ref2 = numpy_reference_bits(x2[ch], chain.taps, cfg.decimation, cfg.fft_len)
        got2 = out2.gather(local=True).numpy()[ch]
        want2 = ref2[pid * ref2.size // nproc:(pid + 1) * ref2.size // nproc]
        assert np.array_equal(got2, want2), f"process {pid} 2-d channel {ch}"

    # the FIR alone, by shift-and-add and by overlap-save, against the JAX
    # package's fir_filter with the JAX chain's taps
    fir_ref = np.load(Path(folder) / "fir.npy")
    for use_os in (False, True):
        got_f = halo.sharded_fir(xg, chain.taps, mesh, use_os=use_os, block_len=256)
        for sh in got_f.addressable_shards:
            err = _rel_rms(sh.data, fir_ref[sh.index[-1]])
            assert err < DDC_RMS, f"process {pid} fir (os {use_os}) shard {sh.index}: {err}"

    # the sharded DDC: per-shard exact NCO rotators and a halo that crosses
    # the process boundary
    dcfg = DdcConfig(freq=DDC_FREQ, decimation=DEC)
    got_d = sharded_ddc(mesh_mod.shard_process_local(local, mesh, ("time",), (n,)), dcfg, mesh)
    ref_d = np.load(Path(folder) / "ddc.npy")  # the JAX package's Ddc.step
    for sh in got_d.addressable_shards:
        err = _rel_rms(sh.data, ref_d[sh.index[-1]])
        assert err < DDC_RMS, f"process {pid} ddc shard {sh.index}: {err}"

    # the block-sharded TPC decode: each process decodes its own blocks,
    # against the JAX package's decode of the same LLRs
    t = TPC(m=4, p=3, iters=2)
    tllr = np.load(Path(folder) / "tpc_llr.npy")
    tmesh = mesh_mod.make_mesh({"channel": 4 * nproc}, devices=["cpu"] * 4)
    tdec, tok = t.sharded_decode(tllr, tmesh)
    mine = slice(pid * 2 * ndev // nproc, (pid + 1) * 2 * ndev // nproc)
    assert np.array_equal(tdec.gather(local=True).numpy(),
                          np.load(Path(folder) / "tpc_dec.npy")[mine])
    assert np.array_equal(tok.gather(local=True).numpy(),
                          np.load(Path(folder) / "tpc_ok.npy")[mine])

    verdicts = _entry_points(pid, folder)
    (Path(folder) / f"verdicts_{pid}.json").write_text(json.dumps(verdicts))
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    print(f"process {pid}: {checked} bits verified OK; entry points: "
          + ", ".join(f"{k} {v}" for k, v in verdicts.items()), flush=True)


if __name__ == "__main__":
    torch.set_num_threads(1)
    worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
