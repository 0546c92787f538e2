"""The port's mesh across processes: two processes over ``torch.distributed``
(gloo, ``tcp://`` on localhost), four CPU shards each, one process-spanning
8-shard ``time`` mesh, the port's counterpart of ``tests/test_distributed.py``
and ``tests/distributed_worker.py``.

Each process builds its part of the capture with
``shard_process_local``, runs ``RxChain.sharded_step`` (the FIR halo crosses
the process boundary through ``send`` / ``recv``), ``sharded_step_2d`` on a
``{time: 4, channel: 2}`` mesh, ``sharded_fir``, ``sharded_ddc`` and
``TPC.sharded_decode``, and holds its own shards to the float64 reference
chain (bits exact), to the JAX package's ``Ddc.step`` and ``fir_filter`` on
the whole capture (RMS error < 1e-5, the JAX worker's bar) and to its
``TPC.decode`` (exact). The test computes the JAX outputs on the same
inputs and writes them to a folder that the workers read; the worker is
this file's ``__main__`` block and imports no JAX.

The cases in one process: ``init_distributed``'s backend check, a mesh of
one process unchanged, and a mesh whose coordinates record two ranks
(built by hand) for ``gather``, ``addressable_shards`` and the entry
points that refuse a mesh spanning processes.
"""

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


def _capture(nproc: int) -> np.ndarray:
    """The capture every process builds: 4 x nproc shards of two spans."""
    n = 4 * nproc * FFT_LEN * DEC * 2
    rng = np.random.default_rng(815)
    return (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)


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


def test_two_process_gloo_sharded_paths(tmp_path):
    # bounded by the workers' communicate(timeout=240) below
    _jax_references(tmp_path, NPROC)
    port = _free_port()
    env = dict(os.environ)
    repo_root = str(Path(__file__).resolve().parent.parent)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (repo_root, env.get("PYTHONPATH")) if p)
    procs = [
        subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), str(i), str(NPROC), str(port),
             str(tmp_path)],
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
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i} failed:\n{out}"
        assert "verified OK" in out, f"process {i} output:\n{out}"


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


def test_entry_points_refuse_a_mesh_that_spans_processes():
    from aether_primitives_tpu_torch.models import RxChain, RxChainConfig
    from aether_primitives_tpu_torch.models import caf, channelizer, ddc, doa
    from aether_primitives_tpu_torch.models.packet import PacketConfig, PacketModem
    from aether_primitives_tpu_torch.parallel import streaming

    m = _two_rank_mesh({"time": 8}, 0)
    x = np.zeros(8 * 1024, np.complex64)
    chain = RxChain(RxChainConfig(fft_len=64, decimation=4), device="cpu")
    calls = {
        "RxChain.sharded_streaming_step_2d":
            lambda: chain.sharded_streaming_step_2d(x[None], chain.init_state((1,)), m, "time",
                                                    "time"),
        "sharded_ambiguity": lambda: caf.sharded_ambiguity(x, x[:64], np.zeros(8), m),
        "sharded_estimate_delay_doppler":
            lambda: caf.sharded_estimate_delay_doppler(x, x[:64], 1e-3, m, n_dopplers=8),
        "sharded_waterfall": lambda: channelizer.sharded_waterfall(x, 64, m, axis_name="time"),
        "sharded_pfb": lambda: channelizer.sharded_pfb(x, 16, m),
        "sharded_pfb_os": lambda: channelizer.sharded_pfb_os(x, 16, m),
        "sharded_duc": lambda: ddc.sharded_duc(x, ddc.DucConfig(), m),
        "sharded_estimate_doa":
            lambda: doa.sharded_estimate_doa(np.zeros((8, 4, 16), np.complex64), 1, m, "time"),
        "PacketModem.rx_batch_sharded":
            lambda: PacketModem(PacketConfig(), device="cpu").rx_batch_sharded(
                np.zeros((8, 64), np.complex64), m, "time"),
        "a streaming executor's sharding":
            lambda: streaming.new("same", lambda b: b).finish(sharding=(m, ("time",)),
                                                              device="cpu"),
    }
    for name, call in calls.items():
        with pytest.raises(NotImplementedError, match="spans processes"):
            call()


# ------------------------------------------------------------- the worker


def _rel_rms(got, want) -> float:
    got, want = np.asarray(got, np.complex128), np.asarray(want, np.complex128)
    return float(np.sqrt(np.mean(np.abs(got - want) ** 2) / np.mean(np.abs(want) ** 2)))


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

    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    print(f"process {pid}: {checked} bits verified OK", flush=True)


if __name__ == "__main__":
    torch.set_num_threads(1)
    worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
