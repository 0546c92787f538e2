"""Entry points of the port: the single-card step and the multi-shard dry run.

Counterpart of ``__graft_entry__.py``:

- :func:`entry` returns the flagship forward step, the fused RX chain (FIR
  -> decimate -> blocked FFT -> demod through the RX frame kernel) with the
  ``Split`` boundary, and its example block;
- :func:`dryrun_multichip` runs the sharded paths over an ``n``-shard mesh
  at small shapes, each against its one-device form on the same data: the
  chain on the ``(channel, time)`` mesh (one step, three streaming blocks
  with the carried state, and both at the flagship fft_len 2048),
  ``sharded_ddc``, ``sharded_pfb_os``, the CAF, the DOA scan,
  ``PacketModem.rx_batch_sharded`` and ``TPC.sharded_decode``.

Both run on the card unless the caller asks for the CPU. Run both with
``python -m aether_primitives_tpu_torch.entry [n_devices] [--cpu]``.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from .boundary import Split
from .models import RxChain, RxChainConfig
from .types import stage_device

AGREEMENT = 1.0  # sharded vs one-device bits, as __graft_entry__.py asserts
SHARDED_RMS = 1e-5  # sharded DDC and CAF vs one device, relative RMS error
DOA_ATOL = 1e-5  # bearings, radians


def _chain(fft_len: int, decimation: int = 4, device="cuda") -> RxChain:
    """The fused chain (FIR, decimation and frame FFT in one frame op: the
    RX frame kernel on a card), as the JAX dry run pins it."""
    return RxChain(RxChainConfig(fft_len=fft_len, decimation=decimation, fir_mode="fused"),
                   device=device)


def entry(device="cuda"):
    """``(fn, example_args)`` for the single-card step: ``RxChain(fft_len=
    2048, decimation=4)``'s ``step_split`` and a 32,768-sample ``Split``
    block from ``default_rng(0)``, on ``device``."""
    dev = stage_device(device, "entry")
    chain = _chain(fft_len=2048, decimation=4, device=dev)
    n = 4 * 2048 * 4  # 32768-sample block
    rng = np.random.default_rng(0)
    block = Split(
        torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(dev),
        torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(dev),
    )
    return chain.step_split, (block,)


def _devices(n_devices: int, devices: Optional[Sequence]) -> list:
    """``devices`` (``n_devices`` of them), or by default the card's: the
    visible cards in turn, so one card holds every shard."""
    if devices is None:
        stage_device("cuda", "dryrun_multichip")
        count = torch.cuda.device_count()
        devices = [f"cuda:{i % count}" for i in range(n_devices)]
    devices = list(devices)
    if len(devices) < n_devices:
        raise ValueError(f"need {n_devices} devices, got {len(devices)}")
    return devices[:n_devices]


def _cn(rng, *shape) -> np.ndarray:
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)


def _rel_rms(got: torch.Tensor, want: torch.Tensor) -> float:
    g, w = got.to(torch.complex128), want.to(device=got.device, dtype=torch.complex128)
    return float(((g - w).abs().pow(2).mean() / (w.abs().pow(2).mean() + 1e-30)).sqrt())


def _agreement(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.cpu() == want.cpu()).to(torch.float64).mean())


def doa_windows(rng, n_windows: int, coherent: bool = True) -> np.ndarray:
    """The dry run's DOA scene: ``[n_windows, 8, 256]`` snapshots of an
    8-element half-wavelength ULA, window ``w`` with sources at ``-25 + 2w``
    and ``15 + w`` degrees and noise of 0.1 a component from ``rng``. Both
    sources send one waveform (``coherent``, as ``__graft_entry__.py``
    has it), so the signal subspace has rank 1; else the second source's
    tone is 0.3 cycles/sample higher."""
    tsnap = np.arange(256)
    wins = []
    for w in range(n_windows):
        xm = np.zeros((8, 256), np.complex64)
        for j, deg in enumerate((-25.0 + 2 * w, 15.0 + w)):
            a = np.exp(-2j * np.pi * 0.5 * np.sin(np.deg2rad(deg)) * np.arange(8))
            s = np.exp(2j * np.pi * (0.05 + 0.011 * w + (0.0 if coherent else 0.3 * j)) * tsnap)
            xm += np.outer(a, s)
        xm += 0.1 * (rng.normal(size=xm.shape) + 1j * rng.normal(size=xm.shape))
        wins.append(xm.astype(np.complex64))
    return np.stack(wins)


def dryrun_multichip(n_devices: int, devices: Optional[Sequence] = None) -> dict:
    """One pass of every sharded path over a mesh of ``n_devices`` shards
    on ``devices`` (default: the card's; ``["cpu"] * n`` asks for the
    CPU), at ``__graft_entry__.py``'s shapes and data (``default_rng(1)``),
    each held to its one-device form on ``devices[0]`` with the JAX dry
    run's assertions (AssertionError where one fails). Prints one summary
    line; returns every path's output as host tensors (and the flagship
    block and the DOA windows), for comparing two devices' runs."""
    from .models import caf, doa as doa_mod
    from .models.channelizer import pfb_channelize_os, sharded_pfb_os
    from .models.ddc import Ddc, DdcConfig, sharded_ddc
    from .models.packet import PacketConfig, PacketModem
    from .ops.tpc import TPC
    from .parallel import mesh as mesh_mod

    devs = _devices(n_devices, devices)
    dev = torch.device(devs[0])
    ch_ax = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    t_ax = n_devices // ch_ax
    mesh = mesh_mod.make_mesh({"channel": ch_ax, "time": t_ax}, devices=devs)
    out = {}

    def on(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    chain = _chain(fft_len=128, decimation=4, device=dev)
    n_local = 4 * 128
    n = t_ax * n_local
    rng = np.random.default_rng(1)
    block = Split(on(rng.normal(size=(ch_ax * 2, n)).astype(np.float32)),
                  on(rng.normal(size=(ch_ax * 2, n)).astype(np.float32)))
    bits = chain.sharded_step_2d(block.to_complex(), mesh).gather(dev)
    expect_bits = (ch_ax * 2, n // chain.config.decimation * 2)
    assert tuple(bits.shape) == expect_bits, (bits.shape, expect_bits)
    agree = _agreement(bits, chain.step(block.to_complex()))
    assert agree >= AGREEMENT, f"sharded/single bit agreement {agree}"
    out["bits"] = bits.cpu()

    # streaming on the mesh: the carried FIR state threads block to block
    # while each block is itself time-sharded with the halo exchange; three
    # blocks equal one contiguous step of the concatenated capture
    n_blocks = 3
    cap = on(_cn(rng, ch_ax * 2, n_blocks * n))
    contiguous = chain.step(cap)
    st = chain.init_state((ch_ax * 2,))
    parts = []
    for i in range(n_blocks):
        bits_i, st = chain.sharded_streaming_step_2d(cap[:, i * n:(i + 1) * n], st, mesh)
        parts.append(bits_i.gather(dev))
    stream_bits = torch.cat(parts, dim=-1)
    stream_agree = _agreement(stream_bits, contiguous)
    assert stream_agree >= AGREEMENT, f"sharded streaming bit agreement {stream_agree}"
    k_taps = chain.taps.shape[-1]
    assert torch.equal(st.gather(dev), cap[:, -(k_taps - 1):]), "carried state != capture tail"
    out["stream_bits"] = stream_bits.cpu()

    # the flagship configuration (dec 4, fft_len 2048) on the same mesh
    chain_fl = _chain(fft_len=2048, decimation=4, device=dev)
    n_fl = t_ax * 4 * 2048
    block_fl = Split(on(rng.normal(size=(ch_ax, n_fl)).astype(np.float32)),
                     on(rng.normal(size=(ch_ax, n_fl)).astype(np.float32)))
    bits_fl = chain_fl.sharded_step_2d(block_fl.to_complex(), mesh).gather(dev)
    agree_fl = _agreement(bits_fl, chain_fl.step(block_fl.to_complex()))
    assert agree_fl >= AGREEMENT, f"flagship sharded/single bit agreement {agree_fl}"
    out["flagship_bits"], out["flagship_block"] = bits_fl.cpu(), block_fl.numpy()

    # flagship streaming: carried state and time halo, three blocks
    cap_fl = on(_cn(rng, ch_ax, 3 * n_fl))
    contig_fl = chain_fl.step(cap_fl)
    st_fl = chain_fl.init_state((ch_ax,))
    parts_fl = []
    for i in range(3):
        b_i, st_fl = chain_fl.sharded_streaming_step_2d(cap_fl[:, i * n_fl:(i + 1) * n_fl],
                                                        st_fl, mesh)
        parts_fl.append(b_i.gather(dev))
    stream_fl = torch.cat(parts_fl, dim=-1)
    agree_sfl = _agreement(stream_fl, contig_fl)
    assert agree_sfl >= AGREEMENT, f"flagship sharded streaming agreement {agree_sfl}"
    out["flagship_stream_bits"] = stream_fl.cpu()

    # the DDC over a pure time mesh: per-shard exact NCO rotators and the
    # halo through the decimating overlap-save fold
    tmesh = mesh_mod.make_mesh({"time": n_devices}, devices=devs)
    cfg = DdcConfig(freq=0.21, decimation=4)
    xd = on(_cn(rng, n_devices * 1024))
    got = sharded_ddc(xd, cfg, tmesh).gather(dev)
    err = _rel_rms(got, Ddc(cfg, device=dev).step(xd))
    assert err < SHARDED_RMS, f"sharded DDC mismatch {err}"
    out["ddc"] = got.cpu()

    # the oversampled PFB's forward (right-halo) frames over the time mesh
    m_pfb = 32
    xp = on(_cn(rng, n_devices * 10 * m_pfb))
    got_p = sharded_pfb_os(xp, m_pfb, tmesh, os=2, taps_per_branch=2).gather(dev)
    ref_p = pfb_channelize_os(xp, m_pfb, os=2, taps_per_branch=2)
    assert torch.equal(got_p[:ref_p.shape[0]], ref_p), "sharded os-PFB mismatch"
    out["pfb_os"] = got_p.cpu()

    # CAF acquisition: the Doppler hypotheses split over the mesh
    ref_sig = _cn(rng, 128)
    xc = (0.05 * _cn(rng, 1024)).astype(np.complex64)
    tt = np.arange(128)
    xc[300:428] += ref_sig * np.exp(2j * np.pi * 2e-3 * (tt + 300))
    dops = np.linspace(-4e-3, 4e-3, 8 * n_devices).astype(np.float32)
    xc_d, ref_d = on(xc), on(ref_sig)
    surf_s = caf.sharded_ambiguity(xc_d, ref_d, dops, tmesh).gather(dev)
    caf_err = _rel_rms(surf_s, caf.ambiguity(xc_d, ref_d, dops))
    assert caf_err < SHARDED_RMS, f"sharded CAF rel err {caf_err}"
    d_est, _nu, _metric = caf.sharded_estimate_delay_doppler(xc_d, ref_d, 4e-3, tmesh,
                                                             n_dopplers=8 * n_devices)
    assert abs(float(d_est) - 300) < 1.0, float(d_est)
    out["caf"], out["caf_delay"] = surf_s.cpu(), float(d_est)

    # the DOA scan: independent windows over the mesh
    dmesh = mesh_mod.make_mesh({"channel": n_devices}, devices=devs)
    wins = doa_windows(rng, 2 * n_devices)
    wins_d = on(wins)
    doa_s = doa_mod.sharded_estimate_doa(wins_d, 2, dmesh).gather(dev)
    doa_err = float((doa_s - doa_mod.estimate_doa(wins_d, 2)).abs().max())
    assert doa_err < DOA_ATOL, f"sharded DOA mismatch {doa_err}"
    out["doa"], out["doa_windows"] = doa_s.cpu(), wins

    # the batched burst link, bursts data-parallel over the mesh
    pm = PacketModem(PacketConfig(payload_bits=120, fec="rs", rs_n=36, rs_k=20,
                                  preamble_half=32), device=dev)
    payloads = rng.integers(0, 2, (n_devices, 120)).astype(np.uint8)
    caps = np.zeros((n_devices, 2048), np.complex64)
    for i in range(n_devices):
        burst = pm.tx(on(payloads[i])).cpu().numpy()
        caps[i, 40 + 16 * i:40 + 16 * i + burst.size] = burst
    caps += 0.02 * (rng.normal(size=caps.shape) + 1j * rng.normal(size=caps.shape))
    caps_d = on(caps.astype(np.complex64))
    bits_s, ok_s, _diag = pm.rx_batch_sharded(caps_d, dmesh)
    bits_u, _ok_u, _du = pm.rx_batch(caps_d)
    bits_s, ok_s = bits_s.gather(dev), ok_s.gather(dev)
    burst_agree = _agreement(bits_s, bits_u)
    assert burst_agree == 1.0 and bool(ok_s.all()), burst_agree
    assert (bits_s.cpu().numpy() == payloads).all()
    out["burst_bits"] = bits_s.cpu()

    # iterative soft FEC: TPC blocks data-parallel over the mesh
    t = TPC(m=4, p=3, iters=2)
    tdata = rng.integers(0, 2, (2 * n_devices, t.k, t.k)).astype(np.uint8)
    tcw = t.encode(torch.from_numpy(tdata)).numpy().astype(np.float64)
    tllr = on(((1 - 2 * tcw) * 5.0 + 0.4 * rng.normal(size=tcw.shape)).astype(np.float32))
    tdec_s, _tok_s = t.sharded_decode(tllr, dmesh)
    tdec_s = tdec_s.gather(dev)
    tpc_agree = _agreement(tdec_s, t.decode(tllr)[0])
    assert tpc_agree == 1.0 and (tdec_s.cpu().numpy() == tdata).all()
    out["tpc"] = tdec_s.cpu()

    print(f"dryrun_multichip({n_devices}) on {sorted(set(devs))}: OK mesh={mesh.shape} "
          f"bits={tuple(bits.shape)} agreement=100% "
          f"streaming={n_blocks}-blocks-exact(state-tail-exact) "
          f"flagship(fft2048)={tuple(bits_fl.shape)} agreement=100% "
          f"flagship_streaming=3-blocks-exact "
          f"ddc_err={err:.1e} os_pfb=exact "
          f"caf_err={caf_err:.1e}({len(dops)}dop) doa_err={doa_err:.1e} "
          f"burst_rx=payload-exact(B={n_devices}) "
          f"tpc=decode-exact(B={2 * n_devices})", flush=True)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m aether_primitives_tpu_torch.entry",
                                 description=__doc__)
    ap.add_argument("n_devices", nargs="?", type=int, default=8)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    fn, ex = entry(device)
    out = fn(*ex)
    if out.is_cuda:
        torch.cuda.synchronize()
    print(f"entry step OK: {tuple(out.shape)} {out.dtype} on {out.device}")
    dryrun_multichip(args.n_devices, devices=["cpu"] * args.n_devices if args.cpu else None)


if __name__ == "__main__":
    main()
