"""The RX chain benchmark and the per-op micro-benchmark on a CUDA device,
and the float64 reference chain.

Counterpart of ``aether_primitives_tpu/cli.py``:

- ``bench_main`` (``aether-torch-bench``): the same chain (fft_len 2048,
  decimation 4, 65 taps, packed QPSK bytes), the same 4,194,304-sample
  blocks and the same two-block streaming gate, timed with CUDA events on
  blocks already resident on the device. Also ``python -m
  aether_primitives_tpu_torch.cli``.
- ``microbench_main`` (``aether-torch-microbench``): the JAX package's 33
  per-op rows (names, sizes and seed 815 kept), each calling the port's
  function for that op on inputs resident on the card, timed by CUDA
  events (the median of ``--rounds`` rounds of ``--iters`` calls after
  warm-up), with the kernels a call and the device's busy time from
  ``torch.profiler`` over one call, and the launches of the seven
  hand-written kernels a call. The JAX package's relay timing (marginal
  cost, digests, the plausibility cap) has no counterpart: events time the
  device directly.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from .models import RxChain, RxChainConfig
from .ops.cuda import rx_frame as _rx_frame

BLOCK = 1 << 22  # samples per block of the benchmark and the gate
GATE_AGREEMENT = 0.99999
GATE_EVM_DB = -80.0
TIMED_STEPS = 50


def numpy_reference_spectra(x: np.ndarray, taps: np.ndarray, dec: int, fft_len: int):
    """float64 reference front half: causal FIR, decimate, fft(SN) frames."""
    y = np.convolve(x.astype(np.complex128), taps.astype(np.complex128))[: len(x)]
    y = y[::dec]
    frames = y.reshape(-1, fft_len)
    return np.fft.fft(frames, axis=-1) / np.sqrt(np.float32(fft_len))


def numpy_reference_bits(x: np.ndarray, taps: np.ndarray, dec: int, fft_len: int):
    """float64 reference chain: causal FIR, decimate, fft(SN), QPSK demod."""
    spec = numpy_reference_spectra(x, taps, dec, fft_len)
    b0 = (spec.real < 0).astype(np.uint8)
    b1 = (spec.imag < 0).astype(np.uint8)
    return np.stack([b0, b1], axis=-1).reshape(-1)


def capture(n: int, seed: int = 815) -> np.ndarray:
    """``n`` complex64 samples of unit-variance Gaussian noise per
    component, from ``seed``."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)


def card_label() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except FileNotFoundError:
        return "nvidia-smi not found"
    return out.stdout.strip() or out.stderr.strip()


def max_sm_clock_hz() -> float:
    """The first card's maximum SM clock as ``nvidia-smi`` reports it, in
    Hz. Raises RuntimeError where it reports none."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30,
        ).stdout.split()
        return float(out[0]) * 1e6
    except (OSError, ValueError, IndexError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"nvidia-smi reported no maximum SM clock: {e!r}") from e


def stream_blocks(chain: RxChain, x_full: np.ndarray, n: int):
    """The main path: consecutive ``n``-sample blocks of ``x_full`` through
    ``chain.streaming_step`` from a zero state. Returns the per-block bits
    and the state after each block (both on the chain's device)."""
    state = chain.init_state()
    bits, states = [], []
    for i in range(len(x_full) // n):
        block = torch.from_numpy(x_full[i * n:(i + 1) * n]).to(chain.device)
        b, state = chain.streaming_step(block, state)
        bits.append(b)
        states.append(state)
    return bits, states


def gate(chain: RxChain, x_full: np.ndarray, n: int, bits, states) -> dict:
    """The streaming gate over the blocks of :func:`stream_blocks`:

    - bit agreement of all blocks against the float64 chain, >= 0.99999;
    - RMS EVM of the last block's spectrum, taken through the RX frame
      op's spectrum epilogue with the carried history, <= -80 dB;
    - the carried state equal to the capture's last K-1 samples.

    QPSK or BPSK chains with all bins active.
    """
    cfg = chain.config
    got = torch.cat([b.cpu() for b in bits], dim=-1)
    if cfg.packed_bits:
        got = _rx_frame.unpack_bits(got)
    got = got.numpy()
    ref_spec = numpy_reference_spectra(x_full, chain.taps, cfg.decimation,
                                       cfg.fft_len)
    if cfg.modulation == "bpsk":
        ref_bits = (ref_spec.real + ref_spec.imag < 0).astype(np.uint8).reshape(-1)
    else:
        ref_bits = np.stack([ref_spec.real < 0, ref_spec.imag < 0],
                            axis=-1).astype(np.uint8).reshape(-1)
    agree = float((got == ref_bits).mean())

    k = chain.taps.shape[-1]
    last = torch.from_numpy(x_full[-n:]).to(chain.device)
    spec = _rx_frame.rx_frame(
        last, chain.taps, cfg.decimation, cfg.fft_len,
        history=states[-2] if len(states) > 1 else None,
        epilogue="spectrum", stage_n1=cfg.stage_n1,
    ).cpu().numpy()
    ref_last = ref_spec[-spec.shape[0]:]
    err = np.abs(spec.astype(np.complex128) - ref_last) ** 2
    evm_db = float(10.0 * np.log10(err.mean() / (np.abs(ref_last) ** 2).mean()))
    tail = torch.from_numpy(x_full[len(x_full) - (k - 1):])
    state_exact = bool(torch.equal(states[-1].cpu(), tail))
    return {
        "bit_agreement": agree,
        "evm_rms_db": evm_db,
        "state_exact": state_exact,
        "ok": agree >= GATE_AGREEMENT and evm_db <= GATE_EVM_DB and state_exact,
    }


def time_cuda(fn, iters: int, warmup: int = 3) -> float:
    """Milliseconds per call of ``fn()``, by CUDA events around ``iters``
    calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def kernel_device_times(fn, match: str, calls: int = 20) -> list:
    """``(name, microseconds)`` of every kernel whose name holds ``match``
    that ``torch.profiler`` (CUPTI) recorded over ``calls`` calls of
    ``fn()`` after one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
            if e.device_type == DeviceType.CUDA and match in e.name]


def kernel_device_ms(fn, match: str, calls: int = 20, tries: int = 6) -> float:
    """Device milliseconds a launch of the kernels whose name holds
    ``match``, by ``torch.profiler`` (CUPTI) over ``calls`` calls of
    ``fn()`` after one: the kernel's own time, without the host's time
    between launches. The mean over the launches the profiler recorded,
    which may be fewer than were made (it drops some, at times all of a
    window's, on an H100 in chip_smoke.py three windows running once: then
    it profiles another window, ``tries`` in all), so a call of ``fn``
    should launch one such kernel. Raises where no window recorded any."""
    for _ in range(tries):
        us = [t for _, t in kernel_device_times(fn, match, calls)]
        if us:
            return sum(us) / len(us) / 1e3
    raise RuntimeError(f"the profiler recorded no device time for kernels named {match!r} "
                       f"in {tries} windows of {calls} calls")


def resident_streaming(chain: RxChain, nblocks: int = 4, seed: int = 816):
    """A ``step()`` closure that streams ``nblocks`` device-resident blocks
    round-robin through ``chain.streaming_step``, carrying the state."""
    blocks = [
        torch.from_numpy(capture(BLOCK, seed + i)).to(chain.device)
        for i in range(nblocks)
    ]
    box = {"state": chain.init_state(), "i": 0}

    def step():
        bits, box["state"] = chain.streaming_step(blocks[box["i"] % nblocks],
                                                  box["state"])
        box["i"] += 1
        return bits

    return step


def bench_main(argv=None):
    """Headline benchmark: Msamples/s of the streaming RX chain on one CUDA
    device, as ONE JSON line. Exits 1 when there is no CUDA device or the
    gate fails."""
    argparse.ArgumentParser(prog="aether-torch-bench").parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("bench_main needs a CUDA device; none is available")
    # the -80 dB gate needs full float32 products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    chain = RxChain(RxChainConfig(fft_len=2048, decimation=4, packed_bits=True),
                    device="cuda")
    x_full = capture(2 * BLOCK)
    bits, states = stream_blocks(chain, x_full, BLOCK)
    result = gate(chain, x_full, BLOCK, bits, states)
    payload = {
        "metric": "rx_chain_msamples_per_s",
        "unit": "Msamples/s",
        "device": torch.cuda.get_device_name(0),
        "card": card_label(),
        "gate": result,
    }
    if not result["ok"]:
        payload["value"] = 0.0
        payload["error"] = "correctness gate failed"
        print(json.dumps(payload))
        sys.exit(1)
    ms = time_cuda(resident_streaming(chain), TIMED_STEPS)
    payload["ms_per_block"] = ms
    payload["value"] = BLOCK / (ms * 1e-3) / 1e6
    print(json.dumps(payload))
    return None


#: The seven hand-written kernels, whose launches a microbench row counts
#: (``ops/cuda/<name>.py``'s ``launches``).
KERNELS = ("rx_frame", "viterbi", "bcjr", "pfb_fold", "cmul", "stream", "halo")


def kernel_launches() -> dict:
    """Every hand-written kernel's launch count in this process."""
    import importlib

    return {k: importlib.import_module(f"{__package__}.ops.cuda.{k}").launches
            for k in KERNELS}


def time_host(fn, iters: int, warmup: int = 0, sync=None) -> float:
    """Milliseconds per call of ``fn()`` by the host clock; ``sync()``,
    where given, runs before the clock starts and before it stops (to wait
    for a card's queued work)."""
    for _ in range(warmup):
        fn()
    if sync is not None:
        sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    if sync is not None:
        sync()
    return (time.perf_counter() - t0) * 1e3 / iters


def profile_call(fn, calls: int = 1, warm: bool = True) -> dict:
    """``torch.profiler`` (CUPTI) over ``calls`` calls of ``fn()``, device
    activity only, after one call outside it where ``warm``: ``{"kernels":
    device activities a call, "busy_ms": their summed device time a call,
    "wall_ms": the host clock a call (profiler on), "names": {kernel name:
    (summed us, count)}}``; None for each where the profiler recorded no
    device activity (it drops records at times)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if warm:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    acts = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not acts:
        return {"kernels": None, "busy_ms": None, "wall_ms": wall_ms, "names": {}}
    names = {}
    for e in acts:
        us, count = names.get(e.name, (0.0, 0))
        names[e.name] = (us + e.time_range.elapsed_us(), count + 1)
    return {"kernels": len(acts) / calls,
            "busy_ms": sum(e.time_range.elapsed_us() for e in acts) / calls / 1e3,
            "wall_ms": wall_ms, "names": names}


def _np_polar_encode(u: np.ndarray) -> np.ndarray:
    """Polar transform of ``u [..., n]`` over GF(2), in numpy (the JAX
    microbench's own helper)."""
    x, step = u.copy(), 1
    while step < u.shape[-1]:
        b = x.reshape(x.shape[:-1] + (-1, 2, step))
        b[..., 0, :] ^= b[..., 1, :]
        x = b.reshape(x.shape)
        step *= 2
    return x


def microbench_main(argv=None):
    """Per-op micro-benchmark: one row per op of the JAX package's
    ``microbench_main`` (``aether_primitives_tpu/cli.py:95-449``), printed
    a line each and written with ``--json``. Exits 1 without a CUDA device
    unless ``--cpu`` asks for the CPU (timed by the host clock: for the
    tests, not a measurement of the card)."""
    ap = argparse.ArgumentParser(prog="aether-torch-microbench",
                                 description="Per-op micro-benchmark of the port on one card.")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU, timed by the host clock (tests only)")
    ap.add_argument("--json", default=None)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--rounds", type=int, default=3,
                    help="timed rounds per row (the median is the row's time)")
    args = ap.parse_args(argv)

    from .models.caf import ambiguity
    from .models.channelizer import istft, stft
    from .models.css import CssConfig, CssModem
    from .models.ddc import DdcConfig
    from .ops import fec as _fec
    from .ops import fir, frontend, modulation, sampling, vecops
    from .ops import ldpc as _ldpc
    from .ops import polar as _polar
    from .ops.fft import Scale, plan as fft_plan
    from .ops.iir import butter_sos, sosfilt
    from .ops.rs import rs_255_223
    from .ops.turbo import turbo_decode, turbo_encode

    if args.cpu:
        dev = torch.device("cpu")
        head = {"platform": "cpu", "device": "cpu", "card": "none (a CPU run: not measured)",
                "timing": "host clock (perf_counter), no card"}
    else:
        if not torch.cuda.is_available():
            sys.exit("microbench_main needs a CUDA device (--cpu asks for the CPU)")
        dev = torch.device("cuda", torch.cuda.current_device())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        head = {"platform": "gpu", "device": torch.cuda.get_device_name(dev),
                "card": card_label(), "timing": "CUDA events"}
    clock = time_host if args.cpu else time_cuda
    rng = np.random.default_rng(815)
    results = []

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def timed(name, fn, blk, samples, iters=args.iters):
        call = (lambda: fn(*blk)) if isinstance(blk, tuple) else (lambda: fn(blk))
        call()  # warm-up: kernel builds, cuFFT plans, caches
        sync()
        before = kernel_launches()  # the second warm-up call counts the launches
        call()
        sync()
        after = kernel_launches()
        launches = {k: after[k] - before[k] for k in KERNELS if after[k] != before[k]}
        rounds = [clock(call, iters, warmup=0) for _ in range(max(1, args.rounds))]
        ms = statistics.median(rounds)
        prof = profile_call(call) if dev.type == "cuda" else {"kernels": None, "busy_ms": None}
        row = {
            "bench": name, "us_per_call": ms * 1e3,
            "msamples_per_s": samples / (ms * 1e-3) / 1e6,
            "rounds_us_per_call": [r * 1e3 for r in rounds],
            "round_spread": max(rounds) / min(rounds),
            "iters": iters,
            "kernels_per_call": prof["kernels"],
            "device_busy_ms": prof["busy_ms"],
            "idle": None if prof["busy_ms"] is None else max(0.0, 1 - prof["busy_ms"] / ms),
            "launches": launches,
        }
        results.append(row)
        busy = ("not measured" if prof["busy_ms"] is None else
                f"{prof['kernels']:g} kernels, busy {prof['busy_ms']:.4f} ms, "
                f"idle {100 * row['idle']:.1f}%")
        print(f"{name:46s} {row['us_per_call']:11.1f} us/call {row['msamples_per_s']:10.1f} "
              f"Msa/s  spread {row['round_spread']:.2f}x/{len(rounds)}r  {busy}"
              + (f"  launches {launches}" if launches else ""), flush=True)

    def on(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def rsplit(shape):
        re = rng.normal(size=shape).astype(np.float32)
        im = rng.normal(size=shape).astype(np.float32)
        return on(re + 1j * im.astype(np.complex64))

    B = args.batch
    slow = min(args.iters, 10)  # the decoders' rows: the JAX rows' 10 calls at most

    # vecops @ N=2048 (reference benches/benches.rs:28-70)
    n = 2048
    two = rsplit((B, n))
    timed("vecops mul [batch x 2048]", lambda x: vecops.mul(x, x), two, B * n)
    timed("vecops scale [batch x 2048]", lambda x: vecops.scale(x, 2.0), two, B * n)
    timed("vecops conj+mirror [batch x 2048]", lambda x: vecops.mirror(vecops.conj(x)), two,
          B * n)

    # interpolate / downsample (reference benches/benches.rs:72-133)
    timed("interpolate (1024,4) [batch]", lambda x: sampling.interpolate(x, 4),
          rsplit((B, 1024)), B * 1024)
    timed("downsample 30720->1024 [batch]", lambda x: sampling.downsample(x, 1024),
          rsplit((B // 8 or 1, 30720)), (B // 8 or 1) * 30720)

    # modulation (reference benches/benches.rs:192-281)
    qpsk = modulation.qpsk()
    bits = on(rng.integers(0, 2, (B, 8000)).astype(np.uint8))
    timed("qpsk modulate 8000 bits [batch]", qpsk.modulate, bits, B * 8000)
    timed("qpsk demod 4000 syms [batch]", qpsk.demod, rsplit((B, 4000)), B * 4000)
    bpsk = modulation.bpsk()
    timed("bpsk modulate 8000 bits [batch]", bpsk.modulate, bits, B * 8000)

    # FFT fwd/bwd (reference benches/benches.rs:288-380)
    for nfft in (512, 1024, 2048):
        p = fft_plan(nfft)
        blk = rsplit((B, nfft))
        timed(f"fft {nfft} fwd SN [batch]", lambda x, p=p: p.fwd(x, Scale.SN), blk, B * nfft)
        timed(f"fft {nfft} bwd SN [batch]", lambda x, p=p: p.bwd(x, Scale.SN), blk, B * nfft)

    # freq-domain correlator (reference benches/benches.rs:382-423)
    for nfft in (512, 1024, 2048):
        sig_c = rsplit((nfft,))
        timed(f"correlator {nfft} [batch]", lambda x, s=sig_c: fir.correlate(x, s),
              rsplit((B, nfft)), B * nfft)

    # the front-end mixer and the DDC core (mix -> lowpass -> /8)
    nddc = B * 2048
    ddc_taps = DdcConfig(decimation=8).resolved_taps()
    one = rsplit((nddc,))
    timed("nco mix [flat]", lambda x: frontend.nco_mix(x, 0.1375), one, nddc)
    timed("ddc core: mix+fir129+/8 [flat]",
          lambda x: fir.fir_filter_os_decimate(frontend.nco_mix(x, 0.1375), ddc_taps, 8),
          one, nddc)

    # channel coding, acquisition, spread spectrum
    h_pc, _g, _info = _ldpc.make_regular_ldpc(648, 3, 6, seed=7)
    nfr = max(B // 16, 1)
    llr_blk = on(rng.normal(size=(nfr, 648)).astype(np.float32) * 4.0)
    timed(f"ldpc min-sum 25 iters [{nfr} x 648]",
          lambda l: _ldpc.ldpc_decode(l, h_pc, iters=25)[0], llr_blk, nfr * 648)
    h_11n, _g11, _i11 = _ldpc.wifi_ldpc()
    timed(f"ldpc 802.11n(648,R1/2) min-sum 25 it [{nfr} cw]",
          lambda l: _ldpc.ldpc_decode(l, h_11n, iters=25)[0], llr_blk, nfr * 648)
    timed(f"ldpc 802.11n QC edge decoder 25 it [{nfr} cw]",
          lambda l: _ldpc.qc_ldpc_decode(l, _ldpc._WIFI_648_R12, 27, iters=25)[0],
          llr_blk, nfr * 648)

    vb_bits = rng.integers(0, 2, (nfr, 1024)).astype(np.uint8)
    vb_coded = _fec.conv_encode(torch.from_numpy(vb_bits)).numpy()
    vb_llr = on((4.0 * (1.0 - 2.0 * vb_coded.astype(np.float32))).astype(np.float32))
    timed(f"viterbi K=7 decode [{nfr} x 1024 bits]", _fec.viterbi_decode, vb_llr, nfr * 1024,
          iters=slow)

    css = CssModem(CssConfig(sf=10), device=dev)
    n_css = B * 1024
    timed("css demod SF10 [flat]", lambda x: css.demod_symbols(x)[0], rsplit((n_css,)), n_css)

    ref_caf = rsplit((4096,))
    dops = np.linspace(-1e-3, 1e-3, 64).astype(np.float32)
    timed("caf 64 dopplers x 4096", lambda x: ambiguity(x, ref_caf, dops), rsplit((4096,)),
          64 * 4096)

    crc_bits_in = on(rng.integers(0, 2, 1 << 20).astype(np.uint8))
    timed("crc32 2^20 bits", lambda b: _fec.crc_compute(b, 0x04C11DB7, 32, 0xFFFFFFFF),
          crc_bits_in, 1 << 20)

    # Reed-Solomon (samples = GF(2^8) symbols = bytes)
    rs_code = rs_255_223()
    nrs = max(B // 4, 1)
    rs_msgs = rng.integers(0, 256, (nrs, 223)).astype(np.uint8)
    timed(f"rs(255,223) encode [{nrs} cw]", rs_code.encode, on(rs_msgs), nrs * 223)
    rs_cws = rs_code.encode(torch.from_numpy(rs_msgs)).numpy().copy()
    for row in rs_cws:  # full-t error load
        row[rng.choice(255, 16, replace=False)] ^= rng.integers(1, 256, 16).astype(np.uint8)
    timed(f"rs(255,223) decode t=16 errs [{nrs} cw]", lambda c: rs_code.decode(c)[0],
          on(rs_cws), nrs * 255)

    # turbo decode, batched over codewords (the BCJR kernel's rsc8 instance)
    ntb, nblk = 1024, max(B // 16, 1)
    tb_bits = rng.integers(0, 2, (nblk, ntb)).astype(np.uint8)
    enc = turbo_encode(torch.from_numpy(tb_bits))
    tb_args = tuple(on((8.0 * (1.0 - 2.0 * v.numpy().astype(np.float32))).astype(np.float32))
                    for v in enc)
    timed(f"turbo decode 8 iters win64 [{nblk} x {ntb} bits]",
          lambda *t: turbo_decode(*t, iterations=8, window=64, guard=16)[0], tb_args,
          nblk * ntb, iters=slow)

    # polar decode, batched over codewords
    npo, kpo, nblk_po = 1024, 512, max(B // 16, 1)
    po_mask = _polar.polar_construct(npo, kpo, design_snr_db=1.0)
    po_u = np.zeros((nblk_po, npo), np.uint8)
    po_u[:, np.where(po_mask)[0]] = rng.integers(0, 2, (nblk_po, kpo)).astype(np.uint8)
    po_llr = on((8.0 * (1.0 - 2.0 * _np_polar_encode(po_u))).astype(np.float32))
    timed(f"polar SC decode (1024,512) [{nblk_po} cw]",
          lambda l: _polar.polar_decode(l, po_mask), po_llr, nblk_po * kpo, iters=slow)
    scl_code = _polar.PolarCode(n=256, k=128, crc="crc8", list_size=8)
    scl_bits = rng.integers(0, 2, (nblk_po, scl_code.payload_bits)).astype(np.uint8)
    scl_x = scl_code.encode(torch.from_numpy(scl_bits)).numpy()
    scl_llr = on((8.0 * (1.0 - 2.0 * scl_x)).astype(np.float32))
    timed(f"polar CA-SCL L=8 (256,128+crc8) [{nblk_po} cw]", lambda l: scl_code.decode(l)[0],
          scl_llr, nblk_po * scl_code.payload_bits, iters=slow)

    # the spectral-processing pair and the truncated-IR IIR
    nsp = B * 1024
    timed("stft+istft 1024/512 [flat]", lambda x: istft(stft(x, 1024), length=nsp),
          rsplit((nsp,)), nsp)
    sos4 = butter_sos(4, 0.1)
    timed("iir sosfilt butter4 [flat]", lambda x: sosfilt(sos4, x), rsplit((nsp,)), nsp)

    payload = {
        **head,
        "batch": B,
        "iters": args.iters,
        "rounds": max(1, args.rounds),
        "methodology": {
            "estimator": f"median of {max(1, args.rounds)} rounds of `iters` calls each "
                         "after two warm-up calls, inputs resident on the device; every "
                         "round committed in rounds_us_per_call",
            "profile": "kernels_per_call and device_busy_ms: torch.profiler (CUDA "
                       "activities) over one call; idle = 1 - busy / the row's time",
            "launches": "launches of the hand-written kernels in one call",
        },
        "results": results,
    }
    if args.json:
        with open(args.json, "w") as f:
            json.dump(payload, f, indent=1)
        print(f"wrote {args.json}")
    return None


if __name__ == "__main__":
    bench_main()
