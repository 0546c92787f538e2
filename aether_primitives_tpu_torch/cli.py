"""The RX chain benchmark on a CUDA device, and the float64 reference chain.

Counterpart of ``aether_primitives_tpu/cli.py`` ``bench_main``: the same
chain (fft_len 2048, decimation 4, 65 taps, packed QPSK bytes), the same
4,194,304-sample blocks and the same two-block streaming gate, timed with
CUDA events on blocks already resident on the device. Run it with
``python -m aether_primitives_tpu_torch.cli``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

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


def kernel_device_ms(fn, match: str, calls: int = 20) -> float:
    """Device milliseconds a launch of the kernels whose name holds
    ``match``, by ``torch.profiler`` (CUPTI) over ``calls`` calls of
    ``fn()`` after one: the kernel's own time, without the host's time
    between launches. The mean over the launches the profiler recorded,
    which may be fewer than were made (it drops some), so a call of ``fn``
    should launch one such kernel. Raises where it recorded none."""
    us = [t for _, t in kernel_device_times(fn, match, calls)]
    if not us:
        raise RuntimeError(f"the profiler recorded no device time for kernels named {match!r}")
    return sum(us) / len(us) / 1e3


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


if __name__ == "__main__":
    bench_main()
