"""Roofline arithmetic of the port's kernels on one H100 (SXM, NVIDIA's
data sheet: 67 TFLOP/s FP32 outside the tensor cores, 3.35 TB/s of HBM3).

A bound is the least time the card could take: the larger of the
operations over the FP32 peak and the bytes over the HBM rate, each input
byte read once and each output byte written once. Frozen copies of the
port's ``chip_smoke.py`` ``bound`` and ``viterbi_bound_of`` and of its RX
frame count.
"""

from __future__ import annotations

import math

PEAK_FP32, PEAK_BYTES = 67e12, 3.35e12


def bound(ops: float, nbytes: float) -> dict:
    """``{"bound_ms", "bound_by"}``: the larger of ops / FP32 peak and
    bytes / HBM rate."""
    t_ops, t_bytes = ops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def rx_frame_bound(rows: int, n: int, dec: int, fft_len: int, taps: int,
                   bits_per_symbol: int = 2) -> dict:
    """One RX frame launch over ``rows`` blocks of ``n`` complex64 samples:
    the FIR at the kept outputs with real taps (2 FMAs a tap, 4 operations)
    and a 5 N log2 N FFT a frame; the bytes: each input sample (8 B) and
    the carried history (``taps - 1`` samples) read once, the packed bits
    written once."""
    ku = taps - 1
    outputs = rows * (n // dec)
    ops = 4.0 * outputs * (ku + 1) + 5.0 * outputs * math.log2(fft_len)
    nbytes = rows * (n * 8 + ku * 8 + (n // dec) * bits_per_symbol // 8)
    return bound(ops, nbytes)


def viterbi_bound(n_tr: int, steps: int, n: int, s_count: int, npat: int) -> dict:
    """The Viterbi kernel's bound on ``n_tr`` trellises of ``steps`` steps:
    a step needs the metric of each of the code's ``npat`` distinct output
    patterns (``n`` FMAs each) and 6 FP32 operations a state, none an FMA,
    so each an FMA's issue slot (twice the data sheet's count at its FP32
    peak); the bytes: the LLRs in, a uint8 bit a step out."""
    return bound(2 * n_tr * steps * (npat * n + 6 * s_count), n_tr * steps * (4 * n + 1))
