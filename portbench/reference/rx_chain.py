"""Plain float64 reference of the RX chain: causal FIR, decimation, frame
FFT (``1/sqrt(N)``), QPSK hard decisions packed LSB-first.

A frozen copy of the port's ``cli.py`` ``numpy_reference_spectra`` /
``numpy_reference_bits`` in plain PyTorch: the FIR is a shift-and-add at
the kept outputs, in float64 (complex128), on whatever device its inputs
lie. It designs its taps itself from the configuration. ``q`` rounds each
stage's output (:mod:`.precision`): identity for the reference,
bfloat16 for the control.
"""

from __future__ import annotations

import numpy as np
import torch

from .precision import identity


def lowpass(ntaps: int, cutoff: float) -> np.ndarray:
    """The chain's default filter as its configuration states it: a
    Hamming-windowed sinc of unit DC gain, held as complex64 taps."""
    n = np.arange(ntaps) - (ntaps - 1) / 2.0
    h = 2 * cutoff * np.sinc(2 * cutoff * n)
    h *= np.hamming(ntaps)
    return (h / h.sum()).astype(np.complex64)


def chain_taps(chain: dict) -> np.ndarray:
    """Taps of an ``RxChainConfig`` given as a dict: its ``fir_taps``, else
    ``16 * decimation + 1`` taps at cutoff ``1 / (2 * decimation)``."""
    if chain.get("fir_taps") is not None:
        return np.asarray(chain["fir_taps"], dtype=np.complex64).ravel()
    dec = int(chain.get("decimation", 4))
    if dec > 1:
        return lowpass(16 * dec + 1, 1.0 / (2 * dec))
    return np.asarray([1.0 + 0j], dtype=np.complex64)


def spectra(x: torch.Tensor, history: torch.Tensor, taps: np.ndarray, dec: int,
            fft_len: int, q=identity) -> torch.Tensor:
    """``x [rows, n]`` after ``history [rows, K-1]`` -> complex128 spectra
    ``[rows, n / (dec fft_len), fft_len]``: ``y[m] = sum_k h[k] x[dec m - k]``
    over the history and the block, then ``fft(frames) / sqrt(fft_len)``."""
    k = taps.shape[-1]
    xe = q(torch.cat([history, x], dim=-1).to(torch.complex128))
    h = q(torch.from_numpy(taps.astype(np.complex128)).to(x.device))
    n = x.shape[-1]
    y = torch.zeros(x.shape[:-1] + (n // dec,), dtype=torch.complex128, device=x.device)
    for j in range(k):
        start = k - 1 - j
        y += h[j] * xe[..., start:start + n:dec]
    y = q(y)
    frames = y.reshape(x.shape[:-1] + (-1, fft_len))
    return q(torch.fft.fft(frames, dim=-1) / np.sqrt(fft_len))


def qpsk_bits(spec: torch.Tensor) -> torch.Tensor:
    """Spectra ``[rows, frames, fft_len]`` -> uint8 bits ``[rows, 2 frames
    fft_len]``: bit 0 of a bin is ``re < 0``, bit 1 ``im < 0``."""
    b = torch.stack([spec.real < 0, spec.imag < 0], dim=-1)
    return b.reshape(spec.shape[0], -1).to(torch.uint8)


def pack(bits: torch.Tensor) -> torch.Tensor:
    """``[rows, 8 m]`` bits -> ``[rows, m]`` bytes, LSB-first."""
    w = (1 << torch.arange(8, device=bits.device)).to(torch.int32)
    b = bits.reshape(bits.shape[0], -1, 8).to(torch.int32)
    return (b * w).sum(-1).to(torch.uint8)


def margins(spec: torch.Tensor) -> torch.Tensor:
    """Each bit's decision margin, ``|component|`` over the RMS of the
    row's components, float32 ``[rows, 2 frames fft_len]`` in bit order."""
    c = torch.stack([spec.real, spec.imag], dim=-1).reshape(spec.shape[0], -1)
    rms = c.pow(2).mean(dim=-1, keepdim=True).sqrt()
    return (c.abs() / rms).to(torch.float32)


_POP = torch.tensor([bin(i).count("1") for i in range(256)], dtype=torch.int64)


def compare(got: torch.Tensor, ref_packed: torch.Tensor, ref_margin: torch.Tensor):
    """Packed bits ``got [rows, m]`` against the reference's: ``(flips,
    bits, worst_margin, row_worst)``, where ``worst_margin`` is the largest
    reference margin of a flipped bit (0.0 with none) and ``row_worst``
    the largest a row."""
    x = got.to(ref_packed.device) ^ ref_packed
    flips = int(_POP.to(x.device)[x.to(torch.int64)].sum())
    row_worst = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
    if flips:
        rows, byte = torch.nonzero(x, as_tuple=True)
        sh = torch.arange(8, device=x.device)
        hit = ((x[rows, byte].to(torch.int32)[:, None] >> sh) & 1).bool()
        r = rows[:, None].expand(-1, 8)[hit]
        pos = (byte[:, None] * 8 + sh)[hit]
        m = ref_margin[r, pos]
        row_worst.scatter_reduce_(0, r, m, reduce="amax")
    return flips, x.numel() * 8, float(row_worst.max()), row_worst
