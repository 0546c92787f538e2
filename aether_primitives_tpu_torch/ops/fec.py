"""Convolutional coding, Viterbi decoding, CRC and block interleaving (PyTorch).

Counterpart of ``aether_primitives_tpu/ops/fec.py``, burst-link subset:

- :func:`conv_encode`: rate ``1/n`` convolutional encoder as XOR
  shift-adds, batched over leading axes.
- :func:`viterbi_decode`: full-block or windowed hard-decision Viterbi,
  batched over leading axes natively (no vmap). Both modes build
  ``[N, Lw, n]`` LLR spans, one trellis per row, and decode them in one
  call of :func:`~.cuda.viterbi.viterbi_lanes`: on a CUDA tensor the
  hand-written kernel, on a CPU tensor its plain version. The windowed
  spans carry the JAX package's boundary-forcing pad LLRs, so both modes
  are bit-identical to its scans.
- :data:`CRC_PARAMS`, :func:`crc_bits`, :func:`crc_append`,
  :func:`crc_check`: the CRC of a fixed-length message is affine over
  GF(2), so it is one float32 matmul against a host-built ``[width, n]``
  matrix (exact: every sum is an integer below 2^24).
- :func:`interleave` / :func:`deinterleave`: the block interleaver.
- The trellis tables ``_trellis``, ``_trellis_fwd`` and
  ``_conv_soft_coeffs`` are the JAX package's, copied verbatim (numpy).

LLR convention: positive = bit 0 likelier.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from .cuda import viterbi as _vk

DEFAULT_POLYS = (0o171, 0o133)
DEFAULT_K = 7
#: Decoder backends: "auto" takes the kernel for a CUDA tensor and the
#: plain version for a CPU tensor; "reference" takes the plain version on
#: any device.
BACKENDS = ("auto", "reference")


def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown backend {backend!r} (expected one of {BACKENDS})"
        )


def _poly_taps(poly: int, k: int) -> np.ndarray:
    """Generator polynomial -> [k] tap array, taps[j] multiplies x[i-j].

    Convention: the MSB of the ``k``-bit octal generator weights the
    CURRENT input bit (tap 0) — e.g. 0o7 = 111 with K=3 is 1+D+D^2.
    """
    return np.array([(poly >> (k - 1 - j)) & 1 for j in range(k)], np.uint8)


def conv_encode(bits, polys: Sequence[int] = DEFAULT_POLYS,
                constraint: int = DEFAULT_K, terminate: bool = True) -> torch.Tensor:
    """Rate-``1/len(polys)`` convolutional encoder from state 0.

    ``terminate`` appends ``constraint - 1`` zero flush bits, so the trellis
    ends in state 0. ``[..., n]`` bits -> ``[..., n_out * len(polys)]``
    uint8, one parity bit per generator per input bit, interleaved.
    """
    x = torch.as_tensor(bits).to(torch.uint8) % 2
    k = int(constraint)
    if terminate:
        x = torch.nn.functional.pad(x, (0, k - 1))
    xp = torch.nn.functional.pad(x, (k - 1, 0))
    n = x.shape[-1]
    outs = []
    for poly in polys:
        taps = _poly_taps(int(poly), k)
        acc = torch.zeros_like(x)
        for j in range(k):
            if taps[j]:
                acc ^= xp[..., k - 1 - j:k - 1 - j + n]
        outs.append(acc)
    y = torch.stack(outs, dim=-1)  # [..., n, n_polys]
    return y.reshape(y.shape[:-2] + (n * len(polys),))


@functools.lru_cache(maxsize=None)
def _trellis(polys: Tuple[int, ...], k: int):
    """Static trellis tables for the scan.

    States are the ``K-1`` most recent input bits (newest in the LSB):
    ``next = ((s << 1) | b) & (2^(K-1) - 1)``. Returns, for each next
    state ``ns`` (with implied input bit ``b = ns & 1``):

    - ``pred [S, 2]``: its two predecessor states (differing in their
      oldest bit);
    - ``outs [S, 2, n]``: the encoder output bits of each transition.
    """
    s_count = 1 << (k - 1)
    half = s_count >> 1
    n = len(polys)
    taps = [_poly_taps(p, k) for p in polys]
    pred = np.zeros((s_count, 2), np.int32)
    outs = np.zeros((s_count, 2, n), np.float32)
    for ns in range(s_count):
        b = ns & 1
        base = ns >> 1
        for which, s in enumerate((base, base | half)):
            pred[ns, which] = s
            # register contents during this transition: input bit b then
            # state bits (newest..oldest) = b, s[0], s[1], ...
            reg = [(b if j == 0 else (s >> (j - 1)) & 1) for j in range(k)]
            for gi in range(n):
                outs[ns, which, gi] = float(
                    int(np.sum(taps[gi] * np.array(reg, np.uint8))) % 2
                )
    return pred, outs


def viterbi_decode(llrs, polys: Sequence[int] = DEFAULT_POLYS,
                   constraint: int = DEFAULT_K, terminated: bool = True,
                   window: int = 0, guard: int = 48,
                   backend: str = "auto") -> torch.Tensor:
    """Maximum-likelihood decode of a rate-``1/n`` convolutional code.

    ``llrs``: ``[..., n_sym * n]`` float32 soft inputs (positive = bit 0;
    hard bits map as ``1 - 2 bit``). Returns uint8 bits ``[..., n_sym -
    (K-1)]`` when ``terminated`` (flush bits stripped), else
    ``[..., n_sym]``.

    ``window = 0`` decodes each block in one trellis from state 0 and, when
    ``terminated``, traces back from state 0. ``window > 0`` is the
    windowed truncated-traceback decoder: the block splits into windows of
    ``window`` steps, each extended by ``guard`` steps on both sides and
    decoded from uniform metrics with a first-argmin traceback; pad LLRs of
    1e6 before the stream (and after it, when terminated) force the known
    state-0 boundaries, as in the JAX package.

    ``backend``: ``"auto"`` (the kernel for a CUDA tensor, which raises on
    a span it does not take, the plain version for a CPU tensor) or
    ``"reference"`` (the plain version on any device).
    """
    _check_backend(backend)
    llr = torch.as_tensor(llrs)
    if llr.dtype != torch.float32:
        llr = llr.to(torch.float32)
    polys = tuple(int(p) for p in polys)
    n = len(polys)
    k = int(constraint)
    if llr.shape[-1] % n:
        raise ValueError(f"LLR count must be a multiple of n = {n}")
    lead = tuple(llr.shape[:-1])
    b_sz = int(np.prod(lead, dtype=np.int64))
    t_steps = llr.shape[-1] // n
    sym = llr.reshape(b_sz, t_steps, n)
    decode = _vk.viterbi_lanes if backend == "auto" else _vk.viterbi_lanes_reference
    if not window:
        bits = decode(sym.contiguous(), t_steps, n, polys, k, True, bool(terminated))
    else:
        n_win = -(-t_steps // window)
        t_pad = n_win * window
        lw = window + 2 * guard
        tail = guard + (t_pad - t_steps)
        symp = torch.cat([
            torch.full((b_sz, guard, n), 1e6, dtype=torch.float32, device=llr.device),
            sym,
            torch.full((b_sz, tail, n), 1e6 if terminated else 0.0,
                       dtype=torch.float32, device=llr.device),
        ], dim=1)  # [B, t_pad + 2 guard, n]
        spans = symp.unfold(1, lw, window)  # [B, W, n, Lw]
        spans = spans.permute(0, 1, 3, 2).reshape(b_sz * n_win, lw, n).contiguous()
        out = decode(spans, lw, n, polys, k, False, False)  # [B*W, Lw]
        bits = out.reshape(b_sz, n_win, lw)[:, :, guard:guard + window]
        bits = bits.reshape(b_sz, t_pad)[:, :t_steps]
    if terminated:
        bits = bits[:, :t_steps - (k - 1)]
    return bits.reshape(lead + bits.shape[-1:])


@functools.lru_cache(maxsize=None)
def _trellis_fwd(polys: Tuple[int, ...], k: int):
    """Forward-indexed trellis tables for the BCJR recursions: for each
    CURRENT state ``s`` and input ``u``, the next state ``nxt[s, u]``
    and encoder output signs ``sgn[s, u, n] = 1 - 2*out`` (so the
    branch log-likelihood is ``0.5 * sgn · llr``)."""
    s_count = 1 << (k - 1)
    n = len(polys)
    taps = [_poly_taps(p, k) for p in polys]
    nxt = np.zeros((s_count, 2), np.int32)
    sgn = np.zeros((s_count, 2, n), np.float32)
    for s in range(s_count):
        for u in (0, 1):
            nxt[s, u] = ((s << 1) | u) & (s_count - 1)
            reg = np.array(
                [u if j == 0 else (s >> (j - 1)) & 1 for j in range(k)],
                np.uint8,
            )
            for gi in range(n):
                sgn[s, u, gi] = 1.0 - 2.0 * float(
                    int(np.sum(taps[gi] * reg)) % 2
                )
    return nxt, sgn


@functools.lru_cache(maxsize=None)
def _conv_soft_coeffs(polys: Tuple[int, ...], k: int):
    """The rate-1/2 feedforward trellis as the generic hashable
    ``(nxt, prev_s, fw0, fw1, bw0, bw1)`` coefficient tables the BCJR
    kernel consumes: ``bw_m[s][u] = 0.5 * sgn[s, u, m]`` (the conv branch
    metric ``0.5 Σ_m sgn·llr_m``), and the forward entries re-read through
    the predecessor structure ``prev_s[s', j] = (s' >> 1) | (j << (K-2))``,
    ``prev_u = s' & 1``."""
    if len(polys) != 2:
        raise ValueError(
            "windowed soft decode supports rate-1/2 codes (two LLR "
            f"streams); got {len(polys)} generators"
        )
    nxt, sgn = _trellis_fwd(polys, k)
    s_count = nxt.shape[0]
    half = s_count >> 1
    prev_s = np.array(
        [[(sp >> 1) | (j * half) for j in (0, 1)] for sp in range(s_count)],
        np.int64,
    )
    bw0 = 0.5 * sgn[:, :, 0]
    bw1 = 0.5 * sgn[:, :, 1]
    fw0 = np.array(
        [[bw0[prev_s[sp, j], sp & 1] for j in (0, 1)]
         for sp in range(s_count)], np.float64,
    )
    fw1 = np.array(
        [[bw1[prev_s[sp, j], sp & 1] for j in (0, 1)]
         for sp in range(s_count)], np.float64,
    )
    return (
        tuple(map(tuple, nxt.tolist())),
        tuple(map(tuple, prev_s.tolist())),
        tuple(map(tuple, fw0.tolist())),
        tuple(map(tuple, fw1.tolist())),
        tuple(map(tuple, bw0.tolist())),
        tuple(map(tuple, bw1.tolist())),
    )


#: Rocksoft parameter sets: (poly, width, init, refin, refout, xorout).
CRC_PARAMS = {
    "crc32": (0x04C11DB7, 32, 0xFFFFFFFF, True, True, 0xFFFFFFFF),  # ISO-HDLC/zlib
    "crc16-ccitt": (0x1021, 16, 0xFFFF, False, False, 0x0),  # CCITT-FALSE
    "crc16-usb": (0x8005, 16, 0xFFFF, True, True, 0xFFFF),
    "crc8": (0x07, 8, 0x00, False, False, 0x00),  # SMBus
    # 3GPP TS 38.212 §5.1: gCRC24A (transport-block CRC) and gCRC24B
    # (code-block CRC) — zero init, no reflection, zero xorout
    "crc24a": (0x864CFB, 24, 0x000000, False, False, 0x000000),
    "crc24b": (0x800063, 24, 0x000000, False, False, 0x000000),
}


def _msb_bits(value: int, width: int) -> np.ndarray:
    return np.array([(value >> (width - 1 - i)) & 1 for i in range(width)],
                    np.int64)


@functools.lru_cache(maxsize=None)
def _crc_affine(kind: str, n: int):
    """The CRC of an ``n``-bit message as an affine map over GF(2):
    ``check = (m @ bits + c) mod 2``, returned as float32 ``m [width, n]``
    and ``c [width]``, with refout and xorout folded in.

    The register (MSB-first, one message bit per step) advances as
    ``crc' = A crc ^ b p`` with ``A = shift ^ p e0^T`` and ``p`` the
    polynomial's bits, so after ``n`` bits ``crc = A^n init ^ sum_j
    A^(n-1-j) p b_j``. Built with exact numpy integers.
    """
    poly, width, init, _refin, refout, xorout = CRC_PARAMS[kind]
    p = _msb_bits(poly, width)
    a = np.zeros((width, width), np.int64)
    a[: width - 1, 1:] = np.eye(width - 1, dtype=np.int64)  # shift (MSB out)
    a[:, 0] ^= p  # feedback of the outgoing MSB
    m = np.zeros((width, n), np.int64)
    col = p.copy()
    for j in range(n - 1, -1, -1):  # m[:, j] = A^(n-1-j) p
        m[:, j] = col
        col = (a @ col) % 2
    c = _msb_bits(init, width)
    for _ in range(n):
        c = (a @ c) % 2
    if refout:
        m, c = m[::-1], c[::-1]
    c = c ^ _msb_bits(xorout, width)
    return (np.ascontiguousarray(m, np.float32),
            np.ascontiguousarray(c, np.float32))


def crc_bits(bits, kind: str = "crc32") -> torch.Tensor:
    """Check bits of an MSB-first bit stream ``[..., n]``, in transmission
    order, uint8 ``[..., width]`` (the JAX package's ``crc_bits``)."""
    b = torch.as_tensor(bits).to(torch.uint8) % 2
    m, c = _crc_affine(kind, b.shape[-1])
    m_t = torch.from_numpy(m).to(b.device)
    c_t = torch.from_numpy(c).to(b.device)
    acc = b.to(torch.float32) @ m_t.T + c_t
    return torch.remainder(acc, 2.0).to(torch.uint8)


def crc_append(bits, kind: str = "crc32") -> torch.Tensor:
    """``[info | crc]``: append the ``kind`` check bits to ``[..., n]``."""
    b = torch.as_tensor(bits).to(torch.uint8) % 2
    return torch.cat([b, crc_bits(b, kind)], dim=-1)


def crc_check(bits, kind: str = "crc32") -> torch.Tensor:
    """Verify ``[..., n]`` frames from :func:`crc_append`: bool ``[...]``."""
    width = CRC_PARAMS[kind][1]
    b = torch.as_tensor(bits).to(torch.uint8) % 2
    n = b.shape[-1]
    want = crc_bits(b[..., : n - width], kind)
    return (want == b[..., n - width:]).all(dim=-1)


def interleave(x, rows: int) -> torch.Tensor:
    """Block interleaver: write ``[..., n]`` row-wise into ``[rows, n /
    rows]``, read column-wise. Bits or LLRs; invert with
    :func:`deinterleave` and the same ``rows``."""
    x = torch.as_tensor(x)
    n = x.shape[-1]
    if n % rows:
        raise ValueError(f"length {n} not divisible by rows {rows}")
    m = x.reshape(x.shape[:-1] + (rows, n // rows))
    return m.transpose(-1, -2).reshape(x.shape)


def deinterleave(x, rows: int) -> torch.Tensor:
    """Inverse of :func:`interleave` (same ``rows``)."""
    x = torch.as_tensor(x)
    n = x.shape[-1]
    if n % rows:
        raise ValueError(f"length {n} not divisible by rows {rows}")
    m = x.reshape(x.shape[:-1] + (n // rows, rows))
    return m.transpose(-1, -2).reshape(x.shape)
