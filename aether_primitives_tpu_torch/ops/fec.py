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
- :func:`conv_decode_soft`: soft-output max-log BCJR over the
  feedforward trellis, batched natively. The full block (``window=0``) is
  a forward/backward recursion over ``[B, S]`` metrics; the windowed form
  builds ``[Lw, B * W]`` spans and decodes them in one call of
  :func:`~.cuda.bcjr.bcjr_windowed_llr` with the trellis's
  ``_conv_soft_coeffs`` tables (the kernel's ``lanes`` instance on a
  CUDA tensor, its plain version on a CPU tensor).
- :data:`CRC_PARAMS`, :func:`crc_bits`, :func:`crc_append`,
  :func:`crc_check`: the CRC of a fixed-length message is affine over
  GF(2), so it is one float32 matmul against a host-built ``[width, n]``
  matrix (exact: every sum is an integer below 2^24).
  :func:`crc_compute` and :func:`crc32` take any register on a flat bit
  stream: the JAX package's GF(2) block matrices on the stream's device,
  the blocks folded pairwise in ``log2`` of their count steps.
- :func:`interleave` / :func:`deinterleave`: the block interleaver;
  :func:`conv_interleave` / :func:`conv_deinterleave` (streaming Forney,
  with state) and :func:`conv_interleave_block` /
  :func:`conv_deinterleave_block` (circular, batched): one gather each.
- :func:`hard_to_llr`.
- The trellis tables ``_trellis``, ``_trellis_fwd`` and
  ``_conv_soft_coeffs`` are the JAX package's, copied verbatim (numpy).

LLR convention: positive = bit 0 likelier.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from ._gf import gf2_power
from .cuda import bcjr as _bk
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
    ns = np.arange(s_count)
    pred = np.stack([ns >> 1, (ns >> 1) | (s_count >> 1)], axis=1).astype(np.int32)
    # register contents during each transition: input bit b = ns & 1 then
    # the predecessor's bits (newest..oldest)
    reg = np.empty((s_count, 2, k), np.int64)
    reg[:, :, 0] = (ns & 1)[:, None]
    for j in range(1, k):
        reg[:, :, j] = (pred >> (j - 1)) & 1
    outs = np.stack([(reg @ _poly_taps(p, k).astype(np.int64)) % 2 for p in polys],
                    axis=-1).astype(np.float32)
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


def conv_soft_spans(llr, polys, k: int, terminated: bool, window: int, guard: int):
    """The windowed soft decode's spans of ``llr [B, T * 2]``: the two LLR
    streams as ``[Lw, B * W]`` float32 (contiguous), ``Lw = window + 2
    guard``, ``W = ceil(T / window)`` windows, column ``b * W + w``. The JAX
    package's window construction: pads of 1e6 before the stream (the known
    state-0 history) and after it when terminated (the flush), else
    zeros."""
    b_sz = llr.shape[0]
    n = len(polys)
    t_steps = llr.shape[-1] // n
    sym = llr.reshape(b_sz, t_steps, n)
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
    spans = spans.permute(2, 3, 0, 1).reshape(n, lw, b_sz * n_win)
    return spans[0].contiguous(), spans[1].contiguous()


def _conv_soft_windowed(llr, polys, k: int, terminated: bool, window: int,
                        guard: int, backend: str) -> torch.Tensor:
    """Windowed max-log BCJR, batched: ``llr [B, T * 2]`` -> a-posteriori
    LLRs ``[B, T]``: the spans of :func:`conv_soft_spans` through one call
    of the BCJR kernel (or its plain version), uniform initial metrics,
    each window's core ``window`` LLRs kept."""
    tables = _conv_soft_coeffs(polys, k)
    b_sz = llr.shape[0]
    t_steps = llr.shape[-1] // len(polys)
    n_win = -(-t_steps // window)
    lw = window + 2 * guard
    l0, l1 = conv_soft_spans(llr, polys, k, terminated, window, guard)
    decode = _bk.bcjr_windowed_llr if backend == "auto" else _bk.bcjr_windowed_llr_reference
    out = decode(l0, l1, lw, tables)
    core = out[guard:guard + window].reshape(window, b_sz, n_win)
    return core.permute(1, 2, 0).reshape(b_sz, n_win * window)[:, :t_steps]


def _conv_soft_full(llr, polys, k: int, terminated: bool) -> torch.Tensor:
    """Exact max-log BCJR over the whole block, batched: ``llr [B, T * n]``
    -> ``[B, T]``. The JAX package's recursion with the batch on the last
    axis: state 0 pinned (0 against -1e9) at the start, and at the end when
    terminated; the forward step is its scatter-max onto a -1e9 floor."""
    nxt, sgn = _trellis_fwd(polys, k)
    dev = llr.device
    s_count = nxt.shape[0]
    b_sz = llr.shape[0]
    n = len(polys)
    t_steps = llr.shape[-1] // n
    sym = llr.reshape(b_sz, t_steps, n).permute(1, 2, 0)  # [T, n, B]
    sgn_t = torch.from_numpy(sgn).to(dev)  # [S, 2, n]
    # gamma[t, s, u, b] = 0.5 * sum_j sgn[s, u, j] * llr[t, j, b]
    gamma = 0.5 * torch.einsum("sun,tnb->tsub", sgn_t, sym)
    ns = np.arange(s_count)
    # the two transitions into next state s': (s' >> 1, u) and ((s' >> 1) | half, u),
    # u = s' & 1, in the order the scatter visits them
    pred = [torch.from_numpy((ns >> 1) | (j * (s_count >> 1))).to(dev) for j in (0, 1)]
    u_in = torch.from_numpy(ns & 1).to(dev)
    nxt_t = [torch.from_numpy(nxt[:, u].astype(np.int64)).to(dev) for u in (0, 1)]
    floor = torch.full((s_count, b_sz), -1e9, dtype=torch.float32, device=dev)
    pinned = floor.clone()
    pinned[0] = 0.0
    alphas = torch.empty((t_steps, s_count, b_sz), dtype=torch.float32, device=dev)
    alpha = pinned
    for t in range(t_steps):
        alphas[t] = alpha
        g = gamma[t]  # [S, 2, B]
        cand = [alpha[pred[j]] + g[pred[j], u_in] for j in (0, 1)]
        a = torch.maximum(floor, torch.maximum(cand[0], cand[1]))
        alpha = a - a.amax(dim=0, keepdim=True)
    betas = torch.empty_like(alphas)
    beta = pinned.clone() if terminated else torch.zeros_like(pinned)
    for t in range(t_steps - 1, -1, -1):
        betas[t] = beta
        g = gamma[t]
        b = torch.maximum(g[:, 0] + beta[nxt_t[0]], g[:, 1] + beta[nxt_t[1]])
        beta = b - b.amax(dim=0, keepdim=True)
    m = [((alphas + gamma[:, :, u]) + betas[:, nxt_t[u]]).amax(dim=1) for u in (0, 1)]
    return (m[0] - m[1]).T  # [B, T], positive = bit 0


def conv_decode_soft(llrs, polys: Sequence[int] = DEFAULT_POLYS,
                     constraint: int = DEFAULT_K, terminated: bool = True,
                     window: int = 0, guard: int = 64,
                     backend: str = "auto") -> torch.Tensor:
    """Soft-output decode of a rate-``1/n`` convolutional code: per-bit
    a-posteriori LLRs by max-log BCJR over the feedforward trellis.

    Same input contract as :func:`viterbi_decode` (``[..., n_sym * n]``
    channel LLRs, positive = bit 0); returns float32 ``[..., n_sym -
    (K-1)]`` when ``terminated`` (flush positions stripped), else ``[...,
    n_sym]``, whose signs are the decoded bits and whose magnitudes are
    per-bit reliabilities. Batched over leading axes natively.

    ``window = 0``: the exact recursion over the whole block (plain
    PyTorch on the tensor's device). ``window > 0``: the windowed form of
    rate-1/2 codes (other rates raise ValueError), every window decoded
    from uniform metrics with ``guard`` steps on both sides, in one call of
    the BCJR kernel with the trellis's tables on a CUDA tensor (``backend
    "auto"``; its ``lanes`` instance) or its plain version (on a CPU
    tensor, or with ``backend="reference"``).
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
    flat = llr.reshape(-1, llr.shape[-1])
    if window:
        out = _conv_soft_windowed(flat, polys, k, bool(terminated), int(window),
                                  int(guard), backend)
    else:
        out = _conv_soft_full(flat, polys, k, bool(terminated))
    if terminated:
        out = out[:, : out.shape[-1] - (k - 1)]
    return out.reshape(lead + out.shape[-1:])


def hard_to_llr(bits) -> torch.Tensor:
    """Hard bits {0, 1} -> float32 LLRs in the convention (+1 = strong 0)."""
    return 1.0 - 2.0 * torch.as_tensor(bits).to(torch.float32)


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


@functools.lru_cache(maxsize=None)
def _crc_matrices(poly: int, width: int, block: int):
    """GF(2) block matrices of the CRC register (the JAX package's
    ``_crc_matrices``, numpy): the register ``crc' = A crc ^ b p`` (``A =
    shift ^ p e0^T``, ``p`` the polynomial's bits, MSB first) advances over
    ``block`` bits as ``A^B crc ^ M bits`` with ``M[:, j] = A^(B-1-j) p``.
    float32 ``(A^B [width, width], M [width, block])``; ``block`` may be 0."""
    p = _msb_bits(poly, width)
    a = np.zeros((width, width), np.int64)
    a[: width - 1, 1:] = np.eye(width - 1, dtype=np.int64)  # shift left (MSB out)
    a[:, 0] ^= p  # feedback of the outgoing MSB
    m = np.zeros((width, block), np.int64)
    col = p.copy()
    for j in range(block - 1, -1, -1):  # m[:, j] = A^(B-1-j) p
        m[:, j] = col
        col = (a @ col) % 2
    return gf2_power(a, block).astype(np.float32), m.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _crc_blocks(poly: int, width: int, block: int, levels: int, device: torch.device):
    """``M.T`` (float32 ``[block, width]``) and ``((A^B)^(2^k)).T`` for ``k
    < levels`` (``[levels, width, width]``: the fold of a pair of runs of
    ``2^k`` blocks each), on ``device``, made once."""
    a_b, m = _crc_matrices(poly, width, block)
    a_b = a_b.astype(np.int64)
    folds = np.zeros((levels, width, width), np.float32)
    for k in range(levels):
        folds[k] = a_b.T
        a_b = (a_b @ a_b) % 2
    return (torch.from_numpy(np.ascontiguousarray(m.T)).to(device),
            torch.from_numpy(folds).to(device))


@functools.lru_cache(maxsize=None)
def _crc_bits_on(value: int, width: int, device: torch.device) -> torch.Tensor:
    """``value``'s ``width`` bits MSB first, float32 on ``device``, made
    once (a copy from host memory would wait for the device's queue)."""
    return torch.from_numpy(_msb_bits(value, width).astype(np.float32)).to(device)


@functools.lru_cache(maxsize=None)
def _crc_short(poly: int, width: int, n: int, device: torch.device):
    """:func:`_crc_matrices` at ``block = n`` on ``device``, made once."""
    return tuple(torch.from_numpy(v).to(device) for v in _crc_matrices(poly, width, n))


def crc_compute(bits, poly: int, width: int, init: int = 0, xorout: int = 0,
                reflect_out: bool = False, block: int = 512) -> torch.Tensor:
    """CRC of a flat MSB-first bit stream: the ``width`` check bits,
    MSB-first after ``reflect_out`` and ``xorout``, uint8 on the stream's
    device (the JAX package's ``crc_compute``, bit for bit).

    The JAX package's GF(2) form, on the stream's device with no copy of it
    to the host: ``init`` folded into the first ``width`` bits (``crc(I, m)
    = crc(0, m ^ I x^(n - width))``), zeros in front to whole blocks, one
    float32 matmul for every block's ``M @ bits``, then the blocks' terms
    folded pairwise, ``v = (A^B)^(2^k) v_left + v_right``, in ``log2`` of
    their count steps (exact: every sum is an integer below 2^24). A
    stream shorter than ``width`` takes one affine step."""
    x = torch.as_tensor(bits)
    if x.ndim != 1:
        raise ValueError("crc_compute takes a flat bit stream")
    poly, width, block = int(poly), int(width), int(block)
    n, dev = x.shape[0], x.device
    iv = _crc_bits_on(int(init), width, dev)
    if n < width:  # too short for the init fold: one affine step
        a_n, m_n = _crc_short(poly, width, n, dev)
        state = torch.remainder(a_n @ iv + m_n @ torch.remainder(x.to(torch.float32), 2.0), 2.0)
    else:
        nb = -(-n // block)
        pad = nb * block - n  # leading zeros: a no-op at state 0
        xb = x.new_zeros(nb * block, dtype=torch.float32)
        xb[pad:] = x
        if init:
            xb[pad:pad + width] += iv
        xb = torch.remainder(xb, 2.0)
        m_t, folds = _crc_blocks(poly, width, block, (nb - 1).bit_length(), dev)
        v = torch.remainder(xb.view(nb, block) @ m_t, 2.0)  # [blocks, width]
        for fold in folds:
            if v.shape[0] % 2:  # a zero run in front
                v = torch.cat([v.new_zeros(1, width), v])
            pairs = v.view(-1, 2, width)
            v = torch.remainder(pairs[:, 0] @ fold + pairs[:, 1], 2.0)
        state = v[0]
    out = state.to(torch.uint8)
    if reflect_out:
        out = out.flip(0)
    if xorout:
        out = out ^ _crc_bits_on(int(xorout), width, dev).to(torch.uint8)
    return out


def crc32(data: bytes) -> int:
    """CRC-32/ISO-HDLC of a byte string, equal to ``zlib.crc32``: bytes
    unpacked LSB-first (``refin``), the register MSB-first, the output
    reflected and inverted (``refout``, ``xorout``)."""
    poly, width, init, _refin, refout, xorout = CRC_PARAMS["crc32"]
    arr = np.frombuffer(bytes(data), np.uint8)
    bits = np.unpackbits(arr, bitorder="little")
    out = crc_compute(torch.from_numpy(bits), poly, width, init, xorout, refout).numpy()
    return int(np.packbits(out[::-1], bitorder="little").view(np.uint32)[0])


def _class_gather(x2: torch.Tensor, starts, length: int) -> torch.Tensor:
    """``out[..., j, r] = x2[..., j, (starts[j] + r) mod L]`` for the class
    rows ``x2 [..., I, L]``: one gather."""
    idx = (np.asarray(starts, np.int64)[:, None] + np.arange(length)) % x2.shape[-1]
    idx_t = torch.from_numpy(idx).to(x2.device)
    return x2.gather(-1, idx_t.expand(x2.shape[:-2] + idx_t.shape))


def _conv_ilv(x, branches: int, cell: int, state, deinter: bool):
    x = torch.as_tensor(x)
    if x.ndim != 1:
        raise ValueError("conv_(de)interleave takes a flat stream")
    i, m = int(branches), int(cell)
    if x.shape[0] % i:
        raise ValueError(
            f"stream length {x.shape[0]} not divisible by branches {i} "
            "(pad the final chunk)"
        )
    depth = (i - 1) * m * i
    if state is None:
        state = torch.zeros(depth, dtype=x.dtype, device=x.device)
    else:
        state = torch.as_tensor(state).to(device=x.device, dtype=x.dtype)
    ext = torch.cat([state, x])
    ext2 = ext.reshape(-1, i).T  # [I, (depth + T) / I]; class j = row j
    rows, d0 = x.shape[0] // i, depth // i
    starts = [d0 - ((i - 1 - j) if deinter else j) * m for j in range(i)]
    y = _class_gather(ext2, starts, rows).T.reshape(-1)
    return y, ext[ext.shape[0] - depth:]


def conv_interleave(x, branches: int = 12, cell: int = 17, state=None):
    """Convolutional (Forney) interleaver on a flat stream: branch ``j``
    (positions ``t = j mod I``) delays by ``j * cell * I`` samples.
    ``state``: the ``(I-1) * cell * I``-sample history (None = zeros).
    Returns ``(y, new_state)``; bits or LLRs, any dtype."""
    return _conv_ilv(x, branches, cell, state, deinter=False)


def conv_deinterleave(x, branches: int = 12, cell: int = 17, state=None):
    """Inverse of :func:`conv_interleave`: branch ``j`` delays by
    ``(I-1-j) * cell * I`` samples, so the cascade is a pure
    ``(I-1) * cell * I``-sample delay. Returns ``(y, new_state)``."""
    return _conv_ilv(x, branches, cell, state, deinter=True)


def _conv_ilv_block(x, branches: int, cell: int, sign: int) -> torch.Tensor:
    x = torch.as_tensor(x)
    n = x.shape[-1]
    i, m = int(branches), int(cell)
    if n % i:
        raise ValueError(f"length {n} not divisible by branches {i}")
    x2 = x.reshape(x.shape[:-1] + (n // i, i)).transpose(-1, -2)  # [..., I, n / I]
    y2 = _class_gather(x2, [-sign * j * m for j in range(i)], n // i)
    return y2.transpose(-1, -2).reshape(x.shape)


def conv_interleave_block(x, branches: int = 12, cell: int = 17) -> torch.Tensor:
    """Circular convolutional interleaver for framed data, batched over
    leading axes: class ``j`` of ``[..., n]`` rolls by ``j * cell`` within
    its ``n / I`` members (a permutation; ``branches`` must divide ``n``).
    Invert with :func:`conv_deinterleave_block`."""
    return _conv_ilv_block(x, branches, cell, 1)


def conv_deinterleave_block(x, branches: int = 12, cell: int = 17) -> torch.Tensor:
    """Inverse permutation of :func:`conv_interleave_block`."""
    return _conv_ilv_block(x, branches, cell, -1)
