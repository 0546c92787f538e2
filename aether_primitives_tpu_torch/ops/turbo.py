"""Turbo codes: two RSC(1, 15/13) constituents and max-log-MAP iterative
decoding (PyTorch).

Counterpart of ``aether_primitives_tpu/ops/turbo.py``: the same code (rate
1/3, K = 4, encoder 1 terminated with 3 tail pairs, encoder 2 open), the
same seeded interleaver, the same extrinsic exchange. Batched over leading
axes natively.

- :func:`rsc_encode`, :func:`turbo_encode`, :func:`turbo_interleaver`.
- :func:`turbo_decode`: with ``window > 0`` each constituent decode is
  :func:`_bcjr_maxlog_windowed`, whose recursion is one call of
  :func:`~.cuda.bcjr.bcjr_windowed_llr` (the hand-written kernel on a CUDA
  tensor, its plain version on a CPU tensor), so an ``iterations``-round
  decode makes ``2 * iterations`` launches. ``window = 0`` is the exact
  recursion :func:`_bcjr_maxlog`, plain PyTorch on the tensors' device
  (the JAX package runs it as an XLA scan on every platform).

LLR convention: positive = bit 0.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .cuda import bcjr as _bk

__all__ = ["turbo_encode", "turbo_decode", "turbo_interleaver", "rsc_encode"]

# RSC(1, 15/13): feedback g0 = 13 octal = 1011, feedforward g1 = 15 = 1101.
# state s = (s1, s2, s3) as the integer s1*4 + s2*2 + s3;
# a = u ^ s2 ^ s3 (feedback), p = a ^ s1 ^ s3, next = (a, s1, s2).
_K = 4
_N_STATES = 8
#: Constituent-decoder backends: "auto" takes the kernel for a CUDA tensor
#: and the plain version for a CPU tensor; "reference" the plain version.
BACKENDS = ("auto", "reference")


@functools.lru_cache(maxsize=None)
def _trellis():
    nxt = np.zeros((_N_STATES, 2), np.int64)
    par = np.zeros((_N_STATES, 2), np.int64)
    fb = np.zeros(_N_STATES, np.int64)  # feedback bit that makes a = 0
    for s in range(_N_STATES):
        s1, s2, s3 = (s >> 2) & 1, (s >> 1) & 1, s & 1
        fb[s] = s2 ^ s3
        for u in (0, 1):
            a = u ^ s2 ^ s3
            p = a ^ s1 ^ s3
            nxt[s, u] = (a << 2) | (s1 << 1) | s2
            par[s, u] = p
    # predecessor table: prev[s'][j] = (s, u) with nxt[s, u] = s' (exactly 2)
    prev_s = np.zeros((_N_STATES, 2), np.int64)
    prev_u = np.zeros((_N_STATES, 2), np.int64)
    fill = np.zeros(_N_STATES, np.int64)
    for s in range(_N_STATES):
        for u in (0, 1):
            sp = nxt[s, u]
            prev_s[sp, fill[sp]] = s
            prev_u[sp, fill[sp]] = u
            fill[sp] += 1
    assert (fill == 2).all()
    return nxt, par, fb, prev_s, prev_u


def rsc_encode(bits, terminate: bool = True):
    """Systematic recursive convolutional encode of ``[..., n]`` {0,1}
    bits from state 0: ``(parity, tail_sys, tail_par)``, uint8. With
    ``terminate`` the trellis is driven back to state 0 in ``K-1 = 3``
    steps whose systematic bits are ``tail_sys``. A loop over the bits,
    batched over the leading axes."""
    nxt, par, fb, _, _ = _trellis()
    u = torch.as_tensor(bits).to(torch.int64) % 2
    dev = u.device
    nxt_t = torch.from_numpy(nxt).to(dev)
    par_t = torch.from_numpy(par).to(dev)
    s = torch.zeros(u.shape[:-1], dtype=torch.int64, device=dev)
    parity = torch.empty(u.shape, dtype=torch.uint8, device=dev)
    for t in range(u.shape[-1]):
        ub = u[..., t]
        parity[..., t] = par_t[s, ub].to(torch.uint8)
        s = nxt_t[s, ub]
    if not terminate:
        empty = torch.zeros(u.shape[:-1] + (0,), dtype=torch.uint8, device=dev)
        return parity, empty, empty.clone()
    fb_t = torch.from_numpy(fb).to(dev)
    tail_sys, tail_par = [], []
    for _ in range(_K - 1):
        ub = fb_t[s]
        tail_sys.append(ub)
        tail_par.append(par_t[s, ub])
        s = nxt_t[s, ub]
    return (parity, torch.stack(tail_sys, -1).to(torch.uint8),
            torch.stack(tail_par, -1).to(torch.uint8))


@functools.lru_cache(maxsize=None)
def turbo_interleaver(n: int, seed: int = 0x5EED) -> np.ndarray:
    """Fixed uniform interleaver permutation for block length ``n``."""
    return np.random.default_rng(seed ^ n).permutation(n)


def turbo_encode(bits, seed: int = 0x5EED):
    """Rate-1/3 turbo encode of ``[..., n]`` info bits: ``(sys, par1, par2,
    tail_sys, tail_par)``, ``par2`` over the interleaved bits, ``3 n + 6``
    bits in all."""
    u = torch.as_tensor(bits).to(torch.uint8) % 2
    n = int(u.shape[-1])
    perm = torch.from_numpy(turbo_interleaver(n, seed)).to(u.device)
    par1, tail_sys, tail_par = rsc_encode(u, terminate=True)
    par2, _, _ = rsc_encode(u.index_select(-1, perm), terminate=False)
    return u, par1, par2, tail_sys, tail_par


def _step_coeffs():
    """Per-transition branch-metric coefficients: forward update of state
    ``s'`` via predecessor slot ``j`` is ``cu[s',j]*(Ls+La) + cp[s',j]*Lp``
    from row ``prev_s[s',j]``; backward update of ``s`` via input ``u`` is
    ``du[u]*(Ls+La) + dp[s,u]*Lp`` from row ``nxt[s,u]``."""
    nxt, par, _, prev_s, prev_u = _trellis()
    u_sgn = 1.0 - 2.0 * np.arange(2)
    p_sgn = 1.0 - 2.0 * par  # [8, 2]
    cu = 0.5 * u_sgn[prev_u]                       # [8, 2]
    cp = 0.5 * p_sgn[prev_s, prev_u]               # [8, 2]
    du = 0.5 * u_sgn                               # [2]
    dp = 0.5 * p_sgn                               # [8, 2]
    return nxt, prev_s, cu, cp, du, dp


def _f32(a, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=dev)


def _bcjr_maxlog(l_sys, l_par, l_apr, terminated: bool):
    """Exact max-log-MAP for one RSC constituent, batched: ``l_* [B, T]``
    -> a-posteriori LLRs ``[B, T]``. With ``terminated`` both recursions
    pin state 0 (metric 0 against -1e9)."""
    nxt, prev_s, cu, cp, du, dp = _step_coeffs()
    dev = l_sys.device
    b_sz, t_len = l_sys.shape
    ls = (l_sys + l_apr).T  # [T, B]
    lp = l_par.T
    nxt_t = [torch.from_numpy(nxt[:, u]).to(dev) for u in (0, 1)]
    prev_t = [torch.from_numpy(prev_s[:, j]).to(dev) for j in (0, 1)]
    cu_t, cp_t, dp_t = (_f32(a, dev)[..., None] for a in (cu, cp, dp))  # [8, 2, 1]
    du_t = [float(np.float32(d)) for d in du]

    pinned = torch.full((_N_STATES, b_sz), -1e9, dtype=torch.float32, device=dev)
    pinned[0] = 0.0
    alpha = pinned
    beta = pinned.clone() if terminated else torch.zeros_like(pinned)
    alphas = torch.empty((t_len, _N_STATES, b_sz), dtype=torch.float32, device=dev)
    betas = torch.empty_like(alphas)
    for i in range(t_len):
        t = t_len - 1 - i
        alphas[i], betas[t] = alpha, beta
        a = torch.maximum(alpha[prev_t[0]] + (cu_t[:, 0] * ls[i] + cp_t[:, 0] * lp[i]),
                          alpha[prev_t[1]] + (cu_t[:, 1] * ls[i] + cp_t[:, 1] * lp[i]))
        alpha = a - a.amax(dim=0, keepdim=True)
        b = torch.maximum(beta[nxt_t[0]] + (du_t[0] * ls[t] + dp_t[:, 0] * lp[t]),
                          beta[nxt_t[1]] + (du_t[1] * ls[t] + dp_t[:, 1] * lp[t]))
        beta = b - b.amax(dim=0, keepdim=True)
    m = []
    for u in (0, 1):
        g = du_t[u] * ls[:, None] + dp_t[None, :, u] * lp[:, None]  # [T, 8, B]
        m.append(((alphas + g) + betas[:, nxt_t[u]]).amax(dim=1))
    return (m[0] - m[1]).T  # [B, T], positive = bit 0


def _bcjr_maxlog_windowed(l_sys, l_par, l_apr, window: int, guard: int,
                          backend: str = "auto"):
    """Windowed parallel max-log-MAP, batched: ``l_* [B, T]`` -> ``[B, T]``.
    The block splits into ``ceil(T / window)`` windows, each extended by
    ``guard`` steps on both sides (zero LLRs beyond the block), and every
    window runs the recursion from uniform metrics: ``[Lw, B * W]`` spans
    through one :func:`~.cuda.bcjr.bcjr_windowed_llr` call (``backend
    "auto"``) or its plain version (``"reference"``); each window keeps its
    core ``window`` LLRs."""
    b_sz, t_len = l_sys.shape
    n_win = -(-t_len // window)
    t_pad = n_win * window
    lw = window + 2 * guard
    lsum = l_sys + l_apr

    def spans(x):  # [B, T] -> [Lw, B * W] overlapped spans, column b * W + w
        xp = torch.nn.functional.pad(x, (guard, guard + (t_pad - t_len)))
        s = xp.unfold(1, lw, window)  # [B, W, Lw]
        return s.permute(2, 0, 1).reshape(lw, b_sz * n_win).contiguous()

    decode = (_bk.bcjr_windowed_llr if backend == "auto"
              else _bk.bcjr_windowed_llr_reference)
    llr = decode(spans(lsum), spans(l_par), lw)
    core = llr[guard:guard + window].reshape(window, b_sz, n_win)
    return core.permute(1, 2, 0).reshape(b_sz, t_pad)[:, :t_len]


def turbo_decode(llr_sys, llr_par1, llr_par2, llr_tail_sys=None,
                 llr_tail_par=None, iterations: int = 6, seed: int = 0x5EED,
                 window: int = 0, guard: int = 24, bcjr_backend: str = "auto"):
    """Iterative turbo decode, batched over leading axes. Inputs are the
    channel LLRs of the streams :func:`turbo_encode` emits, ``[..., n]``
    and tails ``[..., 3]`` (None: decoder 1 open-ended). Returns ``(bits,
    llr)``: hard decisions (uint8) and the final a-posteriori LLRs of the
    ``n`` info bits.

    ``window > 0``: the windowed BCJR (:func:`_bcjr_maxlog_windowed`) for
    both constituents, ``2 * iterations`` recursion calls; ``bcjr_backend``
    is ``"auto"`` (the kernel for CUDA tensors, the plain version for CPU
    tensors) or ``"reference"`` (the plain version). ``window = 0``: the
    exact recursion, plain PyTorch on the inputs' device.
    """
    if bcjr_backend not in BACKENDS:
        raise ValueError(
            f"unknown bcjr_backend {bcjr_backend!r} (expected one of {BACKENDS})"
        )
    ls = torch.as_tensor(llr_sys).to(torch.float32)
    dev = ls.device
    lp1 = torch.as_tensor(llr_par1, device=dev).to(torch.float32)
    lp2 = torch.as_tensor(llr_par2, device=dev).to(torch.float32)
    lead = tuple(ls.shape[:-1])
    n = int(ls.shape[-1])
    ls, lp1, lp2 = ls.reshape(-1, n), lp1.reshape(-1, n), lp2.reshape(-1, n)
    b_sz = ls.shape[0]
    perm_np = turbo_interleaver(n, seed)
    perm = torch.from_numpy(perm_np).to(dev)
    inv = torch.from_numpy(np.argsort(perm_np)).to(dev)
    if llr_tail_sys is not None:
        lts = torch.as_tensor(llr_tail_sys, device=dev).to(torch.float32).reshape(b_sz, -1)
        ltp = torch.as_tensor(llr_tail_par, device=dev).to(torch.float32).reshape(b_sz, -1)
        ls1 = torch.cat([ls, lts], dim=-1)
        lp1e = torch.cat([lp1, ltp], dim=-1)
        terminated = True
    else:
        ls1, lp1e = ls, lp1
        terminated = False
    ls2 = ls.index_select(-1, perm)

    if window:
        def bcjr(ls_, lp_, la_, _terminated):
            return _bcjr_maxlog_windowed(ls_, lp_, la_, window, guard,
                                         backend=bcjr_backend)
    else:
        bcjr = _bcjr_maxlog

    la1 = torch.zeros((b_sz, n), dtype=torch.float32, device=dev)
    llr = la1
    for _ in range(int(iterations)):
        la1_full = (torch.nn.functional.pad(la1, (0, ls1.shape[-1] - n))
                    if ls1.shape[-1] != n else la1)
        l1 = bcjr(ls1, lp1e, la1_full, terminated)[:, :n]
        ext1 = l1 - ls - la1
        la2 = ext1.index_select(-1, perm)
        l2 = bcjr(ls2, lp2, la2, False)
        ext2 = l2 - ls2 - la2
        la1 = ext2.index_select(-1, inv)
        llr = l2.index_select(-1, inv)
    llr = llr.reshape(lead + (n,))
    return (llr < 0).to(torch.uint8), llr
