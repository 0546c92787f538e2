"""Plain float64 reference of the burst receiver for ``fec="ccsds"`` over
QPSK: acquisition by the preamble's correlation, carrier offset off its
two halves, gain and noise off the preamble, blind fine carrier offset and
phase off the fourth power, max-log QPSK LLRs, a full-block Viterbi
decoder, the bit deinterleaver, an RS(n, k) decoder (Berlekamp-Massey,
Chien, Forney), the descrambler and the CRC.

Plain PyTorch (complex128 and float64) batched over bursts, and NumPy for
the few codewords that hold errors. It follows the semantics of the port's
``PacketModem.rx_batch`` with textbook algorithms of its own. ``q`` rounds
every stage's output (:mod:`.precision`): identity for the reference,
bfloat16 for the control.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..gen.burst_tx import (Link, bytes_to_bits, conv_taps, crc, deinterleave, descramble,
                            gf_tables)
from .precision import identity

BLOCK = 512  # captures a block of the front end


def _pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def front_end(caps: torch.Tensor, link: Link, q=identity):
    """Captures ``[B, window]`` -> float64 coded-bit LLRs ``[B, coded_bits]``
    (positive = bit 0) and the estimates ``{"offset", "cfo", "gain",
    "noise_var"}``, each ``[B]``."""
    parts = [_front_block(caps[s:s + BLOCK], link, q) for s in range(0, caps.shape[0], BLOCK)]
    llr = torch.cat([p[0] for p in parts])
    return llr, {k: torch.cat([p[1][k] for p in parts]) for k in parts[0][1]}


def _rot(x: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    n = torch.arange(x.shape[-1], device=x.device, dtype=torch.float64)
    return x * torch.polar(torch.ones_like(n), -2 * math.pi * f[:, None] * n)


def _front_block(caps, link, q):
    dev = caps.device
    x = q(caps.to(torch.complex128))
    pre = q(torch.from_numpy(link.preamble.astype(np.complex128)).to(dev))
    p, length, w = pre.shape[0], link.burst_len, x.shape[-1]
    nfft = _pow2(w + p)
    c = q(torch.fft.ifft(torch.fft.fft(x, nfft) * torch.fft.fft(pre, nfft).conj()))
    offset = (c[:, :w - length + 1].abs() ** 2).argmax(dim=-1)
    b = x.gather(1, offset[:, None] + torch.arange(length, device=dev))
    half = p // 2
    cfo = torch.angle((b[:, half:p] * b[:, :half].conj()).sum(-1)) / (2 * math.pi * half)
    b = q(_rot(b, cfo))
    gain = (b[:, :p] * pre.conj()).sum(-1) / (pre.abs() ** 2).sum()
    eq = q(b[:, p:] / gain[:, None])
    nv = ((b[:, :p] / gain[:, None] - pre).abs() ** 2).mean(-1).clamp_min(1e-6)
    z = q(eq ** 4)
    nz = 4 * _pow2(z.shape[-1])  # the configuration's periodogram: 4x past a power of two
    mag = torch.fft.fft(z, nz).abs()
    k = mag.argmax(-1)
    m = [mag.gather(1, ((k + d) % nz)[:, None])[:, 0] for d in (-1, 0, 1)]
    den = m[0] - 2 * m[1] + m[2]
    kf = k.to(torch.float64) + torch.where(den.abs() > 0, 0.5 * (m[0] - m[2]) / den,
                                           torch.zeros_like(den))
    kf = torch.where(kf > nz / 2, kf - nz, kf)
    eq = q(_rot(eq, kf / (4 * nz)))
    phase = torch.angle(-(eq ** 4).sum(-1)) / 4
    eq = q(eq * torch.polar(torch.ones_like(phase), -phase)[:, None])
    llr = torch.stack([eq.real, eq.imag], dim=-1) * (4 / nv)[:, None, None]
    est = {"offset": offset, "cfo": cfo + kf / (4 * nz), "gain": gain, "noise_var": nv}
    return q(llr.reshape(caps.shape[0], -1)), est


def _trellis(polys, k):
    s = 1 << (k - 1)
    ns = np.arange(s)
    pred = np.stack([ns >> 1, (ns >> 1) | (s >> 1)], axis=1)
    pat = np.zeros((s, 2), np.int64)
    for c in range(2):
        reg = np.zeros((s, k), np.int64)
        reg[:, 0] = ns & 1
        for j in range(1, k):
            reg[:, j] = (pred[:, c] >> (j - 1)) & 1
        bits = [(reg @ np.array(conv_taps(p, k))) % 2 for p in polys]
        pat[:, c] = bits[0] + 2 * bits[1]
    return pred, pat


def viterbi(llr: torch.Tensor, polys=(0o171, 0o133), k: int = 7, q=identity) -> torch.Tensor:
    """Terminated rate-1/2 code, full block from state 0 to state 0:
    ``[B, 2 T]`` LLRs -> ``[B, T - (k - 1)]`` bits."""
    dev = llr.device
    pred_np, pat_np = _trellis(polys, k)
    pred = torch.from_numpy(pred_np).to(dev)
    pat = torch.from_numpy(pat_np).to(dev)
    b, t_steps = llr.shape[0], llr.shape[1] // 2
    l2 = llr.reshape(b, t_steps, 2)
    sign = torch.tensor([[1, 1], [-1, 1], [1, -1], [-1, -1]], dtype=torch.float64, device=dev)
    pm_of = q(l2 @ sign.T)  # [B, T, 4]: the metric of each output pattern
    s = pred.shape[0]
    pm = torch.full((b, s), -1e30, dtype=torch.float64, device=dev)
    pm[:, 0] = 0.0
    dec = torch.empty(t_steps, b, s, dtype=torch.bool, device=dev)
    for t in range(t_steps):
        m = pm_of[:, t]
        c0 = q(pm[:, pred[:, 0]] + m[:, pat[:, 0]])
        c1 = q(pm[:, pred[:, 1]] + m[:, pat[:, 1]])
        dec[t] = c1 > c0
        pm = torch.maximum(c0, c1)
        pm = q(pm - pm.max(dim=1, keepdim=True).values)
    state = torch.zeros(b, dtype=torch.int64, device=dev)
    rows = torch.arange(b, device=dev)
    bits = torch.empty(b, t_steps, dtype=torch.uint8, device=dev)
    for t in range(t_steps - 1, -1, -1):
        bits[:, t] = (state & 1).to(torch.uint8)
        state = pred[state, dec[t, rows, state].to(torch.int64)]
    return bits[:, :t_steps - (k - 1)]


def syndromes(cw: torch.Tensor, nsym: int, fcr: int = 1) -> torch.Tensor:
    """``S_i = r(alpha^(fcr + i))`` of codewords ``[B, n]`` (symbol 0 the
    highest degree): int64 ``[B, nsym]``."""
    exp, log = gf_tables()
    dev = cw.device
    n = cw.shape[-1]
    r = cw.to(torch.int64)
    e = (torch.from_numpy(log).to(dev)[r][:, None, :]
         + ((fcr + torch.arange(nsym, device=dev))[:, None]
            * (n - 1 - torch.arange(n, device=dev))[None, :])[None]) % 255
    v = torch.from_numpy(exp).to(dev)[e] * (r != 0)[:, None, :]  # [B, nsym, n]
    width = _pow2(n)
    v = torch.nn.functional.pad(v, (0, width - n))
    while v.shape[-1] > 1:
        v = v[..., : v.shape[-1] // 2] ^ v[..., v.shape[-1] // 2:]
    return v[..., 0]


def _mul(a: int, b: int, exp, log) -> int:
    return 0 if a == 0 or b == 0 else int(exp[log[a] + log[b]])


def _div(a: int, b: int, exp, log) -> int:
    return 0 if a == 0 else int(exp[(log[a] - log[b]) % 255])


def _eval(poly, x: int, exp, log) -> int:
    """``poly`` (lowest degree first) at ``x``."""
    acc, xp = 0, 1
    for c in poly:
        acc ^= _mul(c, xp, exp, log)
        xp = _mul(xp, x, exp, log)
    return acc


def rs_correct(r: np.ndarray, synd: np.ndarray, nsym: int, fcr: int = 1):
    """One codeword ``r [n]`` with syndromes ``synd``: ``(corrected, ok)``
    by Berlekamp-Massey, Chien's search and Forney's formula (``r`` as it
    came where the decoder fails)."""
    exp, log = gf_tables()
    s = [int(v) for v in synd]
    c, bb, ll, m, bd = [1], [1], 0, 1, 1
    for i in range(nsym):
        d = s[i]
        for j in range(1, ll + 1):
            d ^= _mul(c[j] if j < len(c) else 0, s[i - j], exp, log)
        if d == 0:
            m += 1
            continue
        coef = _div(d, bd, exp, log)
        new = c + [0] * max(0, len(bb) + m - len(c))
        for j, v in enumerate(bb):
            new[j + m] ^= _mul(coef, v, exp, log)
        if 2 * ll <= i:
            bb, ll, bd, m = c, i + 1 - ll, d, 1
        else:
            m += 1
        c = new
    lam = c[:ll + 1]
    n = r.shape[0]
    if ll > nsym // 2:
        return r, False
    pos = [j for j in range(n) if _eval(lam, int(exp[(255 - (n - 1 - j)) % 255]), exp, log) == 0]
    if len(pos) != ll:
        return r, False
    omega = [0] * nsym
    for i in range(nsym):
        for j in range(min(i, ll) + 1):
            omega[i] ^= _mul(s[i - j], lam[j], exp, log)
    dlam = [lam[i] if i % 2 == 1 else 0 for i in range(1, len(lam))]
    out = r.copy()
    for j in pos:
        xinv = int(exp[(255 - (n - 1 - j)) % 255])
        xk = int(exp[(n - 1 - j) % 255])
        num = _mul(_eval(omega, xinv, exp, log), int(exp[(log[xk] * (1 - fcr)) % 255]), exp, log)
        den = _eval(dlam, xinv, exp, log)
        if den == 0:
            return r, False
        out[j] ^= _div(num, den, exp, log)
    return out, True


def rs_decode(cw: torch.Tensor, n: int, k: int):
    """Codewords ``[B, n]`` -> ``(messages [B, k], ok [B], corrected [B])``
    on the codewords' device; ``corrected`` counts the symbols corrected
    (``n - k`` where the decoder fails)."""
    nsym = n - k
    synd = syndromes(cw, nsym)
    bad = torch.nonzero(synd.any(dim=-1)).flatten().tolist()
    ok = torch.ones(cw.shape[0], dtype=torch.bool)
    corrected = torch.zeros(cw.shape[0], dtype=torch.int64)
    out = cw.clone()
    if bad:
        host = cw[bad].cpu().numpy()
        sh = synd[bad].cpu().numpy()
        fixed = []
        for i, row in enumerate(bad):
            word, good = rs_correct(host[i], sh[i], nsym)
            fixed.append(word)
            ok[row] = good
            corrected[row] = int((word != host[i]).sum()) if good else nsym
        out[bad] = torch.from_numpy(np.stack(fixed)).to(cw.device)
    return out[:, :k], ok.to(cw.device), corrected.to(cw.device)


def decode(caps: torch.Tensor, link: Link, q=identity):
    """Captures ``[B, window]`` -> ``(payload [B, payload_bits] uint8,
    crc_ok [B] bool, estimates)``, each burst's CRC verdict on its
    descrambled frame, the estimates as :func:`front_end` gives them and
    ``rs_corrected``, the symbols RS decode corrected a burst."""
    llr, est = front_end(caps, link, q)
    pay, oks, fixes = [], [], []
    for s in range(0, llr.shape[0], 2048):
        hard = viterbi(llr[s:s + 2048], q=q)
        rs_bits = deinterleave(hard, link.rows)
        cw = (rs_bits.reshape(rs_bits.shape[0], -1, 8).to(torch.int64)
              << torch.arange(8, device=llr.device)).sum(-1)
        msg, _ok, fixed = rs_decode(cw, link.rs_n, link.rs_k)
        fixes.append(fixed)
        frame = descramble(bytes_to_bits(msg), link.scrambler)
        width = link.crc_width
        ok = (crc(frame[:, :-width], link.crc) == frame[:, -width:]).all(-1)
        pay.append(frame[:, :link.payload_bits])
        oks.append(ok)
    est["rs_corrected"] = torch.cat(fixes)
    return torch.cat(pay), torch.cat(oks), est
