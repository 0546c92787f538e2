"""Acquisition, tracking loops and equalization (PyTorch).

Counterpart of ``aether_primitives_tpu/models/sync.py``. The feedforward
estimators, batched over leading axes:

- :func:`detect_preamble`: overlap-save matched filter, argmax of ``|y|^2``;
- :func:`estimate_cfo`: Schmidl & Cox over two repeated halves;
- :func:`estimate_cfo_blind`: periodogram peak of ``x^M`` (M-PSK), with a
  parabolic refinement;
- :func:`estimate_phase_mpsk`: Viterbi & Viterbi M-th power phase;
- :func:`apply_freq_shift`: mix by ``e^{-j 2 pi f n}``;
- :class:`OfdmEqualizer`: the one-tap per-subcarrier equalizer of the
  OFDM link (a pilot frame's channel estimate, divided out);
- :func:`estimate_timing` (Oerder & Meyr square law) and
  :func:`estimate_baud_rate` (the strongest line of the squared envelope's
  periodogram).

The feedback loops, each a plain recurrence a symbol (or dwell) a step,
the JAX package's ``lax.scan`` bodies written out: :func:`costas_loop`
(batched over leading axes), :func:`gardner_loop`,
:func:`code_tracking_loop`, :func:`carrier_tracking_loop`; and
:func:`nav_bit_sync`. Their state stays a tensor on the input's device and
a step reads nothing back to the host (windows are gathered at a tensor
index), so on a card a loop only enqueues; every constant is made before
the loop.

Arithmetic follows the JAX package's order (``x^4`` as two squarings, the
angle of a float32 sum, the rotation ``-2 pi f n`` in float32), so results
agree with it to float32 rounding.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..ops import fft as _fft
from ..ops import fir as _fir
from ..types import as_cf32


def _upload(a: np.ndarray, device) -> torch.Tensor:
    """A host array on ``device`` without a stream synchronise (a copy
    from pageable memory returns once CUDA has staged it)."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(device, non_blocking=True)


def detect_preamble(x, preamble, fft_backend: Optional[str] = None):
    """``(offset, peak_metric)`` of the best preamble alignment in ``x``
    ``[..., n]``: ``offset`` (int64) is where the preamble's first sample
    sits, ``peak_metric`` is ``|correlation|^2 / energy(preamble)^2``
    (1.0 for a clean hit). ``fft_backend``: see
    :func:`~aether_primitives_tpu_torch.ops.fft.check_backend`."""
    x = as_cf32(x)
    pre = np.asarray(preamble, dtype=np.complex64)
    y = _fir.matched_filter(x, pre, fft_backend=fft_backend)
    mag2 = y.real ** 2 + y.imag ** 2
    peak_pos = torch.argmax(mag2, dim=-1)
    energy = float(np.sum(np.abs(pre) ** 2))
    peak_val = mag2.gather(-1, peak_pos[..., None])[..., 0]
    # the matched filter peaks at offset + len(pre) - 1 (causal convention)
    offset = peak_pos - (pre.shape[-1] - 1)
    return offset, peak_val / float(np.float32(energy ** 2))


def estimate_cfo(x, rep_len: int) -> torch.Tensor:
    """CFO in cycles/sample from ``x`` starting with two identical
    ``rep_len``-sample halves: ``angle(sum x[n + rep] conj x[n]) / (2 pi
    rep)``. Unambiguous for ``|f| < 1 / (2 rep)``."""
    x = as_cf32(x)
    a = x[..., :rep_len]
    b = x[..., rep_len:2 * rep_len]
    corr = (b * a.conj()).sum(dim=-1)
    return torch.angle(corr) / float(np.float32(2.0 * math.pi * rep_len))


def _pow_m(x: torch.Tensor, m: int) -> torch.Tensor:
    """``x^m`` by repeated squaring (the JAX package's integer power)."""
    acc, base = None, x
    while m:
        if m & 1:
            acc = base if acc is None else acc * base
        m >>= 1
        if m:
            base = base * base
    return acc


def _peak_refined(mag: torch.Tensor, nfft: int):
    """Argmax bin of ``mag [..., nfft]`` refined by a parabola through its
    neighbours: float32 bin position."""
    k = torch.argmax(mag, dim=-1)
    km1 = mag.gather(-1, ((k - 1) % nfft)[..., None])[..., 0]
    k0 = mag.gather(-1, k[..., None])[..., 0]
    kp1 = mag.gather(-1, ((k + 1) % nfft)[..., None])[..., 0]
    denom = km1 - 2.0 * k0 + kp1
    off = torch.where(denom.abs() > 1e-30, 0.5 * (km1 - kp1) / denom,
                      torch.zeros_like(denom))
    return k.to(torch.float32) + off


def estimate_cfo_blind(x, m: int = 4, osr: int = 4) -> torch.Tensor:
    """Blind CFO (cycles/sample) of M-PSK symbols ``[..., n]``: the
    periodogram peak of ``x^M``, zero-padded ``osr`` times past the next
    power of two, divided by ``M``. Unambiguous for ``|f| < 1 / (2 M)``."""
    x = as_cf32(x)
    z = _pow_m(x, m)
    n = z.shape[-1]
    nfft = int(osr) * int(2 ** np.ceil(np.log2(max(n, 2))))
    zp = torch.nn.functional.pad(z, (0, nfft - n))
    mag = _fft.plan(nfft).fwd(zp).abs()
    kf = _peak_refined(mag, nfft)
    kf = torch.where(kf > nfft / 2, kf - nfft, kf)  # signed frequency
    return kf / float(nfft * m)


def _mpsk_grid_ref(m: int, grid: str) -> complex:
    """M-th-power reference of the constellation grid: ``"diagonal"`` (the
    package's BPSK/QPSK tables, points at ``pi/M + 2 pi k/M``) powers to
    ``e^{j pi}``; ``"axes"`` (index-linear ``psk`` tables, points at
    ``2 pi k/M``) powers to ``e^{j 0}``."""
    if grid == "diagonal":
        return complex(np.exp(-1j * np.pi))
    if grid == "axes":
        return 1.0 + 0.0j
    raise ValueError(f"grid must be 'diagonal' or 'axes', got {grid!r}")


def estimate_phase_mpsk(x, m: int = 4, grid: str = "diagonal") -> torch.Tensor:
    """Feedforward M-PSK phase (radians, in ``[-pi/M, pi/M)``): ``angle(
    sum x^M * ref) / M`` with the reference rotation of the constellation
    grid (:func:`_mpsk_grid_ref`: the diagonal BPSK/QPSK tables by
    default, ``(e^{j pi/4})^4 = -1``; ``"axes"`` for ``psk`` tables)."""
    ref = np.complex64(_mpsk_grid_ref(m, grid))
    x = as_cf32(x)
    acc = _pow_m(x, m).sum(dim=-1)
    acc = acc * torch.tensor(ref, device=x.device)
    return torch.angle(acc) / float(m)


def apply_freq_shift(x, cycles_per_sample) -> torch.Tensor:
    """Mix ``x [..., n]`` by ``e^{-j 2 pi f n}`` (undo a +f CFO); ``f`` is
    a float or a tensor of the batch shape (one CFO per row)."""
    x = as_cf32(x)
    n = torch.arange(x.shape[-1], dtype=torch.float32, device=x.device)
    f = torch.as_tensor(cycles_per_sample, dtype=torch.float32, device=x.device)
    if f.ndim:
        f = f[..., None]  # per-row CFOs broadcast against the sample index
    ang = -2.0 * math.pi * f * n
    return x * torch.complex(torch.cos(ang), torch.sin(ang))


class OfdmEqualizer:
    """One-tap per-subcarrier equalizer from a known pilot frame.

    ``estimate(rx_pilot_spec, tx_pilot_spec)`` -> per-bin channel ``H``;
    ``apply(spec, H)`` divides it out. Bins where the pilot is zero (guard
    bands) get ``H = 1``, so the division leaves them as they are. Tensors
    stay where they lie (the received spectrum's device)."""

    @staticmethod
    def estimate(rx_pilot_spec, tx_pilot_spec) -> torch.Tensor:
        rx = as_cf32(rx_pilot_spec)
        tx = as_cf32(tx_pilot_spec, device=rx.device)
        occupied = tx.abs() > 0
        one = torch.ones((), dtype=rx.dtype, device=rx.device)
        return torch.where(occupied, rx / torch.where(occupied, tx, one), one)

    @staticmethod
    def apply(spec, h) -> torch.Tensor:
        spec = as_cf32(spec)
        return spec / as_cf32(h, device=spec.device)


def estimate_timing(x, sps: int) -> torch.Tensor:
    """Non-data-aided symbol-timing offset (Oerder & Meyr square law) of a
    pulse-shaped stream at ``sps`` samples/symbol: ``tau = -sps/(2 pi) *
    arg(sum |x[n]|^2 e^{-j 2 pi n / sps})`` in samples, wrapped to
    ``[-sps/2, sps/2)``; advance the stream by ``tau`` to put the symbol
    instants on ``0, sps, 2 sps, ...``. Batched over leading axes."""
    x = as_cf32(x)
    env = x.real ** 2 + x.imag ** 2
    n = x.shape[-1]
    # the tone is periodic in sps: one period built in float64 as the JAX
    # package builds its whole table (np.mod of an integer index is exact),
    # then repeated on the device
    idx = np.arange(sps, dtype=np.float64)
    period = np.exp(-2j * np.pi * np.mod(idx, sps) / sps).astype(np.complex64)
    tone = _upload(period, x.device)[torch.arange(n, device=x.device) % sps]
    c = (env * tone).sum(dim=-1)
    tau = -torch.angle(c) * float(np.float32(sps / (2.0 * np.pi)))
    return torch.remainder(tau + sps / 2.0, float(sps)) - sps / 2.0


def estimate_baud_rate(x, osr: int = 4, min_rate: float = 0.02) -> torch.Tensor:
    """Blind symbol rate (cycles/sample, float32) of a pulse-shaped linear
    modulation: the strongest line of the periodogram of the mean-removed
    squared envelope, zero-padded ``osr`` times past the next power of two,
    searched over ``(min_rate, 0.5]`` and refined by a parabola through its
    neighbours. Batched over leading axes."""
    x = as_cf32(x)
    env = x.real ** 2 + x.imag ** 2
    env = env - env.mean(dim=-1, keepdim=True)
    n = env.shape[-1]
    nfft = int(osr) * int(2 ** np.ceil(np.log2(max(n, 2))))
    ez = torch.nn.functional.pad(env.to(torch.complex64), (0, nfft - n))
    mag = _fft.plan(nfft).fwd(ez, _fft.Scale.NONE).abs()
    mask = torch.zeros(nfft, dtype=torch.float32, device=x.device)
    mask[int(np.ceil(float(min_rate) * nfft)):nfft // 2 + 1] = 1.0
    return _peak_refined(mag * mask, nfft) / float(nfft)


def _loop_gains(loop_bw: float, damping: float):
    """``(kp, ki)`` of the second-order loop, the standard bandwidth
    normalization, rounded to float32 as the JAX package's constants."""
    zeta = float(damping)
    theta = float(loop_bw) / (zeta + 1.0 / (4.0 * zeta))
    d = 1.0 + 2.0 * zeta * theta + theta * theta
    return float(np.float32(4.0 * zeta * theta / d)), float(np.float32(4.0 * theta * theta / d))


#: The cubic Lagrange weights at ``mu`` over the taps ``-1, 0, 1, 2`` as
#: ``(A * B) * C / D``, each factor ``mu * S + O``: the JAX package's
#: ``c0 = -mu (mu-1) (mu-2) / 6``, ``c1 = (mu+1) (mu-1) (mu-2) / 2``,
#: ``c2 = -(mu+1) mu (mu-2) / 2``, ``c3 = (mu+1) mu (mu-1) / 6``, in its
#: order of operations.
_LAGRANGE_S = np.array([[-1, 1, -1, 1], [1, 1, 1, 1], [1, 1, 1, 1]], np.float32)
_LAGRANGE_O = np.array([[0, 1, -1, 1], [-1, -1, 0, 0], [-2, -2, -2, -1]], np.float32)
_LAGRANGE_D = np.array([6, 2, 2, 6], np.float32)


def _lagrange(device):
    """The weight tables of :data:`_LAGRANGE_S` on ``device``."""
    return tuple(_upload(a, device) for a in (_LAGRANGE_S, _LAGRANGE_O, _LAGRANGE_D))


def _lagrange_weights(mu: torch.Tensor, tables) -> torch.Tensor:
    """Cubic Lagrange weights ``[..., 4]`` at fractional positions ``mu``."""
    s, o, d = tables
    f = torch.addcmul(o, mu[..., None, None], s)  # [..., 3, 4]; mu * S exact
    return f[..., 0, :] * f[..., 1, :] * f[..., 2, :] / d


def costas_loop(x, m: int = 4, loop_bw: float = 0.01, damping: float = 0.7071,
                phase0: float = 0.0, freq0: float = 0.0, grid: str = "diagonal"):
    """Second-order decision-free carrier PLL (Costas loop, M-th power
    detector) over the last axis, batched over leading axes. Returns ``(y,
    phase, freq)``: the de-rotated stream and the per-sample loop traces
    (radians, radians/sample; ``phase`` before each update). Per sample
    ``y = x e^{-j phase}``, ``e = angle(y^M ref) / M`` (``ref`` the
    grid's M-th-power reference, :func:`_mpsk_grid_ref`), ``freq += ki e``,
    ``phase += freq + kp e``; ``loop_bw`` in cycles per symbol."""
    ref = _mpsk_grid_ref(m, grid)
    x = as_cf32(x)
    kp, ki = _loop_gains(loop_bw, damping)
    shape = x.shape
    rows = x.reshape(-1, shape[-1])
    b = rows.shape[0]
    phase = torch.full((b,), float(np.float32(phase0)), dtype=torch.float32, device=x.device)
    freq = torch.full((b,), float(np.float32(freq0)), dtype=torch.float32, device=x.device)
    one = torch.ones((b,), dtype=torch.float32, device=x.device)
    ys, phs, frs = [], [], []
    for i in range(shape[-1]):
        y = rows[:, i] * torch.polar(one, -phase)
        err = torch.angle(_pow_m(y, m) * ref) / float(m)
        freq = freq + ki * err
        ys.append(y)
        phs.append(phase)
        frs.append(freq)
        phase = phase + freq + kp * err
    if not ys:
        return x, x.real.clone(), x.real.clone()
    return tuple(torch.stack(v, dim=-1).reshape(shape) for v in (ys, phs, frs))


def gardner_loop(x, sps: int = 2, loop_bw: float = 0.01, damping: float = 0.7071,
                 n_symbols: Optional[int] = None):
    """Decision-free feedback symbol-timing recovery (Gardner 1986) on one
    stream. Returns ``(symbols, tau)``: one cubic-Lagrange strobe a symbol
    and the fractional position of each (samples). The error ``e =
    Re{(y_k - y_{k-1}) conj(y_{k-1/2})}`` drives ``w -= ki e``, ``pos += w
    - kp e``; strobe positions are clamped to ``[1, n - 4]``. ``n_symbols``
    defaults to the JAX package's ``max(int((n - 8) // sps * 0.998) - 1,
    0)`` (a margin for ~2000 ppm of clock error)."""
    x = as_cf32(x)
    if x.ndim != 1:
        raise ValueError("gardner_loop takes a single stream; vmap for batches")
    n = int(x.shape[-1])
    sps = int(sps)
    if sps < 2:
        raise ValueError("Gardner needs >= 2 samples/symbol")
    if n_symbols is None:
        n_symbols = max(int((n - 8) // sps * 0.998) - 1, 0)
    kp, ki = _loop_gains(loop_bw, damping)
    dev = x.device
    planes = torch.view_as_real(x.contiguous())  # [n, 2]
    hi = float(np.float32(n - 3) - np.float32(1.0))
    taps = torch.arange(4, device=dev)
    tables = _lagrange(dev)
    pos = torch.full((), 2.0 + sps, dtype=torch.float32, device=dev)
    w = torch.full((), float(sps), dtype=torch.float32, device=dev)
    prev = torch.zeros(2, dtype=torch.float32, device=dev)
    syms, taus = [], []
    for _ in range(int(n_symbols)):
        # the on-time and midpoint strobes together: [2] positions
        p = torch.clamp(torch.stack([pos, pos - w * 0.5]), 1.0, hi)
        fl = torch.floor(p)
        mu = p - fl
        # lax.dynamic_slice clamps its start into [0, n - 4]
        start = torch.clamp(fl.long() - 1, 0, n - 4)
        rows = planes[start[:, None] + taps]  # [2, 4, 2]
        y = (_lagrange_weights(mu, tables)[..., None] * rows).sum(dim=-2)  # [2, 2]
        e = ((y[0] - prev) * y[1]).sum()
        w_new = w - ki * e
        syms.append(y[0])
        taus.append(pos)
        pos = pos + w_new - kp * e
        w, prev = w_new, y[0]
    if not syms:
        return x[:0], torch.zeros(0, dtype=torch.float32, device=dev)
    return torch.view_as_complex(torch.stack(syms)), torch.stack(taus)


def code_tracking_loop(x, chips, sps: int = 2, loop_bw: float = 0.005,
                       damping: float = 0.7071, n_dwells: Optional[int] = None):
    """Early-late delay-locked loop for DSSS/GNSS code tracking on one
    stream. Returns ``(prompt, tau)``: one complex prompt correlation a
    code period and the tracked code phase (samples).

    Per dwell the window of one code period plus the lags is shifted by
    the loop's common fractional delay (cubic Lagrange), despread at
    half-chip early, prompt and late lags, and the normalized noncoherent
    discriminator ``(|E|^2 - |L|^2) / (|E|^2 + |L|^2)`` drives a second-order
    loop. ``chips`` in {0,1} or +-1 (length L, one dwell = ``L * sps``
    samples); ``sps`` >= 2; ``loop_bw`` in cycles/dwell. The capture is
    sliced so that the code's first chip begins ~``sps`` samples in."""
    x = as_cf32(x)
    if x.ndim != 1:
        raise ValueError("code_tracking_loop takes one stream; vmap batches")
    sps = int(sps)
    if sps < 2:
        raise ValueError("DLL needs >= 2 samples/chip (half-chip lags)")
    c = np.asarray(chips)
    code = (np.where(c > 0.5, 1.0, -1.0).astype(np.float32) if c.min() >= 0
            else c.astype(np.float32))
    l_chips = code.shape[-1]
    dwell = l_chips * sps
    half = sps // 2
    n = int(x.shape[-1])
    if n_dwells is None:
        n_dwells = max((n - 2 * sps - 8) // dwell - 1, 1)
    kp, ki = _loop_gains(loop_bw, damping)
    dev = x.device
    win = dwell + 2 * half + 4  # E..L span + cubic kernel margin
    nmax = float(np.float32(n - win - 2))
    planes = torch.view_as_real(x.contiguous())  # [n, 2]
    code_t = _upload(code, dev)
    span = torch.arange(win, device=dev)
    # the early, prompt and late lags' chip samples: [3, L]
    lags = (torch.arange(3, device=dev)[:, None] * half
            + torch.arange(l_chips, device=dev) * sps)
    bases = torch.arange(int(n_dwells), dtype=torch.float32, device=dev) * float(dwell)
    tables = _lagrange(dev)
    tau = torch.full((), float(sps - half), dtype=torch.float32, device=dev)
    rate = torch.zeros((), dtype=torch.float32, device=dev)
    prompts, taus = [], []
    for k in range(int(n_dwells)):
        base = torch.clamp(bases[k] + tau, 1.0, nmax)
        fl = torch.floor(base)
        cw = _lagrange_weights(base - fl, tables)  # [4]
        start = torch.clamp(fl.long() - 1, 0, n - win)
        wnd = planes[start + span]  # [win, 2]
        s = cw[0] * wnd[:-3] + cw[1] * wnd[1:-2] + cw[2] * wnd[2:-1] + cw[3] * wnd[3:]
        corr = torch.matmul(code_t, s[lags])  # [3, 2]: early, prompt, late
        pw = (corr * corr).sum(dim=-1)
        err = (pw[0] - pw[2]) / (pw[0] + pw[2] + 1e-12)
        rate_new = rate - ki * err * float(half)
        prompts.append(corr[1])
        taus.append(tau + float(half))
        tau = tau + rate_new - kp * err * float(half)
        rate = rate_new
    return torch.view_as_complex(torch.stack(prompts)), torch.stack(taus)


def carrier_tracking_loop(prompts, pll_bw: float = 0.03, fll_bw: float = 0.3,
                          damping: float = 0.7071):
    """FLL-assisted Costas PLL on one despread prompt stream (the carrier
    layer of a GNSS/DSSS tracking channel). The FLL reads the cross/dot
    discriminator of consecutive wiped prompts folded by ``sign(dot)``
    (nav-bit edges read ~0), the PLL the Costas ``atan(Q/I)``; both in
    cycles. Returns ``(wiped, phase, freq)``: derotated prompts (data on
    the real axis up to the 180 degree ambiguity), the phase before each
    update (cycles) and the frequency after it (cycles/dwell)."""
    p = as_cf32(prompts)
    if p.ndim != 1:
        raise ValueError("carrier_tracking_loop takes one stream; vmap batches")
    kp, ki = _loop_gains(pll_bw, damping)
    kf = float(np.float32(fll_bw))
    two_pi = float(np.float32(2.0 * np.pi))
    dev = p.device
    one = torch.ones((), dtype=torch.float32, device=dev)
    phi = torch.zeros((), dtype=torch.float32, device=dev)
    freq = torch.zeros((), dtype=torch.float32, device=dev)
    prev = torch.ones((), dtype=torch.complex64, device=dev)
    wiped, phis, freqs = [], [], []
    for k in range(p.shape[-1]):
        # (r + j i) e^{-j 2 pi phi}: iw = r c - i s, qw = r s + i c
        w = p[k] * torch.polar(one, phi * -two_pi)
        cd = prev.conj() * w  # dot + j cross
        dot, cross = cd.real, cd.imag
        f_err = torch.atan2(cross * torch.sign(dot), dot.abs() + 1e-12) / two_pi
        p_err = torch.atan2(w.imag, w.real.abs() + 1e-12) * torch.sign(w.real) / two_pi
        freq = freq + ki * p_err + kf * f_err
        wiped.append(w)
        phis.append(phi)
        freqs.append(freq)
        phi = phi + freq + kp * p_err
        prev = w
    if not wiped:
        return p, p.real.clone(), p.real.clone()
    return torch.stack(wiped), torch.stack(phis), torch.stack(freqs)


def nav_bit_sync(symbols, period: int = 20):
    """Bit synchronization and decision for a carrier-wiped prompt stream
    whose BPSK data lasts ``period`` prompts a bit: every edge offset's
    coherent per-bit sums are scored by their summed magnitude, and the
    best offset wins. Returns ``(bits [n_bits] uint8 (0 = +I), offset
    (int32), quality)``, ``quality`` the winner's mean per-bit magnitude
    over the stream's mean ``|symbol|`` times ``period`` (1.0 = fully
    coherent)."""
    s = as_cf32(symbols)
    if s.ndim != 1:
        raise ValueError("nav_bit_sync takes one stream; vmap batches")
    n = s.shape[-1]
    per = int(period)
    n_bits = (n - per + 1) // per  # complete bits at the worst offset
    if n_bits < 1:
        raise ValueError(f"need >= {2 * per - 1} symbols, got {n}")
    sums = torch.stack([s[off:off + n_bits * per].reshape(n_bits, per).sum(dim=-1)
                        for off in range(per)])  # [period, n_bits]
    score = sums.abs().sum(dim=-1)
    best = torch.argmax(score)
    win = sums.index_select(0, best.reshape(1))[0]
    bits = (win.real < 0).to(torch.uint8)
    denom = s.abs().mean() * per * n_bits + 1e-12
    quality = score.index_select(0, best.reshape(1))[0] / denom
    return bits, best.to(torch.int32), quality
