"""Waterfall channelizer, polyphase filterbanks (PFB) and the STFT (PyTorch).

Counterpart of ``aether_primitives_tpu/models/channelizer.py``:

- the chunked-FFT waterfall (:func:`waterfall_spectra`, :func:`welch_psd`,
  :class:`Channelizer`);
- the critically sampled PFB (:func:`pfb_prototype`, :func:`pfb_channelize`,
  :func:`pfb_spectra`, :class:`PfbChannelizer`) and its synthesis dual
  (:func:`pfb_synthesis_taps`, :func:`pfb_synthesize`,
  :class:`PfbSynthesizer`);
- :func:`stft` and :func:`istft`;
- the oversampled PFB, the wideband front end (:func:`pfb_prototype_nyquist`,
  :func:`pfb_channelize_os`, :func:`pfb_synthesize_os`,
  :class:`PfbChannelizerOs`, :class:`PfbSynthesizerOs`);
- the forms over a device mesh (:func:`sharded_waterfall`,
  :func:`sharded_pfb`, :func:`sharded_pfb_os`): contiguous time spans (or
  waterfall rows) per shard, the PFB history crossing shard boundaries
  through the halo exchange of
  :mod:`~aether_primitives_tpu_torch.parallel.halo`.

The oversampled bank's weighted overlap-add (the fold) and its synthesis
overlap-add run through the hand-written fold kernel
(:func:`~aether_primitives_tpu_torch.ops.cuda.pfb_fold.pfb_analysis`,
:func:`~aether_primitives_tpu_torch.ops.cuda.pfb_fold.pfb_synthesis`; real
or complex prototypes) when ``backend="auto"`` and the samples lie on a
CUDA device; on the CPU, or with ``backend="reference"``, through their
plain versions. :func:`pfb_synthesize` keeps the JAX package's default, the
slice-sum overlap-add (``backend="reference"``), and takes the kernel only
when asked for.

Functions run where their input tensor lies (numpy input: the CPU). The
streaming stages take an explicit ``device``, ``"cuda"`` by default, which
raises RuntimeError without a CUDA device. The host designs (prototypes,
windows, synthesis taps) are numpy copies of the JAX package's, pinned
equal by the tests.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import vecops as _vecops
from ..ops.cuda import pfb_fold as _pf
from ..ops.fft import Scale, check_backend, plan as fft_plan
from ..parallel.halo import left_tail, right_head
from ..parallel.mesh import CHANNEL_AXIS, TIME_AXIS, Mesh, Sharded, shard, shard_last
from ..types import as_cf32, stage_device

#: Fold backends: "auto" takes the fold kernel for a CUDA tensor and the
#: plain fold for a CPU tensor; "reference" takes the plain version on any
#: device.
BACKENDS = ("auto", "reference")


def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (expected one of {BACKENDS})")


def _div_real(z: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """``z / d`` for a complex ``z`` and a real float32 ``d``, plane by plane."""
    return torch.complex(z.real / d, z.imag / d)


def _pad_rows(x: torch.Tensor, fft_len: int) -> torch.Tensor:
    n = x.shape[-1]
    rem = n % fft_len
    if rem:
        x = F.pad(x, (0, fft_len - rem))  # zero-pad like the reference waterfall
    return x.reshape(x.shape[:-1] + (x.shape[-1] // fft_len, fft_len))


def _frames_overlapped(x: torch.Tensor, fft_len: int, hop: int) -> torch.Tensor:
    """Overlapped frames ``[..., n_frames, fft_len]``, frame m starting at
    ``m*hop`` (``fft_len % hop == 0``), the capture zero-padded so the last
    frame is complete: each frame is a concat of ``fft_len/hop`` slabs."""
    if hop == fft_len:
        return _pad_rows(x, fft_len)
    q, rem = divmod(fft_len, hop)
    if rem:
        raise ValueError(f"fft_len {fft_len} must be a multiple of hop {hop}")
    n = x.shape[-1]
    n_frames = max(n - fft_len + hop - 1, 0) // hop + 1
    padded_len = (n_frames - 1) * hop + fft_len
    if padded_len > n:
        x = F.pad(x, (0, padded_len - n))
    slabs = x.reshape(x.shape[:-1] + (padded_len // hop, hop))
    return torch.cat([slabs[..., i:i + n_frames, :] for i in range(q)], dim=-1)


def _resolve_window(window, fft_len: int):
    if window is None:
        return None
    if isinstance(window, str):
        if window == "hann":
            w = np.hanning(fft_len)
        elif window == "hamming":
            w = np.hamming(fft_len)
        elif window == "blackman":
            w = np.blackman(fft_len)
        else:
            raise ValueError(f"unknown window {window!r}")
        return w.astype(np.float32)
    w = np.asarray(window, dtype=np.float32)
    if w.shape[-1] != fft_len:
        raise ValueError("window length must equal fft_len")
    return w


def _on(arr: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    """A host constant as a tensor on ``x``'s device."""
    return torch.from_numpy(np.ascontiguousarray(arr)).to(x.device)


def _magnitude(spec: torch.Tensor, use_db: bool) -> torch.Tensor:
    mag = torch.abs(_vecops.mirror(spec))
    return 10.0 * torch.log10(mag) if use_db else mag


def waterfall_spectra(samples, fft_len: int, use_db: bool = False,
                      fft_backend: Optional[str] = None, window=None,
                      hop: Optional[int] = None) -> torch.Tensor:
    """``[rows, fft_len]`` magnitude (or amplitude dB, ``10*log10|.|``)
    waterfall of a capture: per row a forward FFT with ``Scale.SN``, the
    fftshift (:func:`~..ops.vecops.mirror`) and ``|.|``. Optional analysis
    ``window`` ("hann"/"hamming"/"blackman" or an explicit ``[fft_len]``
    array) and overlapped rows with ``hop < fft_len`` (dividing it)."""
    check_backend(fft_backend)
    x = as_cf32(samples)
    rows = _frames_overlapped(x, fft_len, hop or fft_len)
    w = _resolve_window(window, fft_len)
    if w is not None:
        rows = rows * _on(w, rows)
    return _magnitude(fft_plan(fft_len).fwd(rows, Scale.SN), use_db)


def welch_psd(samples, fft_len: int, hop: Optional[int] = None, window="hann",
              fs: float = 1.0, fft_backend: Optional[str] = None, shift: bool = False):
    """Welch power-spectral-density estimate: windowed overlapped frames,
    per-frame periodograms, averaged, with the conventions of
    ``scipy.signal.welch(..., detrend=False, return_onesided=False,
    scaling="density")``: ``Pxx[k] = E[|FFT(w*frame)[k]|^2] / (fs *
    sum(w^2))``, frames every ``hop`` samples (default ``fft_len // 2``),
    complete frames only, periodic named windows. Returns ``(freqs float64
    numpy, psd float32 tensor [..., fft_len])`` in FFT order, or both
    fftshifted with ``shift=True``."""
    check_backend(fft_backend)
    x = as_cf32(samples)
    hop = int(hop) if hop is not None else fft_len // 2
    n = x.shape[-1]
    if n < fft_len:
        raise ValueError(f"capture shorter than one frame ({n} < {fft_len})")
    n_frames = (n - fft_len) // hop + 1
    x = x[..., :(n_frames - 1) * hop + fft_len]
    rows = _frames_overlapped(x, fft_len, hop)
    if isinstance(window, str):
        w = _resolve_window(window, fft_len + 1)[:-1].copy()
    else:
        w = _resolve_window(window, fft_len)
    if w is None:
        w = np.ones(fft_len, np.float32)
    spec = fft_plan(fft_len).fwd(rows * _on(w, rows), Scale.NONE)
    p = torch.mean(spec.real ** 2 + spec.imag ** 2, dim=-2)
    scale = 1.0 / (float(fs) * float(np.sum(w.astype(np.float64) ** 2)))
    psd = p * torch.tensor(scale, dtype=torch.float32, device=p.device)
    freqs = np.fft.fftfreq(fft_len, d=1.0 / fs)
    if shift:
        freqs = np.fft.fftshift(freqs)
        psd = torch.fft.fftshift(psd, dim=-1)
    return freqs, psd


class Channelizer:
    """Streaming waterfall stage: :func:`waterfall_spectra` with a fixed
    configuration on ``device``. It carries no state (frames never straddle
    blocks when ``block % fft_len == 0`` and ``hop == fft_len``)."""

    def __init__(self, fft_len: int, use_db: bool = False, window=None,
                 hop: Optional[int] = None, fft_backend: Optional[str] = None, device="cuda"):
        check_backend(fft_backend)
        self.fft_len = int(fft_len)
        self.use_db = use_db
        self.window = window
        self.hop = hop
        self.device = stage_device(device, "Channelizer")

    def step(self, block) -> torch.Tensor:
        return waterfall_spectra(as_cf32(block, device=self.device), self.fft_len,
                                 use_db=self.use_db, window=self.window, hop=self.hop)

    __call__ = step


def sharded_waterfall(samples, fft_len: int, mesh: Mesh, use_db: bool = False,
                      axis_name: str = CHANNEL_AXIS, fft_backend: Optional[str] = None) -> Sharded:
    """Waterfall with rows sharded across the mesh (no data crosses
    shards: pure scale-out). The capture's ``fft_len``-rows must split
    evenly over the mesh axis. Returns the rows as a
    :class:`~aether_primitives_tpu_torch.parallel.mesh.Sharded`."""
    check_backend(fft_backend)
    rows = _pad_rows(as_cf32(samples), fft_len)
    rs = shard(rows, mesh, (None,) * (rows.ndim - 2) + (axis_name, None))
    return rs.map(lambda r: _magnitude(fft_plan(fft_len).fwd(r, Scale.SN), use_db))


# ------------------------------------------------ critically sampled PFB


def pfb_prototype(n_chan: int, taps_per_branch: int = 8) -> np.ndarray:
    """Hamming-windowed-sinc prototype lowpass for a critically sampled
    ``n_chan``-channel PFB: ``P * n_chan`` real taps, cutoff at half the
    channel spacing (``1/(2*n_chan)`` cycles/sample), unit DC gain.

    ``taps_per_branch`` (``P``) trades skirt steepness against compute:
    P=1 degenerates to the rectangular window (== plain chunked FFT).
    """
    if taps_per_branch < 1:
        raise ValueError("taps_per_branch must be >= 1")
    ntaps = taps_per_branch * n_chan
    n = np.arange(ntaps) - (ntaps - 1) / 2.0
    c = 1.0 / (2.0 * n_chan)
    h = 2 * c * np.sinc(2 * c * n)
    h *= np.hamming(ntaps)
    return (h / h.sum()).astype(np.float32)


def _branches(taps, m: int) -> np.ndarray:
    """Complex64 prototype ``[P, M]`` branch view, zero-padded to whole
    branches."""
    h = np.asarray(taps, dtype=np.complex64).ravel()
    p = max(1, -(-h.shape[-1] // m))
    if h.shape[-1] < p * m:
        h = np.pad(h, (0, p * m - h.shape[-1]))
    return h.reshape(p, m)


def pfb_channelize(samples, n_chan: int, taps: Optional[np.ndarray] = None,
                   taps_per_branch: int = 8, scale: Scale = Scale.NONE,
                   fft_backend: Optional[str] = None, history=None) -> torch.Tensor:
    """Critically sampled polyphase analysis filterbank: ``[..., n]`` ->
    ``[..., T, n_chan]``, ``T = ceil(n / n_chan)`` (zero-padded to whole
    frames). With frames ``F[t, r] = x[t*M + r]``::

        u[t, r] = sum_p h[p*M + r] * F[t - p, r]      (zeros for t < p)
        y[t, c] = sum_r u[t, r] * e^{-2 pi i c r / M}

    ``taps``: explicit prototype (default :func:`pfb_prototype`);
    ``history``: ``[..., (P-1)*M]`` samples preceding the capture (zeros =
    cold start). The branch weighting is P slice products of the
    history-extended frame stack; no kernel runs here (the JAX package has
    none on this path either).
    """
    check_backend(fft_backend)
    x = as_cf32(samples)
    m = int(n_chan)
    if taps is None:
        taps = pfb_prototype(m, taps_per_branch)
    hb = _branches(taps, m)
    p = hb.shape[0]
    fr = _pad_rows(x, m)  # [..., T, M]
    t_frames = fr.shape[-2]
    batch = tuple(fr.shape[:-2])
    if p > 1:
        if history is None:
            h0 = torch.zeros(batch + (p - 1, m), dtype=fr.dtype, device=fr.device)
        else:
            h0 = as_cf32(history, device=fr.device)
            if h0.shape[-1] != (p - 1) * m:
                raise ValueError(f"history must have (P-1)*n_chan = {(p - 1) * m} samples")
            h0 = h0.expand(batch + ((p - 1) * m,)).reshape(batch + (p - 1, m))
        ext = torch.cat([h0, fr], dim=-2)  # [..., T+P-1, M]
    else:
        ext = fr
    hbt = _on(hb, fr)
    u = None
    for pi in range(p):
        start = p - 1 - pi  # frame t - pi lives at extended row (P-1-pi) + t
        term = ext[..., start:start + t_frames, :] * hbt[pi]
        u = term if u is None else u + term
    return fft_plan(m).fwd(u, scale)


def pfb_spectra(samples, n_chan: int, use_db: bool = False,
                taps: Optional[np.ndarray] = None,
                taps_per_branch: int = 8, fft_backend: Optional[str] = None) -> torch.Tensor:
    """PFB waterfall: :func:`pfb_channelize` with ``Scale.SN``, fftshift and
    magnitude (or amplitude dB), as :func:`waterfall_spectra`."""
    check_backend(fft_backend)
    spec = pfb_channelize(samples, n_chan, taps=taps, taps_per_branch=taps_per_branch,
                          scale=Scale.SN)
    return _magnitude(spec, use_db)


class PfbChannelizer:
    """Streaming critically sampled PFB stage on ``device``: carries the
    ``(P-1)*n_chan``-sample tail between blocks, so a capture fed block by
    block equals the one-shot :func:`pfb_channelize`."""

    def __init__(self, n_chan: int, taps: Optional[np.ndarray] = None,
                 taps_per_branch: int = 8, scale: Scale = Scale.NONE,
                 fft_backend: Optional[str] = None, device="cuda"):
        check_backend(fft_backend)
        self.n_chan = int(n_chan)
        self.taps = (
            np.asarray(taps, np.complex64).ravel()
            if taps is not None
            else pfb_prototype(self.n_chan, taps_per_branch).astype(np.complex64)
        )
        self.p = max(1, -(-self.taps.shape[-1] // self.n_chan))
        self.scale = scale
        self.device = stage_device(device, "PfbChannelizer")
        self._tail = None

    def step(self, block) -> torch.Tensor:
        """One block (length divisible by ``n_chan``) -> channel frames."""
        x = as_cf32(block, device=self.device)
        if x.shape[-1] % self.n_chan:
            raise ValueError("block length must be divisible by n_chan")
        out = pfb_channelize(x, self.n_chan, taps=self.taps, scale=self.scale,
                             history=self._tail)
        keep = (self.p - 1) * self.n_chan
        if keep:
            self._tail = x[..., -keep:].clone()
        return out

    __call__ = step


def sharded_pfb(samples, n_chan: int, mesh: Mesh, taps: Optional[np.ndarray] = None,
                taps_per_branch: int = 8, scale: Scale = Scale.NONE,
                axis_name: str = TIME_AXIS, fft_backend: Optional[str] = None) -> Sharded:
    """PFB with contiguous time spans sharded across the mesh: each shard
    takes its ``(P-1)*n_chan``-sample left halo through the halo exchange
    (:func:`~aether_primitives_tpu_torch.parallel.halo.left_tail`), so the
    gathered output equals :func:`pfb_channelize` bit for bit. Each shard's
    span must be divisible by ``n_chan``. Returns the frames as a
    :class:`~aether_primitives_tpu_torch.parallel.mesh.Sharded` ``[..., T,
    n_chan]`` split along ``T``."""
    check_backend(fft_backend)
    m = int(n_chan)
    if taps is None:
        taps = pfb_prototype(m, taps_per_branch)
    h = np.asarray(taps, dtype=np.complex64).ravel()
    p = max(1, -(-h.shape[-1] // m))
    xs = shard_last(samples, mesh, axis_name, dtype=torch.complex64)
    halo = left_tail(xs, (p - 1) * m, axis_name) if p > 1 else None
    return xs.map(lambda xl, hl: pfb_channelize(xl, m, taps=h, scale=scale, history=hl),
                  halo, spec=xs.spec + (None,))


def pfb_synthesis_taps(
    analysis_taps,
    n_chan: int,
    taps_per_branch: Optional[int] = None,
) -> np.ndarray:
    """Least-squares near-perfect-reconstruction synthesis prototype for
    :func:`pfb_synthesize`, given the analysis prototype.

    Per polyphase branch ``r`` the analysis/synthesis cascade is the frame-
    domain FIR convolution ``h_r ⊛ g_r`` (``h_r[p] = h[p*M + r]``); perfect
    reconstruction requires it to be a pure ``d``-frame delay for every
    branch. Each ``g_r`` is the length-``Q`` least-squares FIR inverse of
    ``h_r`` targeting the common delay ``d = (P + Q - 2) // 2`` (a delay
    scan confirms the midpoint is optimal) — solved in f64 at design time
    (``M`` independent ``[P+Q-1, Q]`` lstsq problems).

    Returns ``[Q * n_chan]`` taps (branch view ``g[p*M + r]``); the
    round-trip ``pfb_synthesize(pfb_channelize(x, h), g)`` reproduces ``x``
    delayed by ``d`` frames. Exactness is structurally bounded: a
    critically sampled DFT bank has exact FIR PR only for trivial (pure
    delay+gain) polyphase branches, and the default prototype's branches
    carry zeros near the unit circle (worst |z| ≈ 1.16), so the LS
    residual decays only geometrically in ``Q``. Default ``Q = 8 P``
    measures ≈ −35 dB RMS reconstruction for the default prototype
    (−25 dB at ``Q = 4 P``); push ``taps_per_branch`` higher for more.
    """
    h = np.asarray(analysis_taps).ravel()
    m = int(n_chan)
    p = max(1, -(-h.shape[-1] // m))
    if h.shape[-1] < p * m:
        h = np.pad(h, (0, p * m - h.shape[-1]))
    hb = h.reshape(p, m).astype(np.complex128)
    q = int(taps_per_branch) if taps_per_branch else 8 * p
    d = (p + q - 2) // 2
    gb = np.zeros((q, m), np.complex128)
    for r in range(m):
        c = np.zeros((p + q - 1, q), np.complex128)
        for i in range(q):
            c[i : i + p, i] = hb[:, r]
        e = np.zeros(p + q - 1, np.complex128)
        e[d] = 1.0
        gr, *_ = np.linalg.lstsq(c, e, rcond=None)
        gb[:, r] = gr
    g = gb.reshape(-1)
    if np.abs(g.imag).max() < 1e-12 * max(np.abs(g.real).max(), 1e-30):
        return g.real.astype(np.float32)
    return g.astype(np.complex64)


def _fold_branches(hb: np.ndarray, device, reverse: bool = False) -> torch.Tensor:
    """The branches ``[P, M]`` for the fold on ``device`` (reversed in
    ``p`` for the synthesis): one float32 plane for a real prototype, a
    complex64 tensor (two interleaved planes) for a complex one."""
    w = hb[::-1] if reverse else hb
    if not (np.abs(w.imag) > 0).any():
        w = w.real.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(w)).to(device)


def _slice_sum(v: torch.Tensor, gb: np.ndarray, s_len: int) -> torch.Tensor:
    """The synthesis overlap-add of frames ``v [..., T, M]`` with branches
    ``gb [Q, M]`` as the JAX package sums it: ``out[s] = sum_pi vp[s +
    Q-1-pi] * gb[pi]`` over ``vp = v`` padded by ``Q-1`` zero frames on each
    side, ``s < s_len``, in ``pi`` order."""
    q = gb.shape[0]
    vp = F.pad(v, (0, 0, q - 1, q - 1))
    gbt = _on(gb, v)
    acc = None
    for pi in range(q):
        term = vp[..., q - 1 - pi:q - 1 - pi + s_len, :] * gbt[pi]
        acc = term if acc is None else acc + term
    return acc


def pfb_synthesize(frames, n_chan: Optional[int] = None,
                   taps: Optional[np.ndarray] = None, scale: Scale = Scale.N,
                   fft_backend: Optional[str] = None, backend: str = "reference") -> torch.Tensor:
    """Critically sampled polyphase synthesis filterbank, the dual of
    :func:`pfb_channelize`: ``[..., T, n_chan]`` -> ``[..., (T + Q - 1) *
    n_chan]`` samples, by weighted overlap-add with the synthesis prototype
    ``g`` (branch view ``gb[p, r] = g[p*M + r]``)::

        v[t, r]         = backward DFT of y[t, :] at point r
        x[(t+p)*M + r] += gb[p, r] * v[t, r]        for p in [0, Q)

    ``scale=Scale.N`` makes the DFT pair the identity; ``Q = 1`` unit taps
    inverts the chunked FFT exactly. The trailing ``(Q-1)*M`` samples are
    the partial overlap-add tail.

    ``backend="reference"`` (the default, as the JAX package's) sums ``Q``
    slices of one padded tensor; ``backend="auto"`` runs the overlap-add
    as the fold kernel's synthesis layout at ``os = 1`` (reversed branches,
    real or complex) on a CUDA tensor, and its plain twin on a CPU tensor.
    """
    check_backend(fft_backend)
    _check_backend(backend)
    y = as_cf32(frames)
    m = int(n_chan) if n_chan is not None else y.shape[-1]
    if y.shape[-1] != m:
        raise ValueError(f"frames minor dim {y.shape[-1]} != n_chan {m}")
    if taps is None:
        taps = np.ones(m, np.float32)  # rectangle: inverse of chunked FFT
    gb = _branches(taps, m)
    q = gb.shape[0]
    v = fft_plan(m).bwd(y, scale)  # [..., T, M]
    t_frames = v.shape[-2]
    if q == 1:  # pure per-channel gain
        out = v * _on(gb[0], v)
        return out.reshape(out.shape[:-2] + (t_frames * m,))
    if backend == "auto":
        return _pf.pfb_synthesis(v, _fold_branches(gb, v.device, reverse=True), 1)
    s_len = t_frames + q - 1
    acc = _slice_sum(v, gb, s_len)
    return acc.reshape(acc.shape[:-2] + (s_len * m,))


class PfbSynthesizer:
    """Streaming synthesis stage on ``device``: carries the ``(Q-1)``-frame
    overlap-add tail between blocks, so block-by-block synthesis
    concatenates to the one-shot :func:`pfb_synthesize` output (minus the
    final tail, which :meth:`flush` returns)."""

    def __init__(self, n_chan: int, taps: Optional[np.ndarray] = None,
                 scale: Scale = Scale.N, fft_backend: Optional[str] = None, device="cuda"):
        check_backend(fft_backend)
        self.n_chan = int(n_chan)
        if taps is None:
            taps = np.ones(self.n_chan, np.float32)
        self.taps = np.asarray(taps, np.complex64).ravel()
        self.q = max(1, -(-self.taps.shape[-1] // self.n_chan))
        self.scale = scale
        self.device = stage_device(device, "PfbSynthesizer")
        self._tail = None  # [..., (Q-1)*M] partial overlap-add carry

    def step(self, frames) -> torch.Tensor:
        """``[..., T, n_chan]`` frames -> ``[..., T*n_chan]`` samples."""
        full = pfb_synthesize(as_cf32(frames, device=self.device), self.n_chan,
                              taps=self.taps, scale=self.scale)
        keep = (self.q - 1) * self.n_chan
        if not keep:
            return full
        body, tail = full[..., :-keep], full[..., -keep:]
        if body.shape[-1] < keep:
            raise ValueError(f"block must carry at least Q-1 = {self.q - 1} frames")
        if self._tail is not None:
            body = body + F.pad(self._tail, (0, body.shape[-1] - keep))
        self._tail = tail
        return body

    def flush(self) -> Optional[torch.Tensor]:
        """The final ``(Q-1)*n_chan`` overlap-add tail (None when Q == 1)."""
        t = self._tail
        self._tail = None
        return t

    __call__ = step


# --------------------------------------------------------------- STFT / iSTFT


def _stft_window(window, fft_len: int) -> np.ndarray:
    """PERIODIC windows (the COLA-correct kind; the symmetric variants in
    :func:`_resolve_window` match the reference's plotting conventions,
    these match reconstruction)."""
    if isinstance(window, str):
        n = np.arange(fft_len, dtype=np.float64)
        if window == "hann":
            w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / fft_len)
        elif window == "sqrt_hann":
            w = np.sqrt(0.5 - 0.5 * np.cos(2.0 * np.pi * n / fft_len))
        elif window == "rect":
            w = np.ones(fft_len)
        else:
            raise ValueError(f"unknown stft window {window!r}")
        return w.astype(np.float32)
    w = np.asarray(window, dtype=np.float32).ravel()
    if w.shape[-1] != fft_len:
        raise ValueError("window length must equal fft_len")
    return w


def _overlap_add_weights(w: np.ndarray, hop: int, t_frames: int, full: int) -> np.ndarray:
    """float64 ``[full]``: the sum over frames ``t < t_frames`` of ``w``
    placed at ``t*hop`` (``len(w)`` a multiple of ``hop``), accumulated
    one hop-sized chunk of ``w`` at a time."""
    chunks = w.reshape(-1, hop)
    d = np.zeros((full // hop, hop), np.float64)
    for c in range(chunks.shape[0]):
        d[c:c + t_frames] += chunks[c]
    return d.reshape(-1)


def stft(x, fft_len: int, hop: Optional[int] = None, window="sqrt_hann",
         scale: Scale = Scale.SN, fft_backend: Optional[str] = None) -> torch.Tensor:
    """Short-time Fourier transform: ``[..., n]`` -> ``[..., T, fft_len]``
    spectra of windowed frames starting at ``t*hop`` (default ``fft_len //
    2``, dividing ``fft_len``), with ``fft_len - hop`` boundary zeros on
    each side so every real sample gets the full overlap-add weight. With
    the default periodic ``sqrt_hann`` at 50% overlap, :func:`istft`
    reconstructs exactly."""
    check_backend(fft_backend)
    fft_len = int(fft_len)
    hop = fft_len // 2 if hop is None else int(hop)
    w = _stft_window(window, fft_len)
    xc = as_cf32(x)
    lead = fft_len - hop
    xc = F.pad(xc, (lead, lead))
    frames = _frames_overlapped(xc, fft_len, hop) * _on(w, xc)
    return fft_plan(fft_len).fwd(frames, scale)


def istft(frames, hop: Optional[int] = None, window="sqrt_hann",
          scale: Scale = Scale.SN, fft_backend: Optional[str] = None,
          length: Optional[int] = None) -> torch.Tensor:
    """Inverse STFT: ``[..., T, fft_len]`` -> ``[..., n]`` by windowed
    overlap-add, divided by the exact per-sample ``sum_t w^2(n - t*hop)``
    (so the edges reconstruct too). ``scale`` must match the analysis call;
    ``length`` trims the output (default the full span less :func:`stft`'s
    boundary padding)."""
    check_backend(fft_backend)
    y = as_cf32(frames)
    fft_len = int(y.shape[-1])
    hop = fft_len // 2 if hop is None else int(hop)
    q, rem = divmod(fft_len, hop)
    if rem:
        raise ValueError(f"fft_len {fft_len} must be a multiple of hop {hop}")
    w = _stft_window(window, fft_len)
    v = fft_plan(fft_len).bwd(y, scale) * _on(w, y)
    t_frames = int(v.shape[-2])
    full = (t_frames - 1) * hop + fft_len
    denom = _overlap_add_weights(w.astype(np.float64) ** 2, hop, t_frames, full)
    lead = fft_len - hop
    core = denom[lead:full - lead if lead else full]
    if core.size and core.min() <= 1e-10 * max(denom.max(), 1e-30):
        raise ValueError("window/hop violate NOLA: zero overlap-add weight")
    denom = np.where(denom <= 1e-10 * max(denom.max(), 1e-30), 1.0, denom)
    # overlap-add: slab view [.., T, q, hop]; out slab s = sum_j vs[s-j, j]
    vs = v.reshape(v.shape[:-1] + (q, hop))
    n_slabs = t_frames + q - 1
    vp = F.pad(vs, (0, 0, 0, 0, q - 1, q - 1))
    acc = None
    for j in range(q):
        term = vp[..., q - 1 - j:q - 1 - j + n_slabs, j, :]
        acc = term if acc is None else acc + term
    out = acc.reshape(acc.shape[:-2] + (n_slabs * hop,))
    out = _div_real(out, _on(denom.astype(np.float32), out))
    out = out[..., lead:]
    if length is not None:
        out = out[..., :int(length)]
    return out


# ------------------------------------------------------- oversampled PFB


def pfb_prototype_nyquist(
    n_chan: int, taps_per_branch: int = 16, beta: float = 0.5
) -> np.ndarray:
    """Root-Nyquist (square-root raised-cosine) prototype for the
    OVERSAMPLED filterbank — the power-complementary kind the matched
    analysis/synthesis cascade needs: ``sum_k |H(f - k/M)|^2`` is flat by
    the Nyquist criterion on ``|H|^2``, so :func:`pfb_synthesize_os` with
    the same prototype reconstructs to the truncation floor.

    Returns the FULL symmetric ``2*taps_per_branch*n_chan + 1`` tap vector
    — ``taps_per_branch`` SYMBOLS EACH SIDE (the :func:`~.fir.rrc_taps`
    convention), i.e. ``2*taps_per_branch + 1`` polyphase branches
    (odd length — do NOT trim it to a branch multiple: dropping the last
    tap of the symmetric filter half-sample-shifts the autocorrelation and
    destroys complementarity, measured -8 dB vs -76 dB roundtrip). The
    filterbank zero-pads to whole branches itself.

    The critically sampled default (:func:`pfb_prototype`, windowed sinc)
    deliberately is NOT power-complementary — it optimizes channel
    isolation instead; with ``os = 1`` reconstruction is structurally
    limited anyway (see :func:`pfb_synthesis_taps`).
    """
    from ..ops.fir import rrc_taps

    return np.asarray(
        rrc_taps(int(n_chan), span=int(taps_per_branch), beta=float(beta))
    ).real.astype(np.float32)


def _check_os(m: int, os: int) -> int:
    os = int(os)
    if os < 1 or m % os:
        raise ValueError(f"os must divide n_chan ({m} % {os})")
    return os


def _channelize_os(head: torch.Tensor, body: Optional[torch.Tensor], m: int, os: int,
                   w: torch.Tensor, scale: Scale, backend: str,
                   t_frames: Optional[int] = None) -> torch.Tensor:
    """:func:`pfb_channelize_os` on the samples ``head`` then ``body`` (or
    None) with the fold branches ``w`` (:func:`_fold_branches`) on their
    device: ``t_frames`` frames (default: those whose window fits the
    samples zero-padded to a whole class group), one fold and one FFT."""
    if t_frames is None:
        p = w.shape[0]
        n = head.shape[-1] + (0 if body is None else body.shape[-1])
        t_frames = max(n - p * m + m // os - 1, 0) // (m // os) + 1 if n >= p * m else 1
    fold = _pf.pfb_analysis if backend == "auto" else _pf.pfb_analysis_reference
    return fft_plan(m).fwd(fold(head, body, w, os, t_frames), scale)


def pfb_channelize_os(samples, n_chan: int, os: int = 2,
                      taps: Optional[np.ndarray] = None, taps_per_branch: int = 16,
                      scale: Scale = Scale.NONE, fft_backend: Optional[str] = None,
                      backend: str = "auto") -> torch.Tensor:
    """OVERSAMPLED polyphase analysis filterbank: channel frames advance by
    ``hop = n_chan/os`` samples, ``[..., n]`` -> ``[..., T, n_chan]`` with
    ``y[t, k] = sum_m h[m] x[t*hop + m] e^{-2 pi i k (t*hop + m)/M}``: each
    channel filtered by the prototype shifted to bin ``k`` and brought to
    baseband with an absolute time reference, one frame per ``hop``.
    ``T`` counts the frames whose window fits the capture zero-padded to a
    whole class group (one frame when ``n < P*M``).

    The bank is ``os`` interleaved critically sampled banks: class ``j``
    (frames ``t = i*os + j``) is the ``M``-stride fold of ``x[j*hop:]``,
    rolled by the constant ``(j*hop) mod M``. That fold is the kernel's
    work (``backend="auto"`` on a CUDA tensor: one launch for all classes
    and batch rows, real or complex prototypes, frames written in frame
    order); the channel DFT is ``torch.fft``. Default prototype:
    :func:`pfb_prototype_nyquist` (``2*taps_per_branch + 1`` branches).
    """
    check_backend(fft_backend)
    _check_backend(backend)
    x = as_cf32(samples)
    m = int(n_chan)
    os = _check_os(m, os)
    if taps is None:
        taps = pfb_prototype_nyquist(m, taps_per_branch)
    w = _fold_branches(_branches(taps, m), x.device)
    return _channelize_os(x, None, m, os, w, scale, backend)


def _synthesize_os(y: torch.Tensor, m: int, os: int, hb: np.ndarray, w_rev: torch.Tensor,
                   scale: Scale, length: Optional[int], normalize: bool,
                   backend: str) -> torch.Tensor:
    """:func:`pfb_synthesize_os` with the branches resolved (``w_rev``: the
    fold branches reversed in ``p``, on ``y``'s device): the backward FFT,
    then the raw overlap-add of all classes, each spread as a critically
    sampled stream at its hop offset ``j*hop`` (one fold launch)."""
    hop = m // os
    t_frames = int(y.shape[-2])
    w = fft_plan(m).bwd(y, scale)  # [..., T, M]
    spread = _pf.pfb_synthesis if backend == "auto" else _pf.pfb_synthesis_reference
    out = spread(w, w_rev, os)
    if normalize:
        # exact normalization: the overlap-add of |h|^2 for the actual frames
        hg = np.abs(hb.reshape(-1).astype(np.complex128)) ** 2
        denom = _overlap_add_weights(hg, hop, t_frames, out.shape[-1])
        denom = np.where(denom <= 1e-10 * max(denom.max(), 1e-30), 1.0, denom)
        out = _div_real(out, _on(denom.astype(np.float32), out))
    if length is not None:
        out = out[..., :int(length)]
    return out


def pfb_synthesize_os(frames, n_chan: Optional[int] = None, os: int = 2,
                      taps: Optional[np.ndarray] = None, taps_per_branch: int = 16,
                      scale: Scale = Scale.N, fft_backend: Optional[str] = None,
                      length: Optional[int] = None, normalize: bool = True,
                      backend: str = "auto") -> torch.Tensor:
    """Matched weighted-overlap-add inverse of :func:`pfb_channelize_os`:
    ``[..., T, n_chan]`` -> samples (the full ``(T-1)*hop + P*M`` span,
    or ``length``).

    The synthesis prototype is the analysis one; each class's spread is the
    analysis fold with the branch order reversed at ``os = 1``, placed at
    its hop offset; ``backend="auto"`` on a CUDA tensor launches the fold
    kernel once for all classes (real or complex prototypes).
    ``normalize`` divides by the exact overlap-add of ``|h|^2`` for the
    actual frame count; ``normalize=False`` returns the
    raw overlap-add (the streaming stage divides by the periodic interior
    divisor instead). ``scale`` pairs with the analysis call (defaults:
    ``Scale.NONE`` forward, ``Scale.N`` backward).
    """
    check_backend(fft_backend)
    _check_backend(backend)
    y = as_cf32(frames)
    m = int(n_chan) if n_chan is not None else int(y.shape[-1])
    if y.shape[-1] != m:
        raise ValueError(f"frames minor dim {y.shape[-1]} != n_chan {m}")
    os = _check_os(m, os)
    if taps is None:
        taps = pfb_prototype_nyquist(m, taps_per_branch)
    hb = _branches(taps, m)
    w_rev = _fold_branches(hb, y.device, reverse=True)
    return _synthesize_os(y, m, os, hb, w_rev, scale, length, normalize, backend)


class PfbChannelizerOs:
    """Streaming oversampled-PFB analysis stage on ``device``: carries the
    ``P*M - hop``-sample tail between blocks and emits only frames whose
    window fits, in whole groups of ``os`` frames, so block-by-block output
    equals the one-shot :func:`pfb_channelize_os` frame for frame. One fold
    launch per step on a CUDA device: the kernel reads the carried tail and
    the new block as they lie, and the next tail is a copy of the block's
    last samples."""

    def __init__(self, n_chan: int, os: int = 2, taps: Optional[np.ndarray] = None,
                 taps_per_branch: int = 16, scale: Scale = Scale.NONE,
                 fft_backend: Optional[str] = None, device="cuda", backend: str = "auto"):
        check_backend(fft_backend)
        _check_backend(backend)
        self.n_chan = int(n_chan)
        self.os = _check_os(self.n_chan, os)
        self.hop = self.n_chan // self.os
        self.taps = (
            np.asarray(taps).ravel()
            if taps is not None
            else pfb_prototype_nyquist(self.n_chan, taps_per_branch)
        )
        self.p = max(1, -(-self.taps.shape[-1] // self.n_chan))
        self.scale = scale
        self.backend = backend
        self.device = stage_device(device, "PfbChannelizerOs")
        self._w = _fold_branches(_branches(self.taps, self.n_chan), self.device)
        self._tail = None

    def step(self, block) -> torch.Tensor:
        x = as_cf32(block, device=self.device)
        head, body = (x, None) if self._tail is None else (self._tail, x)
        n_head = int(head.shape[-1])
        n = n_head + (0 if body is None else int(body.shape[-1]))
        pm = self.p * self.n_chan
        t1 = (n - pm) // self.hop + 1 if n >= pm else 0
        t1 -= t1 % self.os
        if t1 <= 0:
            raise ValueError(
                f"block too short: need >= {pm + (self.os - 1) * self.hop} "
                f"buffered samples for one os-aligned frame group, have {n}"
            )
        y = _channelize_os(head, body, self.n_chan, self.os, self._w, self.scale,
                           self.backend, t_frames=t1)
        cut = t1 * self.hop  # the next tail: samples [cut, n)
        if body is None:
            self._tail = head[..., cut:].clone()
        elif cut >= n_head:
            self._tail = body[..., cut - n_head:].clone()
        else:
            self._tail = torch.cat([head[..., cut:], body], dim=-1)
        return y

    __call__ = step


def sharded_pfb_os(samples, n_chan: int, mesh: Mesh, os: int = 2,
                   taps: Optional[np.ndarray] = None, taps_per_branch: int = 16,
                   scale: Scale = Scale.NONE, axis_name: str = TIME_AXIS,
                   fft_backend: Optional[str] = None, backend: str = "auto") -> Sharded:
    """Oversampled PFB with contiguous time spans sharded over the mesh:
    frames are FORWARD-looking, so each shard takes a ``P*M - hop`` RIGHT
    halo (:func:`~aether_primitives_tpu_torch.parallel.halo.right_head`,
    the dual of the causal chains' left halo) and emits the ``span/hop``
    frames that start inside its span: one fold launch per shard on CUDA
    shards. The gathered frames equal :func:`pfb_channelize_os` frame for
    frame (the last shard's zero halo reproduces the one-shot's zero-padded
    tail). Each shard's span must be divisible by ``n_chan`` so the ``os``
    reference-phase classes align per shard. The kernel reads a shard and
    its halo as two sources.
    """
    check_backend(fft_backend)
    _check_backend(backend)
    m = int(n_chan)
    os = _check_os(m, os)
    hop = m // os
    if taps is None:
        taps = pfb_prototype_nyquist(m, taps_per_branch)
    h = np.asarray(taps).ravel()
    p = max(1, -(-h.shape[-1] // m))
    overlap = p * m - hop
    xs = shard_last(samples, mesh, axis_name, dtype=torch.complex64)
    span = xs.shards.flat[0].shape[-1]
    if span % m:
        raise ValueError("per-device span must be divisible by n_chan")
    if span < overlap:
        raise ValueError(
            f"per-device span {span} < halo P*M - hop = {overlap}: the "
            "right halo only reaches ONE neighbor (like the causal "
            "chains' left halo) — use fewer shards or a longer capture"
        )
    halo = right_head(xs, overlap, axis_name)
    hb = _branches(h, m)
    # ext = span + P*M - hop samples -> exactly span/hop full frames
    return xs.map(lambda xl, hl: _channelize_os(xl, hl, m, os, _fold_branches(hb, xl.device),
                                                scale, backend),
                  halo, spec=xs.spec + (None,))


class PfbSynthesizerOs:
    """Streaming oversampled-PFB synthesis stage on ``device``: the raw
    weighted overlap-add of each block, the ``P*M - hop`` output tail
    carried into the next block, and division by the periodic interior
    divisor at emission, so block-by-block output equals the one-shot
    interior (the one-shot's edge-aware normalization differs only inside
    the first and last ``P*M`` samples). One fold launch per step on a CUDA
    device, which also adds the tail and divides."""

    def __init__(self, n_chan: int, os: int = 2, taps: Optional[np.ndarray] = None,
                 taps_per_branch: int = 16, scale: Scale = Scale.N,
                 fft_backend: Optional[str] = None, device="cuda", backend: str = "auto"):
        check_backend(fft_backend)
        _check_backend(backend)
        self.n_chan = int(n_chan)
        self.os = _check_os(self.n_chan, os)
        self.hop = self.n_chan // self.os
        self.taps = (
            np.asarray(taps).ravel()
            if taps is not None
            else pfb_prototype_nyquist(self.n_chan, taps_per_branch)
        )
        self.p = max(1, -(-self.taps.shape[-1] // self.n_chan))
        self.scale = scale
        self.backend = backend
        self.device = stage_device(device, "PfbSynthesizerOs")
        self._hb = _branches(self.taps, self.n_chan)
        self._w_rev = _fold_branches(self._hb, self.device, reverse=True)
        # periodic interior divisor: full-overlap sum of |h|^2 hop-tiles
        pm = self.p * self.n_chan
        h = np.asarray(self.taps, np.complex128).ravel()
        h = np.pad(h, (0, pm - h.shape[-1]))
        hg = np.abs(h) ** 2
        dper = np.zeros(self.hop, np.float64)
        for t in range(pm // self.hop):
            dper += hg[t * self.hop : (t + 1) * self.hop]
        self._dper = dper.astype(np.float32)
        self._dper_dev = torch.from_numpy(self._dper).to(self.device)
        self._tail = None

    def _normalize(self, raw: torch.Tensor) -> torch.Tensor:
        """``raw [..., n]`` divided by the periodic divisor (``n`` a
        multiple of ``hop``)."""
        n = raw.shape[-1]
        shape = raw.shape[:-1] + (n // self.hop, self.hop)
        return _div_real(raw.reshape(shape), self._dper_dev).reshape(raw.shape)

    def step(self, frames) -> torch.Tensor:
        y = as_cf32(frames, device=self.device)
        t = int(y.shape[-2])
        if t % self.os:
            raise ValueError(f"frame count {t} must be a multiple of os={self.os}")
        v = fft_plan(self.n_chan).bwd(y, self.scale)  # [..., T, M]
        # the raw overlap-add (t*hop + P*M - hop samples), the carried tail
        # added, the first t*hop divided by the periodic divisor: one launch
        spread = _pf.pfb_synthesis if self.backend == "auto" else _pf.pfb_synthesis_reference
        out, self._tail = spread(v, self._w_rev, self.os, self._tail, self._dper_dev,
                                 t * self.hop)
        return out

    def flush(self) -> torch.Tensor:
        """Remaining partial overlap-add tail (periodically normalized)."""
        if self._tail is None:
            return torch.zeros(0, dtype=torch.complex64, device=self.device)
        n = int(self._tail.shape[-1])
        reps = -(-n // self.hop)
        pad = F.pad(self._tail, (0, reps * self.hop - n))
        out = self._normalize(pad)[..., :n]
        self._tail = None
        return out

    __call__ = step
