"""The polyphase filterbank fold: the weighted overlap-add of the
oversampled PFB analysis (:func:`~aether_primitives_tpu_torch.models.
channelizer.pfb_channelize_os`) and of the synthesis
(``pfb_synthesize_os``, and ``pfb_synthesize`` when asked for).

Port of the TPU kernel ``aether_primitives_tpu/ops/pallas/pfb_fold.py``
(``_fold_kernel``, wrapper ``pfb_fold_os``), one hand-written kernel
(``csrc/pfb_fold.cu``) in three layouts, each with a plain PyTorch twin:

- :func:`pfb_analysis` (twin :func:`pfb_analysis_reference`): complex64
  samples from two sources, a head and a body (sample ``s`` is
  ``head[..., s]`` for ``s < n_head``, else ``body[..., s - n_head]``, zero
  past the end), folded into frames ``[..., t_frames, M]`` in frame order.
  For class ``j`` of ``os`` (``hop = M / os``), class frame ``i`` and
  column ``c``, frame ``t = i*os + j`` is::

      acc[i, r] = sum_p hb[p, r] * x[..., j*hop + (i + p)*M + r]   (p in order)
      out[..., t, c] = acc[i, (c - j*hop) % M]                      (the roll)

- :func:`pfb_synthesis` (twin :func:`pfb_synthesis_reference`, the
  composition of :func:`pfb_fold_os_reference`, roll, pad and add that the
  channelizer ran before): frames ``[..., T, M]`` to the raw overlap-add
  ``[..., (ceil(T/os) + P - 1)*M + (os - 1)*hop]``, with the branches
  reversed in ``p`` (one launch for all classes);
- :func:`pfb_fold_os` (twin :func:`pfb_fold_os_reference`): the TPU
  wrapper's counterpart on split float32 planes, ``[..., os, t_cls, M]``
  planes out, real branches.

Branches are a ``[P, M]`` tensor: float32 for a real prototype, complex64
for a complex one (the kernel's second tap plane). Every product and sum is
rounded on its own in ``p`` order in kernel and twin (a complex term is
``xr*hr - xi*hi``, ``xr*hi + xi*hr``), so the two are bit-identical.

Each wrapper launches the kernel for a CUDA tensor (built at first use, see
:mod:`.build`) or raises; for a CPU tensor it runs the twin. The input need
not be padded: reads past the end are zeros and the kernel masks the ragged
frame and column edges. A leading batch axis is taken natively (one launch
for all rows). :data:`launches` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import build

#: Launches of the CUDA kernel in this process (the plain versions and
#: calls that raise do not count).
launches = 0

MAX_SMEM = 232_448  # bytes of shared memory one block may use on an H100
STRIP = 64  # columns a block (csrc/pfb_fold.cu)
#: Frames (synthesis: output rows) a tile (csrc/pfb_fold.cu: 8 thread rows
#: x 16 analysis frames; 4 thread rows x 11 synthesis rows)
TILE = {"analysis": 128, "planes": 128, "synthesis": 44}
#: Branches a chunk of weights where every class's do not fit (4 x 16, or
#: 4 x 11 synthesis)
CHUNK = {"analysis": 64, "planes": 64, "synthesis": 44}
MODES = {"analysis": 0, "synthesis": 1, "planes": 2}
MAX_GRID_YZ = 65_535


def launch_plan(mode: str, p: int, os: int, complex_taps: bool = False, tile: int = 0):
    """``(stages, weights_staged)``: how the kernel runs layout ``mode``
    with ``P = p`` branches, as ``csrc/pfb_fold.cu`` chooses. The strip's
    ``os x P x 64`` weights are staged in shared memory once where they fit
    beside one slab of ``(tile + P) x 64`` complex64 samples (else one
    class's :data:`CHUNK` branches at a time), and the ring holds two slabs
    where two fit beside them (else one); ``(0, False)`` where not even one
    slab fits beside a chunk. ``tile`` overrides the layout's
    :data:`TILE`."""
    slab = ((tile or TILE[mode]) + p) * STRIP * 8
    size = 8 if complex_taps else 4
    weights = os * p * STRIP * size
    staged = slab + weights <= MAX_SMEM
    weights = weights if staged else CHUNK[mode] * STRIP * size
    if slab + weights > MAX_SMEM:
        return 0, False
    return (2 if 2 * slab + weights <= MAX_SMEM else 1), staged


def kernel_supports(m: int, p: int, os: int, batch: int = 1, mode: str = "planes",
                    complex_taps: bool = False) -> bool:
    """True when the CUDA kernel takes ``batch`` rows of an ``os``-class
    fold in layout ``mode`` with ``M = m`` columns and ``P = p`` branches:
    one slab of ``(tile + P) x 64`` complex64 samples fits in shared memory
    beside the weights or a chunk of them (``P <= 294`` real and ``262``
    complex taps for analysis and planes, ``388`` and ``366`` synthesis, at
    any ``os``; :func:`launch_plan`), and the grid fits its limits (at most
    65,535 rows and 65,535 strips of 64 columns)."""
    return (p >= 1 and m >= 1 and os >= 1 and m % os == 0
            and launch_plan(mode, p, os, complex_taps)[0] > 0
            and -(-m // STRIP) <= MAX_GRID_YZ and batch <= MAX_GRID_YZ)


def _branches(w, os: int, what: str):
    """Validate the branches ``[P, M]``; returns ``(p, m, hop)``."""
    if not isinstance(w, torch.Tensor):
        raise TypeError(f"{what} takes torch tensors (branches)")
    if w.dtype not in (torch.float32, torch.complex64):
        raise TypeError(f"{what} takes float32 or complex64 branches, got {w.dtype}")
    if w.ndim != 2:
        raise ValueError(f"branches must be [P, M], got {tuple(w.shape)}")
    p, m = w.shape
    os = int(os)
    if os < 1 or m % os:
        raise ValueError(f"os must divide M ({m} % {os})")
    return p, m, m // os


def _planes(w):
    """``(re, im)`` float32 planes of the branches (``im`` None when real)."""
    if w.is_complex():
        return w.real.contiguous(), w.imag.contiguous()
    return w, None


def _check_args(x_re, x_im, hb, os: int, t_cls: int):
    """Validate :func:`pfb_fold_os`'s arguments; returns ``(p, m, hop)``."""
    for name, t in (("x_re", x_re), ("x_im", x_im), ("hb", hb)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"pfb_fold_os takes torch tensors ({name})")
        if t.dtype != torch.float32:
            raise TypeError(f"pfb_fold_os takes float32 planes, got {name} {t.dtype}")
    if x_re.shape != x_im.shape or x_re.ndim < 1:
        raise ValueError(f"x_re {tuple(x_re.shape)} and x_im {tuple(x_im.shape)} "
                         "must be equal shapes [..., n]")
    if hb.ndim != 2:
        raise ValueError(f"hb must be [P, M], got {tuple(hb.shape)}")
    p, m, hop = _branches(hb, os, "pfb_fold_os")
    if int(t_cls) < 1:
        raise ValueError(f"t_cls must be >= 1, got {t_cls}")
    need = (int(os) - 1) * hop + (int(t_cls) - 1 + p) * m
    if x_re.shape[-1] < need:
        raise ValueError(f"input too short: {x_re.shape[-1]} < {need} samples "
                         f"((os-1)*hop + (t_cls-1+P)*M)")
    return p, m, hop


def pfb_fold_os_reference(x_re, x_im, hb, os: int, t_cls: int, hb_im=None):
    """Plain PyTorch version of :func:`pfb_fold_os` (same arguments, same
    output), on any device: per class, ``P`` slice products of the
    ``[t_cls - 1 + P, M]`` frame view added in ``p`` order, then the roll.
    With ``hb_im`` (float32 ``[P, M]``) the branches are complex, ``hb +
    1j*hb_im``, and a term is ``(xr*hr - xi*hi, xr*hi + xi*hr)``."""
    p, m, hop = _check_args(x_re, x_im, hb, os, t_cls)
    if hb_im is not None and (hb_im.shape != hb.shape or hb_im.dtype != torch.float32):
        raise ValueError("hb_im must be float32 of hb's shape")
    t_cls = int(t_cls)
    batch = tuple(x_re.shape[:-1])
    span = (t_cls - 1 + p) * m
    views = [[pl[..., j * hop:j * hop + span].reshape(batch + (t_cls - 1 + p, m))
              for j in range(int(os))] for pl in (x_re, x_im)]
    outs = ([], [])
    for j in range(int(os)):
        fr, fi = views[0][j], views[1][j]
        acc_r = acc_i = None
        for q in range(p):
            xr, xi = fr[..., q:q + t_cls, :], fi[..., q:q + t_cls, :]
            if hb_im is None:
                tr, ti = xr * hb[q], xi * hb[q]
            else:
                tr = xr * hb[q] - xi * hb_im[q]
                ti = xr * hb_im[q] + xi * hb[q]
            acc_r = tr if acc_r is None else acc_r + tr
            acc_i = ti if acc_i is None else acc_i + ti
        a = (j * hop) % m
        for out, acc in zip(outs, (acc_r, acc_i)):
            out.append(torch.roll(acc, a, dims=-1) if a else acc)
    return torch.stack(outs[0], dim=-3), torch.stack(outs[1], dim=-3)


def _complex_fold(x, w, os: int, t_cls: int):
    """The twin's fold of complex ``x [..., n]`` -> complex ``[..., os,
    t_cls, M]`` (on the planes, as the kernel)."""
    w_re, w_im = _planes(w)
    o_r, o_i = pfb_fold_os_reference(x.real.contiguous(), x.imag.contiguous(), w_re, os,
                                     t_cls, w_im)
    return torch.complex(o_r, o_i)


def _check_analysis(head, body, w, os: int, t_frames: int):
    p, m, hop = _branches(w, os, "pfb_analysis")
    for name, t in (("head", head), ("body", body)):
        if t is None and name == "body":
            continue
        if not isinstance(t, torch.Tensor) or t.dtype != torch.complex64 or t.ndim < 1:
            raise TypeError(f"pfb_analysis takes a complex64 tensor [..., n] ({name})")
    if body is not None and body.shape[:-1] != head.shape[:-1]:
        raise ValueError(f"head {tuple(head.shape)} and body {tuple(body.shape)} "
                         "must share their leading axes")
    if int(t_frames) < 1:
        raise ValueError(f"t_frames must be >= 1, got {t_frames}")
    return p, m, hop


def pfb_analysis_reference(head, body, w, os: int, t_frames: int):
    """Plain PyTorch version of :func:`pfb_analysis` (same arguments, same
    output), on any device: the concatenation of head and body, zero-padded
    to the span of ``ceil(t_frames / os)`` class frames, folded by
    :func:`pfb_fold_os_reference` on its planes and interleaved into frame
    order."""
    p, m, hop = _check_analysis(head, body, w, os, t_frames)
    os, t_frames = int(os), int(t_frames)
    t_cls = -(-t_frames // os)
    need = (os - 1) * hop + (t_cls - 1 + p) * m
    x = head if body is None else torch.cat([head, body], dim=-1)
    x = x[..., :need]
    if x.shape[-1] < need:
        x = F.pad(x, (0, need - x.shape[-1]))
    u = _complex_fold(x, w.to(x.device), os, t_cls)  # [..., os, t_cls, M]
    batch = tuple(x.shape[:-1])
    return u.transpose(-3, -2).reshape(batch + (t_cls * os, m))[..., :t_frames, :]


def synthesis_length(t_frames: int, m: int, p: int, os: int) -> int:
    """Samples of the raw overlap-add of ``t_frames`` frames:
    ``(ceil(T/os) + P - 1)*M + (os - 1)*hop``."""
    return (-(-int(t_frames) // os) + p - 1) * m + (os - 1) * (m // os)


def _check_synthesis(frames, w_rev, os: int):
    p, m, hop = _branches(w_rev, os, "pfb_synthesis")
    if (not isinstance(frames, torch.Tensor) or frames.dtype != torch.complex64
            or frames.ndim < 2 or frames.shape[-1] != m or frames.shape[-2] < 1):
        raise ValueError(f"pfb_synthesis takes complex64 frames [..., T >= 1, {m}]")
    return p, m, hop


def pfb_synthesis_reference(frames, w_rev, os: int, tail=None, divisor=None, emit=None):
    """Plain PyTorch version of :func:`pfb_synthesis` (same arguments, same
    output), on any device: per class ``j``, its frames ``i*os + j`` rolled
    by ``-(j*hop) mod M``, padded by ``P - 1`` zero frames on each side,
    folded at ``os = 1`` with the reversed branches, placed at the hop
    offset ``j*hop`` and summed in ``j`` order; then the streaming stage's
    epilogue: ``tail`` added to the first samples, the first ``emit``
    samples divided plane by plane by ``divisor[u mod hop]``."""
    p, m, hop = _check_synthesis(frames, w_rev, os)
    _check_epilogue(frames, hop, synthesis_length(frames.shape[-2], m, p, int(os)),
                    tail, divisor, emit)
    raw = _overlap_add(frames, w_rev, os, p, m, hop)
    if tail is not None:
        raw[..., :tail.shape[-1]] += tail
    if emit is None:
        return raw
    out = raw[..., :int(emit)]
    if divisor is not None:
        shape = out.shape[:-1] + (out.shape[-1] // hop, hop)
        d = divisor.to(out.device)
        out = torch.complex(out.real.reshape(shape) / d, out.imag.reshape(shape) / d)
        out = out.reshape(raw.shape[:-1] + (int(emit),))
    return out.contiguous(), raw[..., int(emit):].contiguous()


def _check_epilogue(frames, hop: int, length: int, tail, divisor, emit):
    batch = tuple(frames.shape[:-2])
    if tail is not None and (not isinstance(tail, torch.Tensor) or tail.dtype != torch.complex64
                             or tuple(tail.shape[:-1]) != batch
                             or tail.shape[-1] > length):
        raise ValueError(f"tail must be complex64 [{batch}, <= {length}]")
    if emit is not None and not 0 <= int(emit) <= length:
        raise ValueError(f"emit must lie in [0, {length}], got {emit}")
    if divisor is not None and (emit is None or int(emit) % hop
                                or divisor.dtype != torch.float32
                                or tuple(divisor.shape) != (hop,)):
        raise ValueError(f"divisor must be float32 [{hop}], with emit a multiple of {hop}")


def _overlap_add(frames, w_rev, os: int, p: int, m: int, hop: int):
    """The twin's raw overlap-add (the composition the module docstring
    names)."""
    os = int(os)
    t_frames = int(frames.shape[-2])
    batch = tuple(frames.shape[:-2])
    t_cls = -(-t_frames // os)
    v = F.pad(frames, (0, 0, 0, t_cls * os - t_frames)) if t_cls * os > t_frames else frames
    wg = v.reshape(batch + (t_cls, os, m))
    m_slabs = t_cls + p - 1  # M-slabs a class stream
    n_slabs = m_slabs * os + (os - 1)  # hop-slabs of the combined output
    w_rev = w_rev.to(frames.device)
    acc = None
    for j in range(os):
        wj = wg[..., j, :]
        a = (j * hop) % m  # undo the class's constant reference roll
        if a:
            wj = torch.roll(wj, -a, dims=-1)
        vp = F.pad(wj, (0, 0, p - 1, p - 1))
        oj = _complex_fold(vp.reshape(batch + (-1,)), w_rev, 1, m_slabs)[..., 0, :, :]
        oh = F.pad(oj.reshape(batch + (m_slabs * os, hop)),
                   (0, 0, j, n_slabs - m_slabs * os - j))
        acc = oh if acc is None else acc + oh
    return acc.reshape(batch + (n_slabs * hop,))


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.load("pfb_fold").pfb_fold_launch
    fn.argtypes = ([ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
                   + [ctypes.c_longlong] * 4
                   + [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 6
                   + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong]
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _rows(t: torch.Tensor, name: str):
    """``(rows, stride)`` of ``t [..., n]`` read as rows of ``n`` samples
    ``stride`` elements apart; raises where the rows are not contiguous or
    the leading axes do not merge."""
    n = t.shape[-1]
    if t.ndim > 1:
        try:
            t = t.view(-1, n)
        except RuntimeError:
            raise ValueError(f"{name}: the leading axes must merge into one row stride") from None
    rows = t.shape[0] if t.ndim > 1 else 1
    if n > 1 and t.stride(-1) != 1:
        raise ValueError(f"{name}: rows must be contiguous")
    return rows, (t.stride(0) if t.ndim > 1 and rows > 1 else n)


def _launch(mode: str, complex_taps: bool, src0, src1, n0, n1, s0, s1, w, out0, out1,
            out_len, rows, m, p, os, t_in, t_out, dev, tail=None, divisor=None, emit=0):
    global launches
    if not kernel_supports(m, p, os, rows, mode, complex_taps):
        raise ValueError(
            f"the CUDA PFB fold kernel ({mode}) does not take M={m}, P={p}, os={os}, "
            f"{'complex' if complex_taps else 'real'} branches over {rows} rows (see "
            f"kernel_supports: one slab and a chunk of the weights within {MAX_SMEM} "
            "bytes of shared memory, rows <= 65535)")
    args = (MODES[mode], int(complex_taps), src0, src1, n0, n1, s0, s1, w, out0, out1,
            out_len, rows, m, p, os, t_in, t_out,
            None if tail is None else tail.data_ptr(), 0 if tail is None else tail.shape[-1],
            None if divisor is None else divisor.data_ptr(), emit)
    if dev.index == torch.cuda.current_device():
        rc = _entry()(*args, torch.cuda.current_stream(dev).cuda_stream)
    else:
        with torch.cuda.device(dev):
            rc = _entry()(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"pfb_fold kernel launch ({mode}) failed: CUDA error {rc}")
    launches += 1


def _on_card(what: str, tensors, w):
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda, not {dev.type}")
    if any(t.device != dev for t in tensors) or w.device != dev:
        raise ValueError(f"{what} takes its samples and branches on one device")
    if not w.is_contiguous():
        raise ValueError(f"{what} takes contiguous branches")
    return dev


def pfb_analysis(head, body, w, os: int, t_frames: int):
    """Fold complex64 samples, ``head [..., n_head]`` then ``body [...,
    n_body]`` (or None), with the branches ``w [P, M]`` (float32: a real
    prototype; complex64: a complex one) into ``t_frames`` frames ``[...,
    t_frames, M]`` complex64 in frame order ``t = i*os + j`` (the module
    docstring gives the formula). Samples past the end read as zeros.

    On a CUDA tensor this launches the kernel's analysis layout on the
    current stream; it raises for a dtype other than complex64, rows that are not contiguous,
    tensors on different devices, a shape the kernel does not take
    (:func:`kernel_supports`), a missing ``nvcc``, a failed build or a
    failed launch. On a CPU tensor it is :func:`pfb_analysis_reference`.
    """
    p, m, hop = _check_analysis(head, body, w, os, t_frames)
    if head.device.type == "cpu":
        return pfb_analysis_reference(head, body, w, os, t_frames)
    dev = _on_card("pfb_analysis", [head] + ([] if body is None else [body]), w)
    os, t_frames = int(os), int(t_frames)
    batch = tuple(head.shape[:-1])
    rows, s0 = _rows(head, "head")
    if body is not None and body.shape[-1] > 0:
        _, s1 = _rows(body, "body")
        src1, n1 = body.data_ptr(), body.shape[-1]
    else:
        src1, n1, s1 = None, 0, 0
    out = torch.empty(batch + (t_frames, m), dtype=torch.complex64, device=dev)
    if rows == 0:
        return out
    _launch("analysis", w.is_complex(), head.data_ptr() if head.shape[-1] else None, src1,
            head.shape[-1], n1, s0, s1, w.data_ptr(), out.data_ptr(), None, 0, rows, m, p,
            os, 0, t_frames, dev)
    return out


def pfb_synthesis(frames, w_rev, os: int, tail=None, divisor=None, emit=None):
    """The weighted overlap-add of the oversampled synthesis: frames ``[...,
    T, M]`` complex64 and the branches reversed in ``p``, ``w_rev [P, M]``
    (float32 or complex64), to ``[..., synthesis_length(T, M, P, os)]``
    complex64, all ``os`` classes in one launch (the module docstring;
    :func:`pfb_synthesis_reference` is the composition it computes).

    The streaming stage's epilogue runs in the same launch: ``tail`` (the
    carried overlap-add, complex64 ``[..., L_t]``) is added to the first
    ``L_t`` samples, and with ``emit`` the call returns ``(out, rest)``:
    the first ``emit`` samples, divided plane by plane by ``divisor[u mod
    hop]`` (float32 ``[hop]``, or None), and the rest, each contiguous.

    On a CUDA tensor this launches the kernel's synthesis layout (refusals
    as :func:`pfb_analysis`; ``frames``, ``tail`` and ``divisor``
    contiguous); on a CPU tensor it is :func:`pfb_synthesis_reference`.
    """
    p, m, hop = _check_synthesis(frames, w_rev, os)
    if frames.device.type == "cpu":
        return pfb_synthesis_reference(frames, w_rev, os, tail, divisor, emit)
    dev = _on_card("pfb_synthesis", [frames] + [t for t in (tail, divisor) if t is not None],
                   w_rev)
    os = int(os)
    t_frames = int(frames.shape[-2])
    length = synthesis_length(t_frames, m, p, os)
    _check_epilogue(frames, hop, length, tail, divisor, emit)
    if not all(t.is_contiguous() for t in (frames, tail, divisor) if t is not None):
        raise ValueError("pfb_synthesis takes contiguous frames, tail and divisor")
    batch = tuple(frames.shape[:-2])
    rows = frames.numel() // (t_frames * m)
    cut = length if emit is None else int(emit)
    out = torch.empty(batch + (cut,), dtype=torch.complex64, device=dev)
    rest = torch.empty(batch + (length - cut,), dtype=torch.complex64, device=dev)
    if rows:
        _launch("synthesis", w_rev.is_complex(), frames.data_ptr(), None, t_frames * m, 0,
                t_frames * m, 0, w_rev.data_ptr(), out.data_ptr(),
                rest.data_ptr() if length > cut else None, length, rows, m, p, os, t_frames, 0,
                dev, tail, divisor, cut)
    return out if emit is None else (out, rest)


def pfb_fold_os(x_re, x_im, hb, os: int, t_cls: int):
    """Fold split planes ``x_re, x_im [..., n]`` with the real prototype
    branches ``hb [P, M]`` into ``(out_re, out_im)``, each ``[..., os,
    t_cls, M]``: class ``j`` holds frames ``t = i*os + j`` of the
    oversampled bank with its reference roll applied (the TPU wrapper's
    layout).

    On a CUDA tensor this launches the kernel's planes layout on the
    current stream; it raises for an input too short (fewer than
    ``(os-1)*hop + (t_cls-1+P)*M`` samples), a dtype other than float32,
    planes that are not contiguous, tensors on different devices, a shape
    the kernel does not take (:func:`kernel_supports`), a missing ``nvcc``,
    a failed build or a failed launch. On a CPU tensor it is
    :func:`pfb_fold_os_reference`.
    """
    p, m, hop = _check_args(x_re, x_im, hb, os, t_cls)
    if x_re.device.type == "cpu":
        return pfb_fold_os_reference(x_re, x_im, hb, os, t_cls)
    dev = _on_card("pfb_fold_os", [x_re, x_im], hb)
    if not (x_re.is_contiguous() and x_im.is_contiguous()):
        raise ValueError("pfb_fold_os takes contiguous planes and branches")
    os, t_cls = int(os), int(t_cls)
    batch = tuple(x_re.shape[:-1])
    rows = x_re.numel() // x_re.shape[-1]
    out_re = torch.empty(batch + (os, t_cls, m), dtype=torch.float32, device=dev)
    out_im = torch.empty_like(out_re)
    if rows == 0:
        return out_re, out_im
    n = x_re.shape[-1]
    _launch("planes", False, x_re.data_ptr(), x_im.data_ptr(), n, 0, n, n, hb.data_ptr(),
            out_re.data_ptr(), out_im.data_ptr(), 0, rows, m, p, os, 0, t_cls, dev)
    return out_re, out_im
