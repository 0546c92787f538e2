"""Sample-capture file I/O (reference src/util/file.rs).

A copy of ``aether_primitives_tpu/utils/file.py`` (numpy only), so that the
port reads and writes the same files without importing the JAX package;
the tests pin the two equal byte for byte. The SigMF recorder field keeps
the original's value for that reason.

The reference's interchange format is back-to-back ``repr(C)`` structs in
native byte order (src/util/file.rs:10-11,28); for ``cf32`` that is
interleaved ``(re: f32, im: f32)`` pairs — **exactly** numpy's complex64
layout, so files written by the Rust crate read here bit-for-bit and vice
versa. Readers/writers are thin, zero-copy numpy wrappers (numpy's
``fromfile``/``tofile`` are C loops; no Python per-sample cost), plus
headerless CSV like the reference's serde-backed csv module.
"""

from __future__ import annotations

import io
import os
from pathlib import Path

import numpy as np


def count_structs_in_file(filepath, dtype=np.complex64) -> int:
    """Number of ``dtype`` items that exactly fill the file; raises if the
    size is not an integer multiple (reference src/util/file.rs:12-25)."""
    size = os.path.getsize(filepath)
    itemsize = np.dtype(dtype).itemsize
    if size % itemsize != 0:
        raise ValueError(
            "File does not contain an integer number of the requested struct"
        )
    return size // itemsize


class BinaryReader:
    """Sequential reader of packed ``dtype`` samples
    (reference ``BinaryReader``, src/util/file.rs:29-73)."""

    def __init__(self, filepath, dtype=np.complex64):
        self.dtype = np.dtype(dtype)
        count_structs_in_file(filepath, self.dtype)  # validate like the reference
        self._f = open(filepath, "rb")

    def read(self, n: int) -> np.ndarray:
        """Read exactly ``n`` items (raises EOFError if short)."""
        buf = self._f.read(n * self.dtype.itemsize)
        if len(buf) != n * self.dtype.itemsize:
            raise EOFError("File ended before the requested number of items")
        return np.frombuffer(buf, dtype=self.dtype).copy()

    def read_all(self) -> np.ndarray:
        data = self._f.read()
        return np.frombuffer(data, dtype=self.dtype).copy()

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class BinaryWriter:
    """Sequential writer of packed ``dtype`` samples; truncates on open
    (reference ``BinaryWriter``, src/util/file.rs:78-107)."""

    def __init__(self, filepath, dtype=np.complex64):
        self.dtype = np.dtype(dtype)
        self._f = open(filepath, "wb")

    def write(self, data) -> None:
        arr = np.ascontiguousarray(np.asarray(data, dtype=self.dtype))
        self._f.write(arr.tobytes())

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def binary_reader(filepath, dtype=np.complex64) -> BinaryReader:
    return BinaryReader(filepath, dtype)


def binary_writer(filepath, dtype=np.complex64) -> BinaryWriter:
    return BinaryWriter(filepath, dtype)


def load(filepath, dtype=np.complex64, mmap: bool = False) -> np.ndarray:
    """Load a whole capture. ``mmap=True`` maps the file instead of copying —
    the zero-copy path for feeding long captures into the streaming executor.
    """
    if mmap:
        return np.memmap(filepath, dtype=dtype, mode="r")
    return np.fromfile(filepath, dtype=dtype)


# -- integer IQ capture formats (SDR front-end interchange) -----------------
#
# Beyond the reference's raw-struct format: the interleaved int16/int8 IQ
# layouts that RF front ends (UHD "sc16", rtl-sdr u8-offset, HackRF s8)
# actually record. Values normalize to full-scale +-1.0 complex64.

_IQ_FORMATS = {
    "sc16": (np.int16, 32767.0, 0.0),
    "sc8": (np.int8, 127.0, 0.0),
    "u8": (np.uint8, 127.5, 127.5),  # rtl-sdr: unsigned with 127.5 offset
}


def load_iq(filepath, fmt: str = "sc16") -> np.ndarray:
    """Read an interleaved integer IQ capture as normalized complex64."""
    try:
        dtype, scale, offset = _IQ_FORMATS[fmt]
    except KeyError:
        raise ValueError(f"unknown IQ format {fmt!r} (one of {sorted(_IQ_FORMATS)})")
    raw = np.fromfile(filepath, dtype=dtype).astype(np.float32)
    if raw.size % 2:
        raise ValueError("IQ file does not contain an integer number of samples")
    raw = (raw - offset) / scale
    return (raw[0::2] + 1j * raw[1::2]).astype(np.complex64)


def save_iq(filepath, data, fmt: str = "sc16") -> None:
    """Write complex samples as an interleaved integer IQ capture
    (values clipped to full scale)."""
    try:
        dtype, scale, offset = _IQ_FORMATS[fmt]
    except KeyError:
        raise ValueError(f"unknown IQ format {fmt!r} (one of {sorted(_IQ_FORMATS)})")
    c = np.asarray(data, dtype=np.complex64).reshape(-1)
    flat = np.empty(2 * c.size, np.float32)
    flat[0::2] = c.real
    flat[1::2] = c.imag
    info = np.iinfo(dtype)
    q = np.clip(np.rint(flat * scale + offset), info.min, info.max).astype(dtype)
    q.tofile(str(filepath))


def save(filepath, data, dtype=np.complex64) -> None:
    np.ascontiguousarray(np.asarray(data, dtype=dtype)).tofile(str(filepath))


# -- headerless CSV (reference src/util/file.rs:112-124) --------------------


def csv_writer(filepath):
    """Write complex samples as headerless ``re,im`` rows."""
    return _CsvWriter(filepath)


class _CsvWriter:
    def __init__(self, filepath):
        self._f = open(filepath, "w", newline="")

    def write(self, data) -> None:
        arr = np.asarray(data, dtype=np.complex64).reshape(-1)
        buf = io.StringIO()
        for c in arr:
            buf.write(f"{c.real},{c.imag}\n")
        self._f.write(buf.getvalue())

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def csv_reader(filepath) -> np.ndarray:
    """Read headerless ``re,im`` rows into a complex64 vector."""
    raw = np.loadtxt(str(filepath), delimiter=",", dtype=np.float32, ndmin=2)
    return (raw[:, 0] + 1j * raw[:, 1]).astype(np.complex64)


def stream_blocks(filepath, block_samples: int, depth: int = 4):
    """Threaded block streamer over an interleaved-complex64 capture:
    iterate to get ``(re, im)`` f32 plane pairs, ready for the device
    boundary (:mod:`~aether_primitives_tpu_torch.boundary`). A native producer
    thread (csrc/hostops.cpp) prefetches + deinterleaves ``depth`` blocks
    ahead so file I/O overlaps device compute — the reference's
    feeder-thread/pool steady state (reference src/pipeline.rs,
    src/pool.rs) with bounded-ring backpressure. Numpy fallback without a
    toolchain."""
    from .. import native

    return native.BlockFeeder(filepath, block_samples, depth)


# ------------------------------------------------------------------ SigMF


_SIGMF_DTYPES = {
    np.dtype(np.complex64): "cf32_le",
    np.dtype(np.int16): "ci16_le",  # interleaved via save_iq("sc16")
    np.dtype(np.int8): "ci8_le",
}
_SIGMF_TO_FMT = {"cf32_le": None, "ci16_le": "sc16", "ci8_le": "sc8"}


def save_sigmf(
    basepath,
    data,
    sample_rate: float,
    frequency: float = 0.0,
    datatype: str = "cf32_le",
    description: str = "",
    annotations=None,
):
    """Write a SigMF recording pair (``<base>.sigmf-data`` +
    ``<base>.sigmf-meta``) — the SDR community's standard interchange
    format (little-endian sample file + JSON metadata). ``datatype``:
    ``cf32_le`` (this framework's native interleaved f32, the reference's
    repr(C) layout), ``ci16_le`` or ``ci8_le`` (via the IQ converters).
    ``annotations``: optional list of dicts merged into the standard
    annotation list (e.g. ``{"core:sample_start": 0, "core:sample_count":
    1024, "core:label": "burst"}``)."""
    import json
    import os

    base = str(basepath)
    if base.endswith(".sigmf-data") or base.endswith(".sigmf-meta"):
        base = base.rsplit(".", 1)[0].rsplit(".sigmf-", 1)[0]
    data = np.asarray(data)
    fmt = _SIGMF_TO_FMT.get(datatype, "__missing__")
    if fmt == "__missing__":
        raise ValueError(f"unsupported SigMF datatype {datatype!r}")
    if fmt is None:
        save(base + ".sigmf-data", data.astype(np.complex64))
    else:
        save_iq(base + ".sigmf-data", data, fmt=fmt)
    meta = {
        "global": {
            "core:datatype": datatype,
            "core:sample_rate": float(sample_rate),
            "core:version": "1.0.0",
            "core:description": str(description),
            "core:recorder": "aether_primitives_tpu",
        },
        "captures": [
            {"core:sample_start": 0, "core:frequency": float(frequency)}
        ],
        "annotations": list(annotations or []),
    }
    with open(base + ".sigmf-meta", "w") as f:
        json.dump(meta, f, indent=1)
    return base


def load_sigmf(basepath):
    """Read a SigMF recording pair: returns ``(samples complex64,
    metadata dict)``. Supports the datatypes :func:`save_sigmf` writes."""
    import json

    base = str(basepath)
    if base.endswith(".sigmf-data") or base.endswith(".sigmf-meta"):
        base = base.rsplit(".sigmf-", 1)[0]
    with open(base + ".sigmf-meta") as f:
        meta = json.load(f)
    datatype = meta["global"]["core:datatype"]
    fmt = _SIGMF_TO_FMT.get(datatype, "__missing__")
    if fmt == "__missing__":
        raise ValueError(f"unsupported SigMF datatype {datatype!r}")
    if fmt is None:
        samples = load(base + ".sigmf-data")
    else:
        samples = load_iq(base + ".sigmf-data", fmt=fmt)
    return samples, meta


# ------------------------------------------------------------------ WAV audio


def save_wav(filepath, audio, sample_rate: int, normalize: bool = True) -> None:
    """Write mono (``[n]``) or multi-channel (``[ch, n]``) real audio as a
    16-bit PCM WAV — the listening end of the analog demods.
    ``normalize`` scales peak to 0.9 full scale; otherwise values are
    clipped at +-1."""
    import wave

    a = np.asarray(audio, np.float64)
    if a.ndim == 1:
        a = a[None, :]
    if a.ndim != 2:
        raise ValueError("audio must be [n] or [channels, n]")
    if normalize:
        peak = np.abs(a).max()
        if peak > 0:
            a = a * (0.9 / peak)
    q = np.clip(np.rint(a * 32767.0), -32768, 32767).astype("<i2")
    inter = q.T.reshape(-1)  # frame-interleaved channels
    with wave.open(str(filepath), "wb") as w:
        w.setnchannels(a.shape[0])
        w.setsampwidth(2)
        w.setframerate(int(sample_rate))
        w.writeframes(inter.tobytes())


def load_wav(filepath):
    """Read a 16-bit PCM WAV: returns ``(audio f32 in [-1, 1] —
    ``[n]`` mono or ``[channels, n]`` — , sample_rate)``."""
    import wave

    with wave.open(str(filepath), "rb") as w:
        nch, sw, rate, nfr = (
            w.getnchannels(), w.getsampwidth(), w.getframerate(), w.getnframes()
        )
        if sw != 2:
            raise ValueError(f"only 16-bit PCM supported, got {8 * sw}-bit")
        raw = np.frombuffer(w.readframes(nfr), dtype="<i2")
    a = (raw.astype(np.float32) / 32768.0).reshape(-1, nch).T
    return (a[0] if nch == 1 else a), rate
