"""Native host-extension loader (csrc/hostops.cpp).

Compiles the C++ host hot-loops on first use (g++ -O3, cached in
``build/``) and exposes them through ctypes. Every entry point has a numpy
fallback so the framework works without a toolchain; ``available()`` tells
you which path is active.

A copy of ``aether_primitives_tpu/native.py`` whose source,
``aether_primitives_tpu_torch/csrc/hostops.cpp``, is a copy of the JAX
package's ``csrc/hostops.cpp`` (the tests pin both equal); its build is
named apart from the JAX package's.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_PKG = Path(__file__).resolve().parent
_SRC = _PKG / "csrc" / "hostops.cpp"
_BUILD = _PKG.parent / "build"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


_CXXFLAGS = [
    "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
    "-march=native", "-funroll-loops",
]


def _lib_path() -> Path:
    # Key the artifact on a source+flags hash, never mtime: a stale or
    # foreign (different-ISA, -march=native) binary must never be dlopen'd
    # just because its mtime looks fresh. A new hash -> a new file name ->
    # a fresh local compile.
    digest = hashlib.sha256(
        _SRC.read_bytes() + " ".join(_CXXFLAGS).encode()
    ).hexdigest()[:12]
    return _BUILD / f"libaether_torch_hostops-{digest}.so"


def _build() -> Optional[Path]:
    lib_path = _lib_path()
    if lib_path.exists():
        return lib_path
    _BUILD.mkdir(exist_ok=True)
    # build to a temp path and rename into place: a concurrent process must
    # never dlopen a half-written .so
    tmp = lib_path.with_suffix(f".tmp.{os.getpid()}.so")
    cmd = ["g++", *_CXXFLAGS, str(_SRC), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, lib_path)
        return lib_path
    except Exception:
        tmp.unlink(missing_ok=True)
        return None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if not _SRC.exists():
            return None
        path = _build()
        if path is None:
            return None
        lib = ctypes.CDLL(str(path))
        fp = ctypes.POINTER(ctypes.c_float)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.deinterleave_c64.argtypes = [fp, fp, fp, ctypes.c_size_t]
        lib.interleave_c64.argtypes = [fp, fp, fp, ctypes.c_size_t]
        lib.peak_c64.argtypes = [
            fp, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_size_t), ctypes.POINTER(ctypes.c_float),
        ]
        lib.pack_bits_lsb.argtypes = [u8p, u8p, ctypes.c_size_t]
        lib.unpack_bits_lsb.argtypes = [u8p, u8p, ctypes.c_size_t]
        lib.feeder_open.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_size_t,
        ]
        lib.feeder_open.restype = ctypes.c_void_p
        lib.feeder_next.argtypes = [ctypes.c_void_p, fp, fp]
        lib.feeder_next.restype = ctypes.c_size_t
        lib.feeder_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    """True when the compiled host extension is loaded."""
    return _load() is not None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def deinterleave(x: np.ndarray):
    """complex64 [n] -> (re, im) f32 planes (native when available)."""
    x = np.ascontiguousarray(x, dtype=np.complex64)
    lib = _load()
    flat = x.reshape(-1)
    n = flat.size
    re = np.empty(x.shape, np.float32)
    im = np.empty(x.shape, np.float32)
    if lib is not None:
        lib.deinterleave_c64(
            _fptr(flat.view(np.float32)), _fptr(re.reshape(-1)), _fptr(im.reshape(-1)), n
        )
    else:
        re[...] = x.real
        im[...] = x.imag
    return re, im


def interleave(re: np.ndarray, im: np.ndarray) -> np.ndarray:
    """(re, im) f32 planes -> complex64 (native when available)."""
    re = np.ascontiguousarray(re, dtype=np.float32)
    im = np.ascontiguousarray(im, dtype=np.float32)
    out = np.empty(re.shape, np.complex64)
    lib = _load()
    if lib is not None:
        lib.interleave_c64(
            _fptr(re.reshape(-1)), _fptr(im.reshape(-1)),
            _fptr(out.reshape(-1).view(np.float32)), re.size,
        )
    else:
        out.real = re
        out.imag = im
    return out


def peak(x: np.ndarray):
    """(argmax index, |x|^2 at it) over a complex64 vector."""
    x = np.ascontiguousarray(x, dtype=np.complex64).reshape(-1)
    lib = _load()
    if lib is not None:
        idx = ctypes.c_size_t()
        mag2 = ctypes.c_float()
        lib.peak_c64(_fptr(x.view(np.float32)), x.size, ctypes.byref(idx), ctypes.byref(mag2))
        return int(idx.value), float(mag2.value)
    m = np.abs(x) ** 2
    i = int(np.argmax(m))
    return i, float(m[i])


def pack_bits(bits: np.ndarray) -> np.ndarray:
    """{0,1} uint8 vector -> LSB-first packed bytes."""
    bits = np.ascontiguousarray(bits, dtype=np.uint8).reshape(-1)
    out = np.zeros((bits.size + 7) // 8, np.uint8)
    lib = _load()
    if lib is not None:
        lib.pack_bits_lsb(_u8ptr(bits), _u8ptr(out), bits.size)
    else:
        out[...] = np.packbits(bits, bitorder="little")
    return out


def unpack_bits(packed: np.ndarray, n_bits: int) -> np.ndarray:
    """LSB-first packed bytes -> {0,1} uint8 vector of length n_bits."""
    packed = np.ascontiguousarray(packed, dtype=np.uint8).reshape(-1)
    out = np.empty(n_bits, np.uint8)
    lib = _load()
    if lib is not None:
        lib.unpack_bits_lsb(_u8ptr(packed), _u8ptr(out), n_bits)
    else:
        out[...] = np.unpackbits(packed, count=n_bits, bitorder="little")
    return out


class BlockFeeder:
    """Threaded capture feeder: a native producer thread reads an
    interleaved-complex64 capture and deinterleaves each block into a
    bounded ring of f32 plane buffers, so disk I/O + deinterleave overlap
    the consumer's device work (the reference's feeder-thread + pool
    steady state, reference src/pipeline.rs / src/pool.rs, with the
    bounded ring replacing the unbounded channel's OOM risk).

    Iterate to receive ``(re, im)`` f32 plane pairs (fresh arrays, safe to
    donate to the device); the final pair may be shorter than
    ``block_samples``. Falls back to a synchronous numpy reader when the
    native extension is unavailable — same yielded values either way.
    Use as a context manager or rely on iterator exhaustion to release
    the native handle.
    """

    def __init__(self, path, block_samples: int, depth: int = 4):
        self.path = str(path)
        self.block = int(block_samples)
        if self.block <= 0:
            raise ValueError("block_samples must be positive")
        self.depth = max(2, int(depth))
        self._handle = None
        self._fallback = None
        lib = _load()
        if lib is not None:
            h = lib.feeder_open(
                self.path.encode(), self.block, self.depth
            )
            if not h:
                raise FileNotFoundError(self.path)
            self._handle = ctypes.c_void_p(h)
        else:
            self._fallback = open(self.path, "rb")

    def __iter__(self):
        return self

    def __next__(self):
        if self._handle is not None:
            lib = _load()
            re = np.empty(self.block, np.float32)
            im = np.empty(self.block, np.float32)
            n = lib.feeder_next(self._handle, _fptr(re), _fptr(im))
            if n == 0:
                self.close()
                raise StopIteration
            return re[:n], im[:n]
        if self._fallback is None:
            raise StopIteration
        raw = np.fromfile(self._fallback, dtype=np.complex64, count=self.block)
        if raw.size == 0:
            self.close()
            raise StopIteration
        return deinterleave(raw)

    def close(self):
        if self._handle is not None:
            lib = _load()
            lib.feeder_close(self._handle)
            self._handle = None
        if self._fallback is not None:
            self._fallback.close()
            self._fallback = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):  # last-resort release; close() is the real contract
        try:
            self.close()
        except Exception:
            pass
