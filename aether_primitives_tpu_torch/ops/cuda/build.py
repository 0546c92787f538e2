"""Build and load the package's hand-written CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` file with a plain C entry point. At
first use it is compiled with ``nvcc`` for ``sm_90a`` into
``build/torch_kernels/`` beside the package, keyed by a hash of the source
and the flags, and loaded with ``ctypes``. A missing ``nvcc`` or a failed
build raises: there is no other route to a kernel.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[2]
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"
#: The CUDA toolkit's default install prefix, searched after $CUDA_HOME and
#: $PATH.
DEFAULT_CUDA_HOME = Path("/usr/local/cuda")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``$PATH``, then the
    toolkit's default prefix. Raises RuntimeError when there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(DEFAULT_CUDA_HOME / "bin" / "nvcc")
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found ($CUDA_HOME/bin, $PATH, "
        f"{DEFAULT_CUDA_HOME}/bin): the CUDA kernels cannot be built"
    )


def library_path(name: str) -> Path:
    """Where the build of ``csrc/<name>.cu`` lives (hash of source + flags)."""
    return source_library_path(PACKAGE_DIR / "csrc" / f"{name}.cu")


def source_library_path(src: Path) -> Path:
    """Where the build of the CUDA source ``src`` lives (hash of source +
    flags)."""
    src = Path(src)
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{digest.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if its build is missing, and load it.

    The compiler's report (``-Xptxas -v``: registers, shared memory,
    spills) is kept beside the library as ``<lib>.log``. Processes that
    build at once each compile into a temporary file and rename it into
    place.
    """
    return load_source(PACKAGE_DIR / "csrc" / f"{name}.cu")


@functools.lru_cache(maxsize=None)
def load_source(src: Path) -> ctypes.CDLL:
    """:func:`load` for any CUDA source with a plain C interface (the
    benches' own kernels, edited copies, another checkout's)."""
    src = Path(src)
    lib = source_library_path(src)
    if not lib.exists():
        nvcc = find_nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run(
                [nvcc, *NVCC_FLAGS, "-o", tmp, str(src)],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed to build {src.name} "
                    f"(exit {proc.returncode}):\n{proc.stderr}"
                )
            lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
            os.replace(tmp, lib)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return ctypes.CDLL(str(lib))
