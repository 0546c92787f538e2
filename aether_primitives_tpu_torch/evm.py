"""Error-Vector-Magnitude assertion — THE numeric acceptance contract.

Vectorized equivalent of the reference's ``assert_evm!`` macro
(reference src/lib.rs:26-49), with identical semantics:

- per element, the error vector magnitude is ``|actual - ref|``;
- the per-element limit is ``|ref| * 10^(limit_db / 10)`` (the reference uses
  the power-ratio formula on an amplitude, and so do we — matching behavior,
  not textbook correctness);
- the default limit is -80 dB (src/lib.rs:29-31);
- inputs must be the same length (src/lib.rs:34) and the threshold must be
  negative (src/lib.rs:35);
- an element whose reference is exactly zero admits no error at all.

Like the reference (which warns about IEEE-754 false positives,
src/lib.rs:25), this check is sensitive to f32 rounding near the limit;
tests pick per-case tolerances the same way the reference's own tests do
(e.g. -72 dB for an fft→scale→ifft chain, reference src/fft.rs:117-119).
"""

from __future__ import annotations

import numpy as np


def evm(actual, ref) -> np.ndarray:
    """Per-element error vector magnitude ``|actual - ref|`` (f64 on host)."""
    a = np.asarray(actual).reshape(-1)
    r = np.asarray(ref).reshape(-1)
    return np.abs(a.astype(np.complex128) - r.astype(np.complex128))


def evm_db(actual, ref) -> float:
    """Worst-case relative EVM in dB: ``10*log10(max |a-r| / |r|)``.

    Elements with ``|ref| == 0`` are excluded from the relative measure; if
    any such element has nonzero error, returns ``+inf``. Returns ``-inf``
    for an exact match.
    """
    a = np.asarray(actual).reshape(-1).astype(np.complex128)
    r = np.asarray(ref).reshape(-1).astype(np.complex128)
    if a.shape != r.shape:
        raise AssertionError("Input arrays must be same length")
    err = np.abs(a - r)
    mag = np.abs(r)
    zero = mag == 0.0
    if np.any(err[zero] > 0.0):
        return float("inf")
    nz = ~zero
    if not np.any(nz) or not np.any(err[nz] > 0.0):
        return float("-inf")
    worst = np.max(err[nz] / mag[nz])
    return float(10.0 * np.log10(worst))


def evm_rms_db(actual, ref) -> float:
    """RMS EVM in dB: ``20*log10(||a - r|| / ||r||)`` over the whole block.

    The aggregate commonly quoted for modem quality; the reference's
    per-element macro is the stricter gate, this is the scale-relative
    measure robust to tiny-magnitude bins.
    """
    a = np.asarray(actual).reshape(-1).astype(np.complex128)
    r = np.asarray(ref).reshape(-1).astype(np.complex128)
    if a.shape != r.shape:
        raise AssertionError("Input arrays must be same length")
    denom = np.linalg.norm(r)
    if denom == 0.0:
        return float("inf") if np.linalg.norm(a) > 0 else float("-inf")
    err = np.linalg.norm(a - r) / denom
    return float(20.0 * np.log10(err)) if err > 0 else float("-inf")


def assert_evm(actual, ref, limit_db: float = -80.0) -> None:
    """Assert every element of ``actual`` is within ``limit_db`` EVM of ``ref``.

    Raises ``AssertionError`` identifying the worst offending element, the
    same failure report the reference macro panics with (src/lib.rs:40-46).
    """
    a = np.asarray(actual).reshape(-1)
    r = np.asarray(ref).reshape(-1)
    if a.shape != r.shape:
        raise AssertionError(
            f"Input slices/vectors must be same length ({a.shape[0]} vs {r.shape[0]})"
        )
    if not float(limit_db) < 0.0:
        raise AssertionError("The EVM threshold must be negative")

    a = a.astype(np.complex128)
    r = r.astype(np.complex128)
    err = np.abs(a - r)
    # Match the reference: the factor is computed in f64 then applied to the
    # f32 norm; we stay in f64 throughout which only widens the check's own
    # precision, not the limit.
    limit = np.abs(r) * (10.0 ** (float(limit_db) / 10.0))
    bad = err > limit
    if np.any(bad):
        idx = int(np.argmax(np.where(bad, err - limit, -np.inf)))
        e = err[idx]
        e_db = 10.0 * np.log10(e) if e > 0 else float("-inf")
        raise AssertionError(
            f"EVM limit exceeded: {e:.6g}({e_db:.2f}dB) > {limit[idx]:.6g}"
            f"({limit_db}dB) for element {idx}. "
            f"Actual {a[idx]}, Expected {r[idx]}"
        )
