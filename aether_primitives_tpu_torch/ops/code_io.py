"""Standard-format interchange for LDPC / QC-LDPC code tables.

A numpy-only copy of ``aether_primitives_tpu/ops/code_io.py``: loading,
saving and auditing a code table is host work done once at configuration
time, so the port carries the module over unchanged, on its own
:mod:`.ldpc` (its tests pin every function equal to the original's output
and every rejection to the original's message).

Formats:

- **alist** (MacKay's format): full binary parity-check matrices.
  :func:`load_alist` / :func:`save_alist`, strict cross-validation of the
  redundant column/row adjacency lists.
- **.npz QC base graphs**: circulant-shift matrices (``-1`` = zero
  block) + lifting size, ``np.savez(path, base=..., z=...)``.
  :func:`load_qc_npz` / :func:`save_qc_npz`; expand with
  :func:`.ldpc.qc_expand`, decode with :func:`.ldpc.qc_ldpc_decode`,
  or feed the shifts to :class:`.nr_ldpc.NrLdpc` via
  :func:`nr_base_graph_from_file`.

:func:`validate_parity_check` reports dimensions, GF(2) rank (the true
code rate), density, degree profile, and a girth-4 check.
:func:`ldpc_from_file` returns the ``(H, G, info_indices)`` triple
:func:`.ldpc.ldpc_encode` / :func:`.ldpc.ldpc_decode` consume;
``PacketModem(PacketConfig(fec="ldpc", ldpc_file=...))`` wires it into the
burst link.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from .ldpc import _generator_and_info, _gf2_row_reduce, qc_expand


# ------------------------------------------------------------------ alist


def load_alist(path) -> np.ndarray:
    """Parse a MacKay-format alist file into a dense ``[m, n]`` uint8
    parity-check matrix.

    Layout (all 1-indexed, 0 entries = padding): ``"n m"``, then
    ``"max_col_deg max_row_deg"``, then the n column degrees, the m row
    degrees, n lines of per-column check indices, m lines of per-row
    variable indices. Both adjacency lists are parsed and
    cross-checked — a file whose row lists disagree with its column
    lists is rejected, not silently trusted.
    """
    with open(path) as f:
        tokens_per_line = [line.split() for line in f if line.strip()]
    flat = [int(t) for line in tokens_per_line for t in line]
    it = iter(flat)

    def take(count):
        out = []
        for _ in range(count):
            try:
                out.append(next(it))
            except StopIteration:
                raise ValueError(f"{path}: truncated alist file") from None
        return out

    n, m = take(2)
    if n <= 0 or m <= 0:
        raise ValueError(f"{path}: bad dimensions n={n} m={m}")
    max_cd, max_rd = take(2)
    col_deg = take(n)
    row_deg = take(m)
    if max(col_deg) > max_cd or max(row_deg) > max_rd:
        raise ValueError(f"{path}: degree exceeds declared maximum")
    if sum(col_deg) != sum(row_deg):
        raise ValueError(
            f"{path}: column degrees sum to {sum(col_deg)} but row "
            f"degrees sum to {sum(row_deg)}"
        )
    h = np.zeros((m, n), np.uint8)
    # Per-entry lines are padded to the max degree in MacKay's files but
    # some emitters write exactly `deg` entries; accept both by reading
    # line-by-line from the original token stream.
    consumed = 0
    # recompute how many tokens the header consumed to find line offset
    header_tokens = 4 + n + m
    line_idx = 0
    while consumed < header_tokens:
        consumed += len(tokens_per_line[line_idx])
        line_idx += 1
        if consumed > header_tokens:
            raise ValueError(f"{path}: header fields split across lines")
    col_lines = tokens_per_line[line_idx : line_idx + n]
    row_lines = tokens_per_line[line_idx + n : line_idx + n + m]
    if len(col_lines) < n or len(row_lines) < m:
        raise ValueError(f"{path}: truncated adjacency lists")
    for j, line in enumerate(col_lines):
        ent = [int(t) for t in line if int(t) != 0]
        if len(ent) != col_deg[j]:
            raise ValueError(
                f"{path}: column {j + 1} lists {len(ent)} checks, "
                f"degree says {col_deg[j]}"
            )
        for r in ent:
            if not (1 <= r <= m):
                raise ValueError(f"{path}: column {j + 1} check index {r} "
                                 f"out of range 1..{m}")
            if h[r - 1, j]:
                raise ValueError(f"{path}: duplicate entry ({r}, {j + 1})")
            h[r - 1, j] = 1
    # cross-check the (redundant) row lists against the built matrix
    for i, line in enumerate(row_lines):
        ent = sorted(int(t) for t in line if int(t) != 0)
        want = sorted((np.nonzero(h[i])[0] + 1).tolist())
        if ent != want:
            raise ValueError(
                f"{path}: row {i + 1} adjacency list disagrees with the "
                f"column lists"
            )
    return h


def save_alist(h, path) -> None:
    """Write a dense binary parity-check matrix as a MacKay alist file
    (entries padded with 0 to the max degree, the database convention)."""
    h = np.asarray(h, np.uint8) % 2
    m, n = h.shape
    cols = [np.nonzero(h[:, j])[0] + 1 for j in range(n)]
    rows = [np.nonzero(h[i, :])[0] + 1 for i in range(m)]
    max_cd = max((len(c) for c in cols), default=0)
    max_rd = max((len(r) for r in rows), default=0)

    def pad(ent, width):
        return " ".join(map(str, list(ent) + [0] * (width - len(ent))))

    with open(path, "w") as f:
        f.write(f"{n} {m}\n{max_cd} {max_rd}\n")
        f.write(" ".join(str(len(c)) for c in cols) + "\n")
        f.write(" ".join(str(len(r)) for r in rows) + "\n")
        for c in cols:
            f.write(pad(c, max_cd) + "\n")
        for r in rows:
            f.write(pad(r, max_rd) + "\n")


# -------------------------------------------------------------- QC .npz


def save_qc_npz(base, z: int, path) -> None:
    """Persist a QC-LDPC base (circulant-shift) matrix + lifting size.
    ``base[i, j] = -1`` marks a zero block, ``s >= 0`` a shift — the
    exact convention of :func:`.ldpc.qc_expand` and TS 38.212 tables."""
    base = np.asarray(base, np.int64)
    if int(z) < 1:
        raise ValueError(f"lifting size z must be >= 1, got {z}")
    np.savez(path, base=base, z=np.int64(z))


def load_qc_npz(path) -> Tuple[np.ndarray, int]:
    """Load ``(base, z)`` saved by :func:`save_qc_npz` (or any npz with
    ``base`` int shift matrix and scalar ``z``). Shifts are validated to
    ``-1 <= s < z``."""
    with np.load(path) as d:
        if "base" not in d or "z" not in d:
            raise ValueError(f"{path}: expected arrays 'base' and 'z'")
        base = np.asarray(d["base"], np.int64)
        z = int(d["z"])
    if base.ndim != 2:
        raise ValueError(f"{path}: base must be 2-D, got shape {base.shape}")
    if z < 1:
        raise ValueError(f"{path}: lifting size z={z} must be >= 1")
    if base.min() < -1 or base.max() >= z:
        raise ValueError(
            f"{path}: shifts must lie in -1..{z - 1}, found "
            f"[{base.min()}, {base.max()}]"
        )
    return base, z


def nr_base_graph_from_file(path) -> tuple:
    """Load a QC ``.npz`` base graph as the hashable tuple-of-tuples
    :class:`.nr_ldpc.NrLdpc` takes via ``base_graph=`` — the drop-in slot
    for the real TS 38.212 shift tables. The lifting size in the file is
    returned implicitly by shape conventions; NrLdpc supplies its own
    ``z`` (shifts apply mod z, the spec's rule), so only the base matrix
    is returned."""
    base, _z = load_qc_npz(path)
    return tuple(map(tuple, base.tolist()))


# ---------------------------------------------------------- validation


@dataclass(frozen=True)
class CodeReport:
    """Structural audit of a parity-check matrix (``validate_parity_check``)."""

    n: int                 # codeword length
    m: int                 # check rows as given
    rank: int              # GF(2) rank (independent checks)
    k: int                 # true information length = n - rank
    density: float         # fraction of ones
    min_col_degree: int
    max_col_degree: int
    min_row_degree: int
    max_row_degree: int
    has_girth_4: bool      # any pair of checks sharing >= 2 variables

    @property
    def rate(self) -> float:
        return self.k / self.n

    @property
    def girth_report(self) -> str:
        return "girth 4 (degrades BP)" if self.has_girth_4 else "girth >= 6"

    def summary(self) -> str:
        return (
            f"H [{self.m}, {self.n}] rank {self.rank} -> k={self.k} "
            f"(rate {self.rate:.3f}), density {self.density:.4f}, "
            f"col deg {self.min_col_degree}-{self.max_col_degree}, "
            f"row deg {self.min_row_degree}-{self.max_row_degree}, "
            f"{self.girth_report}"
        )


def validate_parity_check(h, expect_k: Optional[int] = None) -> CodeReport:
    """Audit a foreign parity-check matrix before trusting it on a link.

    Checks: 2-D binary, no empty rows/columns (an all-zero column is an
    unprotected bit), GF(2) rank (``k = n - rank`` is the TRUE rate —
    dependent rows are common in structured tables and fine, but a rank
    mismatch against ``expect_k`` means the wrong table), and the
    girth-4 test (two checks sharing two variables — BP-degrading,
    reported not rejected: some deployed codes do contain 4-cycles).
    """
    h = np.asarray(h)
    if h.ndim != 2:
        raise ValueError(f"H must be 2-D, got shape {h.shape}")
    if not np.isin(h, (0, 1)).all():
        raise ValueError("H must be binary (0/1)")
    h = h.astype(np.uint8)
    m, n = h.shape
    col_deg = h.sum(axis=0)
    row_deg = h.sum(axis=1)
    if (col_deg == 0).any():
        raise ValueError(
            f"column(s) {np.nonzero(col_deg == 0)[0].tolist()} have no "
            "checks — unprotected codeword bits"
        )
    if (row_deg == 0).any():
        raise ValueError(
            f"row(s) {np.nonzero(row_deg == 0)[0].tolist()} are empty checks"
        )
    _, _, rank = _gf2_row_reduce(h)
    k = n - rank
    if expect_k is not None and k != expect_k:
        raise ValueError(
            f"GF(2) rank {rank} gives k={k}, expected k={expect_k} — "
            "wrong table or corrupted file"
        )
    # 4-cycle test: overlap of check supports; H H^T off-diagonal >= 2.
    # int32 matmul keeps it exact; sizes here are host-side one-offs.
    overlap = (h.astype(np.int32) @ h.astype(np.int32).T)
    np.fill_diagonal(overlap, 0)
    return CodeReport(
        n=n, m=m, rank=rank, k=k,
        density=float(h.mean()),
        min_col_degree=int(col_deg.min()),
        max_col_degree=int(col_deg.max()),
        min_row_degree=int(row_deg.min()),
        max_row_degree=int(row_deg.max()),
        has_girth_4=bool((overlap >= 2).any()),
    )


# ---------------------------------------------------------- high level


def ldpc_from_file(
    path, expect_k: Optional[int] = None
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Load an LDPC code from ``.alist`` or QC ``.npz`` and return the
    ``(H, G, info_indices)`` triple the :mod:`.ldpc` encode/decode pair
    consumes — the same contract as :func:`.ldpc.wifi_ldpc` /
    :func:`.ldpc.make_regular_ldpc`, so a file-loaded foreign table is a
    drop-in code for ``PacketModem(fec="ldpc", ldpc_file=...)``.

    The table is validated (:func:`validate_parity_check`) and the
    generator derived by GF(2) elimination; systematic up to the column
    permutation recorded in ``info_indices``.
    """
    path = str(path)
    if path.endswith(".npz"):
        base, z = load_qc_npz(path)
        h = qc_expand(base, z)
    else:
        h = load_alist(path)
    validate_parity_check(h, expect_k=expect_k)
    g, info = _generator_and_info(h)
    return h, g, info
