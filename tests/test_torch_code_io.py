"""The port's code-table interchange (``ops/code_io.py``) against the JAX
package's, on ``tests/test_code_io.py``'s inputs.

Tolerances: none; every result is integer or boolean. The matrices, base
graphs, generators and info positions are equal arrays, the ``CodeReport``
equal field for field, the files written byte-equal, and every rejection
the same ``ValueError`` with the same message.
"""

import dataclasses

import numpy as np
import pytest
import torch

from aether_primitives_tpu_torch.ops import code_io, ldpc, nr_ldpc

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jcio():
    pytest.importorskip("jax")
    from aether_primitives_tpu.ops import code_io as jcio

    return jcio


def _small_h():
    # hand-checkable 3x6: H rows = {0,1,2}, {2,3,4}, {4,5,0}
    h = np.zeros((3, 6), np.uint8)
    h[0, [0, 1, 2]] = 1
    h[1, [2, 3, 4]] = 1
    h[2, [4, 5, 0]] = 1
    return h


def _same_rejection(jcio, fn: str, *args, match: str):
    with pytest.raises(ValueError, match=match) as got:
        getattr(code_io, fn)(*args)
    with pytest.raises(ValueError) as want:
        getattr(jcio, fn)(*args)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("which", ["wifi", "regular", "small"])
def test_alist_round_trip_equals_jax(jcio, tmp_path, which):
    h = {"wifi": lambda: ldpc.wifi_ldpc()[0], "regular": lambda: ldpc.make_regular_ldpc()[0],
         "small": _small_h}[which]()
    code_io.save_alist(h, tmp_path / "port.alist")
    jcio.save_alist(h, tmp_path / "jax.alist")
    assert (tmp_path / "port.alist").read_bytes() == (tmp_path / "jax.alist").read_bytes()
    got = code_io.load_alist(tmp_path / "port.alist")
    assert got.dtype == np.uint8 and np.array_equal(got, h)
    assert np.array_equal(got, jcio.load_alist(tmp_path / "port.alist"))
    if which == "small":
        assert (tmp_path / "port.alist").read_text().split("\n")[:2] == ["6 3", "2 3"]


def test_qc_npz_round_trip_equals_jax(jcio, tmp_path):
    base = nr_ldpc.make_nr_base_graph(2, 64)
    for name, z, b in (("wifi", 27, ldpc._WIFI_648_R12), ("nr", 64, base)):
        code_io.save_qc_npz(b, z, tmp_path / f"{name}.npz")
        got = code_io.load_qc_npz(tmp_path / f"{name}.npz")
        want = jcio.load_qc_npz(tmp_path / f"{name}.npz")
        assert got[1] == want[1] == z and got[0].dtype == want[0].dtype
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[0], b)
        jcio.save_qc_npz(b, z, tmp_path / f"j{name}.npz")
        assert np.array_equal(code_io.load_qc_npz(tmp_path / f"j{name}.npz")[0], b)
    assert np.array_equal(ldpc.qc_expand(*code_io.load_qc_npz(tmp_path / "wifi.npz")),
                          ldpc.wifi_ldpc()[0])
    got = code_io.nr_base_graph_from_file(tmp_path / "nr.npz")
    assert got == jcio.nr_base_graph_from_file(tmp_path / "nr.npz")
    assert got == tuple(map(tuple, base.tolist()))
    with pytest.raises(ValueError, match="lifting size"):
        code_io.save_qc_npz(base, 0, tmp_path / "bad.npz")


def test_alist_rejections_match_jax(jcio, tmp_path):
    wifi_h = ldpc.wifi_ldpc()[0]
    trunc = tmp_path / "trunc.alist"
    code_io.save_alist(wifi_h, trunc)
    lines = trunc.read_text().strip().split("\n")
    trunc.write_text("\n".join(lines[: len(lines) // 2]))
    _same_rejection(jcio, "load_alist", trunc, match="truncated")

    bad = tmp_path / "bad.alist"
    code_io.save_alist(_small_h(), bad)
    lines = bad.read_text().strip().split("\n")
    lines[-1] = "2 5 6"  # a row list that disagrees with the column lists
    bad.write_text("\n".join(lines) + "\n")
    _same_rejection(jcio, "load_alist", bad, match="disagrees")

    deg = tmp_path / "deg.alist"
    deg.write_text("2 2\n2 2\n2 1\n2 1\n1 0\n1 2\n1 2\n2 0\n")
    _same_rejection(jcio, "load_alist", deg, match="degree|lists")


def test_qc_npz_rejections_match_jax(jcio, tmp_path):
    shifts = tmp_path / "bad_qc.npz"
    np.savez(shifts, base=np.array([[27, -1], [0, 3]], np.int64), z=np.int64(27))
    _same_rejection(jcio, "load_qc_npz", shifts, match="shifts")
    keys = tmp_path / "nokeys.npz"
    np.savez(keys, h=np.eye(3, dtype=np.int64))
    _same_rejection(jcio, "load_qc_npz", keys, match="base")


def test_validation_rejections_match_jax(jcio):
    h = np.zeros((2, 4), np.uint8)
    h[0, [0, 1]] = 1
    h[1, [1, 2]] = 1  # column 3 never checked
    _same_rejection(jcio, "validate_parity_check", h, match="unprotected")
    _same_rejection(jcio, "validate_parity_check", ldpc.wifi_ldpc()[0], 300, match="rank")


@pytest.mark.parametrize("which", ["wifi", "girth4", "regular", "nr"])
def test_code_report_equals_jax_field_for_field(jcio, which):
    if which == "girth4":
        h = np.zeros((3, 6), np.uint8)
        h[0, [0, 1, 2]] = 1
        h[1, [0, 1, 3]] = 1  # shares vars {0, 1} with row 0 -> 4-cycle
        h[2, [3, 4, 5]] = 1
    elif which == "nr":
        h = nr_ldpc.NrLdpc(z=8, bg=2).parity_check()
    else:
        h = {"wifi": ldpc.wifi_ldpc, "regular": ldpc.make_regular_ldpc}[which]()[0]
    got, want = code_io.validate_parity_check(h), jcio.validate_parity_check(h)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.rate, got.girth_report, got.summary()) == (want.rate, want.girth_report,
                                                           want.summary())
    if which == "wifi":
        assert (got.n, got.m, got.rank, got.k) == (648, 324, 324, 324) and not got.has_girth_4
    if which == "girth4":
        assert got.has_girth_4 and "girth 4" in got.girth_report


@pytest.mark.parametrize("suffix", [".alist", ".npz"])
def test_ldpc_from_file_triples_equal_jax(jcio, tmp_path, suffix):
    path = tmp_path / f"code{suffix}"
    if suffix == ".alist":
        h0 = ldpc.make_regular_ldpc(648, 3, 6, seed=13)[0]
        code_io.save_alist(h0, path)
    else:
        code_io.save_qc_npz(ldpc._WIFI_648_R12, 27, path)
        h0 = ldpc.wifi_ldpc()[0]
    got, want = code_io.ldpc_from_file(path), jcio.ldpc_from_file(path)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    h, g, info = got
    assert np.array_equal(h, h0) and not ((g.astype(np.int64) @ h.T) % 2).any()
    msg = np.arange(g.shape[0]) % 2
    assert np.array_equal(((msg @ g) % 2)[info], msg)
    assert code_io.ldpc_from_file(str(path), expect_k=g.shape[0])[0].shape == h.shape
