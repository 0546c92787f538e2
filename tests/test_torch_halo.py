"""The port's halo exchange (``ops/cuda/halo.py`` and ``parallel/halo.py``)
against the JAX package's: the Pallas RDMA kernel in interpret mode (single
mesh axis, as ``tests/test_pallas.py`` runs it) and ``left_tail`` /
``right_head`` under ``shard_map`` on the 8-virtual-device CPU mesh.

The exchange moves samples and computes nothing, so every comparison is
``array_equal``. The port runs on ``devices=["cpu"] * 8``, where the
wrapper takes the kernel's plain version; on a card the kernel is held
``torch.equal`` to that plain version at the sharded paths' shapes and at
ragged ones (those cases carry the ``cuda`` marker and skip without a
card; the two-card case skips under two cards).
"""

import types

import numpy as np
import pytest
import torch

from aether_primitives_tpu_torch.ops.cuda import halo as hk
from aether_primitives_tpu_torch.parallel import halo, mesh as mesh_mod

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jx():
    """The JAX side: jax, the Pallas RDMA wrapper, and the halo and mesh
    modules (imported here, so the ``cuda`` cases run without jax)."""
    jax = pytest.importorskip("jax")
    from aether_primitives_tpu.ops.pallas.halo_rdma import halo_left_rdma
    from aether_primitives_tpu.parallel import halo as jhalo
    from aether_primitives_tpu.parallel import mesh as jmesh

    return types.SimpleNamespace(jax=jax, rdma=halo_left_rdma, halo=jhalo, mesh=jmesh)


def _data(shape, dtype, seed=5):
    rng = np.random.default_rng(seed)
    if np.issubdtype(dtype, np.complexfloating):
        return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(dtype)
    if np.issubdtype(dtype, np.floating):
        return rng.normal(size=shape).astype(dtype)
    return rng.integers(0, 200, size=shape).astype(dtype)


def _jax_halo(jx, fn, x, axes, spec, eight_devices):
    m = jx.mesh.make_mesh(axes, devices=eight_devices)
    p = jx.jax.sharding.PartitionSpec(*spec)
    return np.asarray(jx.jax.jit(jx.jax.shard_map(
        fn, mesh=m, in_specs=p, out_specs=p, check_vma=False))(x))


def _cpu_mesh(axes):
    return mesh_mod.make_mesh(axes, devices=["cpu"] * 8)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("dtype", [np.float32, np.complex64])
@pytest.mark.parametrize("shape,overlap", [((128,), 4), ((3, 256), 7), ((2, 3, 64), 8)],
                         ids=["flat-4", "rows-7", "whole-span"])
def test_twin_equals_pallas_rdma_and_left_tail(jx, eight_devices, dtype, shape, overlap):
    x = _data(shape, dtype)
    spec = (None,) * (len(shape) - 1) + ("time",)
    def via_pallas(plane):
        return _jax_halo(jx, lambda xs: jx.rdma(xs, overlap, "time", interpret=True),
                         np.ascontiguousarray(plane), {"time": 8}, spec, eight_devices)

    # interpret mode allocates no complex buffers: a complex capture goes
    # through the Pallas kernel plane by plane
    pallas = (via_pallas(x.real) + 1j * via_pallas(x.imag)
              if np.iscomplexobj(x) else via_pallas(x))
    ppermute = _jax_halo(jx, lambda xs: jx.halo.left_tail(xs, overlap, "time"),
                         x, {"time": 8}, spec, eight_devices)
    xs = mesh_mod.shard(torch.from_numpy(x), _cpu_mesh({"time": 8}), spec)
    for got in (hk.halo_left_rdma(xs, overlap, "time"),
                hk.halo_left_rdma_reference(xs, overlap, "time"),
                halo.left_tail(xs, overlap, "time"),
                halo.left_tail(xs, overlap, "time", backend="reference")):
        got = np.asarray(got)
        assert got.dtype == x.dtype and got.shape == shape[:-1] + (8 * overlap,)
        assert np.array_equal(got, pallas)
        assert np.array_equal(got, ppermute)
    assert hk.launches == 0  # CPU shards launch nothing


def test_halo_left_layout(jx, eight_devices):
    # shard i must see shard i-1's tail; shard 0 sees zeros (tests/test_parallel.py)
    x = np.arange(8 * 16, dtype=np.float32)
    want = _jax_halo(jx, lambda xs: jx.halo.halo_left(xs, 4, "time"), x, {"time": 8}, ("time",),
                     eight_devices)
    xs = mesh_mod.shard(x, _cpu_mesh({"time": 8}), ("time",))
    out = np.asarray(halo.halo_left(xs, 4)).reshape(8, 20)
    assert np.array_equal(out.reshape(-1), want)
    assert (out[0, :4] == 0).all()
    for i in range(1, 8):
        assert (out[i, :4] == np.arange(i * 16 - 4, i * 16)).all()
        assert (out[i, 4:] == np.arange(i * 16, (i + 1) * 16)).all()
    assert halo.halo_left(xs, 0) is xs


def test_right_head_matches_jax(jx, eight_devices):
    x = _data((2, 8 * 24), np.complex64)
    want = _jax_halo(jx, lambda xs: jx.halo.right_head(xs, 5, "time"), x, {"time": 8},
                     (None, "time"), eight_devices)
    xs = mesh_mod.shard(x, _cpu_mesh({"time": 8}), (None, "time"))
    got = np.asarray(halo.right_head(xs, 5))
    assert np.array_equal(got, want)
    assert (got[:, -5:] == 0).all()  # the last shard: the capture's zero-padded end


@pytest.mark.parametrize("axes,axis_name,spec", [
    ({"channel": 2, "time": 4}, "time", ("channel", "time")),
    ({"time": 4, "channel": 2}, "time", ("channel", "time")),  # exchanged axis first
    ({"channel": 2, "time": 4}, "channel", ("time", "channel")),
], ids=["channel-time", "time-first", "along-channel"])
def test_two_axis_mesh_matches_left_tail_under_shard_map(jx, eight_devices, axes, axis_name, spec):
    # the case interpret mode cannot run for the Pallas kernel: each ring
    # along the exchanged axis is independent
    x = _data((8, 64), np.complex64)
    want = _jax_halo(jx, lambda xs: jx.halo.left_tail(xs, 3, axis_name), x, axes, spec,
                     eight_devices)
    xs = mesh_mod.shard(x, _cpu_mesh(axes), spec)
    assert np.array_equal(np.asarray(hk.halo_left_rdma(xs, 3, axis_name)), want)
    assert np.array_equal(np.asarray(halo.left_tail(xs, 3, axis_name)), want)


def test_ring_of_one_is_zeros():
    m = mesh_mod.make_mesh({"time": 1}, devices=["cpu"])
    xs = mesh_mod.shard(_data((3, 32), np.complex64), m, (None, "time"))
    got = halo.left_tail(xs, 6).gather()
    assert got.shape == (3, 6) and not got.any()


def test_errors_mirror_jax(jx):
    m = _cpu_mesh({"time": 8})
    xs = mesh_mod.shard(np.zeros(64, np.float32), m, ("time",))
    with pytest.raises(ValueError, match="not in mesh axes"):
        hk.halo_left_rdma(xs, 2, "frequency")
    with pytest.raises(ValueError, match="not in mesh axes"):
        jx.rdma(np.zeros(8, np.float32), 2, "frequency", mesh_axis_names=("time",))
    other = _cpu_mesh({"channel": 2, "time": 4})
    with pytest.raises(ValueError, match="not in mesh axes"):
        hk.halo_left_rdma(mesh_mod.shard(np.zeros(64, np.float32), other, ("time",)),
                          2, "channel", mesh=m)
    for fn in (halo.left_tail, halo.right_head, hk.halo_left_rdma_reference):
        with pytest.raises(ValueError, match="exceeds the per-device span"):
            fn(xs, 9, "time")
    with pytest.raises(ValueError, match="unknown backend"):
        halo.left_tail(xs, 2, backend="nccl")


def test_shard_and_gather_round_trip():
    m = _cpu_mesh({"channel": 2, "time": 4})
    x = torch.from_numpy(_data((4, 3, 32), np.float32))
    for spec in (("channel", None, "time"), ("time",), (None, None, "channel"), ()):
        s = mesh_mod.shard(x, m, spec)
        assert s.shape == tuple(x.shape) and s.numel() == x.numel() and s.ndim == 3
        assert torch.equal(s.gather(), x)
        assert np.array_equal(np.asarray(s), x.numpy())
    s = mesh_mod.shard(x, m, ("channel", None, "time"))
    assert s.shards[1, 2].shape == (2, 3, 8) and s.shards[1, 2].is_contiguous()
    assert torch.equal(s.shards[1, 2], x[2:, :, 16:24])
    assert mesh_mod.shard(s, m, ("channel", None, "time")) is s
    doubled = s.map(lambda t, index: t * (index["time"] + 1), with_index=True)
    assert torch.equal(doubled.shards[0, 3], 4 * x[:2, :, 24:])
    with pytest.raises(ValueError, match="does not divide"):
        mesh_mod.shard(x, m, (None, "time"))
    with pytest.raises(ValueError, match="laid out"):
        mesh_mod.shard(s, m, ("time",))


# ------------------------------------------------------------------ on a card

#: (shape of the global tensor, dtype, mesh axes, exchanged axis, spec, overlap)
CARD_CASES = {
    "rx-chain [2, 4M] c64 overlap 64": (
        (2, 1 << 22), np.complex64, {"channel": 2, "time": 4}, "time", ("channel", "time"), 64),
    "pfb [4M] c64 overlap 14336": (
        (1 << 22,), np.complex64, {"time": 4}, "time", ("time",), 14336),
    "f32 [128] overlap 4": ((128,), np.float32, {"time": 8}, "time", ("time",), 4),
    "misaligned rows [3, 5, 8000] c64 overlap 7": (
        (3, 5, 8000), np.complex64, {"time": 8}, "time", (None, None, "time"), 7),
    "whole span [4, 512] f32": ((4, 512), np.float32, {"time": 8}, "time", (None, "time"), 64),
    "ring of one": ((3, 100), np.complex64, {"time": 1}, "time", (None, "time"), 9),
    "time axis first": (
        (2, 4096), np.complex64, {"time": 4, "channel": 2}, "time", ("channel", "time"), 33),
    "uint8 odd overlap": ((7, 808), np.uint8, {"time": 8}, "time", (None, "time"), 13),
    "complex128": ((2, 256), np.complex128, {"time": 4}, "time", (None, "time"), 5),
}


def _check_kernel_case(case, devices):
    shape, dtype, axes, axis_name, spec, overlap = case
    m = mesh_mod.make_mesh(axes, devices=devices)
    xs = mesh_mod.shard(torch.from_numpy(_data(shape, dtype)), m, spec)
    before = hk.launches
    got = hk.halo_left_rdma(xs, overlap, axis_name)
    want = hk.halo_left_rdma_reference(xs, overlap, axis_name)
    for d in {t.device for t in xs.shards.flat}:
        torch.cuda.synchronize(d)
    assert hk.launches - before == m.size  # one push per sending shard
    for c in m.coords():
        assert got.shards[c].device == xs.shards[c].device
        assert torch.equal(got.shards[c], want.shards[c]), c


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CARD_CASES))
def test_cuda_kernel_equals_twin_on_one_card(cuda, name):
    axes = CARD_CASES[name][2]
    _check_kernel_case(CARD_CASES[name], [cuda] * int(np.prod(list(axes.values()))))


@pytest.mark.cuda
def test_cuda_kernel_takes_an_odd_element_offset(cuda):
    # a shard that starts 8 bytes into its buffer: the element-size path
    m = mesh_mod.make_mesh({"time": 2}, devices=[cuda] * 2)
    flat = torch.from_numpy(_data((2 * 64 + 1,), np.complex64)).to(cuda)
    xs = mesh_mod.shard(flat[1:], m, ("time",))
    got, want = (f(xs, 16, "time") for f in (hk.halo_left_rdma, hk.halo_left_rdma_reference))
    torch.cuda.synchronize()
    assert torch.equal(got.gather(), want.gather())


@pytest.mark.cuda
def test_cuda_mixed_shards_raise(cuda):
    m = mesh_mod.make_mesh({"time": 2}, devices=[cuda, "cpu"])
    xs = mesh_mod.shard(np.zeros(64, np.float32), m, ("time",))
    with pytest.raises(ValueError, match="on cpu or on cuda"):
        hk.halo_left_rdma(xs, 4, "time")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CARD_CASES)[:4])
def test_cuda_kernel_equals_twin_across_cards(cuda, name):
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        pytest.skip("needs two CUDA devices")
    size = int(np.prod(list(CARD_CASES[name][2].values())))
    _check_kernel_case(CARD_CASES[name],
                       [torch.device("cuda", i % n_cards) for i in range(size)])
