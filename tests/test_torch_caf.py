"""The port's cross-ambiguity acquisition (``models/caf.py``) against the
JAX package's, on the same seeded numpy inputs.

Tolerances: surfaces RMS EVM <= -100 dB against the JAX package's (the
derotation angle is float32 ``(-2 pi nu) n`` in its order); the Doppler
grid within two ulps of the end point of ``jnp.linspace``'s (XLA contracts
and rewrites its arithmetic: ~1e-10 cycles/sample); delay within 1e-3 samples, Doppler within 1e-7 cycles/sample,
the peak metric rtol 1e-4. The sharded surface and estimate equal the
port's one-device ones (``torch.equal`` on the CPU mesh) and the JAX
package's sharded ones at the bars above. The JAX side runs under
``jax.jit``. The ``cuda`` case holds the card
to the CPU run.
"""

import numpy as np
import pytest
import torch

from aether_primitives_tpu_torch.evm import evm_rms_db
from aether_primitives_tpu_torch.models import caf as tcaf
from aether_primitives_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(1)

EVM_DB, DELAY_ATOL, DOPPLER_ATOL, METRIC_RTOL = -100.0, 1e-3, 1e-7, 1e-4


@pytest.fixture(scope="module")
def jcaf():
    pytest.importorskip("jax")
    from aether_primitives_tpu.models import caf

    return caf


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _jit(fn, **static):
    """The JAX side under ``jax.jit`` (one XLA program a call)."""
    import jax

    return jax.jit(lambda *a: fn(*a, **static))


def _cn(rng, n, scale=1.0):
    return (scale * (rng.normal(size=n) + 1j * rng.normal(size=n))).astype(np.complex64)


def _scene(seed, n=2048, m=256, delay=700, nu=3.3e-3, noise=0.05):
    rng = np.random.default_rng(seed)
    ref = _cn(rng, m)
    x = _cn(rng, n, noise)
    t = np.arange(m)
    x[delay:delay + m] += (ref * np.exp(2j * np.pi * nu * (t + delay))).astype(np.complex64)
    return x, ref


def _close(got, want):
    d, nu, m = (float(v) for v in got)
    jd, jnu, jm = (float(v) for v in want)
    assert abs(d - jd) <= DELAY_ATOL and abs(nu - jnu) <= DOPPLER_ATOL, (got, want)
    assert abs(m - jm) <= METRIC_RTOL * abs(jm), (got, want)


def test_ambiguity_matches_jax(jcaf):
    rng = np.random.default_rng(1)
    x, ref = _cn(rng, 512), _cn(rng, 100)
    dops = np.array([-0.01, -0.003, 0.0, 0.004, 0.02], np.float32)
    got = tcaf.ambiguity(torch.from_numpy(x), torch.from_numpy(ref), torch.from_numpy(dops))
    assert got.shape == (5, 512) and got.dtype == torch.complex64
    assert evm_rms_db(got.numpy(), np.asarray(jcaf.ambiguity(x, ref, dops))) <= EVM_DB
    with pytest.raises(ValueError, match="flat"):
        tcaf.ambiguity(torch.zeros(2, 64, dtype=torch.complex64), torch.zeros(64), [0.0])
    with pytest.raises(ValueError, match="longer"):
        tcaf.ambiguity(torch.zeros(32, dtype=torch.complex64), torch.zeros(64), [0.0])


def test_doppler_grid_is_jax_linspace(jcaf):
    import jax.numpy as jnp

    for mx, n in ((1e-3, 33), (1.25e-3, 64), (5e-3, 64), (0.1, 7), (2e-4, 1)):
        want = np.asarray(jnp.linspace(-mx, mx, n).astype(jnp.float32))
        got = tcaf._doppler_grid(mx, n)
        assert got.dtype == np.float32 and got[0] == want[0] and got[-1] == want[-1]
        assert np.all(np.abs(got - want) <= 2 * np.spacing(np.float32(mx))), (mx, n)


@pytest.mark.parametrize("seed,n_dop", [(2, 33), (3, 65)])
def test_estimate_delay_doppler_matches_jax(jcaf, seed, n_dop):
    x, ref = _scene(seed, n=4096, m=2048 if seed == 3 else 512, delay=137, nu=3.3e-4)
    got = tcaf.estimate_delay_doppler(torch.from_numpy(x), torch.from_numpy(ref), 1e-3, n_dop)
    assert all(v.dtype == torch.float32 and v.ndim == 0 for v in got)
    _close(got, _jit(jcaf.estimate_delay_doppler, max_doppler=1e-3, n_dopplers=n_dop)(x, ref))
    assert abs(float(got[0]) - 137) < 0.5 and abs(float(got[1]) - 3.3e-4) < 2e-5


def test_peak_at_the_grid_edge_and_wrapped_delay(jcaf):
    # the Doppler at the grid's last row (no refinement there) and the delay
    # at sample 0 (its left neighbour wraps to N - 1)
    rng = np.random.default_rng(4)
    ref = _cn(rng, 1024)
    x = (ref * np.exp(2j * np.pi * 1e-3 * np.arange(1024)) + _cn(rng, 1024, 0.1)).astype(
        np.complex64)
    got = tcaf.estimate_delay_doppler(torch.from_numpy(x), torch.from_numpy(ref), 1e-3, 9)
    _close(got, _jit(jcaf.estimate_delay_doppler, max_doppler=1e-3, n_dopplers=9)(x, ref))
    got = tcaf.estimate_delay_doppler(torch.from_numpy(x), torch.from_numpy(ref), 1e-3, 1)
    _close(got, _jit(jcaf.estimate_delay_doppler, max_doppler=1e-3, n_dopplers=1)(x, ref))


def test_sharded_matches(jcaf, eight_devices):
    from aether_primitives_tpu.parallel import mesh as jmesh

    x, ref = _scene(5)
    dops = np.linspace(-5e-3, 5e-3, 64).astype(np.float32)
    mesh = tmesh.make_mesh({"time": 8}, ["cpu"] * 8)
    surf_s = tcaf.sharded_ambiguity(torch.from_numpy(x), torch.from_numpy(ref), dops, mesh)
    assert isinstance(surf_s, tmesh.Sharded) and surf_s.shape == (64, 2048)
    one = tcaf.ambiguity(torch.from_numpy(x), torch.from_numpy(ref), dops)
    assert torch.equal(surf_s.gather(), one)
    jm = jmesh.make_mesh({"time": 8})
    assert evm_rms_db(surf_s.gather().numpy(),
                      np.asarray(_jit(jcaf.sharded_ambiguity, mesh=jm)(x, ref, dops))) <= EVM_DB
    est = tcaf.sharded_estimate_delay_doppler(torch.from_numpy(x), torch.from_numpy(ref), 5e-3, mesh)
    one = tcaf.estimate_delay_doppler(torch.from_numpy(x), torch.from_numpy(ref), 5e-3)
    assert all(torch.equal(a, b) for a, b in zip(est, one))
    _close(est, _jit(jcaf.sharded_estimate_delay_doppler, max_doppler=5e-3, mesh=jm)(x, ref))
    assert abs(float(est[0]) - 700) < 1.0 and abs(float(est[1]) - 3.3e-3) < 2e-4
    with pytest.raises(ValueError, match="divide"):
        tcaf.sharded_ambiguity(torch.from_numpy(x), torch.from_numpy(ref), dops[:63], mesh)


@pytest.mark.cuda
def test_card_matches_cpu(cuda):
    x, ref = _scene(6, n=16368, m=4096, delay=3000, nu=4e-4, noise=3.0)
    got = tcaf.estimate_delay_doppler(torch.from_numpy(x).to(cuda), torch.from_numpy(ref), 1.25e-3)
    assert all(v.device.type == "cuda" for v in got)
    _close([v.cpu() for v in got],
           tcaf.estimate_delay_doppler(torch.from_numpy(x), torch.from_numpy(ref), 1.25e-3))
    dops = np.linspace(-1.25e-3, 1.25e-3, 64).astype(np.float32)
    surf = tcaf.ambiguity(torch.from_numpy(x).to(cuda), torch.from_numpy(ref), dops)
    want = tcaf.ambiguity(torch.from_numpy(x), torch.from_numpy(ref), dops)
    assert evm_rms_db(surf.cpu().numpy(), want.numpy()) <= EVM_DB
