"""The port's AWGN (``aether_primitives_tpu_torch.ops.noise``) against the JAX
package's ``ops/noise.py``.

PyTorch generators cannot reproduce threefry's streams, so the two are held
by statistics on ``N = 65,536`` complex samples, never sample by sample:
each component's mean within 5 sigma of 0 (sigma = ``sqrt(power / N)``)
and its variance within 5 sigma of ``power`` (sigma = ``power * sqrt(2 /
N)``), for the port and for the JAX package alike. Shapes and dtypes are
equal to the JAX package's; one seed and call sequence gives the same
samples, and another seed other samples. The CUDA case carries the
``cuda`` marker and skips without a card.
"""

import numpy as np
import pytest
import torch

from aether_primitives_tpu_torch.ops import noise

torch.set_num_threads(1)

N = 65536
CPU = "cpu"


@pytest.fixture(scope="module")
def jnoise():
    pytest.importorskip("jax")
    import jax

    from aether_primitives_tpu.ops import noise as jn

    return jax, jn


def _check_stats(x, power, n=N):
    x = np.asarray(x).reshape(-1).astype(np.complex128)
    assert x.size == n
    for comp in (x.real, x.imag):
        assert abs(comp.mean()) <= 5 * np.sqrt(power / n)
        assert abs(comp.var() - power) <= 5 * power * np.sqrt(2 / n)


@pytest.mark.parametrize("power", [1.0, 0.01, 4.0])
def test_component_std_is_sqrt_power_as_in_jax(jnoise, power):
    jax, jn = jnoise
    got = noise.Awgn(power, 3, device=CPU).next_block(N)
    want = np.asarray(jn.Awgn(power, 3).next_block(N))
    assert got.dtype == torch.complex64 and got.shape == want.shape == (N,)
    _check_stats(got.numpy(), power)
    _check_stats(want, power)


def test_apply_single_scale_as_in_jax(jnoise):
    # single-scale convention: the noise apply adds has per-component
    # variance `power`, in both packages (not the reference's power^2)
    jax, jn = jnoise
    sig = np.full(N, 1.0 + 2.0j, np.complex64)
    got = noise.Awgn(0.04, 5, device=CPU).apply(torch.from_numpy(sig)).numpy() - sig
    want = np.asarray(jn.Awgn(0.04, 5).apply(sig)) - sig
    _check_stats(got, 0.04)
    _check_stats(want, 0.04)


def test_deterministic_by_seed_and_sequence():
    a, b, c = (noise.new(1.0, s, device=CPU) for s in (7, 7, 8))
    x1, y1, z1 = a.fill(256), b.fill(256), c.fill(256)
    assert torch.equal(x1, y1)
    assert not torch.equal(x1, z1)
    x2 = a.fill(256)  # the next call draws the next samples
    assert not torch.equal(x1, x2)
    assert torch.equal(x2, b.fill(256))


def test_object_api_matches_jax_shapes(jnoise):
    jax, jn = jnoise
    g = noise.generator(device=CPU)
    jg = jn.generator()
    assert (g.power, noise.DEFAULT_RNG_SEED) == (jg.power, jn.DEFAULT_RNG_SEED) == (1.0, 815)
    assert torch.equal(g.fill(64), noise.new(1.0, 815, device=CPU).fill(64))
    g.set_power(0.25)
    jg.set_power(0.25)
    assert g.power == jg.power
    blk = g.next_block((3, 5))
    assert blk.shape == np.shape(jg.next_block((3, 5))) == (3, 5)
    it = g.iter(128)
    chunks = [next(it) for _ in range(3)]
    assert all(c.shape == (128,) for c in chunks) and not torch.equal(chunks[0], chunks[1])
    _check_stats(torch.cat([next(g.iter(N // 4)) for _ in range(4)]).numpy(), 0.25)


def test_pure_function_form(jnoise):
    jax, jn = jnoise
    gen = torch.Generator().manual_seed(11)
    x = noise.awgn(gen, (4, N // 4), 2.0, device=CPU)
    want = np.asarray(jn.awgn(jax.random.key(11), (4, N // 4), 2.0))
    assert x.shape == want.shape and x.dtype == torch.complex64
    _check_stats(x.numpy(), 2.0)
    # an integer seed makes its own generator: the same seed, the same noise
    assert torch.equal(noise.awgn(11, 64, 1.0, device=CPU), noise.awgn(11, 64, 1.0, device=CPU))
    sig = torch.ones(N, dtype=torch.complex64)
    y = noise.apply(12, sig, 0.5)  # a CPU tensor stays on the CPU
    assert y.device.type == "cpu"
    _check_stats((y - sig).numpy(), 0.5)
    # a power given as a tensor, as the JAX package takes a traced scalar
    _check_stats(noise.awgn(13, N, torch.tensor(0.3), device=CPU).numpy(), 0.3)


def test_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: noise.Awgn(), noise.generator, lambda: noise.new(1.0, 1),
                 lambda: noise.awgn(1, 8), lambda: noise.apply(1, np.zeros(8, np.complex64))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()


@pytest.mark.cuda
def test_awgn_on_the_card_statistics_and_determinism():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    a = noise.Awgn(0.5, 9, device="cuda")
    x = a.next_block(N)
    assert x.device.type == "cuda" and x.dtype == torch.complex64
    _check_stats(x.cpu().numpy(), 0.5)
    assert torch.equal(x, noise.Awgn(0.5, 9, device="cuda").next_block(N))
