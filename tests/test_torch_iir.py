"""The port's IIR filters (``ops/iir.py``) against the JAX package's and
``scipy.signal.sosfilt``, on the same seeded numpy inputs.

Tolerances:
- the designs (``butter_sos``, ``fm_deemphasis_sos``) and the truncated
  kernels: ``np.array_equal`` to the JAX package's (host float64 copies);
- ``sosfilt``, ``sosfilt_stream``, ``biquad_apply``: RMS EVM <= -100 dB
  against the JAX output, against scipy's float64 recursion (the
  truncation and float32 FFT floor, ~-106 dB), and a stream against the
  one-shot call; final states <= -100 dB against the JAX states.
"""

import numpy as np
import pytest
import scipy.signal as ss
import torch

from aether_primitives_tpu_torch import convert
from aether_primitives_tpu_torch.evm import evm_rms_db
from aether_primitives_tpu_torch.ops import iir as tiir

torch.set_num_threads(1)

EVM_DB = -100.0


@pytest.fixture(scope="module")
def jiir():
    pytest.importorskip("jax")
    from aether_primitives_tpu.ops import iir

    return iir


def _c(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)


@pytest.mark.parametrize("order,cutoff,btype", [
    (4, 0.1, "lowpass"), (3, 0.08, "highpass"), (2, (0.1, 0.2), "bandpass"),
    (3, (0.05, 0.3), "bandstop"), (4, 0.05, "lowpass"),
])
def test_designs_equal_jax(jiir, order, cutoff, btype):
    sos = tiir.butter_sos(order, cutoff, btype)
    assert np.array_equal(sos, jiir.butter_sos(order, cutoff, btype))
    for row in sos:
        key = tuple(float(c) for c in row)
        for a, b in zip(tiir._biquad_kernels(key), jiir._biquad_kernels(key)):
            assert np.array_equal(a, b)
    assert np.array_equal(tiir.fm_deemphasis_sos(2.4), jiir.fm_deemphasis_sos(2.4))


def test_design_validation_matches_jax(jiir):
    for args, msg in (((2, 0.6), "cutoff must be in"), ((2, 0.1, "bandpass"), "needs cutoff"),
                      ((2, (0.2, 0.1), "bandpass"), "f_low < f_high"),
                      ((2, 0.1, "notch"), "btype must be")):
        for mod in (tiir, jiir):
            with pytest.raises(ValueError, match=msg):
                mod.butter_sos(*args)


@pytest.mark.parametrize("sos_args", [(4, 0.1), (2, (0.1, 0.2), "bandpass")])
def test_sosfilt_matches_jax_and_scipy(jiir, sos_args):
    x = _c(4096, 1)
    sos = tiir.butter_sos(*sos_args)
    got = tiir.sosfilt(sos, torch.from_numpy(x))
    assert got.dtype == torch.complex64 and got.shape == (4096,)
    assert evm_rms_db(got.numpy(), np.asarray(jiir.sosfilt(sos, x))) <= EVM_DB
    assert evm_rms_db(got.numpy(), ss.sosfilt(sos, x.astype(np.complex128))) <= EVM_DB


def test_sosfilt_batched_with_initial_state(jiir):
    x = _c((3, 512), 2)
    sos = tiir.butter_sos(2, 0.2)
    state = [_c((3, 2), 10 + i) for i in range(sos.shape[0])]
    want = np.asarray(jiir.sosfilt(sos, x, state))
    got = tiir.sosfilt(sos, torch.from_numpy(x), [torch.from_numpy(s) for s in state])
    assert evm_rms_db(got.numpy(), want) <= EVM_DB
    # a block shorter than the kernel: the initial state's decayed part
    y, s_end = tiir.biquad_apply(torch.from_numpy(x[:, :20]), sos[0], torch.from_numpy(state[0]))
    jy, js_end = jiir.biquad_apply(x[:, :20], sos[0], state[0])
    assert evm_rms_db(y.numpy(), np.asarray(jy)) <= EVM_DB
    assert evm_rms_db(s_end.numpy(), np.asarray(js_end)) <= EVM_DB


@pytest.mark.parametrize("design,one_shot_db", [((4, 0.1), EVM_DB), ((5, 0.07), -90.0)])
def test_sosfilt_stream_continues_a_jax_stream(jiir, design, one_shot_db):
    # the JAX stream's section states carried into the port: the port's
    # blocks equal the JAX stream's and complete the one-shot output. The
    # one-shot bar of butter(5, 0.07) is the truncation floor both packages
    # share (ROADMAP.md §3.15: -97 dB stream vs one-shot, -86 dB vs scipy)
    x = _c(3000, 3)
    sos = tiir.butter_sos(*design)
    whole = np.asarray(jiir.sosfilt(sos, x))
    edges = (0, 1000, 1700, 1730, 3000)  # 30 samples: shorter than a kernel
    import jax

    jstream = jax.jit(lambda xb, st: jiir.sosfilt_stream(sos, xb, st))  # one program a block
    jstates, tstates, jparts, parts = [None] * sos.shape[0], None, [], []
    for i, (a, b) in enumerate(zip(edges[:-1], edges[1:])):
        if i == 2:
            tstates = convert.iir_states_from_numpy(jstates, "cpu")
            assert all(s.dtype == torch.complex64 for s in tstates)
        y, jstates = jstream(x[a:b], jstates)
        jparts.append(np.asarray(y))
        if i < 2:
            parts.append(np.asarray(y))
        else:
            y, tstates = tiir.sosfilt_stream(sos, torch.from_numpy(x[a:b]), tstates)
            parts.append(y.numpy())
    assert evm_rms_db(np.concatenate(parts), np.concatenate(jparts)) <= EVM_DB
    assert evm_rms_db(np.concatenate(parts), whole) <= one_shot_db
    for t, j in zip(tstates, jstates):
        assert evm_rms_db(t.numpy(), np.asarray(j)) <= EVM_DB
    assert convert.iir_states_from_numpy([None, None], "cpu") == [None, None]
