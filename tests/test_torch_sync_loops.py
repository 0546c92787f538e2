"""The port's tracking loops and timing estimators (``models/sync.py``)
against the JAX package's, on the same seeded numpy inputs.

Tolerances (the loops are float32 recurrences on both sides, whose trig
and sums round apart in the last place; each atol is ten times the
largest difference these cases showed):
- decisions after the settle (QPSK hard decisions of the Costas output,
  nearest-index decisions, Gardner strobe signs, ``nav_bit_sync``'s bits
  and offset): exact;
- ``costas_loop``: ``y`` atol 4e-6, ``phase`` atol 3e-6 rad, ``freq`` atol
  2e-7 rad/sample;
- ``gardner_loop``: ``tau`` within 10 float32 ulps (the strobe position is
  an absolute sample index: one ulp at index 5,300 is 4.9e-4 samples, and
  the runs differ by one), strobes atol 3e-3 (a one-ulp position
  difference moves a strobe on the pulse's slope by 3e-4);
- ``code_tracking_loop``: prompts atol 2e-5 of the code length, ``tau``
  atol 1e-3 samples;
- ``carrier_tracking_loop``: wiped prompts atol 4e-4 of the mean prompt
  magnitude, ``phase`` atol 4e-5 cycles, ``freq`` atol 2e-5 cycles/dwell;
- ``estimate_timing``: atol 3e-6 samples; ``estimate_baud_rate`` and
  ``nav_bit_sync``'s quality: rtol 1e-5.
The ``cuda`` cases run each loop on card-resident input under
``torch.cuda.set_sync_debug_mode("error")`` (a host read in a loop body
raises) and hold it to the CPU run at the same bars.
"""

import numpy as np
import pytest
import torch

from aether_primitives_tpu_torch.models import sync as ts
from aether_primitives_tpu_torch.ops import fir as tfir
from aether_primitives_tpu_torch.ops import modulation as tmod
from aether_primitives_tpu_torch.ops import sampling as tsamp
from aether_primitives_tpu_torch.ops.sequence import gps_ca_code

torch.set_num_threads(1)

COSTAS_Y_ATOL, COSTAS_ATOL, COSTAS_FREQ_ATOL = 4e-6, 3e-6, 2e-7
GARDNER_ATOL, GARDNER_ULPS = 3e-3, 10
DLL_PROMPT_ATOL, DLL_TAU_ATOL = 2e-5, 1e-3
CARRIER_ATOL, CARRIER_PHASE_ATOL, CARRIER_FREQ_ATOL = 4e-4, 4e-5, 2e-5
TIMING_ATOL, RTOL = 3e-6, 1e-5


@pytest.fixture(scope="module")
def js():
    pytest.importorskip("jax")
    from aether_primitives_tpu.models import sync

    return sync


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _qpsk(rng, nsym):
    bits = rng.integers(0, 2, 2 * nsym).astype(np.uint8)
    return bits, tmod.qpsk().modulate(torch.from_numpy(bits)).numpy()


def _shaped(rng, nsym, sps, matched=True):
    """RRC-shaped QPSK at ``sps`` (and RRC-matched: the raised-cosine
    cascade a timing loop sees) and its symbols."""
    _, syms = _qpsk(rng, nsym)
    up = np.zeros(nsym * sps, np.complex64)
    up[::sps] = syms
    taps = tfir.rrc_taps(sps, span=8, beta=0.35)
    x = tfir.fir_filter(torch.from_numpy(up), taps)
    if matched:
        x = tfir.fir_filter(x, taps)
    return x.numpy(), syms


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=atol)


def _t(a):
    return torch.from_numpy(np.array(a))


def _costas_input(seed=31, nsym=2000):
    rng = np.random.default_rng(seed)
    bits, tx = _qpsk(rng, nsym)
    n = np.arange(tx.size)
    walk = np.cumsum(rng.normal(scale=2e-3, size=tx.size))
    rx = tx * np.exp(1j * (2 * np.pi * 1e-4 * n + 0.3 + walk))
    rx = rx + 0.05 * (rng.normal(size=tx.size) + 1j * rng.normal(size=tx.size))
    return bits, rx.astype(np.complex64)


def test_costas_matches_jax_after_settle(js):
    bits, rx = _costas_input()
    jy, jph, jfr = (np.asarray(v) for v in js.costas_loop(rx, m=4, loop_bw=0.02))
    ty, tph, tfr = ts.costas_loop(_t(rx), m=4, loop_bw=0.02)
    assert ty.dtype == torch.complex64 and tph.dtype == tfr.dtype == torch.float32
    _close(ty.numpy(), jy, COSTAS_Y_ATOL)
    _close(tph.numpy(), jph, COSTAS_ATOL)
    _close(tfr.numpy(), jfr, COSTAS_FREQ_ATOL)
    settle = 600
    got = tmod.qpsk().demod(ty[settle:]).numpy()
    assert np.array_equal(got, tmod.qpsk().demod(_t(jy[settle:])).numpy())
    assert np.mean(got != bits[2 * settle:]) < 1e-3


def test_costas_batched_and_axes_grid_match_jax(js):
    rng = np.random.default_rng(4)
    rows = np.stack([_qpsk(rng, 400)[1] * np.exp(1j * ph) for ph in (0.2, -0.3, 0.5)])
    rows = rows.astype(np.complex64)
    for m, grid, x in ((4, "diagonal", rows), (2, "diagonal", rows[:2, None]),
                       (4, "axes", rows * np.exp(1j * np.pi / 4).astype(np.complex64))):
        want = js.costas_loop(x, m=m, loop_bw=0.03, phase0=0.1, freq0=1e-3, grid=grid)
        got = ts.costas_loop(_t(x), m=m, loop_bw=0.03, phase0=0.1, freq0=1e-3, grid=grid)
        for g, w, atol in zip(got, want, (COSTAS_Y_ATOL, COSTAS_ATOL, COSTAS_FREQ_ATOL)):
            assert g.shape == x.shape
            _close(g.numpy(), w, atol)
    with pytest.raises(ValueError, match="grid"):
        ts.costas_loop(_t(rows), grid="hex")


@pytest.mark.parametrize("tau_true,ppm", [(0.3, 0.0), (-0.45, 1000.0)])
def test_gardner_matches_jax(js, tau_true, ppm):
    rng = np.random.default_rng(815)
    sps = 4
    x, syms = _shaped(rng, 2500, sps)
    x = tsamp.fractional_delay(_t(x), tau_true)
    if ppm:
        x = tsamp.resample_poly(x[:(x.shape[-1] // 1000) * 1000], 1001, 1000)
    x = x.numpy()
    jsy, jtau = (np.asarray(v) for v in js.gardner_loop(x, sps=sps, loop_bw=0.02))
    tsy, ttau = ts.gardner_loop(_t(x), sps=sps, loop_bw=0.02)
    assert tsy.shape == jsy.shape and ttau.shape == jtau.shape
    assert tsy.shape[0] == max(int((x.size - 8) // sps * 0.998) - 1, 0)
    _close(tsy.numpy(), jsy, GARDNER_ATOL)
    np.testing.assert_array_max_ulp(ttau.numpy(), jtau, GARDNER_ULPS)
    settle = 400
    dec = np.sign(tsy.numpy()[settle:].real) + 1j * np.sign(tsy.numpy()[settle:].imag)
    want = np.sign(jsy[settle:].real) + 1j * np.sign(jsy[settle:].imag)
    assert np.array_equal(dec, want)


def test_gardner_clamps_and_validates(js):
    # a stream shorter than the symbols asked for: positions clamp to
    # [1, n - 4] and the windows' start to [0, n - 4], as lax.dynamic_slice
    x = _shaped(np.random.default_rng(3), 12, 2)[0][:20]
    want = js.gardner_loop(x, sps=2, n_symbols=15)
    got = ts.gardner_loop(_t(x), sps=2, n_symbols=15)
    _close(got[0].numpy(), want[0], GARDNER_ATOL)
    np.testing.assert_array_max_ulp(got[1].numpy(), np.asarray(want[1]), GARDNER_ULPS)
    with pytest.raises(ValueError, match="2 samples/symbol"):
        ts.gardner_loop(_t(x), sps=1)
    with pytest.raises(ValueError, match="single stream"):
        ts.gardner_loop(torch.zeros(2, 64, dtype=torch.complex64))


@pytest.mark.parametrize("tau_true", [0.0, 0.3, -0.45, 1.2])
def test_estimate_timing_matches_jax(js, tau_true):
    rng = np.random.default_rng(11)
    x, _ = _shaped(rng, 1000, 4, matched=False)
    x = tsamp.fractional_delay(_t(x), tau_true).numpy()
    got = ts.estimate_timing(_t(x), 4)
    _close(got.numpy(), np.asarray(js.estimate_timing(x, 4)), TIMING_ATOL)
    rows = np.stack([x, np.roll(x, 1)])
    _close(ts.estimate_timing(_t(rows), 4).numpy(), np.asarray(js.estimate_timing(rows, 4)),
           TIMING_ATOL)


def test_estimate_baud_rate_matches_jax(js):
    rng = np.random.default_rng(99)
    rows = np.stack([_shaped(rng, 1000, 4, matched=False)[0],
                     _shaped(rng, 2000, 2, matched=False)[0]])
    rows = (rows + 0.05 * (rng.normal(size=rows.shape) + 1j * rng.normal(size=rows.shape)))
    rows = rows.astype(np.complex64)
    got = ts.estimate_baud_rate(_t(rows))
    np.testing.assert_allclose(got.numpy(), np.asarray(js.estimate_baud_rate(rows)), rtol=RTOL)
    assert abs(float(got[0]) - 0.25) < 5e-4 and abs(float(got[1]) - 0.5) < 5e-4
    one = ts.estimate_baud_rate(_t(rows[0]), osr=2, min_rate=0.1)
    np.testing.assert_allclose(float(one), float(js.estimate_baud_rate(rows[0], 2, 0.1)),
                               rtol=RTOL)


def _gnss(seed=42, n_dwells=620, prn=13):
    """examples/gnss_track.py's channel: 5 ppm chip clock, CFO 4e-5,
    noise 0.5, 50 bps nav bits with edges 7 dwells in."""
    rng = np.random.default_rng(seed)
    chips01 = gps_ca_code(prn)
    code = 1.0 - 2.0 * chips01.astype(np.float64)
    sps, ppm, cfo = 2, 5e-6, 4e-5
    dwell = 1023 * sps
    n = (n_dwells + 3) * dwell
    s = np.arange(n, dtype=np.float64)
    idx = np.floor((s - sps) * (1 + ppm) / sps).astype(np.int64) % 1023
    nav = rng.integers(0, 2, n_dwells // 20 + 3).astype(np.uint8)
    bit_of_dwell = (np.floor((s - sps) / dwell).astype(np.int64) + 7) // 20
    x = code[idx] * (1.0 - 2.0 * nav[bit_of_dwell % nav.size]) * np.exp(2j * np.pi * cfo * s)
    x += 0.5 * (rng.normal(size=n) + 1j * rng.normal(size=n))
    return x.astype(np.complex64), chips01, nav


def test_gnss_tracking_channel_matches_jax(js):
    x, chips01, nav = _gnss()
    jp, jtau = (np.asarray(v) for v in js.code_tracking_loop(x, chips01, sps=2, loop_bw=0.05,
                                                             n_dwells=620))
    tp, ttau = ts.code_tracking_loop(_t(x), chips01, sps=2, loop_bw=0.05, n_dwells=620)
    _close(tp.numpy() / 1023, jp / 1023, DLL_PROMPT_ATOL)
    _close(ttau.numpy(), jtau, DLL_TAU_ATOL)
    # the carrier loop on the same prompts (the JAX ones) on both sides
    jw, jphi, jfr = (np.asarray(v) for v in js.carrier_tracking_loop(jp))
    tw, tphi, tfr = ts.carrier_tracking_loop(_t(jp))
    scale = np.abs(jw).mean()
    _close(tw.numpy() / scale, jw / scale, CARRIER_ATOL)
    _close(tphi.numpy(), jphi, CARRIER_PHASE_ATOL)
    _close(tfr.numpy(), jfr, CARRIER_FREQ_ATOL)
    settle = 60
    jb, joff, jq = js.nav_bit_sync(jw[settle:], 20)
    for w in (tw, ts.carrier_tracking_loop(tp)[0]):  # the port's chain end to end too
        bits, off, q = ts.nav_bit_sync(w[settle:], 20)
        assert bits.dtype == torch.uint8 and off.dtype == torch.int32
        assert np.array_equal(bits.numpy(), np.asarray(jb)) and int(off) == int(joff)
        np.testing.assert_allclose(float(q), float(jq), rtol=RTOL)
    expect = nav[(np.arange(bits.numel()) * 20 + settle + int(off) + 7) // 20 % nav.size]
    agree = float((bits.numpy() == expect).mean())
    assert max(agree, 1 - agree) == 1.0


def test_code_tracking_short_capture_and_chip_formats(js):
    # nmax < 1: the window start clamps to [0, n - win] as lax.dynamic_slice
    x, chips01, _ = _gnss(seed=5, n_dwells=4)
    for xs, n_dwells in ((x[:3000], 3), (x, None)):
        want = js.code_tracking_loop(xs, chips01, sps=2, loop_bw=0.05, n_dwells=n_dwells)
        for chips in (chips01, 2.0 * chips01.astype(np.float32) - 1.0):
            got = ts.code_tracking_loop(_t(xs), chips, sps=2, loop_bw=0.05, n_dwells=n_dwells)
            assert got[0].shape == want[0].shape
            _close(got[0].numpy() / 1023, np.asarray(want[0]) / 1023, DLL_PROMPT_ATOL)
            _close(got[1].numpy(), want[1], DLL_TAU_ATOL)
    with pytest.raises(ValueError, match="2 samples/chip"):
        ts.code_tracking_loop(_t(x), chips01, sps=1)
    with pytest.raises(ValueError, match="one stream"):
        ts.code_tracking_loop(_t(np.stack([x, x])), chips01)


def test_loops_validate_like_jax(js):
    with pytest.raises(ValueError, match="one stream"):
        ts.carrier_tracking_loop(torch.zeros(2, 8, dtype=torch.complex64))
    with pytest.raises(ValueError, match="one stream"):
        ts.nav_bit_sync(torch.zeros(2, 80, dtype=torch.complex64))
    with pytest.raises(ValueError, match=r"need >= 39 symbols, got 30"):
        ts.nav_bit_sync(torch.ones(30, dtype=torch.complex64))
    with pytest.raises(ValueError, match=r"need >= 39 symbols, got 30"):
        js.nav_bit_sync(np.ones(30, np.complex64))


def _no_host_reads(fn):
    """``fn()`` with a host read (a stream synchronise) raising."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return out


@pytest.mark.cuda
def test_cuda_loops_do_not_read_the_host(cuda):
    bits, rx = _costas_input(nsym=600)
    xc = _t(rx).to(cuda)
    got = _no_host_reads(lambda: ts.costas_loop(xc, m=4, loop_bw=0.02))
    for g, w, atol in zip(got, ts.costas_loop(_t(rx), m=4, loop_bw=0.02),
                          (COSTAS_Y_ATOL, COSTAS_ATOL, COSTAS_FREQ_ATOL)):
        assert g.device.type == "cuda"
        _close(g.cpu().numpy(), w.numpy(), atol)
    x, _ = _shaped(np.random.default_rng(8), 600, 4)
    xg = _t(x).to(cuda)
    got = _no_host_reads(lambda: ts.gardner_loop(xg, sps=4, loop_bw=0.02))
    want = ts.gardner_loop(_t(x), sps=4, loop_bw=0.02)
    _close(got[0].cpu().numpy(), want[0].numpy(), GARDNER_ATOL)
    np.testing.assert_array_max_ulp(got[1].cpu().numpy(), want[1].numpy(), GARDNER_ULPS)
    xs, chips01, _ = _gnss(n_dwells=60)
    xd = _t(xs).to(cuda)
    p, tau = _no_host_reads(lambda: ts.code_tracking_loop(xd, chips01, sps=2, loop_bw=0.05,
                                                           n_dwells=60))
    hp, htau = ts.code_tracking_loop(_t(xs), chips01, sps=2, loop_bw=0.05, n_dwells=60)
    _close(p.cpu().numpy() / 1023, hp.numpy() / 1023, DLL_PROMPT_ATOL)
    _close(tau.cpu().numpy(), htau.numpy(), DLL_TAU_ATOL)
    w, phi, fr = _no_host_reads(lambda: ts.carrier_tracking_loop(p))
    hw, hphi, hfr = ts.carrier_tracking_loop(p.cpu())
    scale = float(hw.abs().mean())
    _close(w.cpu().numpy() / scale, hw.numpy() / scale, CARRIER_ATOL)
    _close(phi.cpu().numpy(), hphi.numpy(), CARRIER_PHASE_ATOL)
    _close(fr.cpu().numpy(), hfr.numpy(), CARRIER_FREQ_ATOL)
    bits, off, q = _no_host_reads(lambda: ts.nav_bit_sync(w, 20))
    hb, hoff, _ = ts.nav_bit_sync(w.cpu(), 20)
    assert torch.equal(bits.cpu(), hb) and int(off) == int(hoff)
