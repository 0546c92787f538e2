"""Bit-error-rate simulation against closed-form theory (PyTorch).

Counterpart of ``aether_primitives_tpu/models/ber.py``. For the generic
Gray constellations with per-component noise std ``sigma = sqrt(power)``:
QPSK ``BER = Q(1/sigma)`` (one sign decision a component); BPSK on the
diagonal pair ±(1+1j) ``BER = Q(sqrt(2)/sigma)``; square QAM the exact
Gray-coded PAM-per-axis expression (Cho & Yoon 2002). :func:`q_function`
and :func:`theoretical_ber` are plain float math, equal to the JAX
package's; :func:`simulate_ber` runs modulate -> AWGN -> demod on a device.
"""

from __future__ import annotations

import math

import torch

from ..ops import noise as _noise
from ..types import stage_device


def q_function(x: float) -> float:
    """Gaussian tail probability Q(x)."""
    return 0.5 * math.erfc(x / math.sqrt(2.0))


def _gray_pam_ber(m_axis: int, d_over_sigma: float) -> float:
    """Exact Gray-coded M-PAM bit error rate (Cho & Yoon 2002, eq. 16):
    ``d_over_sigma`` is the half-distance between adjacent levels over the
    per-component noise std. Averaged over the axis's ``log2(M)`` bits."""
    kbits = int(math.log2(m_axis))
    total = 0.0
    for k in range(1, kbits + 1):
        pk = 0.0
        top = int((1 - 2.0**-k) * m_axis)
        for i in range(top):
            f = math.floor(i * 2.0 ** (k - 1) / m_axis)
            weight = (-1.0) ** f * (
                2.0 ** (k - 1) - math.floor(i * 2.0 ** (k - 1) / m_axis + 0.5)
            )
            pk += weight * q_function((2 * i + 1) * d_over_sigma)
        total += (2.0 / m_axis) * pk
    return total / kbits


def theoretical_ber(modulation: str, power: float) -> float:
    """Closed-form BER of the generic constellations at noise ``power``
    (per-component variance): ``"qpsk"``, ``"bpsk"``, ``"qamN"`` (square)."""
    sigma = math.sqrt(power)
    if modulation == "qpsk":
        return q_function(1.0 / sigma)
    if modulation == "bpsk":
        return q_function(math.sqrt(2.0) / sigma)
    if modulation.startswith("qam") and modulation[3:].isdigit():
        order = int(modulation[3:])
        bits = int(math.log2(order))
        if 2**bits != order or bits % 2:
            raise ValueError(f"{modulation!r} is not a square QAM")
        m_axis = 2 ** (bits // 2)
        d = 1.0 / math.sqrt(2.0 * (m_axis**2 - 1) / 3.0)
        return _gray_pam_ber(m_axis, d / sigma)
    raise ValueError(f"no closed form for {modulation!r}")


def simulate_ber(modulation: str = "qpsk", powers=(0.25, 0.5, 1.0), n_bits: int = 1 << 20,
                 seed: int = 815, device="cuda"):
    """``[(power, simulated_ber, theoretical_ber)]`` over the noise powers:
    ``n_bits`` uniform bits a point (``torch.randint``, whole symbols only)
    -> modulate -> AWGN -> demod on ``device`` (the card by default), every
    draw from one ``torch.Generator`` seeded with ``seed``."""
    from .modem import _modulation_by_name

    dev = stage_device(device, "simulate_ber")
    m = _modulation_by_name(modulation)
    n_bits -= n_bits % m.bits_per_symbol
    g = _noise.make_generator(seed, dev)
    rows = []
    for p in powers:
        bits = torch.randint(0, 2, (n_bits,), generator=g, dtype=torch.uint8, device=dev)
        noisy = _noise.apply(g, m.modulate(bits), float(p), dev)
        ber = float((m.demod(noisy) != bits).float().mean())
        rows.append((float(p), ber, theoretical_ber(modulation, float(p))))
    return rows
