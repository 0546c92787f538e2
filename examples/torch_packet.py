"""Packet-link demo on the PyTorch/CUDA port, the port's twin of
``examples/packet.py``: the full burst transceiver over a hostile channel.

One PacketModem burst (CRC-32 -> DVB scrambler -> K=7 Viterbi FEC ->
interleaver -> QPSK behind a Gold-code preamble) is dropped at an unknown
offset into a long capture, scaled/rotated by an unknown complex gain,
spun by a carrier offset, and buried in AWGN. The receiver acquires,
corrects, decodes (the Viterbi kernel on a card) and verifies the CRC.

Runs on the card; ``--cpu`` asks for the CPU.

Run: python examples/torch_packet.py [--cpu]
"""

import os
import sys

try:  # a bare, offline clone: the package is the repo root's
    import aether_primitives_tpu_torch  # noqa: F401
except ModuleNotFoundError:
    sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    from aether_primitives_tpu_torch.models.packet import PacketConfig, PacketModem

    device = "cpu" if "--cpu" in sys.argv else "cuda"
    rng = np.random.default_rng(815)
    pm = PacketModem(PacketConfig(payload_bits=960, fec="viterbi", interleave_rows=4),
                     device=device)
    payload = rng.integers(0, 2, 960).astype(np.uint8)
    burst = pm.tx(payload).cpu().numpy()
    print(f"burst: {burst.size} symbols "
          f"({pm.preamble.size} preamble + {pm.n_data_symbols} data)")

    # hostile channel: unknown delay, gain, carrier offset, heavy AWGN
    capture = np.zeros(8192, np.complex64)
    delay, cfo, gain = 2741, 1.7e-3, 0.31 * np.exp(1j * 2.4)
    capture[delay:delay + burst.size] = burst
    capture *= gain * np.exp(2j * np.pi * cfo * np.arange(capture.size))
    capture += 0.15 * (rng.normal(size=capture.size) + 1j * rng.normal(size=capture.size))
    capture = capture.astype(np.complex64)

    bits, ok, diag = pm.rx(capture)
    errs = int((bits.cpu().numpy() != payload).sum())
    print(f"offset: {int(diag['offset'])} (true {delay})")
    print(f"cfo: {float(diag['cfo']):.6f} cyc/sample (true {cfo})")
    print(f"gain magnitude: {abs(complex(diag['gain'].cpu())):.3f} (true {abs(gain):.3f})")
    print(f"preamble metric: {float(diag['metric']):.3f}, "
          f"est. noise var: {float(diag['noise_var']):.3f}")
    print(f"CRC ok: {bool(ok)}; payload bit errors: {errs}/960 (on {pm.device})")
    assert bool(ok) and errs == 0
    print("packet recovered exactly")


if __name__ == "__main__":
    main()
