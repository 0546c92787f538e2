"""End-to-end QPSK modem loopback on the PyTorch/CUDA port, the port's twin
of ``examples/modem.py``: random bits -> QPSK -> AWGN(0.01) -> hard demod
-> bit-exact assert -> time + constellation plots.

Runs on the card; ``--cpu`` asks for the CPU.

Run: python examples/torch_modem.py [--cpu] [--plot out_prefix]
"""

import os
import sys

try:  # a bare, offline clone: the package is the repo root's
    import aether_primitives_tpu_torch  # noqa: F401
except ModuleNotFoundError:
    sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    from aether_primitives_tpu_torch.models import Modem, ModemConfig
    from aether_primitives_tpu_torch.ops import modulation, noise

    device = "cpu" if "--cpu" in sys.argv else "cuda"
    rng = np.random.default_rng()
    bits = rng.integers(0, 2, 100).astype(np.uint8)
    print(f"Input bits: {bits.tolist()}")

    m = modulation.qpsk()
    symbols = m.modulate(bits).to(device)
    n = noise.new(0.01, 815, device=device)
    noisy = n.apply(symbols)
    out_bits = m.demod(noisy).cpu().numpy()
    assert (out_bits == bits).all(), "loopback not bit-exact"
    print("Demodulated bits match input — loopback bit-exact.")

    # the same thing as one modem call on the device
    modem = Modem(ModemConfig(noise_power=0.01, seed=815), device=device)
    fused = modem.loopback(bits).cpu().numpy()
    assert (fused == bits).all()
    print(f"Modem loopback on {modem.device} bit-exact.")

    if "--plot" in sys.argv:
        prefix = sys.argv[sys.argv.index("--plot") + 1]
        from aether_primitives_tpu_torch.utils import plot

        noisy_np = noisy.cpu().numpy()
        plot.time(noisy_np, "m", f"{prefix}_time.png")
        plot.constellation(noisy_np, "Modulated bits", f"{prefix}_constellation.png")
        print(f"Wrote {prefix}_time.png, {prefix}_constellation.png")


if __name__ == "__main__":
    main()
