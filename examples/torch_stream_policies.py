"""Stream edge policies and emission formats on the PyTorch/CUDA port, the
port's twin of ``examples/stream_policies.py``: what happens when a capture
doesn't divide the frame span, and how bit emission works.

- strict default: a precise error names the policy options;
- ``step_ragged``: demodulate every complete frame, carry the remainder
  (drop-free: the streaming receiver's policy);
- ``step_padded``: zero-pad the tail frame (the reference waterfall's
  convention);
- ``packed_bits``: MAC-layer byte emission (8 bits LSB-first).

Runs on the card; ``--cpu`` asks for the CPU.

Run: python examples/torch_stream_policies.py [--cpu]
"""

import os
import sys

try:  # a bare, offline clone: the package is the repo root's
    import aether_primitives_tpu_torch  # noqa: F401
except ModuleNotFoundError:
    sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    from aether_primitives_tpu_torch.models import RxChain, RxChainConfig

    device = "cpu" if "--cpu" in sys.argv else "cuda"
    chain = RxChain(RxChainConfig(fft_len=128, decimation=4, fir_mode="os"), device=device)
    span = chain.frame_span
    rng = np.random.default_rng(3)
    n = 3 * span + 217  # ragged on purpose
    x = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)

    try:
        chain.step(x)
    except ValueError as e:
        print(f"strict default: {str(e)[:84]}...")

    bits, tail = chain.step_ragged(x)
    print(f"step_ragged: {bits.shape[-1]} bits from 3 whole frames, "
          f"{tail.shape[-1]}-sample remainder carried")
    # the carried tail prepends to the next capture: nothing dropped
    y = (rng.normal(size=2 * span - 217)
         + 1j * rng.normal(size=2 * span - 217)).astype(np.complex64)
    bits2, tail2 = chain.step_ragged(np.concatenate([tail.cpu().numpy(), y]))
    assert tail2.shape[-1] == 0
    print(f"  ... next capture consumed the remainder: +{bits2.shape[-1]} bits, no leftover")

    padded = chain.step_padded(x)
    print(f"step_padded: {padded.shape[-1]} bits "
          f"({-(-n // span)} frames incl. the zero-padded tail)")

    packed = RxChain(RxChainConfig(fft_len=128, decimation=4, fir_mode="os",
                                   packed_bits=True), device=device)
    xb = x[:3 * span]
    flat = chain.step(xb).cpu().numpy()
    bytes_out = packed.step(xb).cpu().numpy()
    assert np.array_equal(np.unpackbits(bytes_out, bitorder="little"), flat)
    print(f"packed_bits: {flat.shape[-1]} bits -> {bytes_out.shape[-1]} bytes, "
          f"unpackbits-identical (on {packed.device})")
    print("stream_policies: OK")


if __name__ == "__main__":
    main()
