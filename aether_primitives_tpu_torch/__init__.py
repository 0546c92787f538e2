"""aether-primitives-tpu, ported to PyTorch and CUDA.

Two paths of ``aether_primitives_tpu`` on PyTorch: the streaming receive
chain (causal FIR, decimation, per-frame FFT, hard demod, LSB-first byte
packing), with its frame op as a hand-written CUDA kernel for Hopper
(sm_90a), and the batched burst link (``PacketModem`` with Viterbi or turbo
FEC), with hand-written Viterbi and BCJR kernels. The package imports torch
and numpy only; the JAX package stays the reference that the tests hold
this one against.

Numeric contract: :func:`assert_evm` at -80 dB, as in the JAX package.
"""

from .types import cf32, as_cf32
from .boundary import Split, split, merge
from .evm import assert_evm, evm, evm_db, evm_rms_db
from . import ops
from . import models
from .ops import fft, modulation, fir
from .ops.fft import Scale, Fft, plan as fft_plan
from .models import PacketConfig, PacketModem, RxChain, RxChainConfig

__version__ = "0.3.0"

__all__ = [
    "cf32",
    "as_cf32",
    "Split",
    "split",
    "merge",
    "assert_evm",
    "evm",
    "evm_db",
    "evm_rms_db",
    "Scale",
    "Fft",
    "fft_plan",
    "ops",
    "models",
    "fft",
    "modulation",
    "fir",
    "RxChain",
    "RxChainConfig",
    "PacketConfig",
    "PacketModem",
]
