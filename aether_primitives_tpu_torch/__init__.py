"""aether-primitives-tpu, ported to PyTorch and CUDA.

Five paths of ``aether_primitives_tpu`` on PyTorch, each through
hand-written CUDA kernels for Hopper (sm_90a): the streaming receive chain
(causal FIR, decimation, per-frame FFT, hard demod, LSB-first byte packing;
the RX frame kernel); the same chain fed from host memory by the
bounded-depth streaming executors; the batched burst link (``PacketModem``
with Viterbi or turbo FEC; the Viterbi and BCJR kernels); the wideband
front end (the oversampled PFB channelizers and the DDC; the PFB fold
kernel); and the sharded forms of these paths over a mesh of devices in one
process (:mod:`.parallel.mesh`), whose halo exchange is a peer-push kernel.
The package imports torch and numpy only; the JAX package stays the
reference that the tests hold this one against.

Numeric contract: :func:`assert_evm` at -80 dB, as in the JAX package.
"""

from .types import cf32, cf64, as_cf32
from .boundary import Split, split, merge, f32_boundary
from .evm import assert_evm, evm, evm_db, evm_rms_db
from . import ops
from . import parallel
from . import utils
from . import models
from .ops import vecops, fft, modulation, sequence, fir, frontend, fec
from .ops.vecops import CVec
from .ops.fft import Scale, Fft, plan as fft_plan
from .models import PacketConfig, PacketModem, RxChain, RxChainConfig

__version__ = "0.3.0"

__all__ = [
    "cf32",
    "cf64",
    "as_cf32",
    "Split",
    "split",
    "merge",
    "f32_boundary",
    "assert_evm",
    "evm",
    "evm_db",
    "evm_rms_db",
    "CVec",
    "Scale",
    "Fft",
    "fft_plan",
    "ops",
    "parallel",
    "utils",
    "models",
    "vecops",
    "fft",
    "modulation",
    "sequence",
    "fir",
    "frontend",
    "fec",
    "RxChain",
    "RxChainConfig",
    "PacketConfig",
    "PacketModem",
]
