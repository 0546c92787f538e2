"""DSP ops on complex64 sample tensors: FFT, modulation, FIR, sequences,
FEC (convolutional/Viterbi, CRC, turbo), and the hand-written CUDA
kernels."""

from . import fft
from . import modulation
from . import fir
from . import sequence
from . import cuda
from . import fec
from . import turbo

__all__ = ["fft", "modulation", "fir", "sequence", "cuda", "fec", "turbo"]
