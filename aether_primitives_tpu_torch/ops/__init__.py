"""DSP ops on complex64 sample tensors: FFT, modulation, FIR, and the
hand-written CUDA kernels."""

from . import fft
from . import modulation
from . import fir
from . import cuda

__all__ = ["fft", "modulation", "fir", "cuda"]
