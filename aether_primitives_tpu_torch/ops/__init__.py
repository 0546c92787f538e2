"""DSP ops on complex64 sample tensors: FFT, modulation, FIR and FIR
design, the NCO mixer, vector ops, sequences, FEC (convolutional/Viterbi,
CRC, turbo), and the hand-written CUDA kernels."""

from . import fft
from . import modulation
from . import fir
from . import sequence
from . import cuda
from . import fec
from . import turbo
from . import firdes
from . import frontend
from . import vecops

__all__ = ["fft", "modulation", "fir", "sequence", "cuda", "fec", "turbo",
           "firdes", "frontend", "vecops"]
