"""DSP ops on complex64 sample tensors: FFT, modulation, FIR and FIR
design, IIR filters, the receiver front end (NCO mixer, DC, IQ imbalance,
AGC, blanker, squelch), the analog modes (FM, AM, SSB), vector ops, sequences, AWGN, resampling, FEC
(convolutional/Viterbi and soft-output BCJR, CRC, interleavers, turbo,
Reed-Solomon, BCH, turbo product, LDPC, NR LDPC and polar codes), and the
hand-written CUDA kernels. ``code_io`` (code tables from files) is imported
as a module, as in the JAX package."""

from . import fft
from . import modulation
from . import fir
from . import sequence
from . import cuda
from . import fec
from . import ldpc
from . import nr_ldpc
from . import rs
from . import bch
from . import tpc
from . import turbo
from . import polar
from . import firdes
from . import frontend
from . import vecops
from . import noise
from . import sampling
from . import analog
from . import iir

__all__ = ["fft", "modulation", "fir", "sequence", "cuda", "fec", "ldpc", "nr_ldpc", "rs", "bch",
           "tpc", "turbo", "polar", "firdes", "frontend", "vecops", "noise", "sampling", "analog",
           "iir"]
