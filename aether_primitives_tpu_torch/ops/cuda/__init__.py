"""Hand-written CUDA kernels (sm_90a) and their plain PyTorch versions.

Importing this package builds nothing: a kernel is compiled at its first
launch (:mod:`.build`)."""

from . import bcjr, pfb_fold, rx_frame, viterbi

__all__ = ["bcjr", "pfb_fold", "rx_frame", "viterbi"]
