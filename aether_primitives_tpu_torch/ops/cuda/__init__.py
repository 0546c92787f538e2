"""Hand-written CUDA kernels (sm_90a) and their plain PyTorch versions.

Importing this package builds nothing: a kernel is compiled at its first
launch (:mod:`.build`)."""

#: Device memory of one H100 (80 GB): the limit the kernels' plans name
#: where a geometry's device scratch grows with it (the wrappers hold a
#: call against its own card's ``total_memory``).
CARD_BYTES = 80 * 10**9

from . import bcjr, cmul, halo, pfb_fold, rx_frame, stream, viterbi

__all__ = ["bcjr", "cmul", "halo", "pfb_fold", "rx_frame", "stream", "viterbi"]
