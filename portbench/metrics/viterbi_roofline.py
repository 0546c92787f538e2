"""Decoder kernels, ``ops/cuda/viterbi.py`` -> ``csrc/viterbi.cu``: the
bound of a call's trellises counted on the frame's steps (bursts x coded
steps a burst, not spans x (window + guards), so a change to the windowing
changes the time and not the count) over the device time of the kernels
named ``viterbi*`` a call."""

from portbench.reference.burst_rx import _trellis
from portbench.reference.roofline import viterbi_bound


def read(run):
    t = run.trace
    if t is None or not t.units.get("calls"):
        return None
    us = t.kernel_times("viterbi")
    if not us:
        return None
    s = run.shapes
    _pred, pat = _trellis(s["polys"], s["constraint"])
    b = viterbi_bound(s["bursts"], s["coded_steps"], len(s["polys"]),
                      1 << (s["constraint"] - 1), len(set(pat.ravel().tolist())))
    return 100.0 * b["bound_ms"] / (sum(us) / t.units["calls"] / 1e3)
