"""Frame op kernel, ``ops/cuda/rx_frame.py`` -> ``csrc/rx_frame.cu``: the
bound of one launch over the cell's rows and block (``reference/roofline.py``)
over the mean device time of the kernels named ``rx_frame*`` in the trace."""

from portbench.reference.roofline import rx_frame_bound


def read(run):
    if run.trace is None:
        return None
    us = run.trace.kernel_times("rx_frame")
    if not us:
        return None
    s = run.shapes
    b = rx_frame_bound(s["rows"], s["block"], s["decimation"], s["fft_len"], s["taps"])
    return 100.0 * b["bound_ms"] / (sum(us) / len(us) / 1e3)
