"""Executor and host-to-device copy, ``parallel/streaming.py``: device
milliseconds of a block's HtoD copy, the mean over the traced window."""


def read(run):
    if run.trace is None:
        return None
    us = run.trace.copy_times("HtoD")
    return sum(us) / len(us) / 1e3 if us else None
