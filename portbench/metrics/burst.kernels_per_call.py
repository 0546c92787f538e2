"""Burst link, ``models/packet.py`` and below: device kernels launched a
``rx_batch`` call, from the trace (the host's eager-op count)."""


def read(run):
    t = run.trace
    if t is None or not t.kernels or not t.units.get("calls"):
        return None
    return len(t.kernels) / t.units["calls"]
