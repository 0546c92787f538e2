"""Device: the share of the traced window that no kernel or copy covers."""


def read(run):
    t = run.trace
    if t is None or not (t.kernels or t.copies):
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
