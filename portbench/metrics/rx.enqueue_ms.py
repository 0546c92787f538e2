"""RX chain step, ``models/modem.py``: the host's time to enqueue one
``RxChain.streaming_step`` call, the median over the untraced window's
steps, from the benchmark's own host span around each call."""

import statistics


def read(run):
    spans = run.spans.get("rx.step")
    return statistics.median(spans) * 1e3 if spans else None
