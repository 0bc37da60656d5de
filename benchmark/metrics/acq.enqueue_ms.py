"""``acq.enqueue_ms``: the median host wall of the ``acquire`` call itself
over the window (it returns before the device finishes)."""

import statistics


def read(trace):
    spans = trace.spans.get("bench.acquire", [])
    return 1e3 * statistics.median(spans) if spans else None
