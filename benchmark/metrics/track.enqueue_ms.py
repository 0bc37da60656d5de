"""``track.enqueue_ms``: the median host wall of one superblock's dispatch
(the input state's copy and ``StepGraph.run``: the graph's input copies
and its replay) over the window."""

import statistics


def read(trace):
    spans = trace.spans.get("bench.step", [])
    return 1e3 * statistics.median(spans) if spans else None
