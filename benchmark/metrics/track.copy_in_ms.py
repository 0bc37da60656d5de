"""``track.copy_in_ms``: the median host milliseconds of
``StepGraph.run``'s ``sydr.step.copy_in`` span over the traced
superblocks: the copies of the arguments into the graph's input
buffers."""

import statistics


def read(trace):
    try:
        from sydr_tpu_torch.utils.metrics import RECORDER
    except ImportError:         # a program without the recorder
        return None
    spans = RECORDER.find("sydr.step.copy_in")
    return statistics.median(s.host_ms for s in spans) if spans else None
