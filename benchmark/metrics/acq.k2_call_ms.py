"""``acq.k2_call_ms``: the median host milliseconds of ``acquire``'s
``sydr.acq.k2`` span over the traced requests: K2's launch arguments, the
plan tables, the output's allocation and the launch, with any wait on the
device among them."""

import statistics


def read(trace):
    try:
        from sydr_tpu_torch.utils.metrics import RECORDER
    except ImportError:         # a program without the recorder
        return None
    spans = RECORDER.find("sydr.acq.k2")
    return statistics.median(s.host_ms for s in spans) if spans else None
