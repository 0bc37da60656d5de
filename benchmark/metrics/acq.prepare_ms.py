"""``acq.prepare_ms``: the median host milliseconds of ``acquire``'s
``sydr.acq.prepare`` span over the traced requests: the code spectra and
the Doppler bins to the device and the shift plan, with any wait on the
device that an upload makes."""

import statistics


def read(trace):
    try:
        from sydr_tpu_torch.utils.metrics import RECORDER
    except ImportError:         # a program without the recorder
        return None
    spans = RECORDER.find("sydr.acq.prepare")
    return statistics.median(s.host_ms for s in spans) if spans else None
