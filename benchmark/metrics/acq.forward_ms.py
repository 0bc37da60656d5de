"""``acq.forward_ms``: the median device-busy milliseconds of a traced
request's forward spectra (the mixing, the transforms and the coherent
sum: ``sydr.acq.spectra``'s kernels), read from the trace. On the one
stream a request's rows run in order: its uploads to the device, the
forward spectra, K2, the peak metric, the results' copies to the host. So
the forward spectra are the rows other than copies from a request's first
upload to its first K2 row."""

import re
import statistics

from benchmark import roofline
from benchmark.trace import Trace, merged


def per_request(events) -> list:
    """Device-busy ms of each request's forward spectra, in order."""
    k2 = re.compile(roofline.K2_KERNELS)
    out = []
    rows = None                 # since the request's first upload
    for lo, hi, name in sorted(events):
        if name.startswith("Memcpy HtoD"):
            if rows is None:
                rows = []
        elif k2.search(name):
            if rows:
                out.append(sum(b - a for a, b in merged(rows)) / 1e3)
            rows = None
        elif rows is not None and not name.startswith(("Memcpy", "Memset")):
            rows.append((lo, hi, name))
    return out


def read(trace: Trace):
    ms = per_request(trace.events)
    return statistics.median(ms) if ms else None
