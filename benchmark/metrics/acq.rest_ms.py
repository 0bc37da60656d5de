"""``acq.rest_ms``: device-busy milliseconds per traced request outside K2
(the forward spectra's mixing and ``torch.fft``, the coherent sum, the peak
metric, the copies)."""

from benchmark import roofline
from benchmark.trace import Trace


def read(trace: Trace):
    if not trace.events or trace.units <= 0:
        return None
    k2_s = trace.device_s(roofline.K2_KERNELS)
    return 1e3 * (trace.busy_s - k2_s) / trace.units
