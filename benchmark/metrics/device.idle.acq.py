"""``device.idle.acq``: the share of the traced stretch of acquisition
requests in which no kernel or copy ran on the device."""

from benchmark.trace import idle_pct


def read(trace):
    return idle_pct(trace)
