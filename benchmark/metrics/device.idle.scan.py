"""``device.idle.scan``: the share of the traced stretch of scan
superblocks in which no kernel or copy ran on the device."""

from benchmark.trace import idle_pct


def read(trace):
    return idle_pct(trace)
