"""``acq.k2_roofline``: K2's share of its roofline in the traced requests.

The least time K2 could take for the traced requests (each: rows x bins x
non-coherent blocks of ``5 n log2 n + 10 n`` operations, or its bytes,
whichever bounds; ``roofline.py``) over the device time of the rows named
as K2's entries (``csrc/pcps_bins*.cu``)."""

from benchmark import roofline


def read(trace):
    k2_s = trace.device_s(roofline.K2_KERNELS)
    if k2_s <= 0 or trace.units <= 0:
        return None
    c = trace.counters
    flops = roofline.k2_flops(c["rows"], c["bins"], c["non_coherent"], c["n"])
    nbytes = roofline.k2_bytes(c["rows"], c["bins"], c["non_coherent"],
                               c["n"], c["phases"])
    return 100.0 * trace.units * roofline.bound_s(flops, nbytes) / k2_s
