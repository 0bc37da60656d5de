"""``track.k1_roofline``: K1's share of its roofline in the traced
superblocks.

The least time K1 could take (``roofline.stream_flops`` over the samples
of the tracking channels' epochs, or its bytes, whichever bounds) over the
device time of ``epoch_correlate_kernel`` (``csrc/epoch_correlate.cu``)."""

from benchmark import roofline


def read(trace):
    k1_s = trace.device_s(roofline.K1_KERNELS)
    if k1_s <= 0 or trace.units <= 0:
        return None
    c = trace.counters
    samples = c["tracking_channels"] * c["block_ms"] * c["spms"]
    per_block = roofline.bound_s(
        roofline.stream_flops(samples, c["taps"]),
        roofline.k1_bytes(c["window_samples"], c["channels"], c["block_ms"],
                          c["taps"]))
    return 100.0 * trace.units * c["blocks"] * per_block / k1_s
