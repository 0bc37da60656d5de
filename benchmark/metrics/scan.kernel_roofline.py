"""``scan.kernel_roofline``: the scan kernel's share of its bound in the
traced superblocks.

The least time a block of ``csrc/scan_block.cu`` could take
(``scan_roofline.scan_bound_s``: operations, bytes or the carried chain of
its epochs, whichever is largest) over the device time of
``scan_block_kernel`` a block."""

from benchmark import scan_roofline


def read(trace):
    kernel_s = trace.device_s(scan_roofline.KERNEL)
    if kernel_s <= 0 or trace.units <= 0:
        return None
    c = trace.counters
    per_block = scan_roofline.scan_bound_s(
        c["tracking_channels"], c["channels"], c["block_ms"], c["spms"],
        c["taps"], c["window_samples"])
    return 100.0 * trace.units * c["blocks"] * per_block / kernel_s
