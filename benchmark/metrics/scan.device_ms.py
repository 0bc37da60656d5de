"""``scan.device_ms``: device-busy milliseconds per traced 1 s superblock
of the scan runtime (its scan kernel launches, the state's packing and the
window and output copies)."""


def read(trace):
    if not trace.events or trace.units <= 0:
        return None
    return 1e3 * trace.busy_s / trace.units
