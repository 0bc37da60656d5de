"""``track.device_ms``: device-busy milliseconds per traced superblock
(passes A/B/C of every block in the step graph, the state's packing, the
window and output copies)."""


def read(trace):
    if not trace.events or trace.units <= 0:
        return None
    return 1e3 * trace.busy_s / trace.units
