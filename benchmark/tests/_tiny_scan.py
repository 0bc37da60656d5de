"""The scan cell cut to a size the CPU tests can hold, as ``_tiny`` cuts
the others: 2.046 Msps, four PRN channels, two visible satellites at 46-50
dB-Hz, 5-block superblocks, a 1 s pool. On CPU tensors the receiver runs
the scan runtime's plain version."""

from __future__ import annotations

import copy
import time

from benchmark import harness
from benchmark.tests import _tiny  # noqa: F401  (sets the CPU threads)

SCAN = "track.scan.l1ca_10msps"
SEED = _tiny.SEED


def spec() -> dict:
    s = copy.deepcopy(harness.cell_spec(SCAN))
    s["config"].update(sampling_frequency=2.046e6, prns=[1, 2, 3, 4])
    s["config"]["cruise"]["superblock"] = 5
    s["traffic"].update(pool_s=1.0, pullin_max_s=4.0, compare=2,
                        trace_units=3)
    s["traffic"]["sky"].update(cn0_dbhz=[46.0, 50.0],
                               visible={"prns": [2, 4]})
    return s


def run(trace: bool = False, seconds: float = 0.6, seed: int = SEED):
    """One run of the tiny cell on the CPU: (result, stderr lines)."""
    return harness.run(spec(), seed, seconds, trace, "cpu",
                       time.perf_counter())
