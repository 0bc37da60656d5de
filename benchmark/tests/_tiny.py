"""The benchmark's cells cut to a size the CPU tests can hold.

The configurations, traffic and limits of ``BENCHMARK.json``'s cells,
with the sampling rate at 2.046 Msps, four PRN channels, two visible
satellites at 46-50 dB-Hz, 5-block superblocks, a 1 s pool and three
snapshots. On CPU tensors the receiver runs its plain PyTorch versions of
the kernels.
"""

from __future__ import annotations

import copy
import time

import torch

from benchmark import harness

CRUISE = "track.cruise.l1ca_4msps"
COLD = "acq.cold.l1ca_16368ksps"
SEED = 2**31 + 11

# The test workers share the machine's cores.
torch.set_num_threads(2)


def spec(workload: str) -> dict:
    s = copy.deepcopy(harness.cell_spec(workload))
    s["config"].update(sampling_frequency=2.046e6, prns=[1, 2, 3, 4])
    s["config"]["cruise"]["superblock"] = 5
    s["traffic"].update(pool=3, pool_s=1.0, pullin_max_s=3.0, compare=2,
                        trace_units=3)
    s["traffic"]["sky"].update(cn0_dbhz=[46.0, 50.0], visible=(
        {"prns": [2, 4]} if workload == CRUISE else [2, 2]))
    return s


def run(workload: str, trace: bool = False, seconds: float = 0.6,
        seed: int = SEED):
    """One run of the tiny cell on the CPU: (result, stderr lines)."""
    return harness.run(spec(workload), seed, seconds, trace, "cpu",
                       time.perf_counter())
