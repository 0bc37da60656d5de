"""Host spans, the traced part of a window, and what the readers read.

A :class:`Tracer` times the engine's host spans (``span``) over the whole
window and, in a traced run (``--trace 1``), runs ``torch.profiler`` over a
stretch of whole units (superblocks, requests) that the engine marks with
``start`` and ``stop``. :meth:`Tracer.result` reduces that stretch to a
:class:`Trace`: the device's rows (kernels and copies, CUPTI's records,
graph replays included), the host spans, the count of units and the
engine's counters. Each per-layer metric's reader
(``metrics/<name>.py``, ``read(trace) -> float | None``) takes its number
from a :class:`Trace`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
import time


@dataclasses.dataclass
class Trace:
    events: list                 # (start_us, end_us, name) on the device
    host: list                   # (start_us, end_us, name) host spans
    spans: dict                  # span name -> host seconds of each, window
    units: int                   # whole units inside the traced stretch
    window_s: float              # host seconds of the traced stretch
    counters: dict               # the engine's counts (work per unit, ...)

    @property
    def busy_s(self) -> float:
        """Seconds in which some kernel or copy ran (union of rows)."""
        return sum(hi - lo for lo, hi in merged(self.events)) / 1e6

    def device_s(self, pattern: str) -> float:
        """Device seconds of the rows whose name matches ``pattern``."""
        rx = re.compile(pattern)
        return sum(hi - lo for lo, hi, name in self.events
                   if rx.search(name)) / 1e6


def merged(events) -> list:
    """The union of the rows' intervals, in order."""
    out: list = []
    for lo, hi, _ in sorted(events):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def idle_pct(trace: Trace) -> float | None:
    """The share of the traced stretch with nothing on the device."""
    if not trace.events or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle gaps
    named by the host span that was open in their middle."""
    by_name: dict = {}
    for lo, hi, name in trace.events:
        by_name[name] = by_name.get(name, 0.0) + (hi - lo) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = []
    busy = merged(trace.events)
    for (_, a), (b, _) in zip(busy, busy[1:]):
        mid = 0.5 * (a + b)
        open_spans = [(lo, name) for lo, hi, name in trace.host
                      if lo <= mid <= hi]
        label = max(open_spans)[1] if open_spans else "host (no span)"
        gaps.append([label, (b - a) / 1e6])
    gaps.sort(key=lambda g: -g[1])
    return {"device_ops": [[n[:120], s] for n, s in ops],
            "idle_gaps": gaps[:top]}


class Tracer:
    """Host spans of one window and, when ``enabled``, the profiler over the
    stretch between :meth:`start` and :meth:`stop`."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.spans: dict = {}
        self.counters: dict = {}
        self._prof = None
        self._t0 = 0.0
        self._trace: Trace | None = None

    @property
    def active(self) -> bool:
        return self._prof is not None

    @contextlib.contextmanager
    def span(self, name: str):
        """Time a host span; inside the traced stretch also mark it on the
        profiler's timeline."""
        t0 = time.perf_counter()
        if self._prof is not None:
            import torch

            with torch.profiler.record_function(name):
                yield
        else:
            yield
        self.spans.setdefault(name, []).append(time.perf_counter() - t0)

    def warm(self) -> None:
        """Start the profiler once on a trivial op, so that its first start
        (CUPTI's set-up, seconds) falls in set-up and not in the window."""
        if not self.enabled:
            return
        import torch

        self.start()
        torch.ones(1, device="cuda" if torch.cuda.is_available() else "cpu")
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        prof.events()

    def start(self) -> None:
        """Open the traced stretch (a traced run only), device idle."""
        if not self.enabled or self._prof is not None:
            return
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        self._t0 = time.perf_counter()

    def stop(self, units: int) -> None:
        """Close the traced stretch after ``units`` whole units."""
        if self._prof is None:
            return
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        window_s = time.perf_counter() - self._t0
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        dev, host = [], []
        for e in prof.events():
            row = (e.time_range.start, e.time_range.end, e.key)
            if e.device_type == torch.autograd.DeviceType.CUDA:
                if not getattr(e, "is_user_annotation", False) \
                        and not e.key.startswith("bench."):
                    dev.append(row)
            elif e.key.startswith("bench."):
                host.append(row)
        self._trace = Trace(dev, host, self.spans, units, window_s,
                            self.counters)

    def result(self) -> Trace | None:
        """The traced stretch (its spans run on to the window's end)."""
        return self._trace
