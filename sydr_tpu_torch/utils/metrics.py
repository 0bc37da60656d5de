"""The program's recorder: spans, counters and per-stage timing.

Restores (and extends) the reference's vestigial per-stage profiling — the
v1 channels stamped ``processTimeNanos`` into every packet and the report
aggregated it (``sydr/old/channel_abstract.py:298``,
``io/visualisation.py:860-879``).

A span (:func:`span`) times one stretch of host code: its name, host start
and end (``time.perf_counter_ns``), the span that was open around it (its
parent), a request id that every span of one call shares, the host's waits
on the device made inside it and not inside a child (``syncs``, below),
and any attributes the caller gives (``searches``, ``nodes``). CUDA work
is asynchronous, so a span's host time is the time to enqueue its work
plus any wait on the device: a span that waits shows the wait both in its
host time and in ``syncs``. A span opened with ``device=`` a CUDA device
also brings a pair of timing events on that device's current stream;
``Span.device_ms`` is the device's time from the first to the second, its
idle time included, read once the device has passed them.

Rule 1: the recorder is off by default. Off, :func:`span` costs a flag
check and a ``torch.autograd._profiler_enabled()`` call and returns a
shared null context: it records nothing, opens no profiler range, records
no CUDA event and touches no debug mode.

Rule 2: spans record while :func:`enable` holds or while a
``torch.profiler`` session records on the thread. So every profile of the
program carries its spans. A span opened inside another records into that
span's recorder; a span with no parent into :data:`RECORDER`. A stage
(:meth:`StageTimers.time`, the ``Receiver``'s ``track_block``, ``decode``
and ``measure``) is timed whether or not spans record: off, it takes only
its host start and end; on, it is a span like any other and the parent of
the program's spans inside it.

Rule 3: while a profiler records, a span opens a
``torch.profiler.record_function`` range of its name: it sits on the
profiler's clock beside the kernels it launched, so :func:`device_trace`
shows each idle gap under the program's span. A span that records also
counts the host's waits on the device, as far as PyTorch's sync debug mode
reports them: the outermost open span sets
``torch.cuda.set_sync_debug_mode("warn")`` (when CUDA is initialised and
the mode is the default) and takes PyTorch's "called a synchronizing CUDA
operation" warnings, each counted against the innermost open span of its
thread and not shown; other warnings pass on as before. That mode reports
the implicit waits of PyTorch's own operations (``.item()``, a blocking
copy to or from pageable memory, ...), not ``torch.cuda.synchronize()``,
``Event.synchronize()`` nor a wait inside a kernel library called through
``ctypes``; and a span that opens before CUDA is initialised counts none.
The mode and Python's warnings filters are the process's: while a span is
open on one thread, another thread's waits are neither counted nor shown,
and a filter that code inside the outermost span adds ends with it.

A recorder keeps its spans in a ring (the last :data:`RING`) and a running
summary by name that never drops one (count, total, largest, syncs), so a
long run does not grow it: :meth:`StageTimers.summary`, :meth:`report` and
:meth:`store` (the results database's ``timing`` rows) read the summary.
:func:`device_trace` wraps a ``torch.profiler`` trace for device-level
analysis.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import math
import threading
import time
import warnings

import torch

# Spans a recorder keeps in memory; its summary keeps every one.
RING = 65536

# The warning ``set_sync_debug_mode("warn")`` gives at each wait.
SYNC_WARNING = "called a synchronizing CUDA operation"
SYNC_MODE_WARNING = "Synchronization debug mode is a prototype feature"

_profiler_enabled = torch.autograd._profiler_enabled
_ids = itertools.count(1)
_enabled = False                # enable()


class _Local(threading.local):
    top = None                  # the innermost open span on this thread


_local = _Local()


class _NullSpan:
    """What :func:`span` returns while the recorder is off."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


NULL_SPAN = _NullSpan()


class Span:
    """One span: a context manager that records itself into its recorder
    when it closes (see the module note). A ``bare`` span (a stage while
    spans do not record) takes only its host start and end."""

    __slots__ = ("recorder", "name", "id", "parent", "request", "start_ns",
                 "end_ns", "syncs", "attrs", "bare", "_events", "_device_ms",
                 "_range", "_sync", "_outer")

    def __init__(self, recorder, name, device, request, attrs, bare=False):
        self.recorder = recorder
        self.name = name
        self.id = next(_ids)
        self.request = request
        self.attrs = attrs
        self.bare = bare
        self.syncs = 0
        self.parent = None
        self.start_ns = self.end_ns = 0
        self._device_ms = None
        self._events = None
        if device is not None and torch.device(device).type == "cuda":
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True), device)

    def set(self, **attrs) -> None:
        """Add attributes (a count known only once the work is done)."""
        self.attrs.update(attrs)

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    @property
    def device_ms(self) -> float | None:
        """Milliseconds between the span's two events on the device (its
        kernels and any idle between them); None for a span without
        events, or while the device has not reached the second."""
        if self._device_ms is None and self._events is not None:
            start, end, _ = self._events
            if end.query():
                self._device_ms = start.elapsed_time(end)
                self._events = None
        return self._device_ms

    def __enter__(self):
        if self.bare:
            self.start_ns = time.perf_counter_ns()
            return self
        outer = _local.top
        self._outer = outer
        if outer is not None:
            self.parent = outer.id
            self.request = outer.request
        elif self.request is None:
            self.request = next(self.recorder._requests)
        self._sync = None if outer is not None else _SyncCount().open()
        _local.top = self
        self._range = None
        if _profiler_enabled():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        if self._events is not None:
            start, _, device = self._events
            start.record(torch.cuda.current_stream(device))
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        if self.bare:
            self.recorder._add(self)
            return False
        if self._events is not None:
            _, end, device = self._events
            end.record(torch.cuda.current_stream(device))
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        _local.top = self._outer
        self._outer = None
        if self._sync is not None:
            self._sync.close()
            self._sync = None
        self.recorder._add(self)
        return False


class _SyncCount:
    """The host's waits on the device while the outermost span is open:
    PyTorch's sync-debug warnings, counted against the innermost open span
    of the thread and not shown."""

    def open(self):
        self._catch = warnings.catch_warnings()
        self._catch.__enter__()
        warnings.filterwarnings("always", message=SYNC_WARNING)
        # What PyTorch says once of the mode itself.
        warnings.filterwarnings("ignore", message=SYNC_MODE_WARNING)
        mode = None
        if torch.cuda.is_initialized() \
                and torch.cuda.get_sync_debug_mode() == 0:
            mode = 0
            torch.cuda.set_sync_debug_mode("warn")
        self._mode = mode
        shown = warnings.showwarning

        def show(message, category, filename, lineno, file=None, line=None):
            if str(message).startswith(SYNC_WARNING):
                top = _local.top
                if top is not None:
                    top.syncs += 1
                    return
                if mode is not None:    # said only because the span set it
                    return
            shown(message, category, filename, lineno, file, line)

        warnings.showwarning = show
        return self

    def close(self) -> None:
        if self._mode is not None:
            torch.cuda.set_sync_debug_mode(self._mode)
        self._catch.__exit__(None, None, None)


class StageTimers:
    """A recorder of spans, stages and counters (see the module note)."""

    def __init__(self):
        self.spans: collections.deque = collections.deque(maxlen=RING)
        self.counters: dict[str, int] = {}
        # name -> [count, total s, total s^2, largest s, syncs]
        self._totals: dict[str, list] = {}
        self._requests = itertools.count()

    def time(self, stage: str) -> Span:
        """Time a stage of this recorder: always its host time; while spans
        record, a span of its own (the parent of the spans inside it)."""
        return Span(self, stage, None, None, {},
                    bare=not _enabled and not _profiler_enabled())

    def _bump(self, name: str, n: int) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def _add(self, span: Span) -> None:
        self.spans.append(span)
        s = (span.end_ns - span.start_ns) / 1e9
        tot = self._totals.get(span.name)
        if tot is None:
            tot = self._totals[span.name] = [0, 0.0, 0.0, 0.0, 0]
        tot[0] += 1
        tot[1] += s
        tot[2] += s * s
        tot[3] = max(tot[3], s)
        tot[4] += span.syncs

    # -- reading ----------------------------------------------------------
    def find(self, name: str) -> list[Span]:
        """The ring's spans named ``name``, oldest first."""
        return [s for s in self.spans if s.name == name]

    def trees(self, name: str) -> list[list[Span]]:
        """Each of the ring's spans named ``name`` with every span under
        it (children close before their parent, so they come first)."""
        parent = {s.id: s.parent for s in self.spans}
        roots = {s.id: [] for s in self.spans if s.name == name}
        for s in self.spans:
            up = s.id
            while up is not None and up not in roots:
                up = parent.get(up)
            if up is not None:
                roots[up].append(s)
        return list(roots.values())

    def summary(self) -> dict[str, dict[str, float]]:
        out = {}
        for name, (n, total, sq, top, syncs) in self._totals.items():
            mean = total / n
            out[name] = {
                "count": n,
                "mean_ms": mean * 1e3,
                "std_ms": math.sqrt(max(sq / n - mean * mean, 0.0)) * 1e3,
                "max_ms": top * 1e3,
                "total_s": total,
                "syncs": syncs,
            }
        return out

    def store(self, db) -> None:
        for stage, stats in self.summary().items():
            db.add("timing", {"stage": stage, **stats})

    def report(self) -> str:
        summary = self.summary()
        width = max([18] + [len(k) + 2 for k in summary])
        lines = [f"{'stage':<{width}}{'count':>7}{'mean':>10}{'max':>10}"
                 f"{'total':>10}{'syncs':>8}"]
        for stage, s in sorted(summary.items()):
            lines.append(
                f"{stage:<{width}}{s['count']:>7}{s['mean_ms']:>8.2f}ms"
                f"{s['max_ms']:>8.2f}ms{s['total_s']:>9.2f}s"
                f"{s['syncs']:>8}")
        for name, n in sorted(self.counters.items()):
            lines.append(f"{name:<{width}}{n:>7}")
        return "\n".join(lines)


# The process's recorder: spans with no parent record here.
RECORDER = StageTimers()


def enable(on: bool = True) -> None:
    """Let spans record (or stop them) outside any profiler session."""
    global _enabled
    _enabled = on


def span(name: str, device=None, request=None, **attrs):
    """A span of the program (a null context while spans do not record):
    it records into the recorder of the span open around it, else into
    :data:`RECORDER`. ``device``: a CUDA device whose current stream the
    span's timing events go on; ``request``: the id of a span with no
    parent (else the next of its recorder's)."""
    if not _enabled and not _profiler_enabled():
        return NULL_SPAN
    top = _local.top
    return Span(RECORDER if top is None else top.recorder, name, device,
                request, attrs)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to a counter of the recorder that a span would record
    into now (while spans record)."""
    if _enabled or _profiler_enabled():
        top = _local.top
        (RECORDER if top is None else top.recorder)._bump(name, n)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a torch.profiler trace (CPU, plus CUDA when present) around
    a code region and write it to ``log_dir/trace.json`` (Chrome format);
    the program's spans appear in it as ``sydr.*`` ranges."""
    import os

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
