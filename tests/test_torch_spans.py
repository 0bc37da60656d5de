"""The program's recorder (``sydr_tpu_torch.utils.metrics``), its spans in
``acquire``, ``StepGraph.run`` and ``TrackingSession.process_block``, and
the benchmark's readers of them, on the CPU.

(a) Off by default: no span, no counter, no profiler range, a stage timed
    bare; on under a ``torch.profiler`` session and after ``enable()``.
(b) Parents, request ids, attributes, and the host's waits on the device
    (``syncs``) against the innermost open span; the ring's bound and the
    summary that never drops a span.
(c) The spans where the work happens, once a call, in order.
(d) Each of the benchmark's span readers (``benchmark/metrics/*.py``)
    against a recorder filled by hand and a ``Trace`` beside it; ``None``
    where the recorder holds no such span or the program has no recorder;
    ``acq.forward_ms`` against a ``Trace`` filled by hand.
"""

import threading
import warnings

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.trace import Trace
from sydr_tpu_torch.channels.runtime import TrackingConfig
from sydr_tpu_torch.ops import acquisition as acq
from sydr_tpu_torch.ops.step_graph import StepGraph
from sydr_tpu_torch.receiver.receiver import Receiver, ReceiverConfig
from sydr_tpu_torch.receiver.session import AcquisitionConfig, TrackingSession
from sydr_tpu_torch.utils import metrics
from sydr_tpu_torch.utils.metrics import (
    NULL_SPAN,
    SYNC_WARNING,
    Span,
    StageTimers,
)

torch.set_num_threads(2)

CPU = torch.device("cpu")
FS = 2.046e6
N = 2046
PRNS = [3, 7]
# 21 bins at 500 Hz on 1 kHz DFT bins: two phases, so a shift plan (K2).
ACQ = AcquisitionConfig(doppler_range=5000.0, doppler_step=500.0,
                        coherent=1, non_coherent=2)


@pytest.fixture(autouse=True)
def clean_recorder(monkeypatch):
    monkeypatch.setattr(metrics, "RECORDER", StageTimers())
    metrics.enable(False)
    yield
    metrics.enable(False)


def _sync():
    """What PyTorch's sync debug mode says at a wait on the device."""
    warnings.warn(f"{SYNC_WARNING} (Triggered internally at x.cpp:1.)")


# -- (a) on and off ---------------------------------------------------------
def test_off_records_nothing_and_opens_no_range(monkeypatch):
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: opened.append(name))
    rec = StageTimers()
    assert metrics.span("sydr.x", device=CPU, searches=1) is NULL_SPAN
    with rec.time("stage") as stage:
        with metrics.span("sydr.x") as s:
            s.set(nodes=3)
            metrics.count("sydr.c")
        with pytest.warns(UserWarning, match=SYNC_WARNING):
            _sync()
    assert not opened
    assert not metrics.RECORDER.spans and not metrics.RECORDER.counters
    # The stage is timed bare: no parent, request or wait counted.
    assert stage.bare and [s.name for s in rec.spans] == ["stage"]
    assert stage.parent is None and stage.request is None
    assert stage.syncs == 0 and stage.host_ms >= 0
    assert rec.summary()["stage"]["count"] == 1 and not rec.counters


def test_records_under_the_profiler_and_after_enable():
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with metrics.span("sydr.p"):
            torch.ones(4).sum()
        metrics.count("sydr.c", 2)
    assert "sydr.p" in {e.key for e in prof.events()}
    assert [s.name for s in metrics.RECORDER.spans] == ["sydr.p"]
    assert metrics.RECORDER.counters == {"sydr.c": 2}
    assert metrics.span("sydr.q") is NULL_SPAN
    metrics.enable()
    with metrics.span("sydr.q"):
        pass
    assert [s.name for s in metrics.RECORDER.spans] == ["sydr.p", "sydr.q"]
    metrics.enable(False)
    assert metrics.span("sydr.r") is NULL_SPAN


def test_a_profiler_range_opens_only_while_a_profiler_records(monkeypatch):
    opened = []
    real = torch.profiler.record_function

    def record(name):
        opened.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", record)
    metrics.enable()
    with metrics.span("sydr.enabled"):
        pass
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with metrics.span("sydr.profiled"):
            pass
    assert opened == ["sydr.profiled"]
    assert [s.name for s in metrics.RECORDER.spans] == ["sydr.enabled",
                                                "sydr.profiled"]


# -- (b) what a span records ------------------------------------------------
def test_parents_requests_and_syncs_per_innermost_span():
    metrics.enable()
    with metrics.span("sydr.a", searches=2) as a:
        _sync()
        with metrics.span("sydr.a.b", request=99) as b:
            _sync()
            _sync()
            with pytest.warns(UserWarning, match="unrelated"):
                warnings.warn("unrelated")
        with metrics.span("sydr.a.c") as c:
            b.set(late=1)
    with metrics.span("sydr.a") as a2:
        _sync()
    assert (a.syncs, b.syncs, c.syncs, a2.syncs) == (1, 2, 0, 1)
    assert a.parent is None and b.parent == a.id and c.parent == a.id
    assert b.request == c.request == a.request != a2.request
    assert a.attrs == {"searches": 2} and b.attrs == {"late": 1}
    assert [s.name for s in metrics.RECORDER.spans] == [
        "sydr.a.b", "sydr.a.c", "sydr.a", "sydr.a"]
    assert a.start_ns <= b.start_ns <= b.end_ns <= c.start_ns <= a.end_ns
    assert [[s.name for s in t] for t in metrics.RECORDER.trees("sydr.a")] == [
        ["sydr.a.b", "sydr.a.c", "sydr.a"], ["sydr.a"]]
    summary = metrics.RECORDER.summary()
    assert summary["sydr.a"]["count"] == 2 and summary["sydr.a"]["syncs"] == 2
    assert summary["sydr.a.b"]["syncs"] == 2
    # Outside a span the warning is PyTorch's again.
    with pytest.warns(UserWarning, match=SYNC_WARNING):
        _sync()


def test_another_threads_waits_are_neither_counted_nor_shown(monkeypatch):
    """While a span holds the sync debug mode that it set, a wait on
    another thread is the mode's doing: not counted and not shown."""
    modes = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    shown = []
    monkeypatch.setattr(warnings, "showwarning",
                        lambda message, *a, **k: shown.append(str(message)))
    metrics.enable()
    with metrics.span("sydr.a") as a:
        _sync()
        other = threading.Thread(target=_sync)
        other.start()
        other.join()
        warnings.warn("unrelated")
    assert a.syncs == 1 and modes == ["warn", 0]
    assert shown == ["unrelated"]


def test_a_root_span_takes_its_request_id():
    metrics.enable()
    with metrics.span("sydr.a", request=7) as a:
        pass
    with metrics.span("sydr.a") as b:
        pass
    assert a.request == 7 and b.request != 7


@pytest.mark.parametrize("on", [False, True], ids=["bare", "spans"])
def test_the_ring_is_bounded_and_the_summary_never_drops(on, monkeypatch):
    monkeypatch.setattr(metrics, "RING", 4)
    rec = StageTimers()
    metrics.enable(on)
    for _ in range(10):
        with rec.time("s"):
            pass
    assert len(rec.spans) == 4
    assert all(s.bare is not on for s in rec.spans)
    s = rec.summary()["s"]
    assert s["count"] == 10
    assert s["total_s"] >= s["max_ms"] / 1e3 >= s["mean_ms"] / 1e3 > 0
    assert s["std_ms"] >= 0


def test_a_span_inside_another_recorders_span_records_there():
    rec = StageTimers()
    metrics.enable()
    with rec.time("stage") as outer:
        with metrics.span("sydr.inner") as inner:
            pass
        metrics.count("sydr.c")
    assert [s.name for s in rec.spans] == ["sydr.inner", "stage"]
    assert inner.parent == outer.id and rec.counters == {"sydr.c": 1}
    assert not metrics.RECORDER.spans
    assert "sydr.inner" in rec.report() and "stage" in rec.report()


def test_a_span_on_the_cpu_has_no_device_time():
    metrics.enable()
    with metrics.span("sydr.d", device=CPU) as d:
        pass
    assert d.device_ms is None and d.host_ms >= 0


# -- (c) the spans where the work happens -----------------------------------
def _snapshot(rows, seed=0):
    rng = np.random.default_rng(seed)
    n = ACQ.coherent * ACQ.non_coherent * N
    return (torch.from_numpy(rng.standard_normal((rows, n), np.float32)),
            torch.from_numpy(rng.standard_normal((rows, n), np.float32)))


@pytest.mark.parametrize("step, children", [
    (500.0, ["sydr.acq.prepare", "sydr.acq.spectra", "sydr.acq.k2",
             "sydr.acq.peak"]),
    (130.0, ["sydr.acq.prepare", "sydr.acq.spectra", "sydr.acq.peak"]),
])
def test_acquire_emits_its_spans_once_a_call(step, children):
    """Distinct rows, then one snapshot expanded over the rows: the shift
    map mixes and transforms one row of it (``rows`` 1, the counter
    ``sydr.acq.spectra.shared``), the direct map every row."""
    code_k = np.stack([acq.code_fft_conj(p, FS) for p in PRNS])
    bins = acq.doppler_bins(ACQ.doppler_range, step)
    shift = "sydr.acq.k2" in children
    metrics.enable()
    for call in range(2):
        iq = _snapshot(len(PRNS), call)
        if call:
            iq = tuple(x[:1].expand(len(PRNS), -1) for x in iq)
        acq.acquire(iq, code_k, bins,
                    sampling_frequency=FS, coherent=ACQ.coherent,
                    non_coherent=ACQ.non_coherent)
    trees = metrics.RECORDER.trees("sydr.acq")
    assert len(trees) == 2
    for tree, rows in zip(trees, (len(PRNS), 1 if shift else len(PRNS))):
        root = tree[-1]
        assert [s.name for s in tree] == children + ["sydr.acq"]
        assert root.attrs == {"searches": len(PRNS)}
        assert tree[1].attrs == {"rows": rows}
        assert all(s.parent == root.id and s.request == root.request
                   for s in tree[:-1])
        assert all(s.syncs == 0 for s in tree)
    assert trees[0][-1].request != trees[1][-1].request
    assert metrics.RECORDER.counters == (
        {"sydr.acq.spectra.shared": 1} if shift else {})


def test_step_graph_run_emits_capture_then_copy_in_and_replay():
    graph = StepGraph(CPU, capture=False)

    def fn(x, y):
        return (x + y, x * y)

    args = (torch.ones(3), torch.full((3,), 2.0))
    metrics.enable()
    for _ in range(3):
        graph.run("k", fn, args)
    trees = metrics.RECORDER.trees("sydr.step")
    assert [[s.name for s in t] for t in trees] == [
        ["sydr.step.capture", "sydr.step"],
        ["sydr.step.copy_in", "sydr.step.replay", "sydr.step"],
        ["sydr.step.copy_in", "sydr.step.replay", "sydr.step"]]
    assert [t[-1].request for t in trees] == [0, 1, 2]
    assert trees[1][1].attrs == {"nodes": graph.graphs["k"].nodes}
    assert metrics.RECORDER.counters == {"sydr.step.captures": 1}
    assert graph.graphs["k"].replays == 2


@pytest.mark.parametrize("on", [False, True], ids=["off", "enabled"])
def test_scan_superblock_emits_its_span_and_counter(on):
    """``runtime.run_superblock``: one ``sydr.scan.superblock`` a call
    (``blocks``, ``channels`` and, the state being on the host,
    ``tracking``) with each block's epochs under it, and the counter
    ``sydr.scan.blocks`` the blocks enqueued; nothing while the recorder
    is off."""
    from _scan_inputs import scan_block_tensors, scan_config

    from sydr_tpu_torch.channels import runtime as rt
    from sydr_tpu_torch.channels.state import MODE_TRACKING

    cfg = scan_config(profile="borre", block_ms=4)
    long_cfg = scan_config(profile="borre", block_ms=8)
    codes, st, sre, sim = scan_block_tensors(long_cfg, 8, 3, CPU)
    metrics.enable(on)
    for _ in range(2):
        rt.run_superblock(cfg, 2, codes, st, sre, sim)
    spans = metrics.RECORDER.find("sydr.scan.superblock")
    if not on:
        assert not spans and not metrics.RECORDER.counters
        return
    tracking = int((st.mode == MODE_TRACKING).sum())
    assert 0 < tracking < 8
    assert [s.attrs for s in spans] == [
        {"blocks": 2, "channels": 8, "tracking": tracking}] * 2
    assert all(s.parent is None and s.syncs == 0 for s in spans)
    assert metrics.RECORDER.counters == {"sydr.scan.blocks": 4}


SESSION_CHILDREN = ["boxcar", "quantise", "upload", "step", "history",
                    "acquire", "copy_back", "promote"]


def _session_configs():
    pull_in = TrackingConfig(
        sampling_frequency=FS, input_decimate=2, window_size=N + 256,
        runtime="batch", profile="kaplan", block_ms=5)
    return pull_in


def _blocks(session, count, seed=1):
    rng = np.random.default_rng(seed)
    n = session.block_input_samples
    return [(rng.standard_normal(n).astype(np.float32),
             rng.standard_normal(n).astype(np.float32))
            for _ in range(count)]


def test_process_block_emits_its_eight_children():
    session = TrackingSession(_session_configs(), PRNS, ACQ, device=CPU)
    session.graph = StepGraph(CPU, capture=False)
    metrics.enable()
    for block in _blocks(session, 2):
        session.process_block(*block)
    session.reset_channel(0)
    trees = metrics.RECORDER.trees("sydr.session.block")
    assert len(trees) == 2
    for k, tree in enumerate(trees):
        root = tree[-1]
        kids = [s for s in tree if s.parent == root.id]
        assert [s.name for s in kids] == [
            f"sydr.session.block.{c}" for c in SESSION_CHILDREN]
        assert all(s.request == root.request for s in tree)
        under = {s.name for s in tree[:-1] if s.parent != root.id}
        step = {"sydr.step", "sydr.step.capture"} if k == 0 else {
            "sydr.step", "sydr.step.copy_in", "sydr.step.replay"}
        # The first block's history holds the search (2 ms are needed).
        searched = {"sydr.acq", "sydr.acq.prepare", "sydr.acq.spectra",
                    "sydr.acq.k2", "sydr.acq.peak"} if k == 0 else set()
        assert under == step | searched
        assert kids[5].attrs == {"searches": len(PRNS) if k == 0 else 0}
    # The session searches every pending PRN on its one history ring.
    assert metrics.RECORDER.counters == {"sydr.step.captures": 1,
                                 "sydr.session.resets": 1,
                                 "sydr.acq.spectra.shared": 1}


@pytest.mark.parametrize("on", [False, True], ids=["off", "enabled"])
def test_receiver_report_keeps_its_stages_over_the_session_spans(on):
    """The ``Receiver`` times its three stages always; the session's spans
    record under them only while spans record."""
    rx = Receiver(ReceiverConfig(prns=tuple(PRNS), tracking=_session_configs(),
                                 acquisition=ACQ, tropo_enabled=False),
                  device=CPU)
    metrics.enable(on)
    for block in _blocks(rx.session, 2):
        rx.process_ms(block)
    summary = rx.timers.summary()
    stages = {"track_block", "decode", "measure"}
    assert stages <= set(summary)
    assert summary["track_block"]["count"] == 2
    assert not metrics.RECORDER.spans
    report = rx.timers.report()
    assert all(name in report for name in stages)
    if not on:
        assert set(summary) == stages and not rx.timers.counters
        assert all(s.bare for s in rx.timers.spans)
    else:
        assert summary["sydr.session.block"]["count"] == 2
        assert summary["sydr.acq"]["count"] == 1
        blocks = rx.timers.find("sydr.session.block")
        ids = {s.id for s in rx.timers.find("track_block")}
        assert {s.parent for s in blocks} == ids
        assert "sydr.session.block.copy_back" in report

    class Db:
        rows = []

        def add(self, table, row):
            self.rows.append((table, row))

    db = Db()
    rx.timers.store(db)
    assert {r["stage"] for t, r in db.rows if t == "timing"} == set(summary)


# -- (d) the benchmark's readers --------------------------------------------
def _span(name, ms, parent=None, request=0, syncs=0, **attrs):
    s = Span(metrics.RECORDER, name, None, request, attrs)
    s.parent, s.syncs = (None if parent is None else parent.id), syncs
    s.start_ns, s.end_ns = 0, int(ms * 1e6)
    return s


def _fill_acq():
    for k, (prep, k2, syncs) in enumerate(
            [(25.0, 0.5, 1), (26.0, 0.4, 1), (24.0, 0.6, 2)]):
        root = _span("sydr.acq", prep + k2 + 1.0, request=k, searches=32)
        for child in (_span("sydr.acq.prepare", prep, root, k, syncs),
                      _span("sydr.acq.spectra", 0.1, root, k,
                            rows=(1, 1, 32)[k]),
                      _span("sydr.acq.k2", k2, root, k),
                      _span("sydr.acq.peak", 0.05, root, k)):
            metrics.RECORDER._add(child)
        metrics.RECORDER._add(root)


def _fill_track():
    for k, (copy_in, replay, syncs) in enumerate(
            [(0.02, 0.05, 0), (0.03, 0.06, 0), (0.02, 0.5, 1)]):
        root = _span("sydr.step", copy_in + replay, request=k + 1)
        metrics.RECORDER._add(_span("sydr.step.copy_in", copy_in, root,
                                    k + 1, syncs))
        metrics.RECORDER._add(_span("sydr.step.replay", replay, root, k + 1,
                                    nodes=214))
        metrics.RECORDER._add(root)


READINGS = [
    ("acq.syncs", _fill_acq, 1),
    ("acq.prepare_ms", _fill_acq, 25.0),
    ("acq.k2_call_ms", _fill_acq, 0.5),
    ("acq.spectra_rows", _fill_acq, 1),
    ("track.syncs", _fill_track, 0),
    ("track.copy_in_ms", _fill_track, 0.02),
    ("track.graph_nodes", _fill_track, 214),
]


def _trace(events=((0.0, 10.0, "kernel"),)):
    return Trace(events=list(events), host=[], spans={}, units=3,
                 window_s=1e-4, counters={})


@pytest.mark.parametrize("name, fill, want", READINGS,
                         ids=[r[0] for r in READINGS])
def test_reader_reads_the_recorder(name, fill, want):
    fill()
    assert harness.reader(name)(_trace()) == pytest.approx(want)


@pytest.mark.parametrize("name, fill, want", READINGS,
                         ids=[r[0] for r in READINGS])
def test_reader_without_its_spans_reads_none(name, fill, want):
    (_fill_track if fill is _fill_acq else _fill_acq)()
    assert harness.reader(name)(_trace()) is None


@pytest.mark.parametrize("name", [r[0] for r in READINGS])
def test_reader_of_a_program_without_the_recorder_reads_none(name,
                                                            monkeypatch):
    _fill_acq()
    _fill_track()
    monkeypatch.delattr(metrics, "RECORDER")
    assert harness.reader(name)(_trace()) is None


def _request(t0, forward_us, gap_us=5.0):
    """One request's rows (start us, end us, name) from ``t0``: the
    snapshot's and the bins' uploads, the forward spectra's kernels with a
    gap of idle between them, K2, the peak metric, the results' copy."""
    rows, t = [], t0
    for name, us in [("Memcpy HtoD (Pinned -> Device)", 30.0),
                     ("Memcpy HtoD (Pageable -> Device)", 1.0)]:
        rows.append((t, t + us, name))
        t += us + gap_us
    for k, us in enumerate(forward_us):
        rows.append((t, t + us, f"void at::native::elementwise_kernel {k}"))
        t += us + gap_us
    for name, us in [("void pcps_bins_cluster_kernel<512, 32>", 11400.0),
                     ("void at::native::reduce_kernel<128, 4>", 300.0),
                     ("Memcpy DtoH (Device -> Pinned)", 2.0)]:
        rows.append((t, t + us, name))
        t += us + gap_us
    return rows, t


@pytest.mark.parametrize("forwards, want", [
    ([[3000.0, 6000.0, 4000.0]], 13.0),
    ([[3000.0, 6000.0, 4000.0], [2000.0, 6000.0, 4000.0],
      [3000.0, 7000.0, 4000.0]], 13.0),
    ([[12000.0], [14500.0]], 13.25),
], ids=["one", "three", "two"])
def test_forward_reader_reads_each_requests_busy_time(forwards, want):
    """``acq.forward_ms``: the median over requests of the device-busy
    time from a request's first upload to its K2 row, copies and idle
    left out; the rows after K2 (peak metric, results) are not counted."""
    events, t = [], 0.0
    for forward in forwards:
        rows, t = _request(t, forward)
        events += rows
    read = harness.reader("acq.forward_ms")
    assert read(_trace(events[::-1])) == pytest.approx(want)


@pytest.mark.parametrize("events", [
    [],
    [(0.0, 10.0, "kernel")],
    _request(0.0, [100.0])[0][:3],                  # no K2 row
    [r for r in _request(0.0, [100.0])[0] if "HtoD" not in r[2]],
], ids=["empty", "no_upload_no_k2", "no_k2", "no_upload"])
def test_forward_reader_without_a_whole_request_reads_none(events):
    assert harness.reader("acq.forward_ms")(_trace(events)) is None


def test_readers_are_declared_for_their_cells():
    spec = harness.load_json(harness.HERE.parent / "BENCHMARK.json")
    by_name = {m["name"]: m for m in spec["per_layer"]}
    for name, fill, _ in READINGS + [("acq.forward_ms", _fill_acq, None)]:
        m = by_name[name]
        cell = ("acq.cold.l1ca_16368ksps" if fill is _fill_acq
                else "track.cruise.l1ca_4msps")
        source = ("device_trace" if name == "acq.forward_ms"
                  else "program_span")
        assert m["source"] == source and m["workloads"] == [cell]


SCAN_READERS = [("scan.graph_nodes", "program_span"),
                ("scan.kernel_roofline", "device_trace"),
                ("scan.device_ms", "device_trace"),
                ("device.idle.scan", "device_trace")]


@pytest.mark.parametrize("name, source", SCAN_READERS,
                         ids=[r[0] for r in SCAN_READERS])
def test_scan_readers_are_declared_for_the_scan_cell(name, source):
    spec = harness.load_json(harness.HERE.parent / "BENCHMARK.json")
    m = {m["name"]: m for m in spec["per_layer"]}[name]
    assert m["source"] == source and m["moves"] == "rtf"
    assert m["workloads"] == ["track.scan.l1ca_10msps"]
    harness.reader(name)


def test_scan_graph_nodes_reads_the_replays(monkeypatch):
    """``scan.graph_nodes``: the ``nodes`` of the replays' spans; ``None``
    without them and for a program without the recorder."""
    read = harness.reader("scan.graph_nodes")
    assert read(_trace()) is None
    _fill_track()
    assert read(_trace()) == 214
    monkeypatch.delattr(metrics, "RECORDER")
    assert read(_trace()) is None


def test_a_traced_run_of_the_cold_cell_carries_the_span_metrics():
    """The tiny cold-start cell on the CPU: an untraced run records no
    span (the recorder is off); a traced one records the traced stretch's
    calls, and its line carries the span metrics (not ``acq.forward_ms``:
    the CPU gives the trace no device rows)."""
    from benchmark.tests import _tiny

    result, _ = _tiny.run(_tiny.COLD, trace=False)
    assert result["correct"] and not metrics.RECORDER.spans
    result, _ = _tiny.run(_tiny.COLD, trace=True)
    got = {k: v["value"] for k, v in result["metrics"].items()}
    assert got["acq.syncs"] == 0
    assert 0 < got["acq.prepare_ms"] + got["acq.k2_call_ms"] \
        <= got["acq.enqueue_ms"]
    assert "acq.forward_ms" not in got
    # The traced stretch's requests (fewer than the traffic's three when
    # the short window closes first).
    assert metrics.RECORDER.trees("sydr.acq")
