"""The session's device step as a pure function, and the graph runner's
bookkeeping, on the CPU.

(a) ``TrackingSession._make_packed_run``'s eager ``inner`` held step by
    step against the JAX session's ``_make_packed_run``: the JAX session
    runs tests/test_torch_session.py's stream (8 Msps decimated to 2 Msps,
    two satellites at 46 dB-Hz and an absent PRN, kaplan pull-in at 5 ms,
    promotion to the narrow-only cruise at 20 ms x 5 blocks), and every
    step it takes, through pull-in, promotion and cruise, is fed to the
    port's ``inner`` of the same configuration on the same inputs (the
    state packed, the int8 window, ``inv_scale``, the ring). Bounds are
    tests/test_torch_session.py's: the correlators of every step within
    the production parity gate (the amplitude-scaled error, the prompt
    ratio, the ``max |err| / (|ref| + 1)`` metric over 99% of them),
    ``active`` and the flags exact, the carrier within 1 Hz; the ring is
    the dequantised window in both and equal bit for bit, and the packed
    output names equal.
(b) ``ops.step_graph.StepGraph`` with ``capture=False`` (its static
    buffers, copies in and out, one step function per key, the step run
    on the buffers where a replay runs) inside a ``Receiver``, held bit
    for bit against the plain eager receiver over one run: promotion,
    ``or_flags``, ``reset_channel`` -> demotion -> reacquisition (a
    hand-off) -> re-promotion (both graphs reused), and a checkpoint saved
    by the graphed receiver mid-run and resumed by a fresh one.
(c) ``graph=`` on the CPU and with a mesh (the rule,
    ``step_graph.use_graph``: an NCCL mesh on a card is graphed, a gloo
    mesh eager, ``graph=True`` with gloo or on the CPU raises), and the
    launch counters through a replay.
"""

import dataclasses

import numpy as np
import pytest
import torch

from sydr_tpu.channels.runtime import TrackingConfig as JaxConfig
from sydr_tpu.receiver.session import TrackingSession as JaxSession
from sydr_tpu_torch import parity
from sydr_tpu_torch.channels.runtime import TrackingConfig
from sydr_tpu_torch.channels.state import (
    FIELDS,
    FLAG_BIT_SYNC,
    FLAG_SUBFRAME_SYNC,
    MODE_TRACKING,
    pack_state,
    state_from_numpy,
    unpack_state,
)
from sydr_tpu_torch.ops import native
from sydr_tpu_torch.receiver import checkpoint
from sydr_tpu_torch.receiver.receiver import Receiver, ReceiverConfig
from sydr_tpu_torch.receiver.session import TrackingSession
from sydr_tpu_torch.parallel import distributed
from sydr_tpu_torch.parallel.timeshard import TimeShardGraph
from sydr_tpu_torch.ops.step_graph import StepGraph, use_graph
from sydr_tpu_torch.signal.synthetic import IQGenerator

torch.set_num_threads(2)

CPU = torch.device("cpu")
FS_IN = 8e6
DEC = 4
PER_MS = round(FS_IN * 1e-3)
SIGNAL_MS = 1500
SATS = [dict(prn=5, doppler=1200.0, code_phase=321.4),
        dict(prn=12, doppler=-2600.0, code_phase=811.9)]
PRNS = [5, 12, 20]                 # PRN 20 is absent from the signal


def _generator():
    bits = np.random.default_rng(11).integers(0, 2, 200)
    gen = IQGenerator(FS_IN, noise=True, seed=11)
    for s in SATS:
        gen.add_satellite(s["prn"], doppler_hz=s["doppler"],
                          code_phase_chips=s["code_phase"], cn0_dbhz=46.0,
                          nav_bits=bits)
    return gen


def _configs(config_cls):
    fs = FS_IN / DEC
    pull_in = config_cls(
        sampling_frequency=fs, input_decimate=DEC,
        window_size=round(fs * 1e-3) + 256, runtime="batch",
        profile="kaplan", block_ms=5, quantize_spacing=True)
    cruise = dataclasses.replace(
        pull_in, kaplan_narrow_only=True, block_ms=20, superblock=5)
    return pull_in, cruise


# ---------------------------------------------------------------------------
# (a) the step function against the JAX session's, step by step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_steps():
    """Every step the JAX session takes over SIGNAL_MS: whether it was a
    cruise step, its inputs and outputs as numpy."""
    pull_in, cruise = _configs(JaxConfig)
    session = JaxSession(pull_in, PRNS, cruise=cruise)
    steps = []
    make = session._make_packed_run

    def recording():
        run, promoted = make(), session.promoted

        def rec(state, wre, wim, inv_scale, ring_re, ring_im):
            res = run(state, wre, wim, inv_scale, ring_re, ring_im)
            state2, pf, pi, rre, rim, keys_f, keys_i = res
            steps.append(dict(
                cruise=promoted,
                state={n: np.asarray(getattr(state, n)) for n in FIELDS},
                up=(np.array(wre), np.array(wim)),
                inv_scale=np.float32(inv_scale),
                ring=(np.array(ring_re), np.array(ring_im)),
                out_state={n: np.asarray(getattr(state2, n))
                           for n in FIELDS},
                packed=(np.asarray(pf), np.asarray(pi)),
                out_ring=(np.asarray(rre), np.asarray(rim)),
                keys=(keys_f, keys_i)))
            return res

        return rec

    session._make_packed_run = recording
    gen = _generator()
    fed = 0
    while fed < SIGNAL_MS:
        n_ms = session.block_input_samples // PER_MS
        iq = gen.generate_ms(n_ms)
        session.process_block(np.float32(iq.real), np.float32(iq.imag))
        fed += n_ms
    return steps


@pytest.fixture(scope="module")
def port_steps(jax_steps):
    """The port's ``inner`` of the same configuration on each JAX step's
    inputs."""
    pull_in, cruise = _configs(TrackingConfig)
    session = TrackingSession(pull_in, PRNS, cruise=cruise, device=CPU)
    runs = {c: session._make_packed_run(c) for c in (pull_in, cruise)}
    got = []
    for step in jax_steps:
        inner, keys = runs[cruise if step["cruise"] else pull_in]
        state_f, state_i = pack_state(state_from_numpy(step["state"], CPU))
        res = inner(state_f, state_i,
                    *(torch.from_numpy(x) for x in step["up"]),
                    torch.tensor(step["inv_scale"]),
                    *(torch.from_numpy(x) for x in step["ring"]))
        sf, si, pf, pi, rre, rim = res
        got.append(dict(
            state={n: getattr(unpack_state(sf, si), n).numpy()
                   for n in FIELDS},
            packed=(pf.numpy(), pi.numpy()),
            ring=(rre.numpy(), rim.numpy()), keys=(keys["f"], keys["i"])))
    return got


def test_the_jax_run_reaches_cruise(jax_steps):
    kinds = [s["cruise"] for s in jax_steps]
    assert not kinds[0] and kinds[-1] and kinds.count(True) >= 3
    assert kinds.index(True) == len(kinds) - kinds.count(True)


def test_packed_outputs_have_the_jax_names_and_shapes(jax_steps, port_steps):
    for want, got in zip(jax_steps, port_steps):
        assert got["keys"] == want["keys"]
        for g, w in zip(got["packed"], want["packed"]):
            assert g.shape == w.shape and g.dtype == w.dtype


def test_ring_is_the_dequantised_window(jax_steps, port_steps):
    for want, got in zip(jax_steps, port_steps):
        for g, w in zip(got["ring"], want["out_ring"]):
            np.testing.assert_array_equal(g, w)


def _column(steps, name, which):
    """Output ``name`` of every step, ``[sum T, n_ch]``."""
    keys_f, keys_i = steps[0]["keys"]
    if name in keys_f:
        return np.concatenate([s[which][0][..., keys_f.index(name)]
                               for s in steps])
    return np.concatenate([s[which][1][..., keys_i.index(name)]
                           for s in steps])


def test_step_correlators_within_parity_gate(jax_steps, port_steps):
    visible = [0, 1]
    got = np.stack([_column(port_steps, k, "packed")[:, visible]
                    for k in parity.CORR_KEYS])
    ref = np.stack([_column(jax_steps, k, "packed")[:, visible]
                    for k in parity.CORR_KEYS])
    res = parity.parity_metrics(got, ref)
    bounds = parity.PARITY_BOUNDS
    assert res["parity_scaled"] <= bounds["parity_scaled"], res
    lo, hi = bounds["prompt_ratio"]
    assert lo <= res["prompt_ratio"] <= hi, res
    rel = np.abs(got - ref) / (np.abs(ref) + 1.0)
    assert np.quantile(rel, 0.99) <= bounds["parity_metric"], res


@pytest.mark.parametrize("name", ["active", "flags"])
def test_step_integer_outputs_exact(jax_steps, port_steps, name):
    np.testing.assert_array_equal(_column(port_steps, name, "packed"),
                                  _column(jax_steps, name, "packed"))


def test_step_state_agrees(jax_steps, port_steps):
    for want, got in zip(jax_steps, port_steps):
        np.testing.assert_array_equal(got["state"]["flags"],
                                      want["out_state"]["flags"])
        np.testing.assert_array_equal(got["state"]["mode"],
                                      want["out_state"]["mode"])
        np.testing.assert_allclose(got["state"]["carrier_freq"],
                                   want["out_state"]["carrier_freq"],
                                   atol=1.0)
    last = port_steps[-1]["state"]
    for i, s in enumerate(SATS):
        assert last["flags"][i] & FLAG_BIT_SYNC
        assert abs(last["carrier_freq"][i] - s["doppler"]) < 5.0


# ---------------------------------------------------------------------------
# (b) the graph runner's bookkeeping against the eager receiver
# ---------------------------------------------------------------------------

OUT_KEYS = ("i_prompt", "q_prompt", "i_early", "i_late", "flags",
            "carrier_freq", "active", "unread", "required", "bit_ready",
            "cn0", "pll_lock", "rem_code")


def _receiver(graphed):
    pull_in, cruise = _configs(TrackingConfig)
    rx = Receiver(ReceiverConfig(
        prns=tuple(PRNS), tracking=pull_in, cruise_tracking=cruise,
        tropo_enabled=False), device=CPU)
    if graphed:
        rx.session.graph = StepGraph(CPU, capture=False)
    return rx


@pytest.fixture(scope="module")
def bookkeeping_runs(tmp_path_factory):
    """One run of the eager receiver and one of the graphed receivers on
    the same blocks, with the same edits between them; the graphed run is
    saved after its first cruise superblock past re-promotion and resumed
    by a fresh graphed receiver. Returns the outputs of every call, the
    events and both final receivers."""
    path = str(tmp_path_factory.mktemp("graph") / "mid.npz")
    gen = _generator()
    eager, graphed = _receiver(False), _receiver(True)
    calls = {"eager": [], "graphed": []}
    events = []

    def feed(n):
        for _ in range(n):
            assert eager.session.block_input_samples == \
                graphed.session.block_input_samples
            iq = gen.generate_ms(eager.session.block_input_samples // PER_MS)
            for name, rx in (("eager", eager), ("graphed", graphed)):
                rx.process_ms(iq)
                calls[name].append({k: np.array(rx.last_outputs[k])
                                    for k in OUT_KEYS})

    def until_promoted(limit_ms):
        start = eager.session.total_samples
        while not eager.session.promoted:
            feed(1)
            assert (eager.session.total_samples - start) * DEC \
                < limit_ms * PER_MS, "no promotion"
        assert graphed.session.promoted
        events.append(("promoted", len(calls["eager"])))

    feed(40)                                     # 200 ms of pull-in
    for rx in (eager, graphed):
        rx.session.or_flags(0, FLAG_SUBFRAME_SYNC)
    events.append(("or_flags", len(calls["eager"])))
    until_promoted(2500)
    feed(1)                                      # one cruise superblock
    for rx in (eager, graphed):
        rx.session.reset_channel(1)
    assert not eager.session.promoted and not graphed.session.promoted
    events.append(("reset", len(calls["eager"])))
    feed(1)
    assert 1 in graphed.session.acq_results, "no reacquisition"
    events.append(("handed off", len(calls["eager"])))
    until_promoted(2500)
    feed(1)
    replays = {key[0] is graphed.session.cruise_cfg: entry.replays
               for key, entry in graphed.session.graph.graphs.items()}
    checkpoint.save_checkpoint(graphed, path)
    resumed = _receiver(True)
    checkpoint.load_checkpoint(resumed, path)
    graphed = resumed
    events.append(("resumed", len(calls["eager"])))
    feed(3)
    return dict(calls=calls, events=events, eager=eager, graphed=graphed,
                replays=replays)


def test_bookkeeping_run_has_every_event(bookkeeping_runs):
    names = [e for e, _ in bookkeeping_runs["events"]]
    assert names == ["or_flags", "promoted", "reset", "handed off",
                     "promoted", "resumed"]
    # Before the save: 2 cruise calls (the first captures, the one after
    # the re-promotion replays), every other call but the first pull-in
    # call a replay (the demotion reuses the pull-in graph); after the
    # resume, a fresh cruise graph, captured and replayed twice.
    replays = bookkeeping_runs["replays"]
    calls = dict(bookkeeping_runs["events"])
    n_calls = len(bookkeeping_runs["calls"]["eager"])
    assert replays == {True: 1, False: n_calls - 3 - 2 - 1}
    graphs = bookkeeping_runs["graphed"].session.graph.graphs
    assert len(graphs) == 1 and \
        next(iter(graphs.values())).replays == 2
    assert calls["resumed"] + 3 == n_calls


def test_graph_runner_outputs_equal_eager_bit_for_bit(bookkeeping_runs):
    calls = bookkeeping_runs["calls"]
    assert len(calls["eager"]) == len(calls["graphed"])
    for i, (a, b) in enumerate(zip(calls["eager"], calls["graphed"])):
        for k in OUT_KEYS:
            np.testing.assert_array_equal(b[k], a[k],
                                          err_msg=f"call {i}, {k}")
    flags = np.concatenate([c["flags"] for c in calls["graphed"]])
    at = bookkeeping_runs["events"][0][1]
    rows = sum(len(c["flags"]) for c in calls["graphed"][:at])
    assert (flags[rows:, 0] & FLAG_SUBFRAME_SYNC).all()
    assert not (flags[:rows, 0] & FLAG_SUBFRAME_SYNC).any()


def test_graph_runner_final_state_equals_eager(bookkeeping_runs):
    a = bookkeeping_runs["eager"].session
    b = bookkeeping_runs["graphed"].session
    for name in FIELDS:
        assert torch.equal(getattr(b.state, name), getattr(a.state, name)), \
            name
    assert torch.equal(b._ring_re, a._ring_re)
    assert torch.equal(b._ring_im, a._ring_im)
    np.testing.assert_array_equal(b.mode_host, a.mode_host)
    assert b.promoted and a.promoted
    assert (b.mode_host[:2] == MODE_TRACKING).all()


def test_graph_runner_state_owns_its_memory(bookkeeping_runs):
    """After a replay the session's state and ring are copies: none shares
    storage with the runner's static buffers."""
    session = bookkeeping_runs["graphed"].session
    static = {t.untyped_storage().data_ptr()
              for entry in session.graph.graphs.values()
              for t in (*entry.inputs, *entry.outputs)}
    mine = [getattr(session.state, n) for n in FIELDS] + [
        session._ring_re, session._ring_im]
    assert not {t.untyped_storage().data_ptr() for t in mine} & static


# ---------------------------------------------------------------------------
# (c) graph= on the CPU, and launch counts through replays
# ---------------------------------------------------------------------------

def test_graph_true_on_the_cpu_raises():
    pull_in, cruise = _configs(TrackingConfig)
    with pytest.raises(ValueError, match="CUDA"):
        TrackingSession(pull_in, PRNS, cruise=cruise, device=CPU, graph=True)


def test_graph_default_on_the_cpu_is_eager():
    pull_in, cruise = _configs(TrackingConfig)
    assert TrackingSession(pull_in, PRNS, cruise=cruise,
                           device=CPU).graph is None
    assert TrackingSession(pull_in, PRNS, device=CPU,
                           graph=False).graph is None


def _mesh_of(backend):
    """A ``Mesh`` whose process group was started on ``backend``, made
    without one (only its backend is read here)."""
    mesh = object.__new__(distributed.Mesh)
    mesh.backend = backend
    return mesh


def test_graph_true_with_a_mesh_raises():
    """A gloo mesh's collectives copy through the host: ``graph=True``
    raises, naming the backend, before any tensor is made."""
    pull_in, _ = _configs(TrackingConfig)
    with pytest.raises(ValueError, match="gloo backend"):
        TrackingSession(pull_in, PRNS, device=torch.device("cuda"),
                        mesh=_mesh_of("gloo"), graph=True)
    with pytest.raises(ValueError, match="gloo backend"):
        TimeShardGraph(_mesh_of("gloo"), "cuda", graph=True)


@pytest.mark.parametrize("graph, device, backend, want", [
    (None, "cuda", "nccl", True),       # an NCCL mesh on a card: graphed
    (None, "cuda", "gloo", False),      # a gloo mesh: eager
    (None, "cuda", None, True),         # no process group: no collective
    (None, "cpu", "nccl", False),
    (None, "cpu", "gloo", False),
    (False, "cuda", "nccl", False),
    (True, "cuda", "nccl", True),
])
def test_graph_default_follows_the_mesh_backend(graph, device, backend,
                                                want):
    mesh = _mesh_of(backend)
    assert mesh.captures == (backend != "gloo")
    assert use_graph(graph, device, mesh) is want
    assert use_graph(graph, device, None) is (graph is not False
                                              and device == "cuda")


def test_graph_true_on_the_cpu_with_a_mesh_raises():
    with pytest.raises(ValueError, match="CUDA device, got cpu"):
        use_graph(True, "cpu", _mesh_of("nccl"))


def test_stand_in_refuses_a_cuda_device():
    with pytest.raises(ValueError, match="CPU"):
        StepGraph(torch.device("cuda"), capture=False)
    with pytest.raises(ValueError, match="CUDA"):
        StepGraph(CPU)


class _FakeKernel(native.CudaKernel):
    """A kernel whose entry point is a Python function returning 0."""

    def function(self):
        return lambda *args: 0


def test_replays_count_the_launches_captured(monkeypatch):
    k1 = _FakeKernel("none.cu", "none", [])
    k2 = _FakeKernel("other.cu", "other", [])
    monkeypatch.setattr(native, "stream_capturing", lambda: False)
    k1.launch()
    before = native.captured_counts()
    monkeypatch.setattr(native, "stream_capturing", lambda: True)
    for _ in range(3):
        k1.launch()
    k2.launch()
    monkeypatch.setattr(native, "stream_capturing", lambda: False)
    held = native.graph_launches(before, native.captured_counts())
    assert held == {k1: 3, k2: 1}
    assert (k1.launches, k1.captured, k2.launches, k2.captured) == \
        (1, 3, 0, 1)
    native.count_replay(held)
    native.count_replay(held)
    assert (k1.launches, k2.launches) == (7, 2)
    assert (k1.captured, k2.captured) == (3, 1)


def test_session_is_freed_without_the_cycle_collector():
    """No reference cycle runs through the step function: a session, and
    with it the graphs captured from its steps, goes away with its last
    reference (a graph freed by a later collection could land inside
    another capture)."""
    import gc
    import weakref

    pull_in, cruise = _configs(TrackingConfig)
    session = TrackingSession(pull_in, PRNS, cruise=cruise, device=CPU)
    session.graph = StepGraph(CPU, capture=False)
    gen = _generator()
    for _ in range(2):
        iq = gen.generate_ms(session.block_input_samples // PER_MS)
        session.process_block(np.float32(iq.real), np.float32(iq.imag))
    assert session.graph.graphs
    ref = weakref.ref(session.graph)
    gc.disable()
    try:
        del session
        assert ref() is None
    finally:
        gc.enable()
