"""Channel- and Doppler-sharded port (``parallel.mesh``) on four real
processes, after tests/test_mesh_batch.py.

One gloo world of 4 ranks (tests/_torch_distributed_worker.py, spawned
once for the module) runs every case; the meshes are ``(ch, dop)`` =
``(4, 1)`` and ``(2, 2)``:

* ``make_sharded_batch_step`` in both pass B forms (K1 row sums; K3
  prefix, ``use_pallas=True, boundary_mode="prefix"`` at >= 1024 samples
  per ms), as one block on 4 ``ch`` shards and as a superblock of 3 on 2,
  and the scan runtime's ``make_sharded_run_block``: each rank's rows
  equal the port's unsharded run bit for bit with the default
  ``fll_discriminator="atan"``; with ``"atan2"`` (not slice-invariant on
  the CPU) floats within 1e-6 relative and integers exact. Each is also
  held against the JAX ``parallel.mesh`` function on 4 (or 2) virtual
  devices, at the bounds the unsharded port is held to
  (tests/test_torch_correlator_kernel.py, tests/test_torch_scan_runtime.py):
  integer epoch geometry exact, correlators within two chip-boundary
  ties. The JAX step runs its dense pass B for the prefix cases (its
  Pallas prefix kernel is held to its dense pass by the same budget);
* ``sharded_pcps`` on ``(2, 2)`` against the unsharded ``pcps_map`` +
  ``peak_metric``: Doppler and code index exact, metric within 1e-6;
* ``TrackingSession(mesh=...)`` on ``(2, 2)`` (4 channels, 2 of them PRN 0
  padding) through acquisition and 5 superblocks, bit for bit against the
  unsharded session; a channel count that does not divide raises;
* the same mesh session's step through the graph's CPU stand-in
  (``StepGraph(cpu, capture=False)``: static buffers, the step run where a
  replay runs) against the eager mesh session, in the batch and the scan
  runtime, from acquisition through pull-in (borre, 5 ms blocks),
  promotion and cruise (20 ms blocks; the batch runtime's superblocks of
  2): every output of every call and the final state bit for bit, both
  graphs replayed. The gloo mesh records its backend, cannot be captured,
  and the session's default there is eager.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_distributed_worker as w
from sydr_tpu.channels import runtime as jrt
from sydr_tpu.channels.state import FLAG_BIT_SYNC
from sydr_tpu.parallel import mesh as jmesh
from sydr_tpu.signal.synthetic import IQGenerator
from sydr_tpu_torch.channels import batch_runtime as tbr
from sydr_tpu_torch.channels import runtime as trt
from sydr_tpu_torch.channels.state import FIELDS, code_table, state_from_numpy
from sydr_tpu_torch.ops import acquisition as tacq
from sydr_tpu_torch.receiver.session import AcquisitionConfig, TrackingSession

CORR_KEYS = ("i_early", "q_early", "i_prompt", "q_prompt", "i_late",
             "q_late")
N_CH = 8
# case: (mesh, config fields, blocks); 1.023 Msps is 1023 samples a code
# period, 2.046 Msps the smallest shape of the prefix form.
TINY = dict(sampling_frequency=1.023e6, block_ms=4, tail_ms=2,
            window_size=1152, runtime="batch")
PREFIX = dict(TINY, sampling_frequency=2.046e6, window_size=2304,
              use_pallas=True, boundary_mode="prefix")
KAPLAN = dict(TINY, profile="kaplan")
CASES = {
    "block_k1": ("4x1", TINY, 1),
    "block_prefix": ("4x1", PREFIX, 1),
    "superblock_k1": ("2x2", dict(TINY, superblock=3), 3),
    "superblock_prefix": ("2x2", dict(PREFIX, superblock=3), 3),
    "scan": ("4x1", dict(TINY, runtime="scan"), 1),
    "kaplan_atan": ("4x1", KAPLAN, 1),
    "kaplan_atan2": ("4x1", dict(KAPLAN, fll_discriminator="atan2"), 1),
}
SESSION_FS = 4e6
SESSION_PRNS = [5, 12, 0, 0]            # padded to divide over 2 'ch' shards
SESSION_CFG = dict(sampling_frequency=SESSION_FS, block_ms=20, tail_ms=4,
                   window_size=4224, runtime="batch", superblock=2)
# The stand-in's sessions: SESSION_FS decimated by 2, borre pull-in at 5 ms
# (it promotes at 370 ms), cruise at 20 ms blocks; over the first 560 ms
# of the session's signal.
GRAPH_PULL_IN = dict(sampling_frequency=SESSION_FS / 2, input_decimate=2,
                     window_size=2256, tail_ms=4, quantize_spacing=True,
                     profile="borre", block_ms=5)
GRAPH_CRUISE = {"batch": dict(block_ms=20, superblock=2),
                "scan": dict(block_ms=20)}
GRAPH_BLOCKS = 14
WORLD_TIMEOUT_S = 300


def _case_inputs(case):
    """Tables, state leaves and window of a case (the JAX
    ``__graft_entry__._tracking_inputs`` state, as
    tests/test_mesh_batch.py draws it)."""
    import __graft_entry__ as g

    _, fields, k = CASES[case]
    cfg = trt.TrackingConfig(**fields)
    _, st, _, _ = g._tracking_inputs(jrt.TrackingConfig(**fields), N_CH,
                                     seed=0)
    leaves = {f.name: np.array(getattr(st, f.name))
              for f in dataclasses.fields(st)}
    if cfg.profile == "kaplan":     # past the FLL's convergence gate
        leaves["code_counter"][:] = 150
    prns = [(i % 32) + 1 for i in range(N_CH)]
    tables = (tbr.tiled_code_bits(prns) if cfg.runtime == "batch"
              else code_table(prns))
    rng = np.random.default_rng(1)
    n = (cfg.tail_ms + k * cfg.block_ms) * cfg.samples_per_ms
    wre = rng.standard_normal(n).astype(np.float32)
    wim = rng.standard_normal(n).astype(np.float32)
    return cfg, k, tables, leaves, wre, wim


def _port_step(cfg, k, tables, leaves, wre, wim):
    args = (torch.from_numpy(tables), state_from_numpy(leaves, "cpu"),
            torch.from_numpy(wre), torch.from_numpy(wim))
    if cfg.runtime != "batch":
        return trt.run_block(cfg, *args)
    if k > 1:
        return tbr.run_superblock(cfg, k, *args)
    return tbr.run_block_batched(cfg, *args)


def _jax_step(mesh_name, cfg, k, tables, leaves, wre, wim):
    """The JAX package's sharded step on 4 (or 2) virtual devices; its
    dense pass B stands in for the prefix form."""
    from sydr_tpu.channels.state import ChannelState

    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    fields.update(use_pallas=False, boundary_mode="rowsum")
    jcfg = jrt.TrackingConfig(**fields)
    n_shards = int(mesh_name[0])
    mesh = jmesh.make_mesh(n_ch_shards=n_shards, n_dop_shards=1,
                           devices=jax.devices()[:n_shards])
    st = ChannelState(**{n: jnp.asarray(v) for n, v in leaves.items()})
    if cfg.runtime != "batch":
        run = jmesh.make_sharded_run_block(jcfg, mesh)
        st, out = run(jnp.asarray(tables), st, jnp.asarray(wre),
                      jnp.asarray(wim))
    else:
        shard_ch, repl = jmesh.batch_shardings(mesh)
        step = jmesh.make_sharded_batch_step(jcfg, mesh, k_blocks=k)
        st, out = step(
            jax.device_put(jnp.asarray(tables), shard_ch),
            jax.tree_util.tree_map(lambda x: jax.device_put(x, shard_ch), st),
            jax.device_put(jnp.asarray(wre), repl),
            jax.device_put(jnp.asarray(wim), repl))
    return {key: np.asarray(v) for key, v in out.items()}


def _pcps_inputs():
    fs, coh, nc = 1.023e6, 2, 2
    gen = IQGenerator(fs, noise=True, seed=5)
    for prn, dop, cp in ((1, 1500.0, 100.0), (2, -2500.0, 700.0),
                         (3, 500.0, 20.0), (4, -3000.0, 1000.0)):
        gen.add_satellite(prn, doppler_hz=dop, code_phase_chips=cp,
                          cn0_dbhz=50.0)
    iq = gen.generate_ms(coh * nc)
    code_k = np.stack([tacq.code_fft_conj(p, fs) for p in (1, 2, 3, 4)])
    return {"pcps__iq_re": np.float32(np.tile(iq.real, (4, 1))),
            "pcps__iq_im": np.float32(np.tile(iq.imag, (4, 1))),
            "pcps__code_k": code_k.astype(np.complex64),
            "pcps__bins": tacq.doppler_bins(4000, 500),
            "pcps__fs": np.asarray(fs), "pcps__coherent": np.asarray(coh),
            "pcps__non_coherent": np.asarray(nc)}


def _session_samples(n_blocks):
    """The signal of test_mesh_batch.py's closed-loop session."""
    bits = np.random.default_rng(3).integers(0, 2, 200)
    gen = IQGenerator(SESSION_FS, noise=True, seed=7)
    gen.add_satellite(5, doppler_hz=1200.0, code_phase_chips=321.4,
                      cn0_dbhz=46.0, nav_bits=bits)
    gen.add_satellite(12, doppler_hz=-2600.0, code_phase_chips=811.9,
                      cn0_dbhz=46.0, nav_bits=bits)
    iq = gen.generate_ms(n_blocks * SESSION_CFG["superblock"]
                         * SESSION_CFG["block_ms"])
    return np.float32(iq.real), np.float32(iq.imag)


def _drive_session(prns, sre, sim, mesh=None):
    session = TrackingSession(
        trt.TrackingConfig(**SESSION_CFG), prns,
        AcquisitionConfig(coherent=2, non_coherent=3), device="cpu",
        mesh=mesh)
    step = session.block_input_samples
    outs = [session.process_block(sre[k:k + step], sim[k:k + step])
            for k in range(0, len(sre), step)]
    return session, {k: np.concatenate([o[k] for o in outs])
                     for k in outs[0]}


def _session_entries(prns, sre, sim):
    return {**w.config_entries("session", trt.TrackingConfig(**SESSION_CFG)),
            "session__prns": np.asarray(prns), "session__re": sre,
            "session__im": sim}


def _graph_entries():
    """The stand-in sessions' configurations and signal."""
    entries = {}
    for runtime, cruise in GRAPH_CRUISE.items():
        pull_in = trt.TrackingConfig(runtime=runtime, **GRAPH_PULL_IN)
        entries.update(w.config_entries(f"graph_{runtime}_pull_in", pull_in))
        entries.update(w.config_entries(
            f"graph_{runtime}_cruise", dataclasses.replace(pull_in, **cruise)))
    entries["graph__re"], entries["graph__im"] = _session_samples(GRAPH_BLOCKS)
    return entries


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Spawn the 4-rank world once; meanwhile run the unsharded port here."""
    workdir = str(tmp_path_factory.mktemp("torch_mesh"))
    entries = {"cases": np.asarray(list(CASES))}
    inputs = {}
    for case, (mesh_name, _, _) in CASES.items():
        cfg, k, tables, leaves, wre, wim = inputs[case] = _case_inputs(case)
        entries.update(w.config_entries(case, cfg))
        entries.update(w.state_entries(case, leaves))
        entries.update({f"{case}__tables": tables, f"{case}__wre": wre,
                        f"{case}__wim": wim,
                        f"{case}__k_blocks": np.asarray(k),
                        f"{case}__mesh": np.asarray(mesh_name)})
    pcps = _pcps_inputs()
    sre, sim = _session_samples(5)
    entries.update(pcps)
    entries.update(_session_entries(SESSION_PRNS, sre, sim))
    entries.update(_graph_entries())
    np.savez(f"{workdir}/inputs.npz", **entries)
    procs = w.spawn("mesh", 4, workdir)
    try:
        port = {}
        for case, args in inputs.items():
            st, out = _port_step(*args)
            port[case] = (st, {key: v.numpy() for key, v in out.items()})
        corr = tacq.pcps_map(
            torch.from_numpy(pcps["pcps__iq_re"]),
            torch.from_numpy(pcps["pcps__iq_im"]),
            torch.from_numpy(pcps["pcps__code_k"]),
            torch.from_numpy(pcps["pcps__bins"]),
            sampling_frequency=float(pcps["pcps__fs"]), coherent=2,
            non_coherent=2)
        port["pcps"] = [x.numpy() for x in tacq.peak_metric(
            corr, torch.from_numpy(pcps["pcps__bins"]), samples_per_chip=1)]
        port["session"] = _drive_session(SESSION_PRNS, sre, sim)
    finally:
        w.wait(procs, timeout=WORLD_TIMEOUT_S)
    return workdir, inputs, port


def _gathered(workdir, case, n_ranks, key):
    """A case's ``key`` from every rank's rows, in row order (axis 1 for
    outputs, 0 for state)."""
    parts = [w.load(workdir, case, r) for r in range(n_ranks)]
    axis = 1 if key.startswith("out_") else 0
    return np.concatenate([p[key] for p in parts], axis=axis)


def _ranks(case):
    # On the (2, 2) mesh ranks 2r and 2r + 1 hold the same rows.
    return [0, 1, 2, 3] if CASES[case][0] == "4x1" else [0, 2]


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_step_equals_unsharded(world, case):
    workdir, _, port = world
    st_ref, out_ref = port[case]
    ranks = _ranks(case)
    per = N_CH // len(ranks)
    exact = CASES[case][1].get("fll_discriminator", "atan") == "atan"
    for i, r in enumerate(ranks):
        got = w.load(workdir, case, r)
        rows = slice(i * per, (i + 1) * per)
        assert tuple(got["rows"]) == (rows.start, rows.stop)
        pairs = [(f"out_{k}", v[:, rows]) for k, v in out_ref.items()] + [
            (f"st_{n}", getattr(st_ref, n)[rows].numpy()) for n in FIELDS]
        for key, ref in pairs:
            if exact or ref.dtype.kind != "f":
                np.testing.assert_array_equal(got[key], ref, err_msg=key)
            else:
                np.testing.assert_allclose(got[key], ref, rtol=1e-6,
                                           atol=1e-30, err_msg=key)


@pytest.mark.parametrize("case", ["superblock_k1", "superblock_prefix"])
def test_dop_replicas_agree(world, case):
    """On the (2, 2) mesh the two ranks of a ``dop`` line run the same
    channel rows and must agree."""
    workdir = world[0]
    for r in (0, 2):
        a, b = w.load(workdir, case, r), w.load(workdir, case, r + 1)
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_step_matches_jax(world, case):
    workdir, inputs, _ = world
    mesh_name = CASES[case][0]
    cfg, k, tables, leaves, wre, wim = inputs[case]
    out_j = _jax_step(mesh_name, cfg, k, tables, leaves, wre, wim)
    ranks = _ranks(case)
    parts = [w.load(workdir, case, r) for r in ranks]
    out_t = {key: np.concatenate([p[f"out_{key}"] for p in parts], axis=1)
             for key in out_j}
    for key in ("active", "required", "unread"):
        np.testing.assert_array_equal(out_t[key], out_j[key], err_msg=key)
    got = np.stack([out_t[key] for key in CORR_KEYS])
    ref = np.stack([out_j[key] for key in CORR_KEYS])
    err = np.abs(got - ref)
    peak = max(np.abs(wre).max(), np.abs(wim).max())
    assert (err > 1.0 + 2e-3 * np.abs(ref)).mean() <= 0.05, err.max()
    assert err.max() <= 1.0 + 2 * (2.0 * peak), err.max()
    np.testing.assert_allclose(out_t["carrier_freq"], out_j["carrier_freq"],
                               atol=0.2)


def test_sharded_pcps_equals_unsharded(world):
    workdir, _, port = world
    doppler, code_idx, metric = port["pcps"]
    for r in range(4):
        got = w.load(workdir, "pcps", r)
        np.testing.assert_array_equal(got["doppler"], doppler)
        np.testing.assert_array_equal(got["code_index"], code_idx)
        np.testing.assert_allclose(got["metric"], metric, rtol=1e-6)
    assert metric.min() > 2.0     # four satellites at 50 dB-Hz


@pytest.mark.parametrize("rank", [0, 1, 2, 3])
def test_session_with_mesh_equals_unsharded(world, rank):
    workdir, _, port = world
    session, out_ref = port["session"]
    got = w.load(workdir, "session", rank)
    assert sorted(session.acq_results) == [0, 1]
    for key in ("doppler", "code_index", "metric"):
        np.testing.assert_array_equal(
            got[f"acq_{key}"], [session.acq_results[i][key] for i in (0, 1)])
    for key, ref in out_ref.items():
        np.testing.assert_array_equal(got[f"out_{key}"], ref, err_msg=key)
    for n in FIELDS:
        np.testing.assert_array_equal(
            got[f"st_{n}"], getattr(session.state, n).numpy(), err_msg=n)
    assert out_ref["active"][-20:, :2].all()


def test_session_channel_count_must_divide(world):
    for r in range(4):
        raised = str(w.load(world[0], "indivisible", r)["raised"])
        assert "3 channels do not divide over 2 'ch' shards" in raised


def test_gloo_mesh_is_not_captured(world):
    for r in range(4):
        got = w.load(world[0], "mesh_backend", r)
        assert str(got["backend"]) == "gloo"
        assert not bool(got["captures"])
        assert bool(got["default_graph"])          # the session's is eager


@pytest.mark.parametrize("rank", [0, 1, 2, 3])
@pytest.mark.parametrize("runtime", list(GRAPH_CRUISE))
def test_mesh_session_graph_stand_in_equals_eager(world, runtime, rank):
    eager = w.load(world[0], f"graph_{runtime}_eager", rank)
    graph = w.load(world[0], f"graph_{runtime}_graph", rank)
    head = w.load(world[0], f"graph_{runtime}_eager", 0)
    assert sorted(eager) == sorted(graph)
    for key in eager:
        if key != "replays":
            np.testing.assert_array_equal(graph[key], eager[key],
                                          err_msg=key)
            np.testing.assert_array_equal(eager[key], head[key],
                                          err_msg=f"rank 0 {key}")
    promoted_at, calls = int(eager["promoted_at"]), len(eager["lengths"])
    assert 0 < promoted_at < calls - 1            # cruise replayed
    assert len(eager["replays"]) == 0
    assert len(graph["replays"]) == 2 and (graph["replays"] > 0).all()
    assert eager["out_active"][-20:, :2].all()


@pytest.mark.slow
def test_session_with_mesh_closed_loop(tmp_path):
    """The closed-loop session of test_mesh_batch.py on 4 ranks: tracking
    behaviour as the JAX test asks, and bit for bit the unsharded port."""
    prns = [5, 12, 0, 0]
    sre, sim = _session_samples(30)
    np.savez(tmp_path / "inputs.npz", **_session_entries(prns, sre, sim))
    procs = w.spawn("session_closed_loop", 4, str(tmp_path))
    try:
        _, out_ref = _drive_session(prns, sre, sim)
    finally:
        w.wait(procs, timeout=600)
    for r in range(4):
        got = w.load(str(tmp_path), "closed_loop", r)
        for key, ref in out_ref.items():
            np.testing.assert_array_equal(got[f"out_{key}"], ref,
                                          err_msg=key)
    assert out_ref["active"][-100:, :2].all()
    for i, dop in enumerate((1200.0, -2600.0)):
        cf = out_ref["carrier_freq"][-100:, i].mean()
        assert abs(cf - dop) < 5.0, (i, cf)
        assert out_ref["flags"][-1, i] & FLAG_BIT_SYNC
