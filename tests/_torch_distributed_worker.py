"""One rank of the port's multi-process tests, and the helper that spawns
a gloo world of them.

Usage: python _torch_distributed_worker.py <suite> <port> <rank> <world>
<dir>. Every rank joins a gloo process group on 127.0.0.1:<port>, reads
the suite's inputs from ``<dir>/inputs.npz`` (written by the test), runs
every case of the suite on CPU tensors and writes ``<dir>/<case>_r<rank>.npz``;
it prints ``WORKER_OK <rank>`` last. Imports only torch, numpy and
sydr_tpu_torch. Suites: ``distributed`` (tests/test_torch_distributed.py),
``mesh`` and ``session_closed_loop`` (tests/test_torch_mesh.py),
``timeshard`` (tests/test_torch_timeshard.py).
"""

from __future__ import annotations

import dataclasses
import os
import socket
import subprocess
import sys

import numpy as np

WORKER = os.path.abspath(__file__)
ROOT = os.path.dirname(os.path.dirname(WORKER))
RANK_TIMEOUT_S = 60     # a collective waiting on a dead rank gives up


# ---------------------------------------------------------------------------
# The test side: spawn a world and wait for it
# ---------------------------------------------------------------------------

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(suite: str, world: int, workdir: str) -> list:
    """Start ``world`` ranks of ``suite`` (they read ``workdir``)."""
    port = free_port()
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + os.environ.get("PYTHONPATH", "").split(os.pathsep))
    return [subprocess.Popen(
        [sys.executable, WORKER, suite, str(port), str(r), str(world),
         workdir], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env) for r in range(world)]


def wait(procs: list, timeout: float = 120.0) -> None:
    """Wait for every rank (``timeout`` seconds in all); raise with the
    output tail of the first rank that failed."""
    import time

    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0 or f"WORKER_OK {r}" not in out:
            raise AssertionError(
                f"rank {r} rc={p.returncode}\n{out[-4000:]}")


def run_world(suite: str, world: int, workdir: str,
              timeout: float = 120.0) -> None:
    wait(spawn(suite, world, workdir), timeout)


def config_entries(prefix: str, cfg) -> dict:
    """A TrackingConfig (of either package) as ``inputs.npz`` entries."""
    return {f"{prefix}__{f.name}": np.asarray(getattr(cfg, f.name))
            for f in dataclasses.fields(cfg)}


def state_entries(prefix: str, leaves: dict) -> dict:
    """A state's ``{field: array}`` leaves as ``inputs.npz`` entries."""
    return {f"{prefix}__st_{k}": np.asarray(v) for k, v in leaves.items()}


def load(workdir: str, case: str, rank: int) -> dict:
    with np.load(os.path.join(workdir, f"{case}_r{rank}.npz")) as f:
        return dict(f)


# ---------------------------------------------------------------------------
# The rank side
# ---------------------------------------------------------------------------

def _save(workdir, case, rank, state=None, outputs=None, **extra):
    from sydr_tpu_torch.channels.state import state_to_numpy

    arrays = dict(extra)
    if state is not None:
        arrays.update({f"st_{k}": v for k, v in state_to_numpy(state).items()})
    if outputs is not None:
        arrays.update({f"out_{k}": v.numpy() for k, v in outputs.items()})
    np.savez(os.path.join(workdir, f"{case}_r{rank}.npz"), **arrays)


def _config(inputs, prefix):
    """The TrackingConfig stored as ``<prefix>__<field>`` entries."""
    from sydr_tpu_torch.channels.runtime import TrackingConfig

    kw = {}
    for f in dataclasses.fields(TrackingConfig):
        key = f"{prefix}__{f.name}"
        if key in inputs:
            v = inputs[key]
            kw[f.name] = v.item() if v.ndim == 0 else tuple(v.tolist())
    return TrackingConfig(**kw)


def _state(inputs, prefix, rows=slice(None)):
    from sydr_tpu_torch.channels.state import FIELDS, state_from_numpy

    return state_from_numpy(
        {n: inputs[f"{prefix}__st_{n}"][rows] for n in FIELDS}, "cpu")


def _tensor(a):
    import torch

    return torch.from_numpy(np.ascontiguousarray(a))


def _ch_step_case(inputs, mesh, case, rank, workdir):
    """A ``make_sharded_batch_step`` case: this rank's rows through the
    step; the tables, state and window from ``inputs[case__*]``."""
    from sydr_tpu_torch.parallel import distributed, mesh as pmesh

    cfg = _config(inputs, case)
    tables = inputs[f"{case}__tables"]
    rows = pmesh.channel_slice(mesh, tables.shape[0])
    k_blocks = int(inputs[f"{case}__k_blocks"])
    if cfg.runtime == "batch":
        step = pmesh.make_sharded_batch_step(cfg, mesh, k_blocks=k_blocks)
    else:
        step = pmesh.make_sharded_run_block(cfg, mesh)
    st, out = step(
        distributed.shard_from_hosts(mesh, "ch", tables[rows], "cpu"),
        _state(inputs, case, rows),
        distributed.replicate_from_host(mesh, inputs[f"{case}__wre"], "cpu"),
        distributed.replicate_from_host(mesh, inputs[f"{case}__wim"], "cpu"))
    _save(workdir, case, rank, st, out, rows=np.array([rows.start, rows.stop]))


def suite_distributed(inputs, rank, world, workdir):
    import torch

    from sydr_tpu_torch.parallel import distributed

    mesh = distributed.global_mesh(("ch",))
    for case in ("block", "prefix", "superblock"):
        _ch_step_case(inputs, mesh, case, rank, workdir)
    mine = np.full(3, 10.0 * (rank + 1), np.float32)
    got = distributed.replicate_from_host(mesh, mine, "cpu", broadcast=True)
    same = distributed.replicate_from_host(mesh, mine, "cpu")
    gathered = distributed.gather_axis(
        mesh, "ch", torch.full((2, 3), rank, dtype=torch.int32), dim=0)
    _save(workdir, "collectives", rank, broadcast=got.numpy(),
          local=same.numpy(), gathered=gathered.numpy())


def suite_mesh(inputs, rank, world, workdir):
    import torch

    from sydr_tpu_torch.parallel import mesh as pmesh
    from sydr_tpu_torch.receiver.session import (
        AcquisitionConfig, TrackingSession)

    meshes = {"4x1": pmesh.make_mesh(4, 1), "2x2": pmesh.make_mesh(2, 2)}
    for case in [str(c) for c in inputs["cases"]]:
        _ch_step_case(inputs, meshes[str(inputs[f"{case}__mesh"])], case,
                      rank, workdir)

    code_k = torch.from_numpy(inputs["pcps__code_k"])
    doppler, code_idx, metric = pmesh.sharded_pcps(
        meshes["2x2"], _tensor(inputs["pcps__iq_re"]),
        _tensor(inputs["pcps__iq_im"]), code_k, inputs["pcps__bins"],
        sampling_frequency=float(inputs["pcps__fs"]),
        coherent=int(inputs["pcps__coherent"]),
        non_coherent=int(inputs["pcps__non_coherent"]))
    _save(workdir, "pcps", rank, doppler=doppler.numpy(),
          code_index=code_idx.numpy(), metric=metric.numpy())

    cfg = _config(inputs, "session")
    acq_cfg = AcquisitionConfig(coherent=2, non_coherent=3)
    prns = [int(p) for p in inputs["session__prns"]]
    session = TrackingSession(cfg, prns, acq_cfg, device="cpu",
                              mesh=meshes["2x2"])
    sre, sim = inputs["session__re"], inputs["session__im"]
    step = session.block_input_samples
    outs = [session.process_block(sre[k:k + step], sim[k:k + step])
            for k in range(0, len(sre), step)]
    merged = {f"out_{k}": np.concatenate([o[k] for o in outs])
              for k in outs[0]}
    acq = {f"acq_{k}": np.array([session.acq_results[i][k]
                                 for i in sorted(session.acq_results)])
           for k in ("doppler", "code_index", "metric")}
    _save(workdir, "session", rank, session.state, None, **merged, **acq)

    try:
        TrackingSession(cfg, prns[:3], acq_cfg, device="cpu",
                        mesh=meshes["2x2"])
        raised = ""
    except AssertionError as e:
        raised = str(e)
    _save(workdir, "indivisible", rank, raised=np.array(raised))

    mesh = meshes["2x2"]
    _save(workdir, "mesh_backend", rank, backend=np.array(mesh.backend),
          captures=np.array(mesh.captures),
          default_graph=np.array(session.graph is None))
    for runtime in ("batch", "scan"):
        for form in ("eager", "graph"):
            _graph_session_case(inputs, mesh, runtime, form, rank, workdir)


def _graph_session_case(inputs, mesh, runtime, form, rank, workdir):
    """A pull-in -> cruise mesh session over ``graph__re/im``, its step
    eager or through the graph's CPU stand-in
    (``StepGraph(cpu, capture=False)``): every call's outputs, the call
    lengths, the final state, and the stand-in's graphs and replays."""
    from sydr_tpu_torch.receiver.session import (
        AcquisitionConfig, TrackingSession)
    from sydr_tpu_torch.ops.step_graph import StepGraph

    session = TrackingSession(
        _config(inputs, f"graph_{runtime}_pull_in"),
        [int(p) for p in inputs["session__prns"]],
        AcquisitionConfig(coherent=2, non_coherent=3),
        cruise=_config(inputs, f"graph_{runtime}_cruise"), device="cpu",
        mesh=mesh)
    if form == "graph":
        session.graph = StepGraph("cpu", capture=False)
    sre, sim = inputs["graph__re"], inputs["graph__im"]
    outs, pos, promoted_at = [], 0, -1
    while pos + session.block_input_samples <= len(sre):
        n = session.block_input_samples
        outs.append(session.process_block(sre[pos:pos + n],
                                          sim[pos:pos + n]))
        pos += n
        if promoted_at < 0 and session.promoted:
            promoted_at = len(outs)
    graphs = session.graph.graphs if session.graph is not None else {}
    _save(workdir, f"graph_{runtime}_{form}", rank, session.state, None,
          **{f"out_{k}": np.concatenate([o[k] for o in outs])
             for k in outs[0]},
          lengths=np.array([len(o["flags"]) for o in outs]),
          promoted_at=np.array(promoted_at),
          replays=np.array([e.replays for e in graphs.values()], int))


def suite_session_closed_loop(inputs, rank, world, workdir):
    from sydr_tpu_torch.parallel import mesh as pmesh
    from sydr_tpu_torch.receiver.session import (
        AcquisitionConfig, TrackingSession)

    mesh = pmesh.make_mesh(world, 1)
    cfg = _config(inputs, "session")
    session = TrackingSession(
        cfg, [int(p) for p in inputs["session__prns"]],
        AcquisitionConfig(coherent=2, non_coherent=3), device="cpu",
        mesh=mesh)
    sre, sim = inputs["session__re"], inputs["session__im"]
    step = session.block_input_samples
    outs = [session.process_block(sre[k:k + step], sim[k:k + step])
            for k in range(0, len(sre), step)]
    _save(workdir, "closed_loop", rank, **{
        f"out_{k}": np.concatenate([o[k] for o in outs]) for k in outs[0]})


def suite_timeshard(inputs, rank, world, workdir):
    from sydr_tpu_torch.parallel import distributed, mesh as pmesh
    from sydr_tpu_torch.parallel import timeshard

    meshes = {4: timeshard.make_sp_mesh(4),
              2: distributed.global_mesh(("ch", "sp"), (2, 2))}
    bits = inputs["bits3x"]
    wre, wim = _tensor(inputs["wre"]), _tensor(inputs["wim"])
    for case in [str(c) for c in inputs["cases"]]:
        cfg = _config(inputs, case)
        mesh = meshes[int(inputs[f"{case}__n_sp"])]
        rows = (pmesh.channel_slice(mesh, bits.shape[0])
                if "ch" in mesh.shape else slice(0, bits.shape[0]))
        st, out = timeshard.run_block_batched_timesharded(
            cfg, mesh, _tensor(bits[rows]), _state(inputs, "state", rows),
            wre, wim)
        _save(workdir, case, rank, st, out,
              rows=np.array([rows.start, rows.stop]))

    # The shard's inputs at its edge: one anchor column past its own.
    cfg = _config(inputs, "rowsum_sp4")
    fb_q = _tensor(inputs["edge__fb_q"])
    win_re, _, fb_l, _, m0 = timeshard.shard_inputs(
        cfg, 4, meshes[4].coords["sp"], wre, wim, fb_q, fb_q)
    _save(workdir, "edge", rank, fb_l=fb_l.numpy(), n_win=len(win_re),
          m0=m0)

    cfg21 = _config(inputs, "block21")
    try:
        timeshard.run_block_batched_timesharded(
            cfg21, meshes[4], _tensor(bits), _state(inputs, "state"),
            _tensor(inputs["wre21"]), _tensor(inputs["wim21"]))
        raised = ""
    except AssertionError as e:
        raised = str(e)
    _save(workdir, "block21", rank, raised=np.array(raised))

    cfg = _config(inputs, "superblock")
    st, out = timeshard.run_superblock_timesharded(
        cfg, meshes[4], 2, _tensor(bits), _state(inputs, "state"),
        _tensor(inputs["sre"]), _tensor(inputs["sim"]))
    _save(workdir, "superblock", rank, st, out)

    _timeshard_graph_cases(inputs, meshes, rank, workdir)


def _timeshard_graph_cases(inputs, meshes, rank, workdir):
    """Every case above, and the superblock, through ``TimeShardGraph``
    with the graph's CPU stand-in: the first call (the warm-up) and the
    second (where a replay runs)."""
    from sydr_tpu_torch.parallel import mesh as pmesh
    from sydr_tpu_torch.parallel import timeshard
    from sydr_tpu_torch.ops.step_graph import StepGraph

    bits = inputs["bits3x"]
    wre, wim = _tensor(inputs["wre"]), _tensor(inputs["wim"])
    default = timeshard.TimeShardGraph(meshes[4], "cpu")
    _save(workdir, "ts_graph_default", rank,
          eager=np.array(default.graph is None))
    runners = {}
    for n_sp, mesh in meshes.items():
        runners[n_sp] = timeshard.TimeShardGraph(
            mesh, "cpu", graph=StepGraph("cpu", capture=False))
    for case in [str(c) for c in inputs["cases"]]:
        cfg = _config(inputs, case)
        runner = runners[int(inputs[f"{case}__n_sp"])]
        rows = (pmesh.channel_slice(runner.mesh, bits.shape[0])
                if "ch" in runner.mesh.shape else slice(0, bits.shape[0]))
        for call in (0, 1):
            st, out = runner.block(cfg, _tensor(bits[rows]),
                                   _state(inputs, "state", rows), wre, wim)
            _save(workdir, f"{case}_graph{call}", rank, st, out)
    cfg = _config(inputs, "superblock")
    for call in (0, 1):
        st, out = runners[4].superblock(
            cfg, 2, _tensor(bits), _state(inputs, "state"),
            _tensor(inputs["sre"]), _tensor(inputs["sim"]))
        _save(workdir, f"superblock_graph{call}", rank, st, out)


def main(argv) -> None:
    suite, port, rank, world, workdir = argv
    rank, world = int(rank), int(world)
    import torch

    torch.set_num_threads(1)
    from sydr_tpu_torch.parallel import distributed

    distributed.initialize("gloo", rank=rank, world_size=world,
                           init_method=f"tcp://127.0.0.1:{port}",
                           timeout_s=RANK_TIMEOUT_S)
    with np.load(os.path.join(workdir, "inputs.npz")) as f:
        inputs = dict(f)
    globals()[f"suite_{suite}"](inputs, rank, world, workdir)
    distributed.shutdown()
    print(f"WORKER_OK {rank}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
