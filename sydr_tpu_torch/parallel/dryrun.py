"""Dry run of the multi-device paths over N ranks.

    python -m sydr_tpu_torch.parallel.dryrun --world N --backend gloo|nccl \\
        [--device cuda|cpu]

Spawns N ranks on ``torch.distributed`` (127.0.0.1, a free port) and runs,
in this order, at a small size (1.023 Msps, 2 ms blocks; 2.046 Msps for
the time shards so that the prefix form applies):

1. one ``mesh.sharded_pcps`` on a ``(ch, dop)`` mesh, ``dop = 2`` when N
   is even;
2. one channel-sharded step in each runtime: a batch superblock of 2
   blocks, and a scan-runtime block;
3. one time-sharded block over all N ranks in each pass B form: K1 row
   sums and the K3 prefix;
4. the session's channel-sharded step (2., with its ``all_gather`` of
   state and outputs) in each runtime and the time-sharded block (3.) in
   each form through their graphs (``ops.step_graph.StepGraph``,
   ``timeshard.TimeShardGraph``): captured CUDA graphs with ``nccl``, the
   graph's stand-in (``capture=False``) on the CPU; none with ``gloo`` on
   a card, which cannot be captured. The first call (the warm-up) and a
   second (the replay) are each held bit for bit against the eager run.

Each rank prints its step times, its graphs' nodes and its kernel and
collective launches; rank 0 then prints ``dryrun_multichip OK: mesh=...
sp_shards=... n_channels=... graphs=...``. The channel step is held bit
for bit against the unsharded step on the rank's rows. A failing rank
fails the run (non-zero exit).

Devices: ``--device cuda`` (the default) puts rank r on card ``r mod
count``; ``nccl`` needs one card per rank (it refuses two ranks on one
card), ``gloo`` lets ranks share a card. ``--device cpu`` takes ``gloo``
only. The kernels are built once, before the ranks start.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import socket
import sys
import time

import numpy as np
import torch

TINY = dict(sampling_frequency=1.023e6, block_ms=2, tail_ms=2,
            window_size=1152)


def tracking_inputs(cfg, n_channels, device, seed=0):
    """PRNs (1..32 in turn), a tracking state of ``n_channels`` channels
    and the generator the windows are drawn from."""
    from sydr_tpu_torch.channels.state import MODE_TRACKING, init_state

    rng = np.random.default_rng(seed)
    state = dataclasses.replace(
        init_state(n_channels, device),
        mode=torch.full((n_channels,), MODE_TRACKING, dtype=torch.int32,
                        device=device),
        carrier_freq=torch.tensor(
            rng.uniform(-4000, 4000, n_channels).astype(np.float32),
            device=device),
        unread=torch.full((n_channels,), cfg.samples_per_ms,
                          dtype=torch.int32, device=device))
    return [(k % 32) + 1 for k in range(n_channels)], state, rng


def _window(rng, n, device):
    return torch.tensor(rng.standard_normal(n).astype(np.float32),
                        device=device)


def _timed(fn, device):
    """(result, milliseconds) of ``fn()``, the device drained."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    res = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return res, 1e3 * (time.perf_counter() - t0)


def _kernels():
    from sydr_tpu_torch.ops import acq_kernel
    from sydr_tpu_torch.ops import correlator_kernel as ck
    from sydr_tpu_torch.ops import loop_kernel, scan_kernel

    return {"epoch_correlate": ck.KERNEL,
            "block_cumsum_streams": ck.CUMSUM_KERNEL,
            "pass_c": loop_kernel.PASS_C_KERNEL,
            "scan_block": scan_kernel.SCAN_KERNEL,
            "pcps_bins": acq_kernel.KERNEL,
            "pcps_bins_cluster": acq_kernel.CLUSTER_KERNEL,
            "pcps_bins_twostep": acq_kernel.TWOSTEP_KERNEL,
            "pcps_bins_bluestein": acq_kernel.BLUESTEIN_KERNEL}


def _graph_runner(device, mesh):
    """The ``StepGraph`` for steps whose collectives go over ``mesh`` (see
    the module note, 4.): captured where the session's rule graphs them,
    the stand-in on the CPU, else None."""
    from sydr_tpu_torch.ops.step_graph import StepGraph, use_graph

    if use_graph(None, device, mesh):
        return StepGraph(device)
    if device.type == "cpu":
        return StepGraph(device, capture=False)
    return None


def _same(got, want) -> bool:
    """Two nests of tensors (tuples, dicts, states) equal bit for bit."""
    if isinstance(got, torch.Tensor):
        return torch.equal(got, want)
    if isinstance(got, dict):
        return got.keys() == want.keys() and all(
            _same(got[k], want[k]) for k in got)
    if dataclasses.is_dataclass(got):
        return all(_same(getattr(got, f.name), getattr(want, f.name))
                   for f in dataclasses.fields(got))
    return len(got) == len(want) and all(map(_same, got, want))


def _graph_phase(device, mesh, sp_mesh, steps, sp_cases, times) -> tuple:
    """4.: each channel step ``(name, fn, args)`` through a graph runner
    and each time-sharded case ``(name, cfg, bits, state, wre, wim)``
    through a ``TimeShardGraph``, twice, against the eager run. Returns
    what the runners were and their graphs' nodes by kind."""
    from sydr_tpu_torch.parallel import timeshard

    runner = _graph_runner(device, mesh)
    if runner is None:
        return "none", {}
    nodes = {}
    for name, fn, args in steps:
        want = fn(*args)
        for call in range(2):
            got, times[f"{name} graph {call}"] = _timed(
                lambda: runner.run(name, fn, args), device)
            assert _same(got, want), f"{name}: graph call {call} differs"
        nodes[name] = runner.graphs[name].node_kinds
    sp_graph = timeshard.TimeShardGraph(sp_mesh, device,
                                        graph=_graph_runner(device, sp_mesh))
    for name, cfg, bits, state, wre, wim in sp_cases:
        want = timeshard.run_block_batched_timesharded(cfg, sp_mesh, bits,
                                                       state, wre, wim)
        for call in range(2):
            got, times[f"{name} graph {call}"] = _timed(
                lambda: sp_graph.block(cfg, bits, state, wre, wim), device)
            assert _same(got, want), f"{name}: graph call {call} differs"
    nodes.update({f"sp {key[0].boundary_mode} block": entry.node_kinds
                  for key, entry in sp_graph.graph.graphs.items()})
    return "captured" if runner.capture else "stand-in", nodes


def run_rank(rank: int, world: int, backend: str, device_kind: str,
             port: int) -> None:
    from sydr_tpu_torch.channels import batch_runtime as br
    from sydr_tpu_torch.channels import runtime
    from sydr_tpu_torch.channels.state import (
        FIELDS, ChannelState, code_table, pack_state)
    from sydr_tpu_torch.ops import acquisition as acq
    from sydr_tpu_torch.parallel import distributed, mesh as pmesh, timeshard
    from sydr_tpu_torch.receiver.session import _sharded_step

    if device_kind == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
        torch.set_num_threads(1)
    distributed.initialize(backend, rank=rank, world_size=world,
                           init_method=f"tcp://127.0.0.1:{port}",
                           timeout_s=300)
    n_dop = 2 if world % 2 == 0 else 1
    mesh = pmesh.make_mesh(world // n_dop, n_dop)
    sp_mesh = timeshard.make_sp_mesh(world)
    cfg = runtime.TrackingConfig(runtime="batch", superblock=2, **TINY)
    n_channels = max(8, world)
    n_channels += (-n_channels) % mesh.shape["ch"]
    rows = pmesh.channel_slice(mesh, n_channels)
    times = {}

    # 1. Acquisition: (channel x Doppler)-sharded PCPS.
    prns, state, rng = tracking_inputs(cfg, n_channels, device)
    coherent = non_coherent = 2
    n = cfg.samples_per_ms
    iq = [_window(rng, n_channels * coherent * non_coherent * n,
                  device).reshape(n_channels, -1) for _ in range(2)]
    code_k = torch.tensor(np.stack([
        acq.code_fft_conj(p, cfg.sampling_frequency) for p in prns]),
        dtype=torch.complex64, device=device)
    (doppler, _, metric), times["sharded_pcps"] = _timed(
        lambda: pmesh.sharded_pcps(
            mesh, *iq, code_k, acq.doppler_bins(4000, 500),
            sampling_frequency=cfg.sampling_frequency, coherent=coherent,
            non_coherent=non_coherent), device)
    assert doppler.shape == metric.shape == (n_channels,)
    assert bool(torch.isfinite(metric).all())

    # 2. Channel-sharded steps: batch superblock, scan block.
    bits = torch.tensor(br.tiled_code_bits(prns), device=device)
    sre, sim = (_window(rng, (cfg.tail_ms + 2 * cfg.block_ms) * n, device)
                for _ in range(2))
    local = ChannelState(**{f: getattr(state, f)[rows] for f in FIELDS})
    step = pmesh.make_sharded_batch_step(cfg, mesh, k_blocks=2)
    (_, out), times["ch batch superblock"] = _timed(
        lambda: step(bits[rows], local, sre, sim), device)
    assert out["i_prompt"].shape == (2 * cfg.block_ms, rows.stop - rows.start)
    _, ref = br.run_superblock(cfg, 2, bits, state, sre, sim)
    for key, v in out.items():
        assert torch.equal(v, ref[key][:, rows]), key
    ch_step_ms = min(_timed(lambda: step(bits[rows], local, sre, sim),
                            device)[1] for _ in range(3))
    scan_cfg = dataclasses.replace(cfg, runtime="scan", superblock=1)
    codes = torch.tensor(code_table(prns), device=device)
    scan = pmesh.make_sharded_run_block(scan_cfg, mesh)
    (_, out), times["ch scan block"] = _timed(
        lambda: scan(codes[rows], local, sre[:scan_cfg.window_samples],
                     sim[:scan_cfg.window_samples]), device)
    assert out["i_prompt"].shape == (cfg.block_ms, rows.stop - rows.start)

    # 3. Time-sharded blocks in both pass B forms.
    sp_block = 2 * world - 2 if world > 1 else 2
    sp_cases = []
    for form in ("rowsum", "prefix"):
        sp_cfg = runtime.TrackingConfig(**dict(
            TINY, sampling_frequency=2.046e6, window_size=2304,
            block_ms=sp_block), runtime="batch",
            use_pallas=form == "prefix", boundary_mode=form)
        _, sp_state, sp_rng = tracking_inputs(sp_cfg, n_channels, device)
        wre, wim = (_window(sp_rng, sp_cfg.window_samples, device)
                    for _ in range(2))
        (_, out), times[f"sp {form} block"] = _timed(
            lambda: timeshard.run_block_batched_timesharded(
                sp_cfg, sp_mesh, bits, sp_state, wre, wim), device)
        assert out["i_prompt"].shape == (sp_block, n_channels)
        assert bool(torch.isfinite(out["i_prompt"]).all())
        sp_cases.append((f"sp {form} block", sp_cfg, bits, sp_state, wre,
                         wim))

    # 4. The session's channel steps (the step and its gathers over ch)
    # and the time-sharded blocks through their graphs.
    state_f, state_i = pack_state(state)
    steps = []
    for name, step_cfg, tables, win in (
            ("ch batch superblock", cfg, bits, (sre, sim)),
            ("ch scan block", scan_cfg, codes,
             (sre[:scan_cfg.window_samples], sim[:scan_cfg.window_samples]))):
        sharded = functools.partial(
            _sharded_step, pmesh.make_sharded_batch_step(
                step_cfg, mesh, k_blocks=step_cfg.superblock),
            mesh, rows, n_channels, tables[rows], {})
        steps.append((name, sharded, (state_f, state_i, *win)))
    graphs, nodes = _graph_phase(device, mesh, sp_mesh, steps, sp_cases,
                                 times)

    launches = {name: k.launches for name, k in _kernels().items()}
    collectives = {name: c.launches
                   for name, c in distributed.COLLECTIVES.items()}
    print(f"rank {rank} on {device}: " + ", ".join(
        f"{name} {ms:.1f} ms" for name, ms in times.items())
        + f"; graphs {graphs}, nodes {nodes}; launches {launches}; "
        f"collectives {collectives}", flush=True)
    distributed.all_reduce(sp_mesh, "sp", torch.ones(1, device=device))
    if rank == 0:
        print(f"dryrun_multichip OK: mesh={mesh.shape} sp_shards={world} "
              f"n_channels={n_channels} block_ms={cfg.block_ms} "
              f"ch_step_ms={ch_step_ms:.1f} backend={backend} "
              f"device={device_kind} graphs={graphs}", flush=True)
    distributed.shutdown()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--world", type=int, required=True)
    parser.add_argument("--backend", choices=("gloo", "nccl"),
                        required=True)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    opts = parser.parse_args(argv)
    if opts.device == "cuda":
        if not torch.cuda.is_available():
            print("no CUDA device: pass --device cpu for the CPU",
                  file=sys.stderr)
            return 2
        if opts.backend == "nccl" and opts.world > torch.cuda.device_count():
            print(f"nccl needs one card per rank: {opts.world} ranks, "
                  f"{torch.cuda.device_count()} cards", file=sys.stderr)
            return 2
        from sydr_tpu_torch.ops import native

        native.build_all(list(_kernels().values()))
    elif opts.backend == "nccl":
        print("nccl takes CUDA tensors: use --backend gloo with --device "
              "cpu", file=sys.stderr)
        return 2
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    import torch.multiprocessing as mp

    mp.spawn(run_rank, args=(opts.world, opts.backend, opts.device, port),
             nprocs=opts.world, join=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
