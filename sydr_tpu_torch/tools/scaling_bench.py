"""Multi-device scaling measurement on ``sydr_tpu_torch.parallel``.

Port of ``tools/scaling_bench.py``. The production tracking runtime shards
channel-wise with no collective (``parallel/mesh.make_sharded_batch_step``):
every rank runs the complete runtime on its channel rows with the sample
window replicated, so an n-rank step IS the one-device step at
``n_ch / n`` channels. Two sections:

Card section (``--chip``): the production superblock step (10 Msps input,
device boxcar by 4, narrow-only kaplan at 20 ms x 50 blocks, K1) at {32,
16, 8, 4} channels on one device: the per-shard step time of {1, 2, 4, 8}
-card channel meshes, with ``eff(n) = t(32) / (n * t(32 / n))`` and the
fit ``t(n_ch) = fixed + per_channel * n_ch``; the step captured as a CUDA
graph (the JAX tool times a jitted step), with the eager step's curve
beside it (``eager_*``, ``*_eager``).

Rank section (the default): ``gloo`` process groups of 1..N ranks on the
CPU (``--cpu``; or ranks sharing the card), in place of the JAX tool's
eight virtual devices:
  1. **collective census**: every call the channel-sharded step and the
     time-sharded block make into the backend's collectives
     (``all_reduce``, ``all_gather``; ``gather_axis`` counts as its
     ``all_gather``), read from ``parallel.distributed.COLLECTIVES``. The
     JAX design: 0 for the channel-sharded step; 1 all-gather + 1
     all-reduce per time-sharded block;
  2. **sharding overhead**: the 1-shard step against the unsharded step,
     interleaved;
  3. **wall curves** over 1..N ranks, strong (``--channels`` in all) and
     weak (8 channels a rank). On a shared host they record overhead, not
     an efficiency claim.

NCCL refuses two ranks on one card, so one card gives no multi-card
scaling number. Results print as one JSON object; ``--json-out PATH``
merges them into PATH.

Usage:
  python -m sydr_tpu_torch.tools.scaling_bench --cpu       # rank section
  python -m sydr_tpu_torch.tools.scaling_bench --chip      # card section
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import socket
import sys
import tempfile
import time

import numpy as np

# Channels a rank holds in the weak curve, and the time-sharded census's.
WEAK_CHANNELS = 8
SP_FS = 2.046e6     # at least 1024 samples a ms: the prefix form applies


@contextlib.contextmanager
def count_collectives():
    """Count the calls into the backend's collectives
    (``parallel.distributed.COLLECTIVES``) while the block runs; yields a
    ``Counter`` that holds them, by name, once the block has run."""
    from sydr_tpu_torch.parallel import distributed

    counts = collections.Counter()
    before = {name: c.launches for name, c in distributed.COLLECTIVES.items()}
    yield counts
    for name, c in distributed.COLLECTIVES.items():
        if c.launches > before[name]:
            counts[name] = c.launches - before[name]


# --------------------------------------------------------------------------
# Card section: per-shard step time vs channels per shard
# --------------------------------------------------------------------------
def chip_section(device, fs=10e6, decimate=4, superblock=50, n_blocks=10,
                 channel_counts=(32, 16, 8, 4), warmup=3,
                 block_ms=20) -> dict:
    """The per-shard curve. Each point times the step captured as one
    CUDA graph (``ops.step_graph.StepGraph``; the JAX tool times a
    jitted step): ``n_blocks`` replays between fences, each copying the
    state in and out; that is the primary curve. The eager step, which is
    launch-bound (each rank launches as many ops for 8 channels as for
    32), is timed beside it in turns (graphed, eager, eager, graphed;
    each form's mean): its ``eager_*`` numbers. On the CPU the graph is
    its stand-in (``capture=False``)."""
    import torch

    from sydr_tpu_torch.channels.state import pack_state, unpack_state
    from sydr_tpu_torch.ops.step_graph import StepGraph
    from sydr_tpu_torch.tools import device_name, sync
    from sydr_tpu_torch.tools.trace_profile import superblock_setup

    captured = torch.device(device).type == "cuda"
    out: dict = {"fs": fs, "decimate": decimate, "superblock": superblock,
                 "device": device_name(device),
                 "graph": "captured" if captured else "stand-in",
                 "points": {}}
    signal_s = n_blocks * superblock * block_ms * 1e-3
    for n_ch in channel_counts:
        *_, state, _, _, step = superblock_setup(
            device, n_channels=n_ch, fs=fs, decimate=decimate,
            block_ms=block_ms, superblock=superblock)
        runner = StepGraph(device, capture=captured)

        def packed(state_f, state_i):
            st, outputs = step(unpack_state(state_f, state_i))
            return (*pack_state(st), *outputs.values())

        def graphed(st):
            state_f, state_i, *_ = runner.run(n_ch, packed, pack_state(st))
            return unpack_state(state_f, state_i), None

        forms = {"graphed": graphed, "eager": step}
        walls = {name: [] for name in forms}
        for name in ("graphed", "eager", "eager", "graphed"):
            st = state
            if not walls[name]:           # the first builds the kernels
                for _ in range(1 + warmup):
                    st, _ = forms[name](st)
            sync(device)
            t0 = time.perf_counter()
            for _ in range(n_blocks):
                st, _ = forms[name](st)
            sync(device)
            walls[name].append((time.perf_counter() - t0) / n_blocks)
        step_s = {name: float(np.mean(w)) for name, w in walls.items()}
        out["points"][n_ch] = {
            "step_s": step_s["graphed"], "rtf": signal_s / n_blocks
            / step_s["graphed"], "eager_step_s": step_s["eager"],
            "eager_rtf": signal_s / n_blocks / step_s["eager"],
            "nodes": runner.graphs[n_ch].nodes}
        print(f"{device_name(device)} {n_ch:2d} ch: graphed "
              f"{step_s['graphed'] * 1e3:9.3f} ms/step (RTF "
              f"{signal_s / n_blocks / step_s['graphed']:.3f}), eager "
              f"{step_s['eager'] * 1e3:9.3f} ms/step (RTF "
              f"{signal_s / n_blocks / step_s['eager']:.3f})", flush=True)

    for suffix, key in (("", "step_s"), ("_eager", "eager_step_s")):
        _curve(out, suffix, key)
    return out


def _curve(out, suffix, key) -> None:
    """The fit ``t(n_ch) = fixed + per_channel * n_ch`` and ``eff(n)`` of
    the points' ``key`` times, as ``step_fit<suffix>`` and
    ``ch_mesh_strong_<n>ch<suffix>``."""
    # ``fixed`` is channel-count-independent work that every card of a ch
    # mesh repeats and bounds strong scaling; ``per_channel`` is what
    # shards away.
    ns = np.array(sorted(out["points"]), dtype=np.float64)
    ts = np.array([out["points"][int(n)][key] for n in ns])
    if len(ns) > 1:
        b_fit, a_fit = np.polyfit(ns, ts, 1)
        out[f"step_fit{suffix}"] = {"fixed_s": float(a_fit),
                                    "per_channel_s": float(b_fit)}
    n_max = int(max(ns))
    t_max = out["points"][n_max][key]
    eff = {}
    for n in (1, 2, 4, 8):
        if n_max % n == 0 and n_max // n in out["points"]:
            tn = out["points"][n_max // n][key]
            eff[n] = {"channels_per_card": n_max // n,
                      "per_shard_step_s": tn,
                      "efficiency": t_max / (n * tn)}
    out[f"ch_mesh_strong_{n_max}ch{suffix}"] = eff
    print(f"eff{suffix}(n) = t({n_max}) / (n t({n_max}/n)): " + ", ".join(
        f"n={n} ({e['channels_per_card']} ch) {e['efficiency']:.3f}"
        for n, e in eff.items()), flush=True)


# --------------------------------------------------------------------------
# Rank section: gloo process groups of 1..N ranks
# --------------------------------------------------------------------------
def _min_time(fn, reps, device):
    from sydr_tpu_torch.tools import sync

    fn()
    ts = []
    for _ in range(reps):
        sync(device)
        t0 = time.perf_counter()
        fn()
        sync(device)
        ts.append(time.perf_counter() - t0)
    return min(ts)


def _rank(rank, world, port, device_kind, params, outdir):
    """One rank of a ``world``-rank gloo group: its step times and, on a
    census run with more than one rank, the time-sharded block's
    collectives; writes ``rank<r>.json`` into ``outdir``."""
    import torch

    from sydr_tpu_torch.channels import batch_runtime as br
    from sydr_tpu_torch.channels.state import FIELDS, ChannelState
    from sydr_tpu_torch.parallel import distributed, mesh as pmesh, timeshard
    from sydr_tpu_torch.tools.trace_profile import superblock_setup

    if device_kind == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
        torch.set_num_threads(1)
    distributed.initialize("gloo", rank=rank, world_size=world,
                           init_method=f"tcp://127.0.0.1:{port}",
                           timeout_s=600)
    fs, sb, block_ms, reps = (params[k] for k in
                              ("fs", "superblock", "block_ms", "reps"))
    mesh = pmesh.make_mesh(world, 1)
    res = {"rank": rank, "world": world}

    def sharded(n_channels):
        cfg, bits, state, wre, wim, _ = superblock_setup(
            device, n_channels=n_channels, fs=fs, decimate=1,
            block_ms=block_ms, superblock=sb)
        rows = pmesh.channel_slice(mesh, n_channels)
        local = ChannelState(**{f: getattr(state, f)[rows] for f in FIELDS})
        step = pmesh.make_sharded_batch_step(cfg, mesh, k_blocks=sb)
        return (lambda: step(bits[rows], local, wre, wim)), \
            (cfg, bits, state, wre, wim)

    strong, (cfg, bits, state, wre, wim) = sharded(params["n_channels"])
    with count_collectives() as census:
        strong()
    res["ch_collectives_per_step"] = dict(census)
    res["strong_step_s"] = _min_time(strong, reps, device)
    weak, _ = sharded(WEAK_CHANNELS * world)
    res["weak_step_s"] = _min_time(weak, reps, device)
    if world == 1:
        # Interleave the plain and the 1-shard step: on a shared host
        # back-to-back loops see different host states.
        def plain():
            br.run_superblock(cfg, sb, bits, state, wre, wim)

        t_plain, t_one = [], []
        for _ in range(max(5, reps)):
            t_plain.append(_min_time(plain, 1, device))
            t_one.append(_min_time(strong, 1, device))
        res["unsharded_step_s"] = min(t_plain)
        res["sharded_1_step_s"] = min(t_one)
    if params["census"] and world > 1:
        sp_mesh = timeshard.make_sp_mesh(world)
        res["sp_collectives_per_block"] = {}
        for form in ("rowsum", "prefix"):
            cfg_sp, bits_sp, st_sp, wre_sp, wim_sp, _ = superblock_setup(
                device, n_channels=WEAK_CHANNELS, fs=SP_FS, decimate=1,
                block_ms=block_ms, superblock=1, boundary_mode=form)
            n_win = cfg_sp.window_samples
            with count_collectives() as census:
                timeshard.run_block_batched_timesharded(
                    cfg_sp, sp_mesh, bits_sp, st_sp, wre_sp[:n_win],
                    wim_sp[:n_win])
            res["sp_collectives_per_block"][form] = dict(census)
    distributed.shutdown()
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as fh:
        json.dump(res, fh)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# The JAX design's collectives (tools/scaling_bench.py): none in the
# channel-sharded step, one all-gather and one all-reduce per time-sharded
# block.
JAX_DESIGN = {"ch_per_step": {}, "sp_per_block": {"all_gather": 1,
                                                  "all_reduce": 1}}


def rank_section(device_kind="cpu", fs=2.046e6, n_channels=32, superblock=5,
                 block_ms=20, reps=5, worlds=(1, 2, 4, 8)) -> dict:
    """Step walls, overhead and census over gloo groups of ``worlds``
    ranks (module docstring); the census of the time-sharded block runs on
    the largest world."""
    import torch.multiprocessing as mp

    out: dict = {"backend": "gloo", "device": device_kind, "fs": fs,
                 "n_channels": n_channels, "superblock": superblock,
                 "block_ms": block_ms, "host_cores": os.cpu_count(),
                 "strong_scaling_wall": {}, "weak_scaling_wall": {}}
    signal_s = superblock * block_ms * 1e-3
    for world in worlds:
        params = {"fs": fs, "superblock": superblock, "block_ms": block_ms,
                  "reps": reps, "n_channels": n_channels,
                  "census": world == max(worlds)}
        with tempfile.TemporaryDirectory() as outdir:
            mp.spawn(_rank, args=(world, _free_port(), device_kind, params,
                                  outdir), nprocs=world, join=True)
            ranks = []
            for r in range(world):
                with open(os.path.join(outdir, f"rank{r}.json")) as fh:
                    ranks.append(json.load(fh))
        # a step ends when its slowest shard does
        t_strong = max(r["strong_step_s"] for r in ranks)
        t_weak = max(r["weak_step_s"] for r in ranks)
        out["strong_scaling_wall"][world] = {"step_s": t_strong,
                                             "rtf": signal_s / t_strong}
        out["weak_scaling_wall"][world] = {
            "n_channels": WEAK_CHANNELS * world, "step_s": t_weak,
            "channel_s_per_s": WEAK_CHANNELS * world * signal_s / t_weak}
        census = ranks[0]["ch_collectives_per_step"]
        out.setdefault("ch_collectives_per_step", {})[world] = census
        if world == 1:
            out["unsharded_step_s"] = ranks[0]["unsharded_step_s"]
            out["sharding_overhead_1shard"] = (
                ranks[0]["sharded_1_step_s"] / ranks[0]["unsharded_step_s"])
        if "sp_collectives_per_block" in ranks[0]:
            out["sp_collectives_per_block"] = \
                ranks[0]["sp_collectives_per_block"]
            out["sp_world"] = world
        print(f"{world} rank(s): strong {t_strong * 1e3:.1f} ms/step, weak "
              f"{t_weak * 1e3:.1f} ms/step, collectives per step {census}",
              flush=True)
    out["ch_collectives_total"] = int(sum(
        sum(c.values()) for c in out["ch_collectives_per_step"].values()))
    out["jax_design"] = JAX_DESIGN
    return out


def main(argv=None) -> int:
    from sydr_tpu_torch.tools import add_device_args, device_of

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--chip", action="store_true",
                   help="the card section: the per-shard curve on one "
                        "device")
    p.add_argument("--json-out", default=None,
                   help="merge results into this JSON file")
    p.add_argument("--fs", type=float, default=None)
    p.add_argument("--superblock", type=int, default=None)
    p.add_argument("--block-ms", type=int, default=20)
    p.add_argument("--blocks", type=int, default=10,
                   help="timed superblock steps per card point")
    p.add_argument("--channels", type=int, default=32)
    p.add_argument("--reps", type=int, default=5,
                   help="timed steps per rank-section point")
    p.add_argument("--worlds", type=int, nargs="+", default=[1, 2, 4, 8],
                   help="rank counts of the rank section")
    add_device_args(p)
    args = p.parse_args(argv)
    device = device_of(args)
    if device is None:
        return 2

    kw = {}
    if args.fs:
        kw["fs"] = args.fs
    if args.superblock:
        kw["superblock"] = args.superblock
    if args.chip:
        counts = tuple(c for c in (args.channels, args.channels // 2,
                                   args.channels // 4, args.channels // 8)
                       if c > 0)
        res = {"chip": chip_section(device, n_blocks=args.blocks,
                                    channel_counts=counts,
                                    block_ms=args.block_ms, **kw)}
    else:
        res = {"ranks": rank_section(device.type, n_channels=args.channels,
                                     block_ms=args.block_ms, reps=args.reps,
                                     worlds=tuple(args.worlds), **kw)}

    print(json.dumps(res))
    if args.json_out:
        merged = {}
        if os.path.exists(args.json_out):
            with open(args.json_out) as fh:
                merged = json.load(fh)
        merged.update(res)
        with open(args.json_out, "w") as fh:
            json.dump(merged, fh, indent=1)
            fh.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
