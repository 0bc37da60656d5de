#!/usr/bin/env python3
"""The Session cell's steady cruise, or the scan session, on this tree and
another, in turns.

Usage, from the root of a checkout, on a machine with a CUDA card:

    python3 tools/torch_cruise_parent.py --parent DIR [--turns 2]
        [--form cruise|scan]

``DIR`` is another tree of the repository (a ``git archive`` of another
commit, unpacked under the git-ignored ``_archive/``). Each run is a child
process that imports its tree's ``chip_smoke.py``, in the order parent,
this, this, parent (``--turns`` pairs):

- ``--form cruise`` (the default) runs that tree's phase 5
  (``session_pair_phase``: the 32-channel session on the same 3 s
  capture, eager then graphed, bits, steady cruise superblocks in turns,
  the cruise graph's replay between CUDA events, its nodes and its capture
  and instantiation seconds); then, in a one-rank NCCL process group, the
  mesh session (``TrackingSession(mesh=make_mesh(1, 1))``, graphed and
  eager, on the first 2 s of the capture) and the full-rate time-sharded
  block and superblock of 2 on a one-rank ``sp`` mesh (captured, and
  eager), in both forms of pass B. Each run's outputs and final state go
  into a SHA-256 digest a run, and the digests of the two trees are held
  equal: the trees compute the same bits;
- ``--form scan`` runs that tree's phase 11 session (``slice_phase`` with
  ``runtime="scan"``: 32 channels, borre, 20 ms blocks, on the first 2 s
  of the same capture) twice, its step eager (``graph=False``) and then
  graphed, each with its real-time factor over the tracking calls; then
  steady blocks of the same input in turns (eager, graphed, graphed,
  eager, ...), both real-time factors, and the scan graph's replay
  between CUDA events, its nodes and its capture and instantiation
  seconds.

Every child prints its phase's lines; the last line is one JSON object
with each run's numbers, the card's name and power limit beside them.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The child: one tree's phase 5 and the NCCL world-1 runs, its numbers
# and digests as the last line.
CHILD = r"""
import hashlib, json, sys
import numpy as np
import torch
sys.path.insert(0, {tree!r})
import chip_smoke as cs
from sydr_tpu_torch.channels.state import pack_state
from sydr_tpu_torch.parallel import distributed, mesh as pmesh, timeshard
device = torch.device("cuda")
card = cs.card_line()
capture = cs.make_scenario(np.random.default_rng(cs.SEED), cs.SIGNAL_MS,
                           cs.FS_IN, cs.N_CHANNELS, cs.N_VISIBLE)
res = cs.session_pair_phase(device, capture, card)
gs = res["session"]
entry = next(e for k, e in gs.graph.graphs.items() if k[0] is gs.cruise_cfg)


def digest(outs, state):
    h = hashlib.sha256()
    for out in outs:
        for key in sorted(out):
            value = out[key]
            if isinstance(value, torch.Tensor):
                value = value.cpu().numpy()
            h.update(key.encode())
            h.update(np.ascontiguousarray(value).tobytes())
    for t in pack_state(state):
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()


bits = {{"session (graphed = eager)": digest(res["outputs"], gs.state)}}
distributed.initialize("nccl", rank=0, world_size=1,
                       init_method=f"tcp://127.0.0.1:{{cs.free_port()}}")
try:
    mesh = pmesh.make_mesh(1, 1)
    for graph in (None, False):
        run = cs.mesh_session_run(device, capture, mesh, "batch", graph,
                                  cs.MESH_SIGNAL_MS)
        bits[f"mesh session graph={{graph}}"] = digest(
            run["outs"], run["session"].state)
    sp = timeshard.make_sp_mesh()
    _, st0, wre, wim, code = cs.random_tracking(
        cs.SP_FS, 20, "narrow", True, device,
        np.random.default_rng(cs.SEED + 15))
    for form, cfg in cs.pass_b_forms(cs.random_config(cs.SP_FS, 20,
                                                      "narrow", True)):
        spms = cfg.samples_per_ms
        sre = torch.cat([wre, wre[cfg.tail_ms * spms:]])
        sim = torch.cat([wim, wim[cfg.tail_ms * spms:]])
        runner = timeshard.TimeShardGraph(sp, device)
        for name, graphed, eager in (
                ("block", lambda s: runner.block(cfg, code, s, wre, wim),
                 lambda s: timeshard.run_block_batched_timesharded(
                     cfg, sp, code, s, wre, wim)),
                ("superblock of 2",
                 lambda s: runner.superblock(cfg, 2, code, s, sre, sim),
                 lambda s: timeshard.run_superblock_timesharded(
                     cfg, sp, 2, code, s, sre, sim))):
            for kind, fn in (("graphed", graphed), ("eager", eager)):
                state, outs = st0, []
                for _ in range(3):
                    state, out = fn(state)
                    outs.append(out)
                bits[f"time shards {{form}} {{name}} {{kind}}"] = digest(
                    outs, state)
finally:
    distributed.shutdown()
print(json.dumps({{
    "rtf_graphed": res["steady_rtf"]["graphed"],
    "rtf_eager": res["steady_rtf"]["eager"],
    "replay_ms": res["replay_ms"], "eager_step_ms": res["eager_step_ms"],
    "nodes": entry.nodes, "capture_s": entry.capture_s,
    "instantiate_s": entry.instantiate_s, "bits": bits, "card": card}}))
"""


# The child of ``--form scan``: one tree's scan session, eager and
# graphed, then steady blocks in turns; its numbers as the last line.
CHILD_SCAN = r"""
import json, sys, time
import numpy as np
import torch
sys.path.insert(0, {tree!r})
import chip_smoke as cs
device = torch.device("cuda")
sync = torch.cuda.synchronize
card = cs.card_line()
capture = cs.make_scenario(np.random.default_rng(cs.SEED), cs.SIGNAL_MS,
                           cs.FS_IN, cs.N_CHANNELS, cs.N_VISIBLE)
runs = {{name: cs.slice_phase(device, capture, signal_ms=cs.SCAN_SIGNAL_MS,
                              runtime="scan", sync=sync, card=card,
                              graph=graph)
        for name, graph in (("eager", False), ("graphed", None))}}
sessions = {{name: res["session"] for name, res in runs.items()}}
gs = sessions["graphed"]
n_in = gs.block_input_samples
_, sig_re, sig_im = capture
walls = {{"eager": [], "graphed": []}}
for turn in range(8):
    order = ("eager", "graphed") if turn % 2 == 0 else ("graphed", "eager")
    for name in order:
        sync()
        t0 = time.perf_counter()
        sessions[name].process_block(sig_re[:n_in], sig_im[:n_in])
        sync()
        walls[name].append(time.perf_counter() - t0)
signal_s = n_in / cs.FS_IN
entry = next(iter(gs.graph.graphs.values()))
start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
replay_ms = []
for _ in range(5):
    start.record()
    entry.replay()
    end.record()
    sync()
    replay_ms.append(start.elapsed_time(end))
print(json.dumps({{
    "rtf_graphed": signal_s / float(np.median(walls["graphed"])),
    "rtf_eager": signal_s / float(np.median(walls["eager"])),
    "session_rtf_graphed": runs["graphed"]["rtf"],
    "session_rtf_eager": runs["eager"]["rtf"],
    "replay_ms": replay_ms, "nodes": entry.nodes,
    "capture_s": entry.capture_s, "instantiate_s": entry.instantiate_s,
    "launches_a_replay": {{k.source: n for k, n in entry.launches.items()}},
    "card": card}}))
"""


def run_tree(name: str, tree: str, child: str = CHILD) -> dict:
    """One child process on ``tree``; its numbers."""
    proc = subprocess.run([sys.executable, "-c", child.format(tree=tree)],
                          cwd=tree, capture_output=True, text=True)
    for line in proc.stdout.splitlines()[:-1]:
        print(f"[{name}] {line}", flush=True)
    if proc.returncode != 0:
        print(proc.stderr[-4000:], file=sys.stderr)
        raise SystemExit(f"{name}: its phase failed (rc {proc.returncode})")
    res = json.loads(proc.stdout.splitlines()[-1])
    print(f"[{name}] steady graphed RTF {res['rtf_graphed']:.4f}, eager "
          f"{res['rtf_eager']:.4f}; replay {res['replay_ms']} ms of "
          f"{res['nodes']} nodes; capture {res['capture_s']:.3f} s + "
          f"instantiation {res['instantiate_s']:.3f} s; {res['card']}",
          flush=True)
    return res


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", required=True,
                        help="the other tree's root")
    parser.add_argument("--turns", type=int, default=2,
                        help="pairs of runs (parent, this, this, parent)")
    parser.add_argument("--form", choices=("cruise", "scan"),
                        default="cruise",
                        help="the Session cell's cruise (phase 5) or the "
                             "scan session (phase 11)")
    opts = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 2
    trees = {"parent": os.path.abspath(opts.parent), "this": REPO}
    runs = {"parent": [], "this": []}
    for turn in range(opts.turns):
        order = ("parent", "this") if turn % 2 == 0 else ("this", "parent")
        for name in order:
            runs[name].append(run_tree(
                name, trees[name],
                CHILD_SCAN if opts.form == "scan" else CHILD))
    ok = True
    if opts.form == "cruise":
        # Every run of both trees: one digest a part.
        for key in runs["this"][0]["bits"]:
            seen = {run["bits"].get(key) for name in runs
                    for run in runs[name]}
            same = len(seen) == 1
            ok &= same
            print(f"bits: {key}: the two trees {'agree' if same else 'DIFFER'}"
                  f" ({len(seen)} digest(s) over {2 * opts.turns} runs)",
                  flush=True)
    print(json.dumps(runs), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
