#!/usr/bin/env python3
"""The Session cell's steady cruise on this tree and another, in turns.

Usage, from the root of a checkout, on a machine with a CUDA card:

    python3 tools/torch_cruise_parent.py --parent DIR [--turns 2]

``DIR`` is another tree of the repository (a ``git archive`` of another
commit, unpacked under the git-ignored ``_archive/``). Each run is a child
process that imports its tree's ``chip_smoke.py`` and runs that tree's
phase 5 (``session_pair_phase``: the 32-channel session on the same 3 s
capture, eager then graphed, bits, steady cruise superblocks in turns, the
cruise graph's replay between CUDA events, its nodes and its capture and
instantiation seconds), in the order parent, this, this, parent
(``--turns`` pairs). Every child prints its phase's lines; the last line
is one JSON object with each run's numbers, the card's name and power
limit beside them.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The child: one tree's phase 5, its numbers as the last line.
CHILD = r"""
import json, sys
import numpy as np
import torch
sys.path.insert(0, {tree!r})
import chip_smoke as cs
device = torch.device("cuda")
card = cs.card_line()
capture = cs.make_scenario(np.random.default_rng(cs.SEED), cs.SIGNAL_MS,
                           cs.FS_IN, cs.N_CHANNELS, cs.N_VISIBLE)
res = cs.session_pair_phase(device, capture, card)
gs = res["session"]
entry = next(e for k, e in gs.graph.graphs.items() if k[0] is gs.cruise_cfg)
print(json.dumps({{
    "rtf_graphed": res["steady_rtf"]["graphed"],
    "rtf_eager": res["steady_rtf"]["eager"],
    "replay_ms": res["replay_ms"], "eager_step_ms": res["eager_step_ms"],
    "nodes": entry.nodes, "capture_s": entry.capture_s,
    "instantiate_s": entry.instantiate_s, "card": card}}))
"""


def run_tree(name: str, tree: str) -> dict:
    """One child process on ``tree``; its numbers."""
    proc = subprocess.run([sys.executable, "-c", CHILD.format(tree=tree)],
                          cwd=tree, capture_output=True, text=True)
    for line in proc.stdout.splitlines()[:-1]:
        print(f"[{name}] {line}", flush=True)
    if proc.returncode != 0:
        print(proc.stderr[-4000:], file=sys.stderr)
        raise SystemExit(f"{name}: phase 5 failed (rc {proc.returncode})")
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
            runs[name].append(run_tree(name, trees[name]))
    print(json.dumps(runs), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
