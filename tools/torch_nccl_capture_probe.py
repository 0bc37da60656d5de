#!/usr/bin/env python3
"""What a CUDA graph that holds NCCL collectives needs, on this machine's
PyTorch and NCCL.

Usage, from the root of a checkout, on a machine with a CUDA card:

    python3 tools/torch_nccl_capture_probe.py [--hold 1.5] [--replays 50]

Each variant is a child process of its own (the environment must be set
before the process group starts): a one-rank NCCL process group on
``cuda:0`` (``tcp://127.0.0.1:<free port>``), and a step that scales a
tensor, ``all_reduce``s it and ``all_gather``s it as a list, as
``parallel.distributed`` does. The step runs once eagerly on a side stream (the warm-up that
creates the communicator, as ``ops.step_graph.StepGraph`` does), is
captured with ``torch.cuda.graph(..., capture_error_mode=mode)``, holding
the host inside the capture for ``--hold`` seconds (long enough for the
process group's watchdog thread to poll the warm-up's work), and is then
replayed ``--replays`` times on fresh inputs, each replay followed by an
eager ``all_reduce`` on the same communicator (graph and eager work
mixed), every result held bit for bit against the eager step. The
variants: ``TORCH_NCCL_ASYNC_ERROR_HANDLING`` as the process finds it and
set to 0, times the capture modes ``global`` and ``thread_local``.

Each child prints one JSON line (whether the capture and the replays
held, the error if not, the graph's nodes by kind); the parent prints the
versions, the card's name and power limit, and every line.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV_KEY = "TORCH_NCCL_ASYNC_ERROR_HANDLING"


def child(mode: str, hold_s: float, replays: int) -> dict:
    import time

    import torch
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    from sydr_tpu_torch.ops.step_graph import node_kinds

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    res = {"mode": mode, ENV_KEY: os.environ.get(ENV_KEY)}

    def step(x):
        y = x * 2.0
        dist.all_reduce(y)
        parts = [torch.empty_like(y)]
        dist.all_gather(parts, y)
        return y, parts[0]

    try:
        x = torch.randn(1 << 20, device=device)
        static = x.clone()
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            step(static)
        torch.cuda.current_stream(device).wait_stream(side)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        t0 = time.perf_counter()
        with torch.cuda.graph(graph, capture_error_mode=mode):
            outs = step(static)
            time.sleep(hold_s)
        res["capture_s"] = time.perf_counter() - t0
        graph.instantiate()
        res["nodes"] = node_kinds(graph)
        bad = 0
        other = torch.ones(64, device=device)
        for k in range(replays):
            static.copy_(torch.randn(1 << 20, device=device))
            graph.replay()
            want = step(static.clone())
            bad += sum(not torch.equal(a, b) for a, b in zip(outs, want))
            dist.all_reduce(other)
        torch.cuda.synchronize()
        res.update(ok=bad == 0, mismatches=bad,
                   eager_between=float(other[0]))
    except Exception as e:            # the probe reports what broke
        res.update(ok=False, error=f"{type(e).__name__}: {e}"[:400])
    dist.destroy_process_group()
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--hold", type=float, default=1.5,
                   help="host seconds inside each capture")
    p.add_argument("--replays", type=int, default=50)
    p.add_argument("--child", nargs=3, metavar=("MODE", "HOLD", "REPLAYS"),
                   help=argparse.SUPPRESS)
    opts = p.parse_args(argv)
    if opts.child:
        mode, hold, replays = opts.child
        print(json.dumps(child(mode, float(hold), int(replays))), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} nccl "
          f"{'.'.join(map(str, torch.cuda.nccl.version()))}; {ENV_KEY} "
          f"{os.environ.get(ENV_KEY)!r} in this process; {card}",
          flush=True)
    results = []
    for env_value in (None, "0"):
        for mode in ("global", "thread_local"):
            env = dict(os.environ)
            if env_value is not None:
                env[ENV_KEY] = env_value
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--child", mode,
                 str(opts.hold), str(opts.replays)], env=env,
                capture_output=True, text=True, timeout=300)
            lines = [ln for ln in proc.stdout.splitlines()
                     if ln.startswith("{")]
            res = json.loads(lines[-1]) if lines else {
                "mode": mode, ENV_KEY: env_value, "ok": False,
                "error": f"exit {proc.returncode}: {proc.stderr[-400:]}"}
            results.append(res)
            print(json.dumps(res), flush=True)
    print(json.dumps({"card": card, "variants": results}))
    return 0 if all(r["ok"] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
