"""The readings that the limits of ``correct`` are set from.

    python3 -m benchmark.readings --workload <cell> --seeds 1 2 3 ... \
        --control-seeds 1 2 3 [--seconds 2]

For each seed, in one process: the cell's set-up and a short window at the
cell's own size and load, then the numbers compared for the receiver's
sample (the program's readings) and, for the control seeds, the same
numbers for the control: the plain reference in bfloat16 in the
receiver's place, compared with the reference. With the program's, the
readings of the faults that its engine plants in the receiver's answers
(``FAULTS``, ``fault.<kind>.<number>``). One JSON line per seed.
The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)

    import torch

    from benchmark import harness
    from benchmark.trace import Tracer

    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    spec = harness.cell_spec(args.workload)
    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        t0 = time.perf_counter()
        eng = harness.engine(spec, seed, "cuda")
        try:
            eng.setup()
        except RuntimeError as exc:     # a sky the receiver cannot start on
            print(json.dumps({"seed": seed, "error": str(exc)}), flush=True)
            continue
        t1 = time.perf_counter()
        win = eng.window(args.seconds, Tracer(False))
        eng.release()
        line = {"seed": seed, "setup_s": t1 - t0, "metrics": win["metrics"],
                "lines": win["lines"]}
        if seed in args.seeds:
            faults = importlib.import_module(type(eng).__module__).FAULTS
            t2 = time.perf_counter()
            nums = eng.compare(control=False, faults=faults)
            line["compare_s"] = time.perf_counter() - t2
            line["program"] = {k: v for k, v in nums.items()
                               if not k.startswith("fault.")}
            line["faults"] = {k: v for k, v in nums.items()
                              if k.startswith("fault.")}
        if seed in args.control_seeds:
            line["control"] = eng.compare(control=True)
        print(json.dumps(line), flush=True)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
