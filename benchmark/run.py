"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Exits non-zero, printing no result, when the card or cards that the cell
asks for are missing, or when the JAX package or JAX was loaded. The last
line of standard output is the result (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``; ``breakdown`` when traced; the
numbers compared with their limits last, under ``checks``). The same
numbers and limits are the last lines of standard error.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    # Libraries that would load JAX by themselves stay off it.
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    from benchmark import harness

    spec = harness.cell_spec(args.workload)
    import torch

    need = spec["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {args.workload} needs {need} CUDA device(s), "
              f"found {have}", file=sys.stderr)
        return 2
    result, lines = harness.run(spec, args.seed, args.seconds,
                                bool(args.trace), "cuda", T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"benchmark: loaded {found}: the receiver under test must "
              f"not load JAX or the JAX package", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for line in lines:
        print(line, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
