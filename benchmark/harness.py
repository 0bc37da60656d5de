"""One run of one cell: set-up, the measured window, the comparison that
decides ``correct``, and the result.

The cell's entry in ``BENCHMARK.json`` names its configuration and its
traffic mix; both are files found by name (``configs/<config>.json``,
``traffic/<traffic>.json``), the traffic names its engine
(``engines/<engine>.py``), and the limits of the numbers compared are in
``limits/<cell>.json``. An engine's ``Engine`` does the work:

- ``setup()``: the inputs from the seed, the receiver's objects, warm-up,
  and ``phases``, the seconds of each part of it;
- ``window(seconds, tracer)``: the measured window, returning a dict with
  ``attempted``, ``failed``, the end-to-end ``metrics`` and ``lines`` to
  print beside them;
- ``release()``: drop the receiver's state once the peak is read;
- ``compare(control)``: ``{name: number}`` compared with the plain
  reference (``control=True``: the reference in bfloat16 in the
  receiver's place, for the control's readings).
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path

from benchmark.trace import Tracer, breakdown

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "sydr_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_spec(workload: str, bench: Path | None = None) -> dict:
    """The cell ``workload`` of ``BENCHMARK.json`` with its configuration,
    traffic, limits and metrics."""
    spec = load_json(bench or HERE.parent / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json "
                         f"(have {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}

    def applies(m):
        return workload in m.get("workloads", [workload])

    return {
        "workload": w,
        "config": load_json(HERE.parent / configs[w["config"]]["file"]),
        "traffic": load_json(HERE / "traffic" / f"{w['traffic']}.json"),
        "limits": load_json(HERE / "limits" / f"{workload}.json"),
        "end_to_end": [m for m in spec["end_to_end"] if applies(m)],
        "per_layer": [m for m in spec["per_layer"] if applies(m)],
    }


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted({name.split(".")[0] for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


def reader(name: str):
    """The per-layer metric ``name``'s reader, ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics._{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def engine(spec: dict, seed: int, device):
    module = importlib.import_module(
        f"benchmark.engines.{spec['traffic']['engine']}")
    return module.Engine(spec["config"], spec["traffic"], seed, device)


def device_info(device, count: int) -> dict:
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}


def run(spec: dict, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> tuple[dict, list[str]]:
    """Run the cell once; return the result's dict (its last key
    ``checks``) and the lines to print on standard error before it."""
    t_run = time.perf_counter()
    eng = engine(spec, seed, device)
    tracer = Tracer(trace)
    tracer.warm()
    t_setup = time.perf_counter()
    eng.setup()
    setup_s = time.perf_counter() - t_start
    win = eng.window(seconds, tracer)
    info = device_info(device, spec["workload"]["chips"])
    eng.release()
    numbers = eng.compare(control=False)
    checks = {name: {"value": float(v), "limit": float(spec["limits"][name])}
              for name, v in numbers.items()}
    correct = bool(checks) and all(c["value"] <= c["limit"]
                                   for c in checks.values())
    if trace:
        traced = tracer.result()
        metrics = {}
        for m in spec["per_layer"]:
            value = reader(m["name"])(traced) if traced else None
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
        if traced is not None:
            info["busy_s"] = traced.busy_s
            info["window_s"] = traced.window_s
    else:
        values = dict(win["metrics"], setup_s=setup_s)
        metrics = {m["name"]: {"value": float(values[m["name"]]),
                               "unit": m["unit"]}
                   for m in spec["end_to_end"]}
    result = {"correct": correct, "attempted": int(win["attempted"]),
              "failed": int(win["failed"]), "metrics": metrics,
              "device": info}
    if trace and traced is not None:
        result["breakdown"] = breakdown(traced)
    result["checks"] = checks
    phases = dict(start=t_run - t_start, tracer=t_setup - t_run, **eng.phases)
    lines = list(win["lines"]) + [
        f"setup_s {setup_s:.4f}: " + ", ".join(
            f"{k} {v:.3f} s" for k, v in phases.items())] + [
        f"check {name} {c['value']:.6g} limit {c['limit']:.6g} "
        f"{'ok' if c['value'] <= c['limit'] else 'FAILED'}"
        for name, c in checks.items()]
    return result, lines
