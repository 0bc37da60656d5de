"""Device-time profile of the production superblock, per op and per pass.

Port of ``tools/trace_profile.py``. Runs the bench's tracking step (32
channels, 10 Msps input boxcar-decimated by 4 on the device with
``reshape(-1, 4).sum(1)``, narrow-only kaplan at 20 ms blocks x 50-block
superblocks, quantised taps) under ``torch.profiler`` and prints, per
boundary form (``rowsum``: pass B on K1; ``prefix``: on K3):

  * the device time per op, normalised to ms per second of signal;
  * kernel launches per superblock and the device's busy share (device
    time over the unprofiled wall of the same superblock);
  * the pass A / B / C split: one superblock's blocks run pass by pass
    (pass A with pass B's geometry,
    ``ops.geometry_kernel.block_geometry_all``; pass B,
    ``batch_runtime._pass_b``; pass C with the anchor slew,
    ``ops.loop_kernel.pass_c``), each pass under a ``record_function``
    range whose kernels' device time the profiler sums, and, unprofiled,
    each pass's wall between device fences. On the card a block's pass-A
    range holds one launch of the geometry kernel and its pass-C range one
    launch of the pass-C kernel (on the CPU: the plain versions). The
    profiler ties the PyTorch ops' kernels to the range they ran in, but
    not the kernels the package launches through ``ctypes`` (no op
    launches them): those are tied to their pass by name
    (:data:`CTYPES_KERNELS`: the geometry kernel to pass A, K1 or K3 to
    pass B, pass C's kernel to pass C). What is still tied to no pass is
    the ``unattributed`` row.

Usage: python -m sydr_tpu_torch.tools.trace_profile [prefix] [rowsum]
           [--channels 32] [--fs 10e6] [--decimate 4] [--superblock 50]
           [--cpu]

The last line of each form is one JSON object. On the CPU the profiler
sees host time only: the device fields read null ("not measured").
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import time

PASSES = ("pass A", "pass B", "pass C")
# The kernels the package launches through ctypes (csrc/*.cu, each in an
# anonymous namespace), by the pass that launches them.
CTYPES_KERNELS = {"block_geometry_kernel": "pass A",
                  "epoch_correlate_kernel": "pass B",
                  "totals_kernel": "pass B", "prefix_kernel": "pass B",
                  "pass_c_kernel": "pass C"}
_CTYPES_NAME = re.compile(r"\(anonymous namespace\)::(\w+)[<(]")


def superblock_setup(device, *, n_channels=32, fs=10e6, decimate=4,
                     block_ms=20, superblock=50, boundary_mode="rowsum",
                     quantize=True, seed=0):
    """The bench's superblock step on ``device``: ``(cfg, bits3x, state,
    window_re, window_im, step)``. ``step(state) -> (state, outputs)``
    boxcar-decimates one superblock of random full-rate input on the device
    and runs ``run_superblock`` on it; ``window_re/im`` are that decimated
    input."""
    import torch

    from sydr_tpu_torch.channels import batch_runtime as br
    from sydr_tpu_torch.channels.runtime import TrackingConfig
    from sydr_tpu_torch.parallel.dryrun import tracking_inputs

    fs_trk = fs / decimate
    cfg = TrackingConfig(
        sampling_frequency=fs_trk, block_ms=block_ms, tail_ms=4,
        window_size=int(round(fs_trk * 1e-3)) + 256, runtime="batch",
        use_pallas=True, superblock=superblock, quantize_spacing=quantize,
        boundary_mode=boundary_mode, input_decimate=decimate,
        pass_a="closed", profile="kaplan", kaplan_narrow_only=True)
    prns, state, rng = tracking_inputs(cfg, n_channels, device, seed)
    bits3x = torch.tensor(br.tiled_code_bits(prns), device=device)
    n_in = (cfg.tail_ms + superblock * block_ms) * cfg.samples_per_ms
    raw_re, raw_im = (torch.tensor(
        rng.standard_normal(n_in * decimate).astype("float32"),
        device=device) for _ in range(2))

    def boxcar(x):
        return x.reshape(-1, decimate).sum(1) if decimate > 1 else x

    def step(st):
        return br.run_superblock(cfg, superblock, bits3x, st,
                                 boxcar(raw_re), boxcar(raw_im))

    return cfg, bits3x, state, boxcar(raw_re), boxcar(raw_im), step


def _activities(device):
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _device_us(evt, self_only=True) -> float:
    name = "self_device_time_total" if self_only else "device_time_total"
    return float(getattr(evt, name, 0.0))


def kernel_rows(events):
    """The device's own rows of ``events`` or ``key_averages()`` (kernels
    and copies): summing the host ops' device time as well would count each
    kernel twice, once under its name and once under the op that launched
    it. A ``record_function`` range also shows on the device's timeline,
    spanning its kernels and the gaps between them: left out."""
    import torch

    return [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and e.key not in PASSES]


def ctypes_pass(name: str):
    """The pass that launches the package's ``ctypes`` kernel ``name`` (a
    device symbol as the profiler names it), else None."""
    m = _CTYPES_NAME.search(name)
    return CTYPES_KERNELS.get(m.group(1)) if m else None


def split_device_ms(events) -> dict:
    """``{pass: device ms}`` and ``"unattributed"`` from the profiler's
    ``events`` of a pass-by-pass run: each pass's ranges (the device time
    of the kernels the profiler ties to an op inside them), plus, by name,
    the ``ctypes`` kernels of a name it ties to no op; the rest of the
    kernels' time is unattributed."""
    import torch

    cpu = torch.autograd.DeviceType.CPU
    split = dict.fromkeys(PASSES, 0.0)
    tied = set()          # the kernels' names the profiler tied to an op
    for evt in events:
        if evt.device_type == cpu:
            tied.update(k.name for k in evt.kernels)
            if evt.key in split:
                split[evt.key] += _device_us(evt, self_only=False) / 1e3
    kernels = kernel_rows(events)
    for evt in kernels:
        name = ctypes_pass(evt.key)
        if name and evt.key not in tied:
            split[name] += _device_us(evt) / 1e3
    total = sum(_device_us(e) for e in kernels) / 1e3
    split["unattributed"] = total - sum(split.values())
    return split


def profile_ops(fn, device):
    """Run ``fn()`` under ``torch.profiler``; returns ``(ops, launches,
    device_ms)``: ``[(name, device ms, count)]`` by device time (host time
    on the CPU), the kernel launches the runtime API saw (None on the CPU)
    and the total device time (None on the CPU)."""
    import torch

    from sydr_tpu_torch.tools import sync

    sync(device)
    with torch.profiler.profile(activities=_activities(device)) as prof:
        fn()
        sync(device)
    events = prof.key_averages()
    if device.type != "cuda":
        ops = sorted(((e.key, e.self_cpu_time_total / 1e3, e.count)
                      for e in events), key=lambda r: -r[1])
        return ops, None, None
    ops = sorted(((e.key, _device_us(e) / 1e3, e.count)
                  for e in kernel_rows(events)), key=lambda r: -r[1])
    launches = sum(e.count for e in events if "LaunchKernel" in e.key)
    return ops, launches, sum(ms for _, ms, _ in ops)


def pass_split(cfg, bits3x, state, window_re, window_im, device):
    """The superblock's blocks run pass by pass. Returns ``{pass: {"wall_ms",
    "device_ms"}}`` summed over the blocks: the wall between device fences
    around each pass (unprofiled), and the device time of the kernels
    launched inside each pass's ``record_function`` range (None on the
    CPU). On the card an ``"unattributed"`` row holds the kernel time the
    profiler tied to no range, nor :func:`split_device_ms` by name."""
    import torch

    from sydr_tpu_torch.channels import batch_runtime as br
    from sydr_tpu_torch.ops import geometry_kernel, loop_kernel
    from sydr_tpu_torch.tools import sync

    sb = cfg.block_ms * cfg.samples_per_ms
    win = cfg.window_samples

    def blocks(st, on_pass):
        for k in range(cfg.superblock):
            wre = window_re[k * sb:k * sb + win]
            wim = window_im[k * sb:k * sb + win]
            geo, inputs, bounds = on_pass(
                "pass A", lambda: geometry_kernel.block_geometry_all(cfg, st))
            corr = on_pass("pass B", lambda: br._pass_b(
                cfg, bits3x, inputs, bounds, wre, wim))
            st = on_pass("pass C", lambda: loop_kernel.pass_c(
                cfg, st, geo, corr)[0])

    walls = dict.fromkeys(PASSES, 0.0)

    def fenced(name, fn):
        sync(device)
        t0 = time.perf_counter()
        res = fn()
        sync(device)
        walls[name] += 1e3 * (time.perf_counter() - t0)
        return res

    def ranged(name, fn):
        with torch.profiler.record_function(name):
            return fn()

    blocks(state, fenced)
    split = {name: {"wall_ms": walls[name], "device_ms": None}
             for name in PASSES}
    if device.type == "cuda":
        with torch.profiler.profile(activities=_activities(device)) as prof:
            blocks(state, ranged)
            sync(device)
        device = split_device_ms(prof.events())
        for name in PASSES:
            split[name]["device_ms"] = device[name]
        split["unattributed"] = {"wall_ms": None,
                                 "device_ms": device["unattributed"]}
    return split


def profile_form(mode, device, *, n_channels=32, fs=10e6, decimate=4,
                 block_ms=20, superblock=50, top=14) -> dict:
    """One form's profile (module docstring); prints the tables and
    returns the JSON record."""
    from sydr_tpu_torch.tools import device_name, sync

    cfg, bits3x, state, wre, wim, step = superblock_setup(
        device, n_channels=n_channels, fs=fs, decimate=decimate,
        block_ms=block_ms, superblock=superblock, boundary_mode=mode)
    st, _ = step(state)                 # builds the kernels, warms up
    sync(device)
    t0 = time.perf_counter()
    st, _ = step(st)
    sync(device)
    wall = time.perf_counter() - t0
    ops, launches, device_ms = profile_ops(lambda: step(st), device)
    split = pass_split(cfg, bits3x, st, wre, wim, device)
    sig_s = superblock * block_ms * 1e-3
    kind = "device" if device_ms is not None else "host"
    print(f"\n=== boundary_mode={mode} on {device_name(device)}: "
          f"{n_channels} ch, 1 superblock = {sig_s:g} s of signal, wall "
          f"{wall:.3f} s (RTF {sig_s / wall:.3f}) ===")
    if device_ms is not None:
        print(f"device total: {device_ms / sig_s:.2f} ms/s, busy share "
              f"{100.0 * device_ms / 1e3 / wall:.1f}% of the unprofiled "
              f"wall, {launches} kernel launches per superblock")
    for name, ms, count in ops[:top]:
        print(f"  {ms / sig_s:9.3f} ms/s {kind} {count:7d} x  {name[:80]}")
    print(f"  pass split over the superblock's {superblock} blocks "
          f"(device ms / fenced wall ms):")
    for name, row in split.items():
        d, w = row["device_ms"], row["wall_ms"]
        print(f"    {name}: {'not measured' if d is None else f'{d:.3f}'} "
              f"/ {'-' if w is None else f'{w:.1f}'}")
    record = {
        "tool": "trace_profile", "boundary_mode": mode,
        "device": device_name(device), "n_channels": n_channels,
        "signal_s": sig_s, "wall_s": wall, "rtf": sig_s / wall,
        "launches_per_superblock": launches,
        "device_ms_per_s": None if device_ms is None else device_ms / sig_s,
        "busy_share": None if device_ms is None else device_ms / 1e3 / wall,
        "pass_split": split,
    }
    print(json.dumps(record), flush=True)
    return record


def main(argv=None) -> int:
    from sydr_tpu_torch.tools import add_device_args, device_of

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("modes", nargs="*", choices=("prefix", "rowsum"),
                   help="boundary forms to profile (default: both)")
    p.add_argument("--channels", type=int, default=32)
    p.add_argument("--fs", type=float, default=10e6)
    p.add_argument("--decimate", type=int, default=4)
    p.add_argument("--block-ms", type=int, default=20)
    p.add_argument("--superblock", type=int, default=50)
    p.add_argument("--top", type=int, default=14)
    add_device_args(p)
    args = p.parse_args(argv)
    device = device_of(args)
    if device is None:
        return 2
    for mode in args.modes or ["prefix", "rowsum"]:
        profile_form(mode, device, n_channels=args.channels, fs=args.fs,
                     decimate=args.decimate, block_ms=args.block_ms,
                     superblock=args.superblock, top=args.top)
    return 0


if __name__ == "__main__":
    sys.exit(main())
