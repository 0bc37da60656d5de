#!/usr/bin/env python3
"""Launch shapes of the port's CUDA kernels, timed against each other on
one GPU: the numbers behind the choices in ``sydr_tpu_torch/ops``.

    python3 tools/torch_kernel_variants.py            # K2 and K3
    python3 tools/torch_kernel_variants.py --k2 | --k3
    python3 tools/torch_kernel_variants.py --k2 --n 16368 [26500 ...]
    python3 tools/torch_kernel_variants.py --k2 --entries --n 9722 [...]
    python3 tools/torch_kernel_variants.py --k2 --bluestein --n 9722 [...]
    python3 tools/torch_kernel_variants.py --parent DIR [--n 4070 ...]

* K2 ``pcps_bins`` at n = 4092 (8 channels x 101 bins x 10 blocks), and
  with ``--n`` at any other length that is not prime: the device time of
  every order of the plan's radices that the kernels take (a generic
  radix above 31 neither first nor last, radix 1 only at an end) at
  several block sizes, on the entry that n selects (one block, or a
  cluster of ``cluster_size(n)`` blocks), each held against the plain
  version (1e-4 of the map's maximum), beside the plain version and
  ``torch.fft.ifft`` alone; then the default plan on every cluster size
  whose blocks fit. With ``--entries``, only K2's entries side by side
  at each ``--n``: the Bluestein entry and the radix entry (where a block
  or a cluster holds n's plan), on the same inputs, each held against the
  plain version, beside ``torch.fft.ifft``: the measurement behind
  ``acq_kernel.GENERIC_MAX_PRIME``. A launch above half a second is
  timed once, between CUDA events. With ``--bluestein``, the Bluestein
  entry built with each register cap of ``BLUESTEIN_MIN_BLOCKS`` (its
  ``kMinBlocks``: blocks an SM), timed in turns, and the split of the
  default's device time over its three kernels (``torch.profiler``).
* ``--parent DIR`` (a checkout of another commit): DIR's K2 entries
  against this tree's radix entries at the production shapes of the
  lengths that keep them (one block at n = 2500, 10000, 4092, 4070; a
  cluster at 16368, 26500, 40920), or at ``--n`` with ``--channels``,
  maps bit for bit, device times in turns parent, this, this, parent.
* K3 ``block_cumsum_streams`` at its three shapes (cruise, pull-in, full
  rate): the device time of the totals launch, the prefix launch and both,
  and of the kernel that only makes K3's stores, for several segment
  lengths (``seg_chunks = 1`` is one 1024-sample chunk a block).

Device times are ``chip_smoke.device_ms`` (launches queued behind a
spinning kernel, between CUDA events). Needs a CUDA device; imports no JAX.
"""

from __future__ import annotations

import argparse
import itertools
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def k2_inputs(n: int, n_ch: int, device):
    """Seeded spectra [10, n_ch, 10, n], code [n_ch, n] and a 101-bin
    plan over the 10 phases."""
    import torch

    g = torch.Generator().manual_seed(0)
    spec = torch.randn(10, n_ch, 10, n, dtype=torch.complex64,
                       generator=g).to(device)
    code = torch.randn(n_ch, n, dtype=torch.complex64,
                       generator=g).to(device)
    bins = tuple((b // 10 - 5, b % 10) for b in range(101))
    return spec, code, bins


def k2_args(cargs, plan, threads, cluster):
    """``pcps_bins_launch_args``' C arguments with another plan, block size
    and cluster size (1: the one-block entry's arguments)."""
    from sydr_tpu_torch.ops import acq_kernel

    radices = (acq_kernel._INT * len(plan))(*plan)
    extra = () if cluster == 1 else (cluster,)
    return (*cargs[:8], radices, len(plan), threads, *extra, *cargs[-3:])


def plan_runs(plan) -> bool:
    """Whether the kernels take ``plan`` in this order (``parse_plan`` in
    ``csrc/pcps_fft.cuh``): a radix above 31 neither first nor last,
    radix 1 at an end only, and first only before a radix above 31."""
    last = len(plan) - 1
    for i, r in enumerate(plan):
        end = i in (0, last)
        if (r > 31 and end) or (r == 1 and not end):
            return False
    return plan[0] != 1 or len(plan) == 2 or plan[1] > 31


def k2_variants(n: int, n_ch: int, device) -> None:
    """Every order of ``n``'s radices x block sizes, on the entry (one
    block or a cluster of the wrapper's size) that ``n`` selects; then the
    default plan on every cluster size whose blocks fit."""
    import torch

    from sydr_tpu_torch.ops import acq_kernel

    spec, code, bins = k2_inputs(n, n_ch, device)
    ref = acq_kernel.pcps_bins_ref(spec, code, bins)
    bound = chip_smoke.K2_RTOL * float(ref.abs().max())
    plain = chip_smoke.cuda_ms(
        lambda: acq_kernel.pcps_bins_ref(spec, code, bins), 5)
    library = chip_smoke.ifft_library_ms(spec, code, bins)
    kernel, shape = acq_kernel.radix_kernel_for(n)
    cluster = 1 if kernel is acq_kernel.KERNEL else shape[3]
    base = acq_kernel.radix_plan(n)
    print(f"K2 n={n}, {n_ch} ch x {len(bins)} bins: plain {plain:.4f} ms, "
          f"library {library:.4f} ms, default plan {base} x {shape[2]} "
          f"threads on {cluster} block(s) ({kernel.source})", flush=True)
    _, out, cargs = acq_kernel.pcps_bins_launch_args(spec, code, bins,
                                                     entry="radix")

    def run(plan, threads, c):
        fn = (acq_kernel.KERNEL if c == 1
              else acq_kernel.CLUSTER_KERNEL).function()
        args = k2_args(cargs, plan, threads, c)
        chip_smoke.check(fn(*args) == 0,
                         f"launch failed: {plan} x {threads} on {c}")
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        chip_smoke.check(err <= bound, f"{plan} x {threads} on {c}: error "
                                       f"{err}")
        return chip_smoke.device_ms(lambda: fn(*args), 10), err

    plans = [p for p in sorted(set(itertools.permutations(base)))
             if plan_runs(p)]
    if len(plans) > 24:   # the default and its rotations
        plans = [p for p in (base[i:] + base[:i] for i in range(len(base)))
                 if plan_runs(p)]
    prime = acq_kernel.has_prime_radix(base)
    sizes = (128, 192, 256, 384, 512) if prime else (128, 256, 512, 1024)
    rows = []
    for plan, threads in itertools.product(plans, sizes):
        if not acq_kernel.block_fits(n, plan, cluster, threads):
            continue
        ms, err = run(plan, threads, cluster)
        rows.append((ms, plan, threads))
        print(f"   plan {plan} x {threads} threads: {ms:.4f} ms "
              f"(max_abs_err {err:.3e}, bound {bound:.3e})", flush=True)
    for ms, plan, threads in sorted(rows)[:5]:
        print(f"K2 n={n} best: {ms:.4f} ms plan {plan} x {threads}",
              flush=True)
    for c in acq_kernel.CLUSTER_SIZES:
        threads = acq_kernel.fft_threads(n, base, c)
        if not acq_kernel.block_fits(n, base, c, threads):
            continue
        ms, _ = run(base, threads, c)
        chosen = " (the wrapper's choice)" if c == cluster else ""
        print(f"K2 n={n} on {c} block(s) of {threads} threads: {ms:.4f} "
              f"ms{chosen}", flush=True)


def once_ms(fn) -> float:
    """Device milliseconds of one launch of a C entry point after one
    warm-up, between CUDA events (for launches of a second or more,
    where the host's share is nothing)."""
    import torch

    chip_smoke.check(fn() == 0, "launch failed")
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    chip_smoke.check(fn() == 0, "launch failed")
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop)


def k2_entries(n: int, n_ch: int, device) -> None:
    """The Bluestein entry and the radix entry (where one holds n's plan)
    on the same inputs, 8 ch x 101 bins x 10 blocks (``n_ch``): device
    times, each map within 1e-4 of the plain version's maximum, beside
    ``torch.fft.ifft``; which one ``kernel_for`` takes."""
    import torch

    from sydr_tpu_torch.ops import acq_kernel

    spec, code, bins = k2_inputs(n, n_ch, device)
    ref = acq_kernel.pcps_bins_ref(spec, code, bins)
    bound = chip_smoke.K2_RTOL * float(ref.abs().max())
    library = chip_smoke.ifft_library_ms(spec, code, bins, quiet=True)
    routed = acq_kernel.kernel_for(n)[0]
    m, m1, m2 = acq_kernel.bluestein_lengths(n)
    entries = ["bluestein"]
    plan = acq_kernel.radix_plan(n) if acq_kernel.has_radix_plan(n) \
        else None
    if plan is not None and acq_kernel.fitting_cluster(n, plan):
        entries.insert(0, "radix")
    times = {}
    for name in entries:
        kernel, out, cargs = acq_kernel.pcps_bins_launch_args(
            spec, code, bins, entry=name)
        fn = kernel.function()
        chip_smoke.check(fn(*cargs) == 0, f"n={n} {name}: launch failed")
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        chip_smoke.check(err <= bound, f"n={n} {name}: error {err} above "
                                       f"{bound}")
        once = once_ms(lambda: fn(*cargs))
        ms = once if once > 500 else chip_smoke.device_ms(
            lambda: fn(*cargs), max(2, min(10, int(200 / once))))
        times[name] = ms
        print(f"   n={n} {name} ({kernel.source}): {ms:.4f} ms "
              f"(max_abs_err {err / float(ref.abs().max()):.2e} of the "
              f"maximum)", flush=True)
    ratio = (f", radix / bluestein {times['radix'] / times['bluestein']:.2f}"
             if "radix" in times else "")
    print(f"K2 entries n={n} (largest prime factor "
          f"{acq_kernel.prime_factors(n)[-1]}, plan {plan}, M = {m} = {m1} x "
          f"{m2}), {n_ch} ch x {len(bins)} bins x 10 blocks: "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items())
          + f", ifft {library:.4f} ms{ratio}; kernel_for takes "
          f"{routed.source}", flush=True)


# kMinBlocks of csrc/pcps_bins_bluestein.cu tried by --bluestein (3 is
# the source's): a register cap of 128, 85 and 64 a thread.
BLUESTEIN_MIN_BLOCKS = (2, 3, 4)


def k2_bluestein(ns, n_ch: int, device) -> None:
    """The Bluestein entry with each of :data:`BLUESTEIN_MIN_BLOCKS` (a
    copy of its source under ``_build/``), each checked against the plain
    version and timed in two turns, then the device time of each of the
    source's three kernels in one call (``torch.profiler``)."""
    from pathlib import Path

    import torch
    from torch.profiler import ProfilerActivity, profile

    from sydr_tpu_torch.ops import acq_kernel, native

    base = acq_kernel.BLUESTEIN_KERNEL
    text = (base.csrc_dir / base.source).read_text()
    line = "constexpr int kMinBlocks = 3;"
    chip_smoke.check(line in text, "kMinBlocks not found in the source")
    variants = {}
    for blocks in BLUESTEIN_MIN_BLOCKS:
        folder = Path(native.PACKAGE_DIR, "_build", "variants",
                      f"min_blocks_{blocks}")
        folder.mkdir(parents=True, exist_ok=True)
        (folder / base.source).write_text(
            text.replace(line, f"constexpr int kMinBlocks = {blocks};"))
        variants[blocks] = native.CudaKernel(base.source, base.symbol,
                                             base.argtypes, csrc_dir=folder)
    native.build_all(list(variants.values()))
    for blocks, kern in variants.items():
        usage = [ln.strip() for ln in kern.build_log.splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"kMinBlocks {blocks}: " + "; ".join(usage), flush=True)
    for n in ns:
        spec, code, bins = k2_inputs(n, n_ch, device)
        ref = acq_kernel.pcps_bins_ref(spec, code, bins)
        bound = chip_smoke.K2_RTOL * float(ref.abs().max())
        _, out, cargs = acq_kernel.pcps_bins_launch_args(
            spec, code, bins, entry="bluestein")
        times = {blocks: [] for blocks in variants}
        for turn in (BLUESTEIN_MIN_BLOCKS, BLUESTEIN_MIN_BLOCKS[::-1]):
            for blocks in turn:
                fn = variants[blocks].function()
                chip_smoke.check(fn(*cargs) == 0, "launch failed")
                torch.cuda.synchronize()
                err = float((out - ref).abs().max())
                chip_smoke.check(err <= bound, f"kMinBlocks {blocks}: "
                                               f"error {err}")
                times[blocks].append(chip_smoke.device_ms(
                    lambda: fn(*cargs), 5))
        fn = base.function()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fn(*cargs)
            torch.cuda.synchronize()
        names = ("column_forward", "row_filter", "column_inverse")
        split = {next((k for k in names if k in ev.key), ev.key[:40]):
                 ev.device_time_total / 3e3
                 for ev in prof.key_averages() if ev.device_time_total > 0}
        print(f"K2 Bluestein n={n}, {n_ch} ch x {len(bins)} bins x 10 "
              f"blocks, device ms by kMinBlocks: "
              + ", ".join(f"{b}: {t[0]:.4f} / {t[1]:.4f}"
                          for b, t in times.items())
              + "; the source's kernels a call: "
              + ", ".join(f"{k} {v:.4f}" for k, v in split.items()),
              flush=True)


# The production shapes of the lengths that keep a radix entry
# (chip_smoke.py's phase 3): one block, then a cluster.
PARENT_CASES = ((2500, 32), (10000, 12), (4092, 8), (4070, 8), (16368, 8),
                (26500, 8), (40920, 8))


def k2_against_parent(parent: str, device, cases=PARENT_CASES) -> None:
    """The K2 entries of another tree (``parent``, a checkout) against this
    tree's on the same inputs at ``cases`` ((n, channels) pairs): the maps
    bit for bit, and the device times in turns parent, this, this,
    parent."""
    from pathlib import Path

    import torch

    from sydr_tpu_torch.ops import acq_kernel, native

    theirs = {kern.source: native.CudaKernel(
        kern.source, kern.symbol, kern.argtypes,
        csrc_dir=Path(parent) / "sydr_tpu_torch" / "csrc")
        for kern in (acq_kernel.KERNEL, acq_kernel.CLUSTER_KERNEL)}
    native.build_all(list(theirs.values()))
    for n, n_ch in cases:
        spec, code, bins = k2_inputs(n, n_ch, device)
        kernel, out, cargs = acq_kernel.pcps_bins_launch_args(
            spec, code, bins, entry="radix")
        fns = {"parent": theirs[kernel.source].function(),
               "this": kernel.function()}
        maps = {}
        for name in ("this", "parent", "this"):
            chip_smoke.check(fns[name](*cargs) == 0, f"{name} launch failed")
            torch.cuda.synchronize()
            if name in maps:
                chip_smoke.check(torch.equal(maps[name], out),
                                 "the entry is not deterministic")
            maps[name] = out.clone()
        same = torch.equal(maps["parent"], maps["this"])
        ms = {name: [] for name in fns}
        for name in ("parent", "this", "this", "parent"):
            ms[name].append(chip_smoke.device_ms(
                lambda fn=fns[name]: fn(*cargs), 10))
        print(f"K2 {kernel.source} n={n}, {n_ch} ch x 101 bins: maps "
              f"{'bit-identical' if same else 'DIFFER'}; device ms parent "
              f"{ms['parent'][0]:.4f} / {ms['parent'][1]:.4f}, this "
              f"{ms['this'][0]:.4f} / {ms['this'][1]:.4f}", flush=True)
        chip_smoke.check(same, f"n={n}: the maps differ from the parent's")


def k3_variants(device) -> None:
    import torch

    from sydr_tpu_torch.ops import correlator_kernel as ck

    rng = np.random.default_rng(chip_smoke.SEED)
    fn = ck.CUMSUM_KERNEL.function()
    ceiling = ck.STORE_CEILING.function()
    default_shape = ck.cumsum_shape
    for name, fs, block_ms, profile in (
            ("cruise 2.5 Msps 20 ms 6 streams", 2.5e6, 20, "narrow"),
            ("pull-in 2.5 Msps 5 ms 10 streams", 2.5e6, 5, "kaplan"),
            ("full-rate 10 Msps 20 ms 6 streams", 10e6, 20, "narrow")):
        args = chip_smoke.random_block(fs, block_ms, profile, True, device,
                                       rng)
        k3 = args[:8] + args[9:]
        ref = ck.block_cumsum_streams_ref(*k3)
        n_ch, n_streams, n_win = ref.shape
        n_chunks = -(-n_win // ck.CUMSUM_CHUNK)
        default = default_shape(n_win, n_ch)
        print(f"K3 {name}: out {tuple(ref.shape)}, {n_chunks} chunks, "
              f"default segments {default}", flush=True)
        bound = chip_smoke.K3_PREFIX_SIGMAS * n_win ** 0.5 * 2.0 ** -24 \
            * float(ref.abs().max())
        for seg_chunks in sorted({1, 2, 3, 4, 6, 8, 12, 16, 30, default[0]}):
            if seg_chunks > n_chunks:
                continue
            n_seg = -(-n_chunks // seg_chunks)
            ck.cumsum_shape = lambda _w, _c, s=(seg_chunks, n_seg): s
            ms = {}
            keep = []
            for launches in (3, 1, 2):
                out, cargs, totals = ck.block_cumsum_streams_launch_args(
                    *k3, launches=launches)
                if keep:
                    totals.copy_(keep[0][2])
                keep.append((out, cargs, totals))
                chip_smoke.check(fn(*cargs) == 0, "launch failed")
                ms[launches] = chip_smoke.device_ms(
                    lambda: fn(*cargs), 50)
            out = keep[0][0]
            fn(*keep[0][1])
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            chip_smoke.check(err <= bound, f"seg {seg_chunks}: error {err}")
            cargs = (n_ch, n_streams, n_win, seg_chunks, n_seg,
                     out.data_ptr(), keep[0][1][-1])
            store = chip_smoke.device_ms(lambda: ceiling(*cargs), 50)
            print(f"   segments of {seg_chunks:3d} chunks, grid ({n_seg}, "
                  f"{n_ch}): both {ms[3]:.4f} ms, totals {ms[1]:.4f}, "
                  f"prefix {ms[2]:.4f}, stores alone {store:.4f} "
                  f"(max_abs_err {err:.3e})", flush=True)


def main(argv=None) -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--k2", action="store_true")
    parser.add_argument("--k3", action="store_true")
    parser.add_argument("--n", type=int, nargs="+",
                        help="code periods (default 4092; with --parent, "
                             "the 31-smooth production shapes)")
    parser.add_argument("--channels", type=int, default=8)
    parser.add_argument("--entries", action="store_true",
                        help="with --k2: only the Bluestein and radix "
                             "entries side by side at each --n")
    parser.add_argument("--bluestein", action="store_true",
                        help="with --k2: the Bluestein entry's register "
                             "caps and its kernels' split at each --n")
    parser.add_argument("--parent", metavar="DIR",
                        help="hold the one-block K2 entry of the checkout "
                             "DIR against this tree's")
    opts = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 2
    from sydr_tpu_torch.ops import acq_kernel, native
    from sydr_tpu_torch.ops import correlator_kernel as ck

    print(f"card: {chip_smoke.card_line()}", flush=True)
    device = torch.device("cuda")
    built = [acq_kernel.KERNEL, acq_kernel.CLUSTER_KERNEL,
             acq_kernel.BLUESTEIN_KERNEL, ck.CUMSUM_KERNEL, ck.STORE_CEILING]
    native.build_all(built)
    for kern in built:
        usage = [ln.strip() for ln in kern.build_log.splitlines()
                 if "registers" in ln or "spill" in ln
                 or "Compiling entry" in ln]
        print(f"built {kern.source} in {kern.build_seconds or 0:.2f} s:\n   "
              + "\n   ".join(usage), flush=True)
    both = not (opts.k2 or opts.k3 or opts.parent)
    if opts.k2 and opts.bluestein:
        k2_bluestein(opts.n or [9722], opts.channels, device)
    elif opts.k2 or both:
        for n in opts.n or [4092]:
            if opts.entries:
                k2_entries(n, opts.channels, device)
            else:
                k2_variants(n, opts.channels, device)
    if opts.parent:
        k2_against_parent(opts.parent, device, PARENT_CASES if opts.n is None
                          else [(n, opts.channels) for n in opts.n])
    if opts.k3 or both:
        k3_variants(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
