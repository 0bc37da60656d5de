#!/usr/bin/env python3
"""Launch shapes of the port's CUDA kernels, timed against each other on
one GPU: the numbers behind the choices in ``sydr_tpu_torch/ops``.

    python3 tools/torch_kernel_variants.py            # K2 and K3
    python3 tools/torch_kernel_variants.py --k2 | --k3
    python3 tools/torch_kernel_variants.py --k2 --n 16368 [26500 ...]
    python3 tools/torch_kernel_variants.py --k2 --entries --n 9722 [...]
    python3 tools/torch_kernel_variants.py --k2 --bluestein --n 9722 [...]
    python3 tools/torch_kernel_variants.py --twostep [--n 70000 245520]
    python3 tools/torch_kernel_variants.py --twostep --layouts --n 99375
    python3 tools/torch_kernel_variants.py --k2 --bluestein --layouts --n 9722
    python3 tools/torch_kernel_variants.py --parent DIR [--n 4070 ...]
    python3 tools/torch_kernel_variants.py --pass-c [--parent DIR]
    python3 tools/torch_kernel_variants.py --scan [--parent DIR]

* K2 ``pcps_bins`` at n = 4092 (8 channels x 101 bins x 10 blocks), and
  with ``--n`` at any other length that is not prime: the device time of
  every order of the plan's radices that the kernels take (a generic
  radix above 31 neither first nor last, radix 1 only at an end) at
  several block sizes, on the entry that n selects (one block, or a
  cluster of ``cluster_size(n)`` blocks), each held against the plain
  version (1e-4 of the map's maximum), beside the plain version and
  ``torch.fft.ifft`` alone; then the default plan on every cluster size
  whose blocks fit. With ``--entries``, only K2's entries side by side
  at each ``--n``: the radix entry (where a block or a cluster holds n's
  plan), the two-step entry (where n's split fits the tile, whatever its
  largest prime factor) and the Bluestein entry, on the same inputs at
  8 ch x 101 bins x 10 blocks and 1 x 11 x 2, each held against the
  plain version, timed in two turns, beside ``torch.fft.ifft``: the
  measurement behind ``acq_kernel.GENERIC_MAX_PRIME`` and
  ``TWOSTEP_MAX_PRIME``. A launch above half a second is timed once,
  between CUDA events. With ``--bluestein`` (default n:
  :data:`BLUESTEIN_N`), the Bluestein entry at the convolution lengths
  of the source's rule and of each of :data:`BLUESTEIN_RULES` (the least
  5-, 7-, 13- and 31-smooth M >= 2n - 1 split balanced, the least
  7-smooth with the longest columns and with the fewest passes, and the
  5- and 7-smooth M within 2% with the fewest passes), at 8 ch x 101
  bins x 10 blocks and 1 ch x 11 bins x 2 blocks, timed in turns, with
  each rule's geometric mean over the n of its time over the fastest:
  the measurement behind ``acq_kernel.bluestein_lengths``; then the
  split of the source rule's device time over its three kernels
  (``torch.profiler``). With ``--bluestein --layouts``, the Bluestein
  entry at the source rule's M with its sub-plans in other orders (the
  radix-16 passes moved), its split swapped, and built with the tile's
  radix-16 variant at :data:`TILE_16_BLOCKS` blocks an SM, at both
  shapes, in two turns.
* ``--twostep``: K2's two-step entry at 8 ch x 101 bins x 10 blocks at
  each ``--n`` (default 70000 and 245520): (1) the entry built with each
  of :data:`TWOSTEP_SHAPES` (threads a block, and blocks an SM for each
  of its three variants: the register cap), each held against the plain
  version and timed in two turns, with the split of the source's device
  time over its two kernels (``torch.profiler``); (2) chunks of
  :data:`TWOSTEP_CHUNK_PAIRS` (bin, channel) pairs, whose scratch stays
  in the 50 MB L2 between the passes, against the wrapper's one chunk of
  up to 512 MiB; (3) the entry forced at 16368 and 40920, below 65,536,
  beside the cluster entry that ``kernel_for`` gives there and
  ``torch.fft.ifft`` (a record for a later routing decision). With
  ``--layouts``, only the entry at each ``--n`` (default 99375) in each
  of :func:`twostep_layouts` (the wrapper's split and sub-plans, the
  generic radices or the radix-16 passes at other positions, splits with
  the generic radices all in the rows or all in the columns, or, for a
  31-smooth n, with the fewest passes) and in the wrapper's layout built
  with the generic variant at :data:`TWOSTEP_ANY_BLOCKS` blocks an SM and
  with the 2048-point tile that a 31-smooth split of the same lengths
  takes (:data:`TWOSTEP_GENERIC_TILE`), where a sub-plan has a generic
  radix, and with the radix-16 variant at :data:`TILE_16_BLOCKS` blocks
  an SM, where one has radix 16, at 8 x 101 x 10 and 1 x 11 x 2, in two
  turns.
* ``--parent DIR`` (a checkout of another commit): DIR's K2 entries
  against this tree's on the entry that ``kernel_for`` gives, at
  :data:`PARENT_CASES` (one block at n = 2500, 10000, 4092, 4070; a
  cluster at 16368, 40920; the two-step entry at 26500, 70000, 99375,
  245520 and 2^20; the Bluestein entry at :data:`BLUESTEIN_N`; then the
  sweeps' 1 x 11 x 2 at the lengths whose tile plans radix 8 and 16
  changed and at some they left), or at ``--n`` with ``--channels``: the
  maps bit for bit where both trees launch the same entry, split or
  lengths and sub-plans, else each tree at its own arguments against the
  plain version; each tree's plans, its build's registers and spills,
  and the device times in turns parent, this, this, parent.
* K3 ``block_cumsum_streams`` at its three shapes (cruise, pull-in, full
  rate): the device time of the totals launch, the prefix launch and both,
  and of the kernel that only makes K3's stores, for several segment
  lengths (``seg_chunks = 1`` is one 1024-sample chunk a block).

* ``--pass-c``: pass C's kernel at the cruise and pull-in shapes and at
  64 epochs, built as the source is and with parts taken out by text
  substitution (:data:`PASS_C_CUTS`: the serial phase B or D, both, phase
  D's histogram reductions, the discriminators, the derotation's sinf and
  cosf, the output stores), each timed in two turns: where a block's
  device time goes (a cut kernel's results are not checked: they are
  wrong by construction). With ``--parent DIR``, only DIR's pass C
  kernel (launched through DIR's own ``ops/loop_kernel.py``, so its own
  launch signature) against this tree's at the cruise and pull-in shapes,
  in turns parent, this, this, parent, their outputs and states held equal
  bit for bit (a parent without the folded anchor slew with the plain
  slew applied to its state).

* ``--scan``: the scan runtime's kernel (``csrc/scan_block.cu``) on
  ``tests/_scan_inputs.py``'s mid-track blocks at ``chip_smoke.py``'s
  three scan cases (2.5 Msps borre, the scan session's; 10 Msps with
  kaplan's 5 taps; 16.368 Msps borre): the source (C = 4 CTAs a
  channel) and its C = 1 and C = 2 variants at 20 epochs of 32 and of
  one channel, and at 1, 5 and 40 epochs (a launch's fixed cost, an
  epoch's, whether channels wait for each other), with
  ``cudaOccupancyMaxActiveClusters``; the kernel built with each of
  :data:`SCAN_VARIANTS` (C = 1 and 2, other threads a CTA, occupancy
  caps, the phase polled otherwise, no bookkeeping warp, the first
  sample loaded late, no tree, no correlation, no discriminate, no loop
  update), at 32 channels and at one, each timed in two turns; the
  variants that change no arithmetic (:data:`SCAN_SAME_BITS`) held to
  the source bit for bit (a cut kernel's results are not checked);
  :data:`SCAN_CHECK_LAUNCHES` launches of the protocol check
  (``scan_kernel.SCAN_CHECK_KERNEL``) a case, each bit for bit with the
  production kernel and without a fault; and C = 1, 2, 4 at 32 channels
  at 0.5-5 Msps (:data:`SCAN_SWEEP_FS`): the measurements behind
  ``scan_kernel.SCAN_CLUSTER``. With ``--parent DIR``: DIR's kernel (a
  checkout of another commit with the same entry point) cut by text
  substitution (:data:`PARENT_SCAN_CUTS`: the output stores, bit sync
  and C/N0, the serial warp sum, the phase advance's doubles, all four,
  the correlation, the loop update) and timed in two turns, then
  against this tree's on the same inputs at the three cases in turns
  parent, this, this, parent (device times, and the call time of each
  tree's ``scan_kernel.scan_block`` wrapper): each tree bit for bit
  with itself, this tree within the scan runtime's bounds of the
  parent's (``_scan_inputs.bound_faults``).

Device times are ``chip_smoke.device_ms`` (launches queued behind a
spinning kernel, between CUDA events). Needs a CUDA device; imports no JAX.
"""

from __future__ import annotations

import argparse
import functools
import itertools
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def k2_inputs(n: int, n_ch: int, device, n_bins: int = 101, nc: int = 10):
    """Seeded spectra [10, n_ch, nc, n], code [n_ch, n] and an
    ``n_bins``-bin plan over the 10 phases."""
    import torch

    g = torch.Generator().manual_seed(0)
    spec = torch.randn(10, n_ch, nc, n, dtype=torch.complex64,
                       generator=g).to(device)
    code = torch.randn(n_ch, n, dtype=torch.complex64,
                       generator=g).to(device)
    bins = tuple((b // 10 - 5, b % 10) for b in range(n_bins))
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


def entry_time(fn) -> float:
    """Device milliseconds of a launch of ``fn``: once, between CUDA
    events, above half a second; else ``chip_smoke.device_ms`` over about
    200 ms of launches (2 to 20)."""
    once = once_ms(fn)
    if once > 500:
        return once
    return chip_smoke.device_ms(fn, max(2, min(20, int(200 / once))))


def k2_entries(n: int, n_ch: int, device) -> None:
    """The radix entry (where a block or a cluster holds n's plan), the
    two-step entry (where n's split fits the tile) and the Bluestein
    entry on the same inputs, at ``n_ch`` ch x 101 bins x 10 blocks and 1
    ch x 11 bins x 2 blocks: device times in two turns, each map within
    1e-4 of the plain version's maximum, beside ``torch.fft.ifft``, the
    ratios of the entries, and which one ``kernel_for`` takes."""
    import torch

    from sydr_tpu_torch.ops import acq_kernel

    plan = acq_kernel.radix_plan(n) if acq_kernel.has_radix_plan(n) \
        else None
    entries = ["bluestein"]
    try:
        split = acq_kernel.twostep_split(n)
        entries.insert(0, "twostep")
    except ValueError:
        split = None
    if plan is not None and acq_kernel.fitting_cluster(n, plan):
        entries.insert(0, "radix")
    routed = acq_kernel.kernel_for(n)[0]
    m, m1, m2 = acq_kernel.bluestein_lengths(n)
    for shape in ((n_ch, 101, 10), (1, 11, 2)):
        spec, code, bins = k2_inputs(n, shape[0], device, *shape[1:])
        ref = acq_kernel.pcps_bins_ref(spec, code, bins)
        bound = chip_smoke.K2_RTOL * float(ref.abs().max())
        try:
            ms = chip_smoke.ifft_library_ms(spec, code, bins, quiet=True)
            library = f"{ms:.4f}"
        except torch.OutOfMemoryError:   # its product and output pass 80 GB
            library = "not measured"
        torch.cuda.empty_cache()
        fns = {}
        for name in entries:
            kernel, out, cargs = acq_kernel.pcps_bins_launch_args(
                spec, code, bins, entry=name)
            fn = kernel.function()
            chip_smoke.check(fn(*cargs) == 0, f"n={n} {name}: launch failed")
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            chip_smoke.check(err <= bound, f"n={n} {name}: error {err} "
                                           f"above {bound}")
            fns[name] = (lambda fn=fn, cargs=cargs: fn(*cargs), err)
        times = {name: [] for name in entries}
        for turn in (entries, entries[::-1]):
            for name in turn:
                times[name].append(entry_time(fns[name][0]))
        mean = {k: sum(v) / len(v) for k, v in times.items()}
        ratios = ", ".join(f"{a} / {b} {mean[a] / mean[b]:.3f}"
                           for a, b in itertools.combinations(entries, 2))
        print(f"K2 entries n={n} (largest prime factor "
              f"{acq_kernel.prime_factors(n)[-1]}, plan {plan}, two-step "
              f"{split}, M = {m} = {m1} x {m2}), {shape[0]} ch x "
              f"{shape[1]} bins x {shape[2]} blocks: "
              + ", ".join(f"{k} {v[0]:.4f} / {v[1]:.4f} ms (err "
                          f"{fns[k][1] / float(ref.abs().max()):.2e})"
                          for k, v in times.items())
              + f", ifft {library} ms; {ratios}; kernel_for takes "
              f"{routed.source}", flush=True)


def plan_orders(plan, row: bool) -> list:
    """Other orders of the tile sub-plan ``plan`` that the entries take:
    its generic radices (above 31), or its radix-16 passes, moved together
    to each other position among the rest (a row plan that would end in a
    generic radix ends in radix 1)."""
    out = []
    for moved in (lambda r: r > 31, lambda r: r == 16):
        block = [r for r in plan if moved(r)]
        rest = [r for r in plan if not moved(r) and r != 1]
        for pos in range(len(rest) + 1) if block else ():
            alt = tuple(rest[:pos] + block + rest[pos:])
            if row and alt[-1] > 31:
                alt += (1,)
            if alt != tuple(plan) and alt not in out:
                out.append(alt)
    return out


def twostep_layouts(n: int) -> list:
    """``(label, N1, plan1, plan2)`` of the two-step entry at ``n``: the
    wrapper's (:func:`acq_kernel.twostep_split`); its sub-plans in the
    other orders of :func:`plan_orders` (the generic radices, or the
    radix-16 passes, at other positions); JAX's balanced split; and the
    splits N1 x N2 within the tile (N1 <= N2) with the fewest passes whose
    generic radices are all in the rows, or all in the columns, or, for a
    31-smooth n, with the fewest passes (2^20 = 256 x 4096 in five where
    JAX's 1024 x 1024 takes six), where those differ from the
    wrapper's."""
    from sydr_tpu_torch.ops import acq_kernel

    n1, n2, p1, p2 = acq_kernel.twostep_split(n)
    out = [("default", n1, p1, p2)]
    seen = {(n1, p1, p2)}

    def add(label, a, q1, q2):
        if (a, q1, q2) not in seen:
            seen.add((a, q1, q2))
            out.append((label, a, q1, q2))

    for alt in plan_orders(p1, False):
        add(f"columns in order {alt}", n1, alt, p2)
    for alt in plan_orders(p2, True):
        add(f"rows in order {alt}", n1, p1, alt)
    a, b = acq_kernel.balanced_factors(n)
    if b <= acq_kernel.TWOSTEP_MAX_N2:
        add(f"JAX's balanced split, {a} x {b}", a, acq_kernel.sub_plan(a),
            acq_kernel.sub_plan(b, row=True))
    best = {}
    smooth = acq_kernel.prime_factors(n)[-1] <= 31
    for a in range(2, acq_kernel.TWOSTEP_MAX_N1 + 1):
        b = n // a
        if n % a or b < a or b > acq_kernel.TWOSTEP_MAX_N2:
            continue
        q1, q2 = acq_kernel.sub_plan(a), acq_kernel.sub_plan(b, row=True)
        where = ("the fewest passes" if smooth else
                 "generic in the rows"
                 if max(acq_kernel.prime_factors(a)) <= 31 else
                 "generic in the columns"
                 if max(acq_kernel.prime_factors(b)) <= 31 else None)
        keys = [(where, (len(q1) + len(q2), b)),
                (f"{where}, most balanced", (b - a,))]
        if smooth and b <= 2048:
            keys.append((f"{where}, rows up to 2048",
                         (len(q1) + len(q2), b)))
        for label, key in keys:
            if where and (label not in best or key < best[label][0]):
                best[label] = (key, a, q1, q2)
    for where, (_, a, q1, q2) in sorted(best.items()):
        add(f"{where}, {a} x {n // a}", a, q1, q2)
    return out


def k2_twostep_layouts(ns, n_ch: int, device) -> None:
    """The two-step entry at each of :func:`twostep_layouts`, at ``n_ch``
    ch x 101 bins x 10 blocks and 1 ch x 11 bins x 2 blocks: each map
    within 1e-4 of the plain version's maximum, device times in two
    turns."""
    import torch

    from sydr_tpu_torch.ops import acq_kernel, native

    generic_caps = {f"kAnyRadix at {b} blocks an SM": source_variant(
        acq_kernel.TWOSTEP_KERNEL, f"twostep_any_{b}",
        {"constexpr int kMinBlocksAny = ": b}) for b in TWOSTEP_ANY_BLOCKS}
    generic_caps["the small tile where a smooth split takes it"] = \
        source_variant(acq_kernel.TWOSTEP_KERNEL, "twostep_any_small_tile",
                       {}, swap=TWOSTEP_GENERIC_TILE)
    caps16 = radix16_caps(acq_kernel.TWOSTEP_KERNEL, "twostep")
    native.build_all([*generic_caps.values(), *caps16.values()])
    for b, kern in {**generic_caps, **caps16}.items():
        usage = [ln.strip() for ln in kern.build_log.splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"two-step, {b}: " + "; ".join(usage), flush=True)
    fn = acq_kernel.TWOSTEP_KERNEL.function()
    INT = acq_kernel._INT
    for n in ns:
        layouts = twostep_layouts(n)
        split = acq_kernel.twostep_split(n)
        caps = {**(generic_caps if max(split[2] + split[3]) > 31 else {}),
                **(caps16 if 16 in split[2] + split[3] else {})}
        for shape in ((n_ch, 101, 10), (1, 11, 2)):
            spec, code, bins = k2_inputs(n, shape[0], device, *shape[1:])
            ref = acq_kernel.pcps_bins_ref(spec, code, bins)
            bound = chip_smoke.K2_RTOL * float(ref.abs().max())
            _, out, cargs = acq_kernel.pcps_bins_launch_args(
                spec, code, bins, entry="twostep")
            runs = {}
            for label, a, q1, q2 in layouts:
                args = (*cargs[:9], a, (INT * len(q1))(*q1), len(q1),
                        (INT * len(q2))(*q2), len(q2), *cargs[14:])
                out.zero_()
                chip_smoke.check(fn(*args) == 0, f"n={n} {label}: launch "
                                                 f"failed")
                torch.cuda.synchronize()
                err = float((out - ref).abs().max())
                chip_smoke.check(err <= bound, f"n={n} {label}: error {err}")
                runs[label] = lambda args=args: fn(*args)
            for b, kern in caps.items():
                f = kern.function()
                out.zero_()
                chip_smoke.check(f(*cargs) == 0, f"n={n} {b}: launch failed")
                torch.cuda.synchronize()
                err = float((out - ref).abs().max())
                chip_smoke.check(err <= bound, f"n={n} {b}: error {err}")
                runs[b] = lambda f=f: f(*cargs)
            times = {label: [] for label in runs}
            for turn in (list(runs), list(runs)[::-1]):
                for label in turn:
                    times[label].append(entry_time(runs[label]))
            shapes = {label: f" ({a} x {n // a}, {q1} {q2})"
                      for label, a, q1, q2 in layouts}
            print(f"K2 two-step layouts n={n}, {shape[0]} ch x {shape[1]} "
                  f"bins x {shape[2]} blocks: " + "; ".join(
                      f"{label}{shapes.get(label, '')} {t[0]:.4f} / "
                      f"{t[1]:.4f} ms" for label, t in times.items()),
                  flush=True)


# Code periods of --bluestein (and --parent): the 9.722 Msps session's,
# large prime factors below the clusters, the first n above them, a
# 99.375 Msps front end (3 x 5^4 x 53) and 2 x 65537.
BLUESTEIN_N = (9722, 16370, 65498, 65538, 99375, 131074)
PRIMES = {5: (2, 3, 5), 7: (2, 3, 5, 7), 13: (2, 3, 5, 7, 11, 13),
          31: (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31)}


@functools.lru_cache(maxsize=None)
def smooth(top: int) -> tuple:
    """The PRIMES[top]-smooth numbers up to 2^22."""
    from sydr_tpu_torch.ops import acq_kernel

    return acq_kernel.smooth_numbers(PRIMES[top], 1 << 22)


@functools.lru_cache(maxsize=None)
def split_of(m: int, how: str):
    """``(M1, M2)`` of ``m`` for the tile FFT (M1 <= 1024, M2 <= 4096,
    both at least 2) by the split ``how``: "balanced" (M1 the largest
    divisor up to sqrt(M)), "long columns" (M1 the largest divisor) or
    "fewest passes" (``acq_kernel.tile_split``: the fewest passes of the
    two sub-plans, then the most balanced); None where there is none."""
    from sydr_tpu_torch.ops import acq_kernel

    fits = [(m1, m // m1) for m1 in range(2, acq_kernel.TWOSTEP_MAX_N1 + 1)
            if m % m1 == 0 and 2 <= m // m1 <= acq_kernel.TWOSTEP_MAX_N2]
    if not fits:
        return None
    if how == "balanced":
        return max((f for f in fits if f[0] <= f[1]), default=None)
    if how == "long columns":
        return max(fits)
    return acq_kernel.tile_split(m)


def passes(m1: int, m2: int) -> int:
    """Passes of the two sub-plans of the split M1 x M2."""
    from sydr_tpu_torch.ops import acq_kernel

    return len(acq_kernel.sub_plan(m1)) + len(acq_kernel.sub_plan(m2))


def bluestein_rule(top: int, how: str, slack: float = 0.0):
    """A rule n -> (M, M1, M2): the least PRIMES[top]-smooth M >= 2n - 1
    that splits by ``how``; with ``slack``, of the smooth M up to (1 +
    slack)(2n - 1), the one whose split by ``how`` has the fewest passes
    (then the least M)."""
    import bisect

    def lengths(n):
        nums = smooth(top)
        i = bisect.bisect_left(nums, 2 * n - 1)
        best = None
        while best is None or nums[i] <= (1 + slack) * (2 * n - 1):
            split = split_of(nums[i], how)
            if split is not None:
                key = (passes(*split) if slack else 0, nums[i])
                if best is None or key < best[0]:
                    best = (key, (nums[i], *split))
            i += 1
        return best[1]

    return lengths


# The rules that --bluestein times beside acq_kernel.bluestein_lengths
# (SOURCE_RULE: the 13-smooth M within 2% above 2n - 1 with the fewest
# passes): the least 5-, 7-, 13- and 31-smooth M >= 2n - 1, split
# balanced, the least 7-smooth with the longest columns and with the
# fewest passes, and the 5- and 7-smooth M within 2% with the fewest
# passes.
SOURCE_RULE = "13-smooth within 2%, fewest passes (the source's rule)"
BLUESTEIN_RULES = {
    "least 7-smooth, balanced": bluestein_rule(7, "balanced"),
    "least 5-smooth, balanced": bluestein_rule(5, "balanced"),
    "least 13-smooth, balanced": bluestein_rule(13, "balanced"),
    "least 31-smooth, balanced": bluestein_rule(31, "balanced"),
    "least 7-smooth, long columns": bluestein_rule(7, "long columns"),
    "least 7-smooth, fewest passes": bluestein_rule(7, "fewest passes"),
    "5-smooth within 2%, fewest passes": bluestein_rule(
        5, "fewest passes", 0.02),
    "7-smooth within 2%, fewest passes": bluestein_rule(
        7, "fewest passes", 0.02),
}


def bluestein_candidates(n: int) -> dict:
    """``{(M, M1, M2): [rules]}``: the lengths of the source's rule and of
    each of BLUESTEIN_RULES at ``n``."""
    from sydr_tpu_torch.ops import acq_kernel

    out = {acq_kernel.bluestein_lengths(n): [SOURCE_RULE]}
    for name, rule in BLUESTEIN_RULES.items():
        out.setdefault(rule(n), []).append(name)
    return out


def timer(fn, reps: int):
    """How to time ``fn`` (a C entry point's call): ``chip_smoke.device_ms``
    over ``reps`` calls, or, where one call takes more than 5 ms (up to
    hundreds of launches a call in chunks of pairs: more than the launch
    queue holds behind ``device_ms``'s spin), ``chip_smoke.cuda_ms`` over
    3 calls, whose host share is then nothing."""
    if chip_smoke.cuda_ms(fn, 1) > 5.0:
        return lambda f: chip_smoke.cuda_ms(f, 3)
    return lambda f: chip_smoke.device_ms(f, reps)


class bluestein_lengths_as:
    """Within the block, ``acq_kernel.bluestein_lengths`` gives
    ``lengths`` (the wrapper builds the entry's arguments at them)."""

    def __init__(self, lengths):
        self.lengths = lengths

    def __enter__(self):
        from sydr_tpu_torch.ops import acq_kernel

        self.rule = acq_kernel.bluestein_lengths
        acq_kernel.bluestein_lengths = lambda n: self.lengths

    def __exit__(self, *exc):
        from sydr_tpu_torch.ops import acq_kernel

        acq_kernel.bluestein_lengths = self.rule


def sweep_inputs(n: int, device):
    """``chip_smoke.k2_sweep``'s inputs: 1 ch x 11 bins x 2 blocks."""
    import torch

    g = torch.Generator().manual_seed(chip_smoke.SEED)
    spec = torch.randn(2, 1, 2, n, dtype=torch.complex64,
                       generator=g).to(device)
    code = torch.randn(1, n, dtype=torch.complex64, generator=g).to(device)
    return spec, code, tuple((b - 5, b % 2) for b in range(11))


def kernel_split(fn, calls: int = 3) -> dict:
    """Device milliseconds a call of ``fn`` spends in each kernel (its
    name's first word before a template argument), ``torch.profiler``
    over ``calls`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split = {}
    for ev in prof.key_averages():
        if ev.device_time_total > 0:
            key = ev.key.replace("(anonymous namespace)::", "")
            key = key.split("(")[0].split("<")[0].split()[-1]
            split[key] = split.get(key, 0.0) + ev.device_time_total / (
                1e3 * calls)
    return split


def k2_bluestein(ns, n_ch: int, device) -> None:
    """The Bluestein entry at the lengths of each of BLUESTEIN_RULES (built
    with every variant of the tile FFT, a copy of its source under
    ``_build/``), at 8 ch x 101 bins x 10 blocks (``n_ch``) and 1 ch x 11
    bins x 2 blocks, each held against the plain version and timed in two
    turns; per rule and shape, the geometric mean over ``ns`` of its time
    over the fastest; then the device time of each of the source rule's
    three kernels in one call (``torch.profiler``)."""
    import torch

    from sydr_tpu_torch.ops import acq_kernel, native

    wide = source_variant(acq_kernel.BLUESTEIN_KERNEL, "bluestein_wide",
                          {"constexpr int kWidestRadix = ": 31})
    native.build_all([wide])
    usage = [ln.strip() for ln in wide.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    print("Bluestein entry with every variant: " + "; ".join(usage),
          flush=True)
    fn = wide.function()
    shapes = (f"{n_ch} ch x 101 bins x 10", "1 ch x 11 bins x 2")
    names = [SOURCE_RULE, *BLUESTEIN_RULES]
    ratios = {(name, shape): [] for name in names for shape in shapes}
    for n in ns:
        cands = bluestein_candidates(n)
        rule = acq_kernel.bluestein_lengths(n)
        for shape, (spec, code, bins) in zip(
                shapes, (k2_inputs(n, n_ch, device), sweep_inputs(n, device))):
            ref = acq_kernel.pcps_bins_ref(spec, code, bins)
            bound = chip_smoke.K2_RTOL * float(ref.abs().max())
            reps = 5 if len(bins) > 11 else 20
            times = {lengths: [] for lengths in cands}
            clock = None
            for turn in (list(cands), list(cands)[::-1]):
                for lengths in turn:
                    with bluestein_lengths_as(lengths):
                        _, out, cargs = acq_kernel.pcps_bins_launch_args(
                            spec, code, bins, entry="bluestein")
                    chip_smoke.check(fn(*cargs) == 0,
                                     f"M = {lengths}: launch failed")
                    torch.cuda.synchronize()
                    err = float((out - ref).abs().max())
                    chip_smoke.check(err <= bound, f"M = {lengths}: error "
                                                   f"{err} above {bound}")
                    clock = clock or timer(lambda: fn(*cargs), reps)
                    times[lengths].append(clock(lambda: fn(*cargs)))
                    del out, cargs
            library = chip_smoke.ifft_library_ms(spec, code, bins, True)
            fastest = min(sum(t) / 2 for t in times.values())
            print(f"K2 Bluestein n={n}, {shape}: ifft {library:.4f} ms; "
                  f"the source's M = {rule[0]} = {rule[1]} x {rule[2]}",
                  flush=True)
            for lengths, t in sorted(times.items(), key=lambda kv: sum(kv[1])):
                m, m1, m2 = lengths
                for name in cands[lengths]:
                    ratios[(name, shape)].append(sum(t) / 2 / fastest)
                print(f"   M = {m} = {m1} x {m2} ({m / (2 * n - 1):.4f} "
                      f"(2n - 1)), plans {acq_kernel.sub_plan(m1)} "
                      f"{acq_kernel.sub_plan(m2)}: {t[0]:.4f} / {t[1]:.4f} "
                      f"ms [{'; '.join(cands[lengths])}]"
                      + (" <- the source's" if lengths == rule else ""),
                      flush=True)
        spec, code, bins = k2_inputs(n, n_ch, device)
        kern, _, cargs = acq_kernel.pcps_bins_launch_args(
            spec, code, bins, entry="bluestein")
        own = kern.function()
        split = kernel_split(lambda: own(*cargs))
        print(f"K2 Bluestein n={n}, {n_ch} ch x 101 bins x 10, the source's "
              f"kernels a call: " + ", ".join(f"{k} {v:.4f} ms"
                                              for k, v in split.items()),
              flush=True)
    for shape in shapes:
        print(f"K2 Bluestein rules at {shape}, n = {list(ns)}: geometric "
              f"mean of the time over the fastest's", flush=True)
        for name in sorted(names, key=lambda k: np.prod(ratios[(k, shape)])):
            r = ratios[(name, shape)]
            print(f"   {name}: {np.prod(r) ** (1 / len(r)):.4f} (worst "
                  f"{max(r):.4f})", flush=True)


def k2_bluestein_layouts(ns, n_ch: int, device) -> None:
    """The Bluestein entry at the convolution length of the source's rule
    (``acq_kernel.bluestein_lengths``) with its sub-plans in the other
    orders of :func:`plan_orders` (the radix-16 passes at other
    positions), its split swapped (M2 x M1, where M2 fits the columns),
    and built with the tile's radix-16 variant at other blocks an SM
    (:func:`radix16_caps`), at ``n_ch`` ch x 101 bins x 10 blocks and 1 ch
    x 11 bins x 2 blocks: each map within 1e-4 of the plain version's
    maximum, device times in two turns."""
    import torch

    from sydr_tpu_torch.ops import acq_kernel, native

    caps = radix16_caps(acq_kernel.BLUESTEIN_KERNEL, "bluestein")
    native.build_all(list(caps.values()))
    for b, kern in caps.items():
        usage = [ln.strip() for ln in kern.build_log.splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"Bluestein, {b}: " + "; ".join(usage), flush=True)
    fn = acq_kernel.BLUESTEIN_KERNEL.function()
    INT = acq_kernel._INT
    for n in ns:
        m, m1, m2 = acq_kernel.bluestein_lengths(n)
        p1, p2 = acq_kernel.sub_plan(m1), acq_kernel.sub_plan(m2)
        layouts = [("default", (m, m1, m2), p1, p2)]
        layouts += [(f"columns in order {alt}", (m, m1, m2), alt, p2)
                    for alt in plan_orders(p1, False)]
        layouts += [(f"rows in order {alt}", (m, m1, m2), p1, alt)
                    for alt in plan_orders(p2, False)]
        if m2 != m1 and m2 <= acq_kernel.TWOSTEP_MAX_N1:
            layouts.append((f"split swapped, {m2} x {m1}", (m, m2, m1),
                            acq_kernel.sub_plan(m2), acq_kernel.sub_plan(m1)))
        for shape in ((n_ch, 101, 10), (1, 11, 2)):
            spec, code, bins = k2_inputs(n, shape[0], device, *shape[1:])
            ref = acq_kernel.pcps_bins_ref(spec, code, bins)
            bound = chip_smoke.K2_RTOL * float(ref.abs().max())
            runs, keep = {}, []
            for label, lengths, q1, q2 in layouts:
                with bluestein_lengths_as(lengths):
                    _, out, cargs = acq_kernel.pcps_bins_launch_args(
                        spec, code, bins, entry="bluestein")
                args = (*cargs[:13], (INT * len(q1))(*q1), len(q1),
                        (INT * len(q2))(*q2), len(q2), *cargs[17:])
                chip_smoke.check(fn(*args) == 0, f"n={n} {label}: launch "
                                                 f"failed")
                torch.cuda.synchronize()
                err = float((out - ref).abs().max())
                chip_smoke.check(err <= bound, f"n={n} {label}: error {err}")
                runs[label] = (fn, args)
                keep.append(out)
            for b, kern in caps.items():
                f, args = kern.function(), runs["default"][1]
                keep[0].zero_()
                chip_smoke.check(f(*args) == 0, f"n={n} {b}: launch failed")
                torch.cuda.synchronize()
                err = float((keep[0] - ref).abs().max())
                chip_smoke.check(err <= bound, f"n={n} {b}: error {err}")
                runs[b] = (f, args)
            f, args = runs["default"]
            clock = timer(lambda: f(*args), 5 if len(bins) > 11 else 20)
            times = {label: [] for label in runs}
            for turn in (list(runs), list(runs)[::-1]):
                for label in turn:
                    f, args = runs[label]
                    times[label].append(clock(lambda f=f, args=args:
                                              f(*args)))
            shapes = {label: f" ({lengths[1]} x {lengths[2]}, {q1} {q2})"
                      for label, lengths, q1, q2 in layouts}
            print(f"K2 Bluestein layouts n={n}, M = {m}, {shape[0]} ch x "
                  f"{shape[1]} bins x {shape[2]} blocks: " + "; ".join(
                      f"{label}{shapes.get(label, '')} {t[0]:.4f} / "
                      f"{t[1]:.4f} ms" for label, t in times.items()),
                  flush=True)
            del keep, runs


# (threads, (blocks an SM of the variants with radices up to 10, up to
# 13, up to 31), the smaller tile's points, the L2 bytes of the order
# rule) of csrc/pcps_bins_twostep.cu tried by --twostep (a small tile of
# 4096: one tile size; L2 bytes 0: (a) always block-major, 2^40: always
# pair by pair); the first is the source's.
TWOSTEP_SHAPES = ((256, (4, 4, 2), 2048, 50 << 20),
                  (256, (4, 4, 2), 2048, 0), (256, (4, 4, 2), 2048, 1 << 40),
                  (256, (3, 3, 2), 2048, 50 << 20),
                  (256, (4, 4, 1), 2048, 50 << 20),
                  (256, (4, 4, 2), 4096, 50 << 20),
                  (512, (2, 2, 1), 2048, 50 << 20),
                  (128, (6, 6, 2), 2048, 50 << 20))
# The twiddle of (a)'s last pass, as two factors of the table
# (csrc/pcps_tile.cuh's table_twiddle), and the direct read that --twostep
# times beside it.
TWOSTEP_TWIDDLE = ("cmul(__ldg(tw + (r & ~1023)), __ldg(tw + (r & 1023)))",
                   "__ldg(tw + r)")
# Blocks an SM of the generic variant (kAnyRadix) tried by --layouts
# beside the source's.
TWOSTEP_ANY_BLOCKS = (1, 3)
# Blocks an SM of the tile's radix-16 variant (kMinBlocks16: at most
# 65536 / (256 x blocks) registers a thread) tried by --layouts beside
# the source's, on the two-step and Bluestein entries.
TILE_16_BLOCKS = (2, 3, 4)
# The tile rule before kAnyRadix took the largest tile always (--layouts).
TWOSTEP_GENERIC_TILE = ("max1 == kAnyRadix || max2 == kAnyRadix", "false")
# Pairs a chunk tried by --twostep beside the wrapper's own.
TWOSTEP_CHUNK_PAIRS = (4, 8, 16, 32)
# Lengths below 65,536 where --twostep forces the entry.
TWOSTEP_FORCED_N = (16368, 40920)


def variant_texts(kern, lines, swap=None) -> dict:
    """``kern``'s source and the headers beside it ({file name: text}) with
    the lines that start with a key of ``lines`` (each once in all the
    files) given that value (``constexpr int kThreads = 256;`` with
    ``{"constexpr int kThreads = ": 512}``), and the text ``swap[0]``
    (once) replaced by ``swap[1]`` (``swap`` may also be a list of such
    pairs)."""
    files = [kern.source] + sorted(h.name
                                   for h in kern.csrc_dir.glob("*.cuh"))
    texts = {name: (kern.csrc_dir / name).read_text() for name in files}
    found = {head: 0 for head in lines}
    for name, text in texts.items():
        out = []
        for line in text.splitlines(keepends=True):
            for head, value in lines.items():
                if line.startswith(head):
                    line = f"{head}{value};" + line.split(";", 1)[1]
                    found[head] += 1
            out.append(line)
        texts[name] = "".join(out)
    chip_smoke.check(all(v == 1 for v in found.values()),
                     f"lines not found once in {kern.source} and its "
                     f"headers: {found}")
    swaps = [] if swap is None else (
        swap if isinstance(swap, list) else [swap])
    for old, new in swaps:
        hits = [name for name, text in texts.items() if old in text]
        chip_smoke.check(len(hits) == 1 and texts[hits[0]].count(old)
                         == 1, f"{old} not in the sources once")
        texts[hits[0]] = texts[hits[0]].replace(old, new)
    return texts


def source_variant(kern, tag, lines, swap=None):
    """:func:`variant_texts` of ``kern`` as a kernel (``kern``'s entry
    point and flags) built from copies under ``_build/variants/<tag>``."""
    from pathlib import Path

    from sydr_tpu_torch.ops import native

    folder = Path(native.PACKAGE_DIR, "_build", "variants", tag)
    folder.mkdir(parents=True, exist_ok=True)
    for name, text in variant_texts(kern, lines, swap).items():
        (folder / name).write_text(text)
    return native.CudaKernel(kern.source, kern.symbol, kern.argtypes,
                             csrc_dir=folder, flags=kern.flags)


def radix16_caps(kern, tag) -> dict:
    """``kern`` (the two-step or Bluestein entry) built with its tile's
    radix-16 variant at each of :data:`TILE_16_BLOCKS` blocks an SM other
    than the source's (:func:`source_variant`), by label."""
    import re

    from sydr_tpu_torch.ops import native

    text = (native.CSRC_DIR / kern.source).read_text()
    own = int(re.search(r"constexpr int kMinBlocks16 = (\d+);", text)[1])
    return {f"radix-16 variant at {b} blocks an SM": source_variant(
        kern, f"{tag}_16_{b}", {"constexpr int kMinBlocks16 = ": b})
        for b in TILE_16_BLOCKS if b != own}


def twostep_variant(threads, blocks, small_tile, l2_bytes, swap=None):
    """The two-step entry's source with another block size, register caps,
    smaller tile and order rule (and the text ``swap[0]`` replaced by
    ``swap[1]``): :func:`source_variant`."""
    from sydr_tpu_torch.ops import acq_kernel

    lines = {"constexpr int kThreads = ": threads,
             "constexpr int kMinBlocksSmall = ": blocks[0],
             "constexpr int kMinBlocksMid = ": blocks[1],
             "constexpr int kMinBlocksWide = ": blocks[2],
             "constexpr int kSmallTile = ": small_tile,
             "constexpr long long kL2Bytes = ": f"{l2_bytes}LL"}
    tag = (f"twostep_{threads}_{'_'.join(map(str, blocks))}_{small_tile}_"
           f"{l2_bytes}{'_swap' if swap else ''}")
    return source_variant(acq_kernel.TWOSTEP_KERNEL, tag, lines, swap)


def plain_ms(spec, code, bins) -> float:
    """Milliseconds a call of the plain version takes (CUDA events)."""
    from sydr_tpu_torch.ops import acq_kernel

    return chip_smoke.cuda_ms(
        lambda: acq_kernel.pcps_bins_ref(spec, code, bins), 3)


def k2_twostep(ns, n_ch: int, device) -> None:
    """``--twostep`` (module note)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sydr_tpu_torch.ops import acq_kernel, native

    variants = {shape: twostep_variant(*shape) for shape in TWOSTEP_SHAPES}
    direct = twostep_variant(*TWOSTEP_SHAPES[0], swap=TWOSTEP_TWIDDLE)
    native.build_all([*variants.values(), direct])
    for shape, kern in variants.items():
        usage = [ln.strip() for ln in kern.build_log.splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"two-step {shape[0]} threads, blocks an SM {shape[1]}, "
              f"small tile {shape[2]}, order rule's L2 bytes {shape[3]}: "
              + "; ".join(usage), flush=True)
    for n in ns:
        spec, code, bins = k2_inputs(n, n_ch, device)
        ref = acq_kernel.pcps_bins_ref(spec, code, bins)
        bound = chip_smoke.K2_RTOL * float(ref.abs().max())
        _, out, cargs = acq_kernel.pcps_bins_launch_args(
            spec, code, bins, entry="twostep")
        times = {shape: [] for shape in variants}
        for turn in (TWOSTEP_SHAPES, TWOSTEP_SHAPES[::-1]):
            for shape in turn:
                fn = variants[shape].function()
                out.zero_()
                chip_smoke.check(fn(*cargs) == 0, f"{shape}: launch failed")
                torch.cuda.synchronize()
                err = float((out - ref).abs().max())
                chip_smoke.check(err <= bound, f"{shape}: error {err}")
                times[shape].append(chip_smoke.device_ms(
                    lambda: fn(*cargs), 5))
        # The source against the direct twiddle read and against the pairs
        # in the plan's own bin order (an identity `order`), in turns.
        identity = torch.arange(len(bins), dtype=torch.int32, device=device)
        unordered = (*cargs[:5], identity.data_ptr(), *cargs[6:])
        fn = acq_kernel.TWOSTEP_KERNEL.function()
        others = {"source": (fn, cargs), "direct twiddle": (
            direct.function(), cargs), "bins unordered": (fn, unordered)}
        turns = {name: [] for name in others}
        for turn in (list(others), list(others)[::-1]):
            for name in turn:
                f, args = others[name]
                out.zero_()
                chip_smoke.check(f(*args) == 0, f"{name}: launch failed")
                torch.cuda.synchronize()
                err = float((out - ref).abs().max())
                chip_smoke.check(err <= bound, f"{name}: error {err}")
                turns[name].append(chip_smoke.device_ms(lambda: f(*args), 5))
        print(f"K2 two-step n={n}: device ms " + ", ".join(
            f"{k} {v[0]:.4f} / {v[1]:.4f}" for k, v in turns.items())
            + f"; the Bluestein entry "
            f"{chip_smoke.entry_ms(spec, code, bins, 'bluestein'):.4f} ms, "
            f"ifft {chip_smoke.ifft_library_ms(spec, code, bins, True):.4f} "
            f"ms, the plain version {plain_ms(spec, code, bins):.4f} ms",
            flush=True)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fn(*cargs)
            torch.cuda.synchronize()
        split = {}
        for ev in prof.key_averages():
            if ev.device_time_total > 0:
                key = next((k for k in ("column_pass", "row_pass")
                            if k in ev.key), ev.key[:40])
                split[key] = split.get(key, 0.0) + ev.device_time_total / 3e3
        n1, n2, plan1, plan2 = acq_kernel.twostep_kernel_for(n)[1]
        print(f"K2 two-step n={n} = {n1} x {n2}, plans {plan1} {plan2}, "
              f"{n_ch} ch x {len(bins)} bins x 10 blocks, chunk "
              f"{cargs[16]} pairs: device ms by (threads, blocks an SM, "
              f"small tile, order rule's L2 bytes): "
              + ", ".join(f"{s}: {t[0]:.4f} / {t[1]:.4f}"
                          for s, t in times.items())
              + "; the source's kernels a call: "
              + ", ".join(f"{k} {v:.4f}" for k, v in split.items()),
              flush=True)
        chunks = {}
        for chunk in (*TWOSTEP_CHUNK_PAIRS, cargs[16]):
            args = (*cargs[:16], chunk, *cargs[17:])
            scratch = torch.empty(chunk * 10 * n, dtype=torch.complex64,
                                  device=device)
            args = (*args[:15], scratch.data_ptr(), *args[16:])
            out.zero_()
            chip_smoke.check(fn(*args) == 0, f"chunk {chunk}: launch failed")
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            chip_smoke.check(err <= bound, f"chunk {chunk}: error {err}")
            # Up to 2 x 202 launches a call: a queue of five calls passes
            # the launch queue's depth, so the host cannot run ahead of a
            # spin (device_ms); the device is the slower side here.
            chunks[chunk] = chip_smoke.cuda_ms(lambda: fn(*args), 3)
            del scratch
        print(f"K2 two-step n={n}: device ms by pairs a chunk (scratch MB): "
              + ", ".join(f"{c} ({c * 10 * n * 8 / 1e6:.0f}): {t:.4f}"
                          for c, t in chunks.items()), flush=True)
    for n in TWOSTEP_FORCED_N:
        spec, code, bins = k2_inputs(n, n_ch, device)
        ref = acq_kernel.pcps_bins_ref(spec, code, bins)
        bound = chip_smoke.K2_RTOL * float(ref.abs().max())
        times = {}
        for entry in ("twostep", None):
            kernel, out, cargs = acq_kernel.pcps_bins_launch_args(
                spec, code, bins, entry=entry)
            fn = kernel.function()
            chip_smoke.check(fn(*cargs) == 0, f"n={n}: launch failed")
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            chip_smoke.check(err <= bound, f"n={n} {entry}: error {err}")
            times[kernel.source] = chip_smoke.device_ms(
                lambda: fn(*cargs), 10)
        library = chip_smoke.ifft_library_ms(spec, code, bins, quiet=True)
        print(f"K2 n={n} forced, {n_ch} ch x {len(bins)} bins x 10 blocks: "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items())
              + f", ifft {library:.4f} ms", flush=True)


# The production shapes of the lengths that --parent holds against the
# parent's entries, (n, channels, bins, blocks): the radix entries (one
# block, then a cluster), the two-step entry (the 70 and 99.375 Msps
# sessions' n, 120, 245.52 Msps and 2^20) and the Bluestein entry
# (BLUESTEIN_N) at 101 bins x 10 blocks, 8 ch but the first two and 2^20
# (1 ch); then the sweeps' shape, 1 ch x 11 bins x 2 blocks, at the
# lengths whose tile plans or split radix 8 and 16 change (2^20, 2^19,
# 2^18, 2^17, 122880, 120000, 400000, 245520, 66000, 65792; the
# Bluestein lengths of 16370, 65498 and 2^20 - 2) and at 70000, 99375
# and 26500.
PARENT_CASES = ((2500, 32, 101, 10), (10000, 12, 101, 10),
                (4092, 8, 101, 10), (4070, 8, 101, 10),
                (16368, 8, 101, 10), (26500, 8, 101, 10),
                (40920, 8, 101, 10), (70000, 8, 101, 10),
                (99375, 8, 101, 10), (120000, 8, 101, 10),
                (245520, 8, 101, 10),
                (1 << 20, 1, 101, 10),
                *((n, 8, 101, 10) for n in BLUESTEIN_N if n != 99375),
                *((n, 1, 11, 2) for n in (
                    1 << 20, 1 << 19, 1 << 18, 131072, 122880, 120000,
                    400000, 245520, 66000, 65792, 16370, 65498, 1048574,
                    70000, 99375, 26500)))


def launch_shape(module, n: int) -> tuple:
    """What ``module`` (an ``acq_kernel``) launches at ``n``: the entry's
    source and its plan (radix entries), split and sub-plans (two-step)
    or lengths and sub-plans (Bluestein); equal shapes launch the same
    arithmetic."""
    kernel, shape = module.kernel_for(n)
    if kernel is module.BLUESTEIN_KERNEL:
        return (kernel.source, *shape, module.sub_plan(shape[1]),
                module.sub_plan(shape[2]))
    if kernel is module.TWOSTEP_KERNEL:
        return (kernel.source, *shape)
    return (kernel.source, module.radix_plan(n), module.cluster_size(n))


def parent_module(parent: str):
    """The parent tree's ``sydr_tpu_torch/ops/acq_kernel.py`` as a module of
    its own (its launch arguments; the kernels it names are this tree's,
    not launched)."""
    import importlib.util
    from pathlib import Path

    path = Path(parent) / "sydr_tpu_torch" / "ops" / "acq_kernel.py"
    spec = importlib.util.spec_from_file_location("parent_acq_kernel", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def k2_against_parent(parent: str, device, cases=PARENT_CASES) -> None:
    """The K2 entries of another tree (``parent``, a checkout) against this
    tree's on the same inputs at ``cases`` ((n, channels, bins, blocks)),
    on the entry that ``kernel_for`` gives: where both trees launch the
    same shape (:func:`launch_shape`), the maps bit for bit at this tree's
    arguments; where the entry, its split, lengths or sub-plans differ
    (the parent's radix-4 plans), each tree at its own arguments (its
    wrapper's), each map within 1e-4 of the plain version's maximum; the
    device times in turns parent, this, this, parent."""
    from pathlib import Path

    import torch

    from sydr_tpu_torch.ops import acq_kernel, native

    old = parent_module(parent)
    theirs = {kern.source: native.CudaKernel(
        kern.source, kern.symbol, kern.argtypes,
        csrc_dir=Path(parent) / "sydr_tpu_torch" / "csrc")
        for kern in (old.KERNEL, old.CLUSTER_KERNEL, old.TWOSTEP_KERNEL,
                     old.BLUESTEIN_KERNEL)}
    native.build_all(list(theirs.values()))
    for kern in theirs.values():
        usage = [ln.strip() for ln in kern.build_log.splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"parent's {kern.source} built in "
              f"{kern.build_seconds or 0:.2f} s:\n   " + "\n   ".join(usage),
              flush=True)
    for n, n_ch, n_bins, nc in cases:
        spec, code, bins = k2_inputs(n, n_ch, device, n_bins, nc)
        kernel, out, cargs = acq_kernel.pcps_bins_launch_args(spec, code,
                                                              bins)
        old_kernel = old.kernel_for(n)[0]
        moved = old_kernel.source != kernel.source
        shapes = {"parent": launch_shape(old, n),
                  "this": launch_shape(acq_kernel, n)}
        changed = shapes["parent"] != shapes["this"]
        if changed:
            _, old_out, old_args = old.pcps_bins_launch_args(spec, code,
                                                             bins)
        else:
            old_out, old_args = out, cargs
        fns = {"parent": (theirs[old_kernel.source].function(), old_args,
                          old_out),
               "this": (kernel.function(), cargs, out)}
        ref = acq_kernel.pcps_bins_ref(spec, code, bins)
        bound = chip_smoke.K2_RTOL * float(ref.abs().max())
        maps = {}
        for name in ("this", "parent", "this", "parent"):
            fn, args, dst = fns[name]
            chip_smoke.check(fn(*args) == 0, f"{name} launch failed")
            torch.cuda.synchronize()
            if name in maps:
                chip_smoke.check(torch.equal(maps[name], dst),
                                 f"{name}: the entry is not deterministic")
            maps[name] = dst.clone()
        errs = {name: float((m - ref).abs().max()) / float(ref.abs().max())
                for name, m in maps.items()}
        same = torch.equal(maps["parent"], maps["this"])
        ms = {name: [] for name in fns}
        fn, args, _ = fns["parent"]
        clock = timer(lambda: fn(*args), 10)
        for name in ("parent", "this", "this", "parent"):
            fn, args, _ = fns[name]
            ms[name].append(clock(lambda fn=fn, args=args: fn(*args)))
        mean = {name: sum(t) / 2 for name, t in ms.items()}
        splits = {name: kernel_split(lambda fn=fn, args=args: fn(*args))
                  for name, (fn, args, _) in fns.items()}
        plans = (f"; parent {shapes['parent'][1:]}, this "
                 f"{shapes['this'][1:]}" if changed else
                 f"; both {shapes['this'][1:]}")
        print(f"K2 {kernel.source} n={n}"
              + (f" (parent: {old_kernel.source})" if moved else "")
              + f", {n_ch} ch x {n_bins} bins x {nc} blocks{plans}: maps "
              f"{'bit-identical' if same else 'differ'} (of the maximum: "
              f"parent {errs['parent']:.2e}, this {errs['this']:.2e}); "
              f"device ms parent {ms['parent'][0]:.4f} / "
              f"{ms['parent'][1]:.4f}, this {ms['this'][0]:.4f} / "
              f"{ms['this'][1]:.4f} (parent / this "
              f"{mean['parent'] / mean['this']:.3f}); kernels a call: "
              + "; ".join(f"{name} " + ", ".join(
                  f"{k} {v:.4f}" for k, v in split.items())
                  for name, split in splits.items()), flush=True)
        if changed:
            chip_smoke.check(max(errs.values()) * float(ref.abs().max())
                             <= bound, f"n={n}: a map above the bound")
        else:
            chip_smoke.check(same, f"n={n}: the maps differ from the "
                                   f"parent's")


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


# Pass C's epoch loop with parts taken out: (label, [(text, replacement)]).
_PHASE_B = ("for (int e = 0; e < m; ++e) {\n      Disc de = d;",
            "for (int e = 0; e < 0; ++e) {\n      Disc de = d;")
_PHASE_D = ("for (int e = 0; e < m; ++e) {\n      const float ipc_e",
            "for (int e = 0; e < 0; ++e) {\n      const float ipc_e")
PASS_C_CUTS = (
    ("no phase B", [_PHASE_B]),
    ("no phase D", [_PHASE_D]),
    ("no phase B or D", [_PHASE_B, _PHASE_D]),
    ("no histogram reductions", [("      if (!had_sync) {\n",
                                  "      if (false) {\n")]),
    ("no discriminate", [(
        "  const Disc d = discriminate(k, kProf, corr, ip_prev, qp_prev);",
        "  Disc d = {};\n  d.ip = ip;\n  d.qp = qp;")]),
    ("no sinf or cosf", [("  const float cth = cosf(theta), sth = sinf(theta);",
                          "  const float cth = theta, sth = theta;")]),
    ("no output stores", [("  if (w >= live || e >= m) return;",
                           "  if (w >= 0) return;")]),
)


def pass_c_variants(device) -> None:
    """``--pass-c`` (module note)."""
    from sydr_tpu_torch.ops import loop_kernel as lk
    from sydr_tpu_torch.ops import native

    kerns = {"source": lk.PASS_C_KERNEL}
    for k, (label, swaps) in enumerate(PASS_C_CUTS):
        kerns[label] = source_variant(lk.PASS_C_KERNEL, f"pass_c_cut{k}",
                                      {}, swaps)
    native.build_all(list(kerns.values()))
    mod = chip_smoke.pass_c_module()
    cases = [(name, chip_smoke.pass_c_inputs(bm, extra, device))
             for name, bm, extra, _ in chip_smoke.PASS_C_CASES]
    cases.append(("64 epochs, narrow-only kaplan", mod.shaped_block(
        64, 32, "pass-a", mod.NARROW, device)))
    for name, (cfg, st, geo, corr) in cases:
        _, args = lk.pass_c_launch_args(cfg, st, geo, corr)
        stream = native.stream_of(corr)
        times = {label: [] for label in kerns}
        for turn in range(2):
            for label in (kerns if turn == 0 else reversed(list(kerns))):
                fn = kerns[label].function()
                times[label].append(chip_smoke.device_ms(
                    lambda: fn(*args, stream), 200))
        print(f"pass C {name}: device ms in two turns: " + "; ".join(
            f"{label} " + " / ".join(f"{ms:.5f}" for ms in v)
            for label, v in times.items()), flush=True)


# The scan kernel's variants: (label, lines, [(text, its replacement)]),
# applied as source_variant applies them.
_DISCRIMINATE = ("    const Disc d = discriminate(k, kProf, corr, cr.ip_prev, "
                 "cr.qp_prev);\n")
SCAN_VARIANTS = (
    ("C = 1", {"constexpr int kCluster = ": 1}, []),
    ("C = 2", {"constexpr int kCluster = ": 2}, []),
    ("512 threads", {}, [("constexpr int kThreads = 256;   ",
                          "constexpr int kThreads = 512;   ")]),
    ("384 threads", {}, [("constexpr int kThreads = 256;   ",
                          "constexpr int kThreads = 384;   ")]),
    ("128 threads", {}, [("constexpr int kThreads = 256;   ",
                          "constexpr int kThreads = 128;   ")]),
    ("the phase polled by test_wait", {}, [(
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, ",
        "mbarrier.test_wait.parity.acquire.cluster.shared::cta.b64 p, ")]),
    ("the phase's acquire at CTA scope", {}, [(
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64",
        "mbarrier.try_wait.parity.acquire.cta.shared::cta.b64")]),
    ("no bookkeeping", {}, [
        ("    if (!writer || lane != 0) continue;\n    // The epoch's record",
         "    continue;\n    // The epoch's record"),
        ("    if (rank == 0) {\n      bookkeeping_warp(",
         "    if (rank == 0 && n_ch < 0) {\n      bookkeeping_warp(")]),
    ("first sample loaded after the geometry", {}, [
        ("    if (e == 0) first_sample(p, sc, g.read_ptr, first, n_window, "
         "xr, xi);",
         "    first_sample(p, sc, g.read_ptr, first, n_window, xr, xi);"),
        ("    first_sample(p, sc, g.next_read_ptr, first, n_window, xr, "
         "xi);\n", "")]),
    ("two CTAs an SM", {}, [("__global__ void __launch_bounds__(kBlock, 1)",
                             "__global__ void __launch_bounds__(kBlock, 2)")]),
    ("at most two CTAs an SM", {}, [(
        "  cfg.dynamicSmemBytes = 0;",
        "  cfg.dynamicSmemBytes = 80 << 10;\n"
        "  cudaFuncSetAttribute(kernel, "
        "cudaFuncAttributeMaxDynamicSharedMemorySize, 80 << 10);")]),
    ("at most one CTA an SM", {}, [(
        "  cfg.dynamicSmemBytes = 0;",
        "  cfg.dynamicSmemBytes = 150 << 10;\n"
        "  cudaFuncSetAttribute(kernel, "
        "cudaFuncAttributeMaxDynamicSharedMemorySize, 150 << 10);")]),
    ("no correlation", {}, [(
        "  g.n_valid = min(max(q.required, 0), sc.window_size);",
        "  g.n_valid = 0;")]),
    ("no tree", {}, [("      if (off < span) {", "      if (off < 0) {")]),
    ("no discriminate", {}, [(
        _DISCRIMINATE,
        "    Disc d = {};\n    d.ie = corr[0];\n    d.qe = corr[1];\n"
        "    d.ip = corr[2];\n    d.qp = corr[3];\n    d.il = corr[4];\n"
        "    d.ql = corr[5];\n    d.dll = sub(corr[0], corr[4]);\n"
        "    d.dll_w = d.dll;\n    d.costas = mul(corr[3], 1e-9f);\n")]),
    ("no loop update", {}, [(
        _DISCRIMINATE + "    const LoopOut lu = filter_step(k, kProf, "
        "kOrder, d, li, active);",
        "    LoopOut lu = {};\n    lu.i_prompt = corr[2];")]),
)
# The cluster sizes --scan compares: the source's (SCAN_CLUSTER) and the
# variants'.
SCAN_CLUSTERS = ("source", "C = 1", "C = 2")
# The variants that change no arithmetic: their outputs and state must be
# the source's bit for bit.
SCAN_SAME_BITS = ("two CTAs an SM", "at most two CTAs an SM",
                  "at most one CTA an SM", "the phase polled by test_wait",
                  "the phase's acquire at CTA scope",
                  "first sample loaded after the geometry")
# (epochs, channels) of the scan kernel's shapes.
SCAN_SHAPES = ((1, 32), (5, 32), (20, 32), (40, 32), (20, 1))
# Rates of the cluster sweep beside chip_smoke.SCAN_CASES' (borre): the
# measurements behind scan_kernel.SCAN_CLUSTER.
SCAN_SWEEP_FS = (0.5e6, 1.023e6, 2.046e6, 4e6, 5e6)
# Launches of the protocol check a case (SCAN_CHECK_KERNEL) by --scan.
SCAN_CHECK_LAUNCHES = 500


def scan_times(kerns, cfg, inputs, device, reps=20) -> dict:
    """Device ms of each of ``kerns`` ({label: kernel}) on ``inputs``
    (codes, state, window planes), in two turns (forwards, then
    backwards): {label: [ms, ms]}."""
    from sydr_tpu_torch.ops import native
    from sydr_tpu_torch.ops import scan_kernel as sk

    _, args = sk.scan_launch_args(cfg, *inputs)
    stream = native.stream_of(inputs[2])
    runs = {label: (lambda fn=kern.function(): fn(*args, stream))
            for label, kern in kerns.items()}
    times = {key: [] for key in runs}
    for turn in range(2):
        for key in (runs if turn == 0 else reversed(list(runs))):
            times[key].append(chip_smoke.device_ms(runs[key], reps))
    return times


def results_equal(a, b) -> bool:
    """Whether two ``(state, outputs)`` results are equal bit for bit."""
    import torch

    from sydr_tpu_torch.channels.state import FIELDS

    (sa, oa), (sb, ob) = a, b
    pairs = [(oa[k], ob[k]) for k in oa] + [
        (getattr(sa, f), getattr(sb, f)) for f in FIELDS]
    return list(oa) == list(ob) and all(
        torch.equal(x.view(torch.int8), y.view(torch.int8))
        for x, y in pairs)


def scan_bits_equal(kern_a, kern_b, cfg, inputs) -> bool:
    """Whether two builds of the scan kernel give the same outputs and
    state, bit for bit, on ``inputs``."""
    import torch

    from sydr_tpu_torch.ops import native
    from sydr_tpu_torch.ops import scan_kernel as sk
    from sydr_tpu_torch.ops.loop_kernel import unpack

    stream = native.stream_of(inputs[2])
    outs = []
    for kern in (kern_a, kern_b):
        bufs, args = sk.scan_launch_args(cfg, *inputs)
        chip_smoke.check(kern.function()(*args, stream) == 0,
                         "a scan launch failed")
        outs.append(bufs)
    torch.cuda.synchronize()
    return results_equal(unpack(outs[0]), unpack(outs[1]))


def scan_protocol(name, cfg, inputs, launches) -> None:
    """``launches`` launches of the scan kernel's protocol check on
    ``inputs``: each the production kernel's results bit for bit, and no
    fault of any kind."""
    from sydr_tpu_torch.ops import scan_kernel as sk

    ref = sk.scan_block(cfg, *inputs)
    faults = dict.fromkeys(sk.PROTOCOL_FAULTS, 0)
    same = 0
    for _ in range(launches):
        got, counts = sk.check_protocol(cfg, *inputs)
        same += results_equal(got, ref)
        for kind, n in counts.items():
            faults[kind] += n
    print(f"scan {name}: protocol check, {launches} launches of "
          f"{inputs[0].shape[0]} channels: faults {faults}; bit for bit "
          f"with the production kernel: {same} of {launches}", flush=True)
    chip_smoke.check(not any(faults.values()) and same == launches,
                     f"scan {name}: the protocol check failed: {faults}, "
                     f"{launches - same} launches differ")


def scan_variants(device) -> None:
    """``--scan`` (module note)."""
    import dataclasses

    from sydr_tpu_torch.ops import native
    from sydr_tpu_torch.ops import scan_kernel as sk

    kerns = {"source": sk.SCAN_KERNEL}
    for k, (label, lines, swaps) in enumerate(SCAN_VARIANTS):
        kerns[label] = source_variant(sk.SCAN_KERNEL, f"scan_cut{k}", lines,
                                      swaps)
    native.build_all([*kerns.values(), sk.SCAN_CHECK_KERNEL])
    for label, kern in [*kerns.items(), ("check", sk.SCAN_CHECK_KERNEL)]:
        usage = [ln.strip() for ln in kern.build_log.splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"scan {label}: built in {kern.build_seconds or 0:.2f} s; "
              f"{usage or 'cached'}", flush=True)
    clusters = {label: kerns[label] for label in SCAN_CLUSTERS}

    def show(title, times):
        print(f"scan {title}: device ms in two turns: " + "; ".join(
            f"{label} " + " / ".join(f"{ms:.5f}" for ms in v)
            for label, v in times.items()), flush=True)

    mod = chip_smoke.scan_module()
    cases = list(chip_smoke.SCAN_CASES) + [
        (f"sweep {fs / 1e6:g} Msps, borre",
         dict(sampling_frequency=fs, profile="borre"))
        for fs in SCAN_SWEEP_FS]
    for name, extra in cases:
        base = mod.scan_config(**extra)
        sweep = name.startswith("sweep")
        active = {label: sk.max_active_clusters(base, kern)
                  for label, kern in (clusters if sweep else kerns).items()}
        print(f"scan {name}: active clusters a wave "
              f"(cudaOccupancyMaxActiveClusters; source C = "
              f"{sk.SCAN_CLUSTER}): {active}", flush=True)
        inputs = mod.scan_block_tensors(base, 32, chip_smoke.SEED % 1000,
                                        device)
        show(f"{name}, 20 epochs x 32 ch, each C",
             scan_times(clusters, base, inputs, device))
        if sweep:
            continue
        show(f"{name}, 20 epochs x 32 ch, variants",
             scan_times(kerns, base, inputs, device))
        show(f"{name}, 20 epochs x 1 ch, variants",
             scan_times(kerns, base, mod.scan_block_tensors(
                 base, 1, chip_smoke.SEED % 1000, device), device))
        same = {label: scan_bits_equal(sk.SCAN_KERNEL, kerns[label], base,
                                       inputs)
                for label in SCAN_SAME_BITS}
        print(f"scan {name}: bit for bit with the source: {same}",
              flush=True)
        chip_smoke.check(all(same.values()), f"scan {name}: a variant that "
                         f"changes no arithmetic changed the bits: {same}")
        scan_protocol(name, base, inputs, SCAN_CHECK_LAUNCHES)
        for epochs, n_ch in SCAN_SHAPES:
            cfg = dataclasses.replace(base, block_ms=epochs)
            show(f"{name}, {epochs} epochs x {n_ch} ch",
                 scan_times(clusters, cfg, mod.scan_block_tensors(
                     cfg, n_ch, chip_smoke.SEED % 1000, device), device))


# Cuts of the scan kernel's first form (a CTA of 512 threads a channel,
# one thread for the loops and the bookkeeping), applied by --scan
# --parent to a checkout of that form: what its lone thread's time an
# epoch outside the loop update splits into. (label, [(text, its
# replacement)]).
PARENT_SCAN_CUTS = (
    ("no output stores", [
        ("      // The epoch's outputs, row e of each [block_ms, n_ch] "
         "output.\n",
         "      if (e >= n_epochs) {\n"),
        ("      ob[kOutBitReady * plane] = bit_complete;\n",
         "      ob[kOutBitReady * plane] = bit_complete;\n      }\n")]),
    ("no bit sync or C/N0", [
        ("      if (counting && sydr::sign(cr.ip_prev) != "
         "sydr::sign(lu.i_prompt)) {\n        hist[ms] += 1;\n      }\n",
         ""),
        ("      const bool declare = !had_sync && bit_sync_declare(k, hist, "
         "argmax);",
         "      const bool declare = false;"),
        ("      const float cn0 = bit_complete\n"
         "                            ? cn0_estimate(k, cr.ip_sum, cr.qp_sum, "
         "cr.ip_sq,\n"
         "                                           cr.qp_sq, cr.ratio_sum, "
         "cr.cn0)\n"
         "                            : cr.cn0;",
         "      const float cn0 = cr.cn0;")]),
    ("no serial warp sum", [
        ("        for (int r = 1; r < kWarps; ++r) v = add(v, red[r][s]);\n",
         "")]),
    ("phase advance in float", [
        ("      const float whole = __double2float_rn(__dadd_rn(\n"
         "          __dmul_rn(static_cast<double>(static_cast<float>(\n"
         "                        st.required - sc.samples_per_ms)),\n"
         "                    sc.code_ratio),\n"
         "          static_cast<double>(cr.rem_code)));\n"
         "      const float rem_code = __double2float_rn(__dadd_rn(\n"
         "          __dmul_rn(static_cast<double>(req_f),\n"
         "                    static_cast<double>(mul(st.delta, "
         "sc.rcp_fs))),\n"
         "          static_cast<double>(whole)));\n",
         "      const float whole = add(mul(static_cast<float>(\n"
         "          st.required - sc.samples_per_ms),\n"
         "          static_cast<float>(sc.code_ratio)), cr.rem_code);\n"
         "      const float rem_code = add(mul(req_f, mul(st.delta, "
         "sc.rcp_fs)),\n"
         "                                 whole);\n")]),
    ("no correlation", [(
        "  g.n_valid = min(max(q.required, 0), sc.window_size);",
        "  g.n_valid = 0;")]),
    ("no loop update", [(
        "      const Disc d = discriminate(k, kProf, corr, cr.ip_prev, "
        "cr.qp_prev);\n"
        "      const LoopOut lu = filter_step(k, kProf, kOrder, d, in, "
        "active);",
        "      LoopOut lu = {};\n      lu.i_prompt = corr[2];")]),
)
PARENT_SCAN_CUTS = PARENT_SCAN_CUTS + (
    ("no bookkeeping (the first four cuts)",
     [pair for _, pairs in PARENT_SCAN_CUTS[:4] for pair in pairs]),)


def parent_module(parent: str, name: str, kernel: str):
    """The parent tree's ``sydr_tpu_torch/ops/<name>.py`` as a module of
    its own whose kernel ``kernel`` (a module attribute) is built from the
    parent's ``csrc``, with the module's own ctypes structures and launch
    arguments: its host path, for the wrapper's call time and its
    launch."""
    import importlib.util
    from pathlib import Path

    from sydr_tpu_torch.ops import native

    path = Path(parent) / "sydr_tpu_torch" / "ops" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"parent_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    kern = getattr(module, kernel)
    setattr(module, kernel, native.CudaKernel(
        kern.source, kern.symbol, kern.argtypes,
        csrc_dir=Path(parent, "sydr_tpu_torch", "csrc")))
    return module


def scan_against_parent(parent: str, device) -> None:
    """``--scan --parent DIR`` (module note)."""
    from pathlib import Path

    import torch

    from sydr_tpu_torch.ops import native
    from sydr_tpu_torch.ops import scan_kernel as sk

    theirs = native.CudaKernel(
        "scan_block.cu", "scan_block_launch", sk.SCAN_KERNEL.argtypes,
        csrc_dir=Path(parent, "sydr_tpu_torch", "csrc"))
    wrapper = parent_module(parent, "scan_kernel", "SCAN_KERNEL")
    cuts = {"parent": theirs}
    for k, (label, swaps) in enumerate(PARENT_SCAN_CUTS):
        cuts[label] = source_variant(theirs, f"parent_scan_cut{k}", {},
                                     swaps)
    native.build_all([*cuts.values(), sk.SCAN_KERNEL])
    for label, kern in [*cuts.items(), ("this", sk.SCAN_KERNEL)]:
        usage = [ln.strip() for ln in kern.build_log.splitlines()
                 if "registers" in ln]
        print(f"scan {label}: built in {kern.build_seconds or 0:.2f} s; "
              f"{usage[:1] or 'cached'}", flush=True)
    mod = chip_smoke.scan_module()
    for name, extra in chip_smoke.SCAN_CASES:
        cfg, codes, st, wre, wim = chip_smoke.scan_inputs(extra, device)
        stream = native.stream_of(wre)
        _, args = sk.scan_launch_args(cfg, codes, st, wre, wim)
        pargs = args
        times = {label: [] for label in cuts}
        for turn in range(2):
            for label in (cuts if turn == 0 else reversed(list(cuts))):
                fn = cuts[label].function()
                times[label].append(chip_smoke.device_ms(
                    lambda: fn(*pargs, stream), 20))
        print(f"scan {name}: the parent's cuts, device ms in two turns: "
              + "; ".join(f"{label} " + " / ".join(f"{ms:.5f}" for ms in v)
                          for label, v in times.items()), flush=True)
        runs = {}
        results = {}
        for label, kern, a in (("parent", theirs, pargs),
                               ("this", sk.SCAN_KERNEL, args)):
            outs = []
            for _ in range(2):
                bufs, fresh = sk.scan_launch_args(cfg, codes, st, wre, wim)
                chip_smoke.check(kern.function()(*fresh, stream) == 0,
                                 f"scan {name}: the {label} launch failed")
                outs.append(bufs)
            runs[label] = (lambda fn=kern.function(), a=a:
                           fn(*a, stream))
            results[label] = outs
        torch.cuda.synchronize()
        repeat = {label: all(torch.equal(o[0][k].view(torch.int8),
                                         o[1][k].view(torch.int8))
                             for k in o[0])
                  for label, o in results.items()}
        peak = max(float(wre.abs().max()), float(wim.abs().max()))
        from sydr_tpu_torch.ops.loop_kernel import unpack

        faults, errors = mod.bound_faults(unpack(results["this"][0]),
                                          unpack(results["parent"][0]),
                                          peak)
        calls = {"parent": lambda: wrapper.scan_block(cfg, codes, st, wre,
                                                      wim),
                 "this": lambda: sk.scan_block(cfg, codes, st, wre, wim)}
        times = {"parent": [], "this": []}
        call = {"parent": [], "this": []}
        for label in ("parent", "this", "this", "parent"):
            times[label].append(chip_smoke.device_ms(runs[label], 20))
            call[label].append(chip_smoke.cuda_ms(calls[label], 20))
        print(f"scan {name}: parent -> this, in turns (parent, this, this, "
              f"parent): device ms parent "
              + " / ".join(f"{ms:.5f}" for ms in times["parent"])
              + "; this " + " / ".join(f"{ms:.5f}" for ms in times["this"])
              + "; the wrapper's call ms (chip_smoke's call_ms) parent "
              + " / ".join(f"{ms:.5f}" for ms in call["parent"])
              + "; this " + " / ".join(f"{ms:.5f}" for ms in call["this"])
              + f"; each bit for bit with itself: {repeat}; this within "
              f"the scan runtime's bounds of the parent: {not faults} "
              f"(max abs err "
              f"{ {k: float(f'{v:.2e}') for k, v in errors.items()} })",
              flush=True)
        chip_smoke.check(all(repeat.values()),
                         f"scan {name}: a tree's second launch differs")
        chip_smoke.check(not faults, f"scan {name}: the trees' kernels "
                                     f"differ beyond the bounds: {faults}")


def pass_c_against_parent(parent: str, device) -> None:
    """``--pass-c --parent DIR`` (module note). The parent's kernel is
    launched through the parent's own wrapper module
    (:func:`parent_module`: its constants, pointer structures and launch
    arguments), so any parent's launch signature serves. A parent whose
    pass C does not carry the anchor slew (its ``LoopConsts`` has no
    ``slew_on``) is held to this tree's kernel with the plain slew
    (``runtime._slew_anchor``) applied to its new state."""
    import torch

    from sydr_tpu_torch.channels.runtime import _slew_anchor
    from sydr_tpu_torch.channels.state import FIELDS
    from sydr_tpu_torch.ops import loop_kernel as lk
    from sydr_tpu_torch.ops import native

    wrapper = parent_module(parent, "loop_kernel", "PASS_C_KERNEL")
    theirs = wrapper.PASS_C_KERNEL
    slews = "slew_on" in dict(wrapper.LoopConsts._fields_)
    native.build_all([theirs, lk.PASS_C_KERNEL])
    for name, bm, extra, _ in chip_smoke.PASS_C_CASES:
        cfg, st, geo, corr = chip_smoke.pass_c_inputs(bm, extra, device)
        stream = native.stream_of(corr)
        bufs, args = lk.pass_c_launch_args(cfg, st, geo, corr)
        pbufs, pargs = wrapper.pass_c_launch_args(cfg, st, geo, corr)
        runs = {"parent": lambda: theirs.function()(*pargs, stream),
                "this": lambda: lk.PASS_C_KERNEL.function()(*args, stream)}
        for run in runs.values():
            chip_smoke.check(run() == 0, f"pass C {name}: a launch failed")
        torch.cuda.synchronize()
        (got_st, got), (want_st, want) = lk.unpack(bufs), \
            wrapper.unpack(pbufs)
        if not slews:
            want_st = _slew_anchor(cfg, want_st)
        same = all(torch.equal(got[k].view(torch.int8),
                               want[k].view(torch.int8)) for k in want) \
            and all(torch.equal(getattr(got_st, f).view(torch.int8),
                                getattr(want_st, f).view(torch.int8))
                    for f in FIELDS)
        times = {"parent": [], "this": []}
        for label in ("parent", "this", "this", "parent"):
            times[label].append(chip_smoke.device_ms(runs[label], 200))
        print(f"pass C {name}: parent -> this, device ms in turns "
              f"(parent, this, this, parent): parent "
              + " / ".join(f"{ms:.5f}" for ms in times["parent"])
              + "; this " + " / ".join(f"{ms:.5f}" for ms in times["this"])
              + f"; outputs and state bit-identical: {same}", flush=True)
        chip_smoke.check(same, f"pass C {name}: the trees' kernels differ")


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
                        help="with --k2: the Bluestein entry's convolution "
                             "lengths and its kernels' split at each --n")
    parser.add_argument("--twostep", action="store_true",
                        help="K2's two-step entry: block shapes, chunks, "
                             "and the entry forced below 65,536")
    parser.add_argument("--layouts", action="store_true",
                        help="with --twostep: only the two-step entry's "
                             "splits and sub-plan orders at each --n; with "
                             "--k2 --bluestein: the Bluestein entry's "
                             "sub-plan orders and split at each --n")
    parser.add_argument("--pass-c", action="store_true",
                        help="pass C's kernel with parts of its epoch "
                             "loop cut out")
    parser.add_argument("--scan", action="store_true",
                        help="the scan runtime's kernel at other shapes, "
                             "threads a CTA and with parts cut out")
    parser.add_argument("--parent", metavar="DIR",
                        help="hold the K2 entries (with --pass-c, pass "
                             "C's kernel; with --scan, the scan kernel) "
                             "of the checkout DIR against this tree's")
    opts = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 2
    from sydr_tpu_torch.ops import acq_kernel, native
    from sydr_tpu_torch.ops import correlator_kernel as ck

    print(f"card: {chip_smoke.card_line()}", flush=True)
    device = torch.device("cuda")
    if opts.pass_c and opts.parent:
        pass_c_against_parent(opts.parent, device)
        return 0
    if opts.pass_c:
        pass_c_variants(device)
        return 0
    if opts.scan and opts.parent:
        scan_against_parent(opts.parent, device)
        return 0
    if opts.scan:
        scan_variants(device)
        return 0
    built = [acq_kernel.KERNEL, acq_kernel.CLUSTER_KERNEL,
             acq_kernel.TWOSTEP_KERNEL, acq_kernel.BLUESTEIN_KERNEL,
             ck.CUMSUM_KERNEL, ck.STORE_CEILING]
    native.build_all(built)
    for kern in built:
        usage = [ln.strip() for ln in kern.build_log.splitlines()
                 if "registers" in ln or "spill" in ln
                 or "Compiling entry" in ln]
        print(f"built {kern.source} in {kern.build_seconds or 0:.2f} s:\n   "
              + "\n   ".join(usage), flush=True)
    both = not (opts.k2 or opts.k3 or opts.parent or opts.twostep)
    if opts.twostep and opts.layouts:
        k2_twostep_layouts(opts.n or [99375], opts.channels, device)
    elif opts.twostep:
        k2_twostep(opts.n or [70000, 245520], opts.channels, device)
    if opts.k2 and opts.bluestein and opts.layouts:
        k2_bluestein_layouts(opts.n or BLUESTEIN_N, opts.channels, device)
    elif opts.k2 and opts.bluestein:
        k2_bluestein(opts.n or BLUESTEIN_N, opts.channels, device)
    elif opts.k2 or both:
        for n in opts.n or [4092]:
            if opts.entries:
                k2_entries(n, opts.channels, device)
            else:
                k2_variants(n, opts.channels, device)
    if opts.parent:
        k2_against_parent(opts.parent, device, PARENT_CASES if opts.n is None
                          else [(n, opts.channels, 101, 10) for n in opts.n])
    if opts.k3 or both:
        k3_variants(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
