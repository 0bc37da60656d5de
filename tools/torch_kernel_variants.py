#!/usr/bin/env python3
"""Launch shapes of the port's CUDA kernels, timed against each other on
one GPU: the numbers behind the choices in ``sydr_tpu_torch/ops``.

    python3 tools/torch_kernel_variants.py            # K2 and K3
    python3 tools/torch_kernel_variants.py --k2 | --k3

* K2 ``pcps_bins`` at n = 4092 (8 channels x 101 bins x 10 blocks), and
  with ``--n`` at another length with a radix plan: the device time of
  every order of the plan's radices at several block sizes, each held
  against the plain version (1e-4 of the map's maximum), beside the plain
  version and ``torch.fft.ifft`` alone.
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


def k2_variants(n: int, n_ch: int, device) -> None:
    import torch

    from sydr_tpu_torch.ops import acq_kernel

    g = torch.Generator().manual_seed(0)
    spec = torch.randn(10, n_ch, 10, n, dtype=torch.complex64,
                       generator=g).to(device)
    code = torch.randn(n_ch, n, dtype=torch.complex64,
                       generator=g).to(device)
    bins = tuple((b // 10 - 5, b % 10) for b in range(101))
    ref = acq_kernel.pcps_bins_ref(spec, code, bins)
    bound = chip_smoke.K2_RTOL * float(ref.abs().max())
    plain = chip_smoke.cuda_ms(
        lambda: acq_kernel.pcps_bins_ref(spec, code, bins), 5)
    library = chip_smoke.ifft_library_ms(spec, code, bins)
    print(f"K2 n={n}, {n_ch} ch x {len(bins)} bins: plain {plain:.4f} ms, "
          f"library {library:.4f} ms, default plan "
          f"{acq_kernel.radix_plan(n)} x {acq_kernel.fft_threads(n)} "
          f"threads", flush=True)
    base = acq_kernel.radix_plan(n)
    plans = sorted(set(itertools.permutations(base)))
    if len(plans) > 24:   # the default and its rotations
        plans = [base[i:] + base[:i] for i in range(len(base))]
    prime = max(base) > 10
    sizes = (128, 192, 256, 384, 512) if prime else (128, 256, 512, 1024)
    fn = acq_kernel.KERNEL.function()
    rows = []
    for plan, threads in itertools.product(plans, sizes):
        limit = 32 // plan[-1] if prime else 21 // plan[-1]
        if n // plan[-1] > limit * threads:
            continue
        acq_kernel.radix_plan = lambda _n, plan=plan: plan
        acq_kernel.fft_threads = lambda _n, _p=None, t=threads: t
        acq_kernel.has_radix_plan = lambda _n: True
        _, out, cargs = acq_kernel.pcps_bins_launch_args(spec, code, bins)
        chip_smoke.check(fn(*cargs) == 0, f"launch failed: {plan} {threads}")
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        chip_smoke.check(err <= bound, f"{plan} x {threads}: error {err}")
        ms = chip_smoke.device_ms(lambda: fn(*cargs), 10)
        rows.append((ms, plan, threads, err))
        print(f"   plan {plan} x {threads} threads: {ms:.4f} ms "
              f"(max_abs_err {err:.3e}, bound {bound:.3e})", flush=True)
    for ms, plan, threads, _ in sorted(rows)[:5]:
        print(f"K2 n={n} best: {ms:.4f} ms plan {plan} x {threads}",
              flush=True)


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
    parser.add_argument("--n", type=int, default=4092)
    parser.add_argument("--channels", type=int, default=8)
    opts = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 2
    from sydr_tpu_torch.ops import acq_kernel, native
    from sydr_tpu_torch.ops import correlator_kernel as ck

    print(f"card: {chip_smoke.card_line()}", flush=True)
    device = torch.device("cuda")
    built = [acq_kernel.KERNEL, ck.CUMSUM_KERNEL, ck.STORE_CEILING]
    native.build_all(built)
    for kern in built:
        usage = [ln.strip() for ln in kern.build_log.splitlines()
                 if "registers" in ln or "spill" in ln
                 or "Compiling entry" in ln]
        print(f"built {kern.source} in {kern.build_seconds or 0:.2f} s:\n   "
              + "\n   ".join(usage), flush=True)
    both = not (opts.k2 or opts.k3)
    if opts.k2 or both:
        k2_variants(opts.n, opts.channels, device)
    if opts.k3 or both:
        k3_variants(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
