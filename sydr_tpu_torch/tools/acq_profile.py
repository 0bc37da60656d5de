"""A/B the two PCPS maps at the bench's acquisition shape.

Port of ``tools/acq_profile.py``: times the shift-theorem map
(``pcps_shift_map``: per-phase forward FFTs, then the K2 bins kernel on
the card) and the direct map (``pcps_map``: mix, transform and inverse per
Doppler bin, 4 bins at a time) on the same noise capture, 12 channels x
101 bins x n = 10000 (10 Msps, 5 x 10 ms), so that ``shift_plan`` can gate
on measured cost. The JAX tool's bf16 and fused variants exist only for
the TPU's matmul DFT: the shift map here IS the fused kernel's path.

Usage: python -m sydr_tpu_torch.tools.acq_profile [--fs 10e6]
           [--channels 12] [--reps 3] [--cpu]

Prints one JSON line with both rates in grid points per second (Doppler
bins x code phases x channels over the map's time between device fences).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def profile_maps(device, fs=10e6, n_ch=12, reps=3, coherent=5,
                 non_coherent=10) -> dict:
    """Both maps' rates (module docstring), and their largest difference
    relative to the map's maximum."""
    import torch

    from sydr_tpu_torch.ops import acquisition as acq
    from sydr_tpu_torch.tools import device_name, sync

    n = int(round(fs * 1e-3))
    rng = np.random.default_rng(0)
    iq_re, iq_im = (torch.tensor(
        rng.standard_normal((n_ch, coherent * non_coherent * n)).astype(
            np.float32), device=device) for _ in range(2))
    code_k = torch.tensor(
        np.stack([acq.code_fft_conj(i + 1, fs) for i in range(n_ch)]),
        dtype=torch.complex64, device=device)
    bins = acq.doppler_bins(5000, 100)          # 101-bin production grid
    grid_points = n_ch * len(bins) * n
    common = dict(sampling_frequency=fs, coherent=coherent,
                  non_coherent=non_coherent)
    out = {"tool": "acq_profile", "device": device_name(device), "n": n,
           "n_ch": n_ch, "n_bins": len(bins)}

    def timed(fn):
        res = fn()                              # builds, plans, warms
        sync(device)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        sync(device)
        return res, grid_points / ((time.perf_counter() - t0) / reps)

    maps = {}
    plan = acq.shift_plan(bins, fs, n, mode="shift")
    if plan is not None:
        phases, bin_shifts = plan
        maps["shift"], out["shift_pts_per_s"] = timed(
            lambda: acq.pcps_shift_map(iq_re, iq_im, code_k, phases=phases,
                                       bin_shifts=bin_shifts, **common))
        out["n_phases"] = len(phases)
    bins_dev = torch.from_numpy(bins).to(device)
    maps["direct"], out["direct_pts_per_s"] = timed(
        lambda: acq.pcps_map(iq_re, iq_im, code_k, bins_dev,
                             doppler_chunk=4, **common))
    if len(maps) == 2:
        out["max_rel_diff"] = float(
            (maps["shift"] - maps["direct"]).abs().max()
            / maps["direct"].abs().max())
    return out


def main(argv=None) -> int:
    from sydr_tpu_torch.tools import add_device_args, device_of

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--fs", type=float, default=10e6)
    p.add_argument("--channels", type=int, default=12)
    p.add_argument("--reps", type=int, default=3)
    add_device_args(p)
    args = p.parse_args(argv)
    device = device_of(args)
    if device is None:
        return 2
    print(json.dumps(profile_maps(device, args.fs, args.channels,
                                  args.reps)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
