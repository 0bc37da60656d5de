"""Per-fix forensics for a failed soak: error time series + channel events.

Port of ``tools/soak_debug.py``. Runs the soak's receiver configuration
(:func:`sydr_tpu_torch.tools.soak.soak_config`) but prints every fix (time,
error split, bias) and the channels' status every 10 s, with the
WARNING-level channel events timestamped by the log, so that a bound
violation can be attributed to a channel event (reacquisition re-entry,
smoothing reset) rather than guessed at.

Usage: python -m sydr_tpu_torch.tools.soak_debug --seconds 90 [--cpu]

The last line is one JSON object: the fix count and the steady mean and
max error.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import sys

import numpy as np


def main(argv=None) -> int:
    from sydr_tpu_torch.tools import add_device_args, device_of

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=int, default=90)
    ap.add_argument("--fs", type=float, default=10e6)
    ap.add_argument("--decimate", type=int, default=4)
    ap.add_argument("--pallas", action="store_true")
    ap.add_argument("--superblock", type=int, default=25)
    ap.add_argument("--no-smoothing", action="store_true")
    ap.add_argument("--seed", type=int, default=3)
    add_device_args(ap)
    args = ap.parse_args(argv)
    device = device_of(args)
    if device is None:
        return 2
    logging.basicConfig(
        level=logging.INFO,
        format="%(relativeCreated)8.0fms %(levelname)s %(message)s")

    from sydr_tpu_torch.receiver.receiver import Receiver
    from sydr_tpu_torch.signal.scenario import DEMO_RX_TRUTH
    from sydr_tpu_torch.tools.soak import demo_scenario, soak_config

    rx_truth = np.asarray(DEMO_RX_TRUTH)
    scn = demo_scenario(args.fs, seed=args.seed)
    rcfg = soak_config(args.fs, args.decimate, use_pallas=args.pallas,
                       superblock=args.superblock)
    if args.no_smoothing:
        rcfg = dataclasses.replace(rcfg, smoothing_time_s=0.0)
    receiver = Receiver(rcfg, device=device)

    total_ms = args.seconds * 1000
    done = 0
    n_seen = 0
    while done < total_ms:
        n = min(1000, total_ms - done)
        receiver.process_ms(scn.generate_ms(n))
        done += n
        out = receiver.last_outputs
        if done % 10000 == 0:
            rows = []
            for i, ch in enumerate(receiver.channels):
                cn0 = (float(np.asarray(out["cn0"])[-1, i])
                       if out is not None else None)
                pll = (float(np.asarray(out["pll_lock"])[-1, i])
                       if out is not None else None)
                rows.append({
                    "prn": ch.prn,
                    "cn0": round(cn0, 1) if cn0 else cn0,
                    "pll": round(pll, 2) if pll is not None else None,
                    "n_codes": ch.n_codes,
                    "bits": ch.bits_pushed,
                    "tow": ch.tow_ref is not None,
                    "sf": sorted(ch.subframes_seen),
                })
            print(json.dumps({"ms": done, "channels": rows}), flush=True)
        for f in receiver.fixes[n_seen:]:
            err = f.solution.position - rx_truth
            print(json.dumps({
                "t": round(f.tow, 3), "ms": done,
                "err_m": round(float(np.linalg.norm(err)), 3),
                "err_xyz": [round(float(v), 2) for v in err],
                "bias_m": round(float(f.solution.clock_bias_m), 1),
                "nsat": int(f.n_satellites),
                "prns": list(map(int, f.prns)),
                "resid_rms_m": round(float(np.sqrt(np.mean(
                    np.square(f.solution.residuals)))), 3),
            }), flush=True)
        n_seen = len(receiver.fixes)

    errs = np.array([
        np.linalg.norm(f.solution.position - rx_truth)
        for f in receiver.fixes])
    conv = errs[3:] if len(errs) > 6 else errs
    print(json.dumps({
        "n_fixes": len(errs),
        "mean": round(float(conv.mean()), 3) if len(conv) else None,
        "max": round(float(conv.max()), 3) if len(conv) else None,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
