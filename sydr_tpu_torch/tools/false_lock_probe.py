"""Attribute a stuck channel: tracked code/carrier vs scenario truth.

Port of ``tools/false_lock_probe.py``. Runs the soak configuration
(:func:`sydr_tpu_torch.tools.soak.soak_config`) for a few seconds, then
for every channel computes the stream position of its latest code
boundary (the ``_transmit_time_at`` geometry) and evaluates the TRUTH code
phase of its own satellite at that instant: a healthy lock reads ~0 (mod
1023) chips; a code-offset false lock reads the offset directly; a
cross-PRN lock shows a large offset plus a tracked Doppler matching a
different satellite.

Usage: python -m sydr_tpu_torch.tools.false_lock_probe [--seconds 8] [--cpu]

Prints one JSON line per channel.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def main(argv=None) -> int:
    from sydr_tpu_torch.tools import add_device_args, device_of

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=int, default=8)
    ap.add_argument("--fs", type=float, default=10e6)
    ap.add_argument("--decimate", type=int, default=4)
    ap.add_argument("--seed", type=int, default=3)
    add_device_args(ap)
    args = ap.parse_args(argv)
    device = device_of(args)
    if device is None:
        return 2

    from sydr_tpu_torch.constants import (
        GPS_L1CA_CARRIER_FREQ, GPS_L1CA_CODE_FREQ)
    from sydr_tpu_torch.receiver.receiver import Receiver
    from sydr_tpu_torch.tools.soak import T0, demo_scenario, soak_config

    scn = demo_scenario(args.fs, seed=args.seed)
    fs_trk = args.fs / args.decimate
    receiver = Receiver(soak_config(args.fs, args.decimate), device=device)

    done = 0
    while done < args.seconds * 1000:
        receiver.process_ms(scn.generate_ms(1000))
        done += 1000

    snapshot = receiver._state_snapshot()      # one host copy
    out = receiver.last_outputs
    truth = scn.truth_state(T0 + done * 1e-3)
    tmap = {s["prn"]: s for s in truth}
    total = receiver.session.total_samples
    for i, ch in enumerate(receiver.channels):
        unread = int(snapshot["unread"][i])
        rem_code = float(snapshot["rem_code"][i])
        carrier = float(snapshot["carrier_freq"][i])
        delta = float(snapshot["code_freq_offset"][i]) + carrier * (
            GPS_L1CA_CODE_FREQ / GPS_L1CA_CARRIER_FREQ)
        step = (GPS_L1CA_CODE_FREQ + delta) / fs_trk
        p = (total - unread) - rem_code / step
        t_p = T0 + p / fs_trk
        sat = next(s for s in scn.sats if s.eph.prn == ch.prn)
        code_phase, _ = scn._phase_at(sat, t_p)
        off = float(np.mod(code_phase, 1023.0))
        off = off if off < 511.5 else off - 1023.0
        cn0 = float(np.asarray(out["cn0"])[-1, i]) if out is not None else 0
        print(json.dumps({
            "prn": ch.prn,
            "cn0": round(cn0, 1),
            "tracked_doppler": round(carrier, 1),
            "truth_doppler": round(tmap[ch.prn]["doppler"], 1),
            "code_offset_chips": round(off, 3),
            "nearest_other_doppler": round(min(
                (s["doppler"] for s in truth if s["prn"] != ch.prn),
                key=lambda d: abs(d - carrier)), 1),
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
