"""Monte-Carlo tracking sensitivity: lock retention / slips / BER vs C/N0.

Port of ``tools/track_benchmark.py``, the twin of ``acq_benchmark``: each
trial locks a channel at a comfortable 45 dB-Hz, then drops the signal to
the target C/N0 (phase-continuously, ``IQGenerator.set_cn0``) and measures
over the holding period:

  * **retention** — channel still in TRACKING with code lock at the end
    (no reacquisition reset);
  * **pll_lock** — mean PLL lock indicator (NBD/NBP) over the hold;
  * **cn0_est** — mean estimated C/N0 over the last half of the hold;
  * **slip_cycles** — net carrier-phase slip: integrated tracked Doppler
    minus truth, in cycles over the hold (|.| >= 0.5 means at least one
    half-cycle Costas slip);
  * **ber** — data-bit error rate of the decoded 50 Hz bit stream vs the
    injected pattern (best alignment over offset x polarity).

``--pvt`` runs the receiver-level availability sweep instead: the
6-satellite demo sky with ALL satellites at the target C/N0, counting 1 Hz
fixes produced in the second half of a 20 s run.

On the card the trials run K2 (acquisition) and K1 (pass B) at 4 Msps.

Usage:
  python -m sydr_tpu_torch.tools.track_benchmark            # channel sweep
  python -m sydr_tpu_torch.tools.track_benchmark --profile kaplan
  python -m sydr_tpu_torch.tools.track_benchmark --pvt --cn0 33 30 27
  python -m sydr_tpu_torch.tools.track_benchmark --cpu --out table.md
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np

FS = 4e6
PRN = 7
IF_HZ = 0.0
WARMUP_S = 3.0
HOLD_S = 12.0


def _receiver_for(profile: str, device):
    """Cruise wiring per profile: kaplan pull-in at 5 ms blocks, then
    promotion to the requested 20 ms cruise loops. 'kaplan' is the
    PRODUCTION cruise; 'borre' measures the reference-faithful Costas
    cruise (borre loops cannot pull in off-grid Doppler under batch
    feedback delay, so both profiles pull in with kaplan)."""
    from sydr_tpu_torch.channels.runtime import TrackingConfig
    from sydr_tpu_torch.receiver.receiver import Receiver, ReceiverConfig

    pull_in = TrackingConfig(
        sampling_frequency=FS, block_ms=5, tail_ms=4,
        window_size=4224, runtime="batch", profile="kaplan",
    )
    if profile == "borre":
        cruise = dataclasses.replace(pull_in, profile="borre", block_ms=20)
    else:
        # the production cruise: narrow-only kaplan at 20 ms blocks
        cruise = dataclasses.replace(pull_in, profile="kaplan",
                                     kaplan_narrow_only=True, block_ms=20)
    cfg = ReceiverConfig(
        prns=(PRN,), tracking=pull_in, cruise_tracking=cruise,
        tropo_enabled=False,
    )
    return Receiver(cfg, device=device)


def run_trial(cn0_dbhz: float, profile: str, seed: int,
              device="cuda") -> dict:
    from sydr_tpu_torch.channels.state import FLAG_CODE_LOCK, MODE_TRACKING
    from sydr_tpu_torch.signal.synthetic import IQGenerator

    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, 64)
    true_dop = float(rng.uniform(-3000.0, 3000.0))
    gen = IQGenerator(FS, noise=True, seed=seed)
    gen.add_satellite(PRN, doppler_hz=true_dop,
                      code_phase_chips=float(rng.uniform(0, 1023)),
                      cn0_dbhz=45.0, nav_bits=bits)

    rx = _receiver_for(profile, device)

    # tap the decoded 50 Hz bit stream
    decoded_bits: list[int] = []
    dec = rx.channels[0].decoder
    orig_push = dec.push_bit

    def tap(b):
        decoded_bits.append(int(b))
        return orig_push(b)

    dec.push_bit = tap

    chunk = 100  # ms per process_ms call
    cf_trace: list[np.ndarray] = []   # per-ms carrier freq
    pll_trace: list[np.ndarray] = []
    cn0_trace: list[np.ndarray] = []
    act_trace: list[np.ndarray] = []

    def run_ms(n_ms, collect):
        # keep_outputs captures EVERY processed block (a 100 ms chunk spans
        # five 20 ms cruise blocks); the outputs are host arrays.
        rx.keep_outputs = collect
        rx.block_outputs = []
        for _ in range(n_ms // chunk):
            rx.process_ms(gen.generate_ms(chunk))
            if collect:
                for o in rx.block_outputs:
                    cf_trace.append(np.asarray(o["carrier_freq"][:, 0]))
                    pll_trace.append(np.asarray(o["pll_lock"][:, 0]))
                    cn0_trace.append(np.asarray(o["cn0"][:, 0]))
                    act_trace.append(np.asarray(o["active"][:, 0]))
                rx.block_outputs = []

    run_ms(int(WARMUP_S * 1e3), collect=False)
    # for the cruise profile, hold 45 dB-Hz until promotion (bounded)
    extra = 0
    while (rx.session.cruise_cfg is not None and not rx.session.promoted
           and extra < 5000):
        run_ms(chunk, collect=False)
        extra += chunk
    locked_at_drop = int(rx.session.mode_host[0]) == MODE_TRACKING
    if rx.session.cruise_cfg is not None:
        locked_at_drop = locked_at_drop and rx.session.promoted
    n_bits_warm = len(decoded_bits)
    ch_at_drop = rx.channels[0]   # a reacq reset REPLACES this object
    gen.set_cn0(PRN, cn0_dbhz)
    run_ms(int(HOLD_S * 1e3), collect=True)

    out: dict = {"cn0_dbhz": cn0_dbhz, "profile": profile, "seed": seed,
                 "locked_at_drop": locked_at_drop}
    if not locked_at_drop:
        out["retained"] = False
        return out

    # the tracking state lives on the session's device: one host copy
    flags = int(rx.session.state.flags[0].cpu())
    mode_end = int(rx.session.mode_host[0])
    # a reacquisition reset means the receiver itself declared lock lost
    # (a reset replaces the bookkeeping object, so identity is exact)
    was_reset = rx.channels[0] is not ch_at_drop
    out["retained"] = bool(
        mode_end == MODE_TRACKING and not was_reset
        and (flags & FLAG_CODE_LOCK))

    cf = np.concatenate(cf_trace)
    act = np.concatenate(act_trace).astype(bool)
    pll = np.concatenate(pll_trace)
    cn0e = np.concatenate(cn0_trace)
    out["pll_lock_mean"] = float(np.mean(pll[act])) if act.any() else 0.0
    half = len(cn0e) // 2
    sel = act[half:]
    out["cn0_est_mean"] = (
        float(np.mean(cn0e[half:][sel])) if sel.any() else 0.0)

    # net carrier slip over the hold: each active epoch spans ~1 code
    # period (1 ms); inactive epochs carry no phase. Truth Doppler is
    # constant by construction.
    phase_cycles = np.sum(np.where(act, cf - IF_HZ, 0.0)) * 1e-3
    truth_cycles = true_dop * np.count_nonzero(act) * 1e-3
    out["slip_cycles"] = float(phase_cycles - truth_cycles)

    # BER on the hold-period bit stream vs the injected cycled pattern
    stream = np.asarray(decoded_bits[n_bits_warm:], dtype=np.int8) * 2 - 1
    out["n_bits"] = int(stream.size)
    if stream.size >= 40:
        pat = np.asarray(bits, dtype=np.int8) * 2 - 1
        best = stream.size
        for off in range(len(pat)):
            ref = pat[(off + np.arange(stream.size)) % len(pat)]
            err = int(np.sum(ref != stream))
            best = min(best, err, stream.size - err)
        out["ber"] = best / stream.size
    else:
        out["ber"] = 1.0
    return out


def trial_seed(seed0: int, cn0: float, t: int) -> int:
    """The seed of trial ``t`` at ``cn0``: from the C/N0 VALUE and the
    trial index, so that any documented subset re-runs reproducibly."""
    return seed0 + int(round(cn0 * 100)) + t


def channel_sweep(cn0_list, profiles, trials, seed0,
                  device="cuda") -> list[dict]:
    rows = []
    for profile in profiles:
        for cn0 in cn0_list:
            cell = [run_trial(float(cn0), profile, trial_seed(seed0, cn0, t),
                              device) for t in range(trials)]
            locked = [r for r in cell if r["locked_at_drop"]]
            agg = {
                "profile": profile, "cn0_dbhz": float(cn0),
                "trials": len(locked),
                "retention": (float(np.mean([r["retained"] for r in locked]))
                              if locked else 0.0),
                "pll_lock_mean": float(np.mean(
                    [r.get("pll_lock_mean", 0.0) for r in locked] or [0])),
                "cn0_est_mean": float(np.mean(
                    [r.get("cn0_est_mean", 0.0) for r in locked] or [0])),
                "slip_p50_cycles": float(np.median(
                    [abs(r.get("slip_cycles", 0.0)) for r in locked] or [0])),
                "slipped_frac": (float(np.mean(
                    [abs(r.get("slip_cycles", 0.0)) >= 0.5
                     for r in locked])) if locked else 0.0),
                "ber_mean": float(np.mean(
                    [r.get("ber", 1.0) for r in locked] or [1.0])),
            }
            rows.append(agg)
            print(json.dumps(agg), flush=True)
    return rows


def pvt_sweep(cn0_list, profiles, seed0, device="cuda") -> list[dict]:
    """Receiver-level availability: the 6-satellite demo sky, all at the
    target C/N0."""
    from sydr_tpu_torch.channels.runtime import TrackingConfig
    from sydr_tpu_torch.receiver.receiver import Receiver, ReceiverConfig
    from sydr_tpu_torch.signal.scenario import (
        DEMO_RX_TRUTH, Scenario, demo_ephemerides)

    t0, week = 302400.0, 2190
    rx_truth = np.asarray(DEMO_RX_TRUTH)
    rows = []
    for profile in profiles:
        for cn0 in cn0_list:
            sats = demo_ephemerides(t0, week)
            scn = Scenario(rx_truth, sats, t0, FS, cn0_dbhz=float(cn0),
                           noise=True, seed=seed0 + int(round(cn0 * 100)))
            pull_in = TrackingConfig(
                sampling_frequency=FS, tail_ms=4, window_size=4224,
                runtime="batch", profile="kaplan", block_ms=5,
            )
            cruise = dataclasses.replace(
                pull_in, profile=profile, block_ms=20,
                kaplan_narrow_only=(profile == "kaplan"))
            cfg = ReceiverConfig(
                prns=tuple(e.prn for e in sats),
                tracking=pull_in, cruise_tracking=cruise,
                approx_position=tuple(
                    rx_truth + np.array([3000.0, -2000.0, 1500.0])),
                assisted_ephemerides={e.prn: e for e in sats},
                tropo_enabled=False,
            )
            rx = Receiver(cfg, device=device)
            total_ms, chunk = 20000, 500
            for _ in range(total_ms // chunk):
                rx.process_ms(scn.generate_ms(chunk))
            mid_tow = t0 + total_ms * 5e-4
            late = [f for f in rx.fixes if f.tow >= mid_tow]
            err = None
            if late:
                p = np.stack([f.solution.position for f in late])
                err = float(np.mean(
                    np.linalg.norm(p - rx_truth, axis=1)))
            row = {
                "profile": profile, "cn0_dbhz": float(cn0),
                "fixes_late_10s": len(late),
                "availability": round(len(late) / 10.0, 2),
                "err_mean_m": None if err is None else round(err, 2),
            }
            rows.append(row)
            print(json.dumps(row), flush=True)
    return rows


def render_table(rows, pvt=False) -> str:
    if pvt:
        lines = ["| profile | C/N0 [dB-Hz] | fixes (10 s) | availability |"
                 " mean err [m] |", "|---|---|---|---|---|"]
        for r in rows:
            lines.append(
                f"| {r['profile']} | {r['cn0_dbhz']:.0f} "
                f"| {r['fixes_late_10s']} | {r['availability']:.2f} "
                f"| {r['err_mean_m'] if r['err_mean_m'] is not None else '-'}"
                " |")
        return "\n".join(lines)
    lines = [
        "| profile | C/N0 [dB-Hz] | retention | PLL lock | C/N0 est |"
        " slipped | BER |",
        "|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        lines.append(
            f"| {r['profile']} | {r['cn0_dbhz']:.0f} "
            f"| {r['retention']:.2f} | {r['pll_lock_mean']:.2f} "
            f"| {r['cn0_est_mean']:.1f} | {r['slipped_frac']:.2f} "
            f"| {r['ber_mean']:.3f} |")
    return "\n".join(lines)


def main(argv=None) -> int:
    from sydr_tpu_torch.tools import add_device_args, device_name, device_of

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cn0", type=float, nargs="+",
                   default=[45.0, 40.0, 35.0, 31.0, 28.0, 25.0])
    p.add_argument("--profile", choices=("borre", "kaplan", "both"),
                   default="both")
    p.add_argument("--trials", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--pvt", action="store_true",
                   help="receiver-level availability sweep instead")
    p.add_argument("--out", help="also append the markdown table here")
    add_device_args(p)
    args = p.parse_args(argv)
    device = device_of(args)
    if device is None:
        return 2

    profiles = (("borre", "kaplan") if args.profile == "both"
                else (args.profile,))
    if args.pvt:
        rows = pvt_sweep(args.cn0, profiles, args.seed, device)
    else:
        rows = channel_sweep(args.cn0, profiles, args.trials, args.seed,
                             device)
    table = render_table(rows, pvt=args.pvt)
    print("\n" + table)
    if args.out:
        cmd = "python -m sydr_tpu_torch.tools.track_benchmark " + " ".join(
            a for a in (argv if argv is not None else sys.argv[1:])
            if a != "--out" and a != args.out
            and not a.startswith("--out="))
        mode = "PVT availability" if args.pvt else "channel sensitivity"
        with open(args.out, "a") as fh:
            fh.write(f"\n## {mode} ({device_name(device)})\n\n"
                     f"Exact command: `{cmd}`\n\n" + table + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
