"""Command-line entry point: run the receiver on a file or a scenario.

Covers the reference ``main.py`` (config -> receiver -> run -> report) with a
proper CLI the reference lacks (its config path is hard-coded,
``main.py:16``)::

    python -m sydr_tpu_torch --config config/receiver.yaml
    python -m sydr_tpu_torch --config my_reference_style.ini --ms 10000
    python -m sydr_tpu_torch --demo          # synthetic 6-satellite scenario
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time


def _build_demo(args):
    """Synthetic truth scenario (no dataset required)."""
    import numpy as np

    from sydr_tpu_torch.channels.runtime import TrackingConfig
    from sydr_tpu_torch.config import RunConfig
    from sydr_tpu_torch.receiver.receiver import ReceiverConfig
    from sydr_tpu_torch.signal.scenario import (
        DEMO_RX_TRUTH, Scenario, demo_ephemerides)

    rx_truth = np.array(DEMO_RX_TRUTH)
    t0, week, fs = 302400.0, 2190, float(args.fs)
    sats = demo_ephemerides(t0, week)
    scenario = Scenario(rx_truth, sats, t0, fs, cn0_dbhz=47.0, seed=3)
    dec = max(1, int(args.decimate))
    fs_trk = fs / dec
    pull_in = TrackingConfig(
        sampling_frequency=fs_trk,
        input_decimate=dec,
        window_size=round(fs_trk * 1e-3) + 256,
        runtime=args.runtime,
        use_pallas=args.pallas,
        # Acquisition leaves up to 50 Hz Doppler error; the batched
        # runtime's per-block feedback cannot pull that in with the
        # Costas-only Borre loops, so batch mode runs the Kaplan
        # FLL-assisted profile at short blocks (stability rule:
        # loop_bandwidth * block_length < ~0.15).
        profile="kaplan" if args.runtime == "batch" else "borre",
        block_ms=5 if args.runtime == "batch" else 20,
        superblock=args.superblock,
        quantize_spacing=args.quantize,
    )
    # Pull-in -> cruise handoff (batch runtime default): once every channel
    # is stable the session promotes itself to the throughput-optimal
    # cruise shape — kaplan loops at 20 ms blocks scanned into long
    # superblock dispatches, the bench.py headline configuration.
    # (Round 5: cruise switched borre -> kaplan. The borre Costas loop
    # under 20 ms delayed block feedback holds metastable alias locks at
    # ~k*25 Hz on ~15% of cold-start code phases — C/N0 -18 dB, PLL lock
    # ~0 — found by tools/track_benchmark.py; the FLL-assisted kaplan
    # loop at the same shape never cycles, at equal kernel cost.)
    # The scan runtime's loops already run at the reference's per-ms
    # cadence: its cruise, when --cruise-superblock asks for one, keeps
    # them and only dispatches more blocks a call.
    import dataclasses as _dc

    cruise = None
    if args.runtime == "batch" and not args.no_cruise:
        cruise = _dc.replace(
            pull_in, profile="kaplan", kaplan_narrow_only=True, block_ms=20,
            superblock=max(1, 50 if args.cruise_superblock is None
                             else int(args.cruise_superblock)))
    elif args.cruise_superblock is not None and not args.no_cruise:
        cruise = _dc.replace(pull_in,
                             superblock=max(1, int(args.cruise_superblock)))
    run_cfg = RunConfig(
        receiver=ReceiverConfig(
            prns=tuple(e.prn for e in sats),
            tracking=pull_in,
            cruise_tracking=cruise,
            approx_position=tuple(rx_truth + 1000.0),
            assisted_ephemerides={e.prn: e for e in sats},
            tropo_enabled=False,
        ),
        name="demo",
        ms_to_process=args.ms or 16000,
        out_folder=args.out,
        reference_position=tuple(rx_truth),
    )
    return run_cfg, scenario


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="sydr_tpu_torch", description="TPU-native GNSS software receiver")
    parser.add_argument("--config", help="receiver config (.ini or .yaml)")
    parser.add_argument("--demo", action="store_true",
                        help="run the synthetic demo scenario")
    parser.add_argument("--ms", type=int, default=None,
                        help="milliseconds of signal to process")
    parser.add_argument("--fs", type=float, default=4e6,
                        help="demo sampling frequency [Hz]")
    parser.add_argument("--out", default=".results", help="output folder")
    parser.add_argument("--log-config", default=None,
                        help="logging.ini in the reference's fileConfig "
                             "format (overrides the built-in layered "
                             "console+file setup)")
    parser.add_argument("--runtime", choices=("scan", "batch"),
                        default="batch")
    parser.add_argument("--pallas", action="store_true",
                        help="use the fused Pallas correlation kernel")
    parser.add_argument("--superblock", type=int, default=1,
                        help="blocks per device dispatch")
    parser.add_argument("--no-cruise", action="store_true",
                        help="stay in the pull-in configuration (no "
                             "promotion to the cruise shape)")
    parser.add_argument("--cruise-superblock", type=int, default=None,
                        help="superblock of the cruise configuration after "
                             "promotion (batch: kaplan/20ms blocks, 50 "
                             "unless given; scan: the pull-in loops, no "
                             "cruise unless given)")
    parser.add_argument("--decimate", type=int, default=1,
                        help="boxcar pre-correlation decimation factor: "
                             "track at fs/D (trades ~0.2-0.5 dB of "
                             "correlation loss for ~D x device throughput)")
    parser.add_argument("--quantize", action="store_true",
                        help="sample-quantised correlator spacings")
    parser.add_argument("--no-dashboard", action="store_true")
    parser.add_argument("--no-report", action="store_true")
    parser.add_argument("--rinex-obs", metavar="PATH", default=None,
                        help="export the run's pseudorange/Doppler "
                             "measurements as a RINEX 3.04 observation "
                             "file (io/rinex_obs.py)")
    parser.add_argument("--checkpoint-every", type=int, default=0,
                        help="save resumable state every N ms (0 = off)")
    parser.add_argument("--cpu", action="store_true",
                        help="force the CPU backend (development machines)")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the tracking state and kernels "
                             "(--cpu means --device cpu)")
    parser.add_argument("-v", "--verbose", action="store_true")
    args = parser.parse_args(argv)

    device = "cpu" if args.cpu else args.device
    if device.startswith("cuda"):
        import torch

        if not torch.cuda.is_available():
            print(f"--device {device}: CUDA is not available (use --cpu "
                  f"to run on the CPU)", file=sys.stderr)
            return 2

    # Layered logging (reference logger.py:22-30 + config/logging.ini):
    # INFO console + DEBUG file in the output folder; --log-config applies
    # a reference-format logging.ini verbatim. The file handler is added
    # here with the CLI --out (config runs may override the folder, but
    # logging must exist before config parsing can be logged).
    from sydr_tpu_torch.utils.logconfig import configure_logging

    configure_logging(
        out_folder=args.out,
        console_level="DEBUG" if args.verbose else "INFO",
        config_path=args.log_config,
    )

    import dataclasses

    import numpy as np

    from sydr_tpu_torch import config as config_mod
    from sydr_tpu_torch.receiver.dashboard import Dashboard
    from sydr_tpu_torch.receiver.receiver import Receiver
    from sydr_tpu_torch.signal.rf import RFConfig, RFFileSource, SyntheticSource

    if args.demo:
        run_cfg, generator = _build_demo(args)
        source = SyntheticSource(generator)
    elif args.config:
        run_cfg = config_mod.load(args.config)
        if args.ms:
            run_cfg.ms_to_process = args.ms
        if run_cfg.rf_filepath is None:
            print("config has no RF file; use --demo for synthetic runs",
                  file=sys.stderr)
            return 2
        source = RFFileSource(RFConfig(
            filepath=run_cfg.rf_filepath,
            # the file is read at the INPUT rate; the session decimates
            sampling_frequency=(
                run_cfg.receiver.tracking.sampling_frequency
                * run_cfg.receiver.tracking.input_decimate),
            intermediate_frequency=(
                run_cfg.receiver.tracking.intermediate_frequency),
            data_size=run_cfg.rf_data_size,
            is_complex=run_cfg.rf_is_complex,
        ))
        # AGNSS (ephemerides + header iono + assisted clock) and
        # MEASUREMENTS toggles.
        run_cfg = config_mod.apply_agnss(run_cfg)
    else:
        parser.print_help()
        return 2

    os.makedirs(run_cfg.out_folder, exist_ok=True)
    db_path = os.path.join(run_cfg.out_folder, f"{run_cfg.name}.db")
    run_cfg.receiver = dataclasses.replace(
        run_cfg.receiver, database_path=db_path)

    receiver = Receiver(run_cfg.receiver, device=device)
    dash = Dashboard(receiver, enabled=not args.no_dashboard,
                     total_ms=run_cfg.ms_to_process)
    block_ms = (run_cfg.receiver.tracking.block_ms
                * run_cfg.receiver.tracking.superblock)
    # Feed ~500 ms per read (whole blocks); long dispatches feed one block.
    chunk_ms = max(block_ms, (500 // block_ms) * block_ms)

    t_start = time.time()
    processed = 0
    try:
        while processed < run_cfg.ms_to_process:
            n = min(chunk_ms, run_cfg.ms_to_process - processed)
            n -= n % block_ms
            if n == 0:
                break
            try:
                re, im = source.read_ms(n)
            except EOFError:
                logging.info("end of RF file")
                break
            receiver.process_ms((re, im))
            processed += n
            if receiver.last_outputs is not None:
                dash.update(receiver.last_outputs)
            if args.checkpoint_every and processed % args.checkpoint_every == 0:
                from sydr_tpu_torch.receiver.checkpoint import save_checkpoint

                save_checkpoint(
                    receiver,
                    os.path.join(run_cfg.out_folder,
                                 f"{run_cfg.name}.ckpt.npz"),
                )
    finally:
        dash.close()
        source.close()

    wall = time.time() - t_start
    rtf = processed * 1e-3 / wall if wall > 0 else 0.0
    print(f"processed {processed} ms of signal in {wall:.1f} s "
          f"(RTF {rtf:.1f})")
    if receiver.fixes:
        fix = receiver.fixes[-1]
        p = fix.solution.position
        print(f"final fix: ECEF ({p[0]:.2f}, {p[1]:.2f}, {p[2]:.2f}) m, "
              f"clock bias {fix.solution.clock_bias_m:.1f} m, "
              f"nsat {fix.n_satellites}")
        if run_cfg.reference_position is not None:
            err = np.linalg.norm(p - np.asarray(run_cfg.reference_position))
            print(f"error vs reference position: {err:.2f} m")
    else:
        print("no position fix produced")

    print(receiver.timers.report())
    if receiver.db is not None:
        receiver.timers.store(receiver.db)
        receiver.db.commit()
        if args.rinex_obs:
            from sydr_tpu_torch.io.rinex_obs import export_from_database

            n = export_from_database(receiver.db, args.rinex_obs)
            print(f"rinex obs: {args.rinex_obs} ({n} epochs)")
        if not args.no_report:
            from sydr_tpu_torch.io.report import generate_report

            path = generate_report(
                receiver.db,
                os.path.join(run_cfg.out_folder,
                             f"report_{run_cfg.name}.html"),
                reference_position=run_cfg.reference_position,
                title=f"sydr_tpu_torch — {run_cfg.name}",
            )
            print(f"report: {path}")
        receiver.db.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
