"""GPS L1 C/A receiver: tracking session + decoding + measurements + PVT.

The top-level orchestrator, functionally covering the reference's
``Receiver``/``ReceiverGPSL1CA``
(``sydr/receiver/receiver.py:101-144``,
``receiver_gps_l1ca.py:162-381``): it feeds IQ blocks through the device
tracking runtime, decodes navigation bits on the host, forms pseudoranges at
measurement epochs, and solves least-squares PVT fixes.

Measurement formation is sample-accurate *and* sub-sample accurate — unlike
the reference, whose time-since-TOW is quantised to one sample
(``channel_l1ca_borre.py:636-654``), the transmit time here includes the
fractional code-phase remainder, giving cm-level pseudorange resolution:

    t_tx(S) = t_subframe + (n - n_sf) * 1ms + (S - p) * step/1023 * 1ms

where ``n`` counts code boundaries, ``p`` is the (fractional) sample position
of the latest boundary and ``S`` the measurement sample.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np

from sydr_tpu_torch.channels.runtime import TrackingConfig
from sydr_tpu_torch.channels.state import MODE_TRACKING
from sydr_tpu_torch.constants import (
    AVG_TRAVEL_TIME_MS,
    GPS_L1CA_CARRIER_FREQ,
    GPS_L1CA_CODE_FREQ,
    GPS_L1CA_CODE_LENGTH,
    SPEED_OF_LIGHT,
)
from sydr_tpu_torch.decoding.lnav import LnavDecoder
from sydr_tpu_torch.nav.ephemeris import Ephemeris
from sydr_tpu_torch.nav.lse import PvtSolution, solve_pvt
from sydr_tpu_torch.receiver.session import AcquisitionConfig, TrackingSession

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class ReceiverConfig:
    prns: tuple
    tracking: TrackingConfig = dataclasses.field(default_factory=TrackingConfig)
    acquisition: AcquisitionConfig = dataclasses.field(
        default_factory=AcquisitionConfig
    )
    # Pull-in -> cruise handoff: when set, ``tracking`` is the pull-in
    # configuration and the session promotes to this throughput-optimal
    # config once every channel is stable (session.CruisePolicy).
    cruise_tracking: TrackingConfig | None = None
    measurement_period_ms: int = 1000
    approx_position: tuple = (0.0, 0.0, 0.0)
    # Assisted mode: externally supplied ephemerides ({prn: Ephemeris}) allow
    # fixes before broadcast decode completes (reference AGNSS).
    assisted_ephemerides: dict | None = None
    # Clock-assisted start: receiver time-of-week at sample 0 (reference
    # initialises its clock from the AGNSS config datetime,
    # receiver_gps_l1ca.py:68-71). None = initialise from the first
    # measurement epoch (max transmit time + nominal travel time).
    assisted_clock_tow: float | None = None
    # Measurement types.
    enable_doppler: bool = True
    # Atmospheric corrections (applied once a position estimate exists).
    tropo_enabled: bool = True
    iono_enabled: bool = False
    iono_alpha: tuple = (0.0, 0.0, 0.0, 0.0)
    iono_beta: tuple = (0.0, 0.0, 0.0, 0.0)
    # Lock-loss reacquisition (round-4 forensics, tools/soak_debug.py /
    # tools/false_lock_probe.py): the round-3 block-count window
    # (25 consecutive low blocks) was 125 ms at the 5 ms pull-in shape,
    # and the C/N0 estimator reads 13-24 dB-Hz for several seconds while
    # warming up — healthy channels were being reset at ~3-5 s and their
    # re-rolls could park in a ~19 Hz Costas alias. All windows are now
    # TIME-based and the low-C/N0 test only arms after
    # ``reacq_warmup_codes`` tracked code periods; a separate fast path
    # catches truly dead channels (C/N0 at the noise floor, e.g. a failed
    # acquisition handoff) without waiting out the warm-up.
    reacq_cn0_threshold: float = 25.0
    reacq_low_cn0_s: float = 3.0        # consecutive low-C/N0 time
    reacq_warmup_codes: int = 5000      # estimator warm-up [code periods]
    reacq_dead_cn0: float = 10.0        # "no signal at all" threshold
    reacq_dead_s: float = 1.0           # dead-channel window (arms at 1 s)
    # Decode-progress timeout: a TRACKING channel that has pushed this
    # many nav bits without ever assembling one valid subframe is
    # decode-dead no matter how healthy its correlators look (cross-PRN
    # capture, Costas half-bit-rate alias with noise-declared bit sync:
    # PRN 6 in the round-4 soak tracked 40+ s at 29 dB-Hz and never
    # decoded) and is reset. ~1250 bits = 25 s, > 3 subframe periods +
    # sync time. 0 disables.
    decode_timeout_bits: int = 1250
    # Solution integrity (RAIM-lite): with > 4 satellites, measurements
    # whose post-fit residual exceeds the gate are excluded worst-first
    # and the epoch re-solved; if no clean subset remains the epoch
    # produces no fix (and the clock is NOT steered). A healthy
    # overdetermined solve leaves cm-level residuals, so the gate only
    # fires on real faults. An excluded measurement whose residual
    # implies a timing slip (>= fix_fault_reset_m, i.e. km-scale — an
    # integer-ms code-boundary error, not thermal noise) also resets its
    # channel to reacquire. 0 disables the gate.
    fix_residual_gate_m: float = 75.0
    fix_fault_reset_m: float = 10_000.0
    # Channels still without bit sync after this many tracked code periods
    # AND with a weak PLL lock indicator are false-locked (e.g.
    # cross-correlation capture or a +-25 Hz Costas alias during pull-in)
    # and are reset to reacquire. A phase-LOCKED channel (NBD/NBP above
    # ``reacq_no_bitsync_pll``) is legitimately waiting for a data-bit
    # transition — zero-heavy LNAV words can go seconds without one — and
    # gets until ``reacq_no_bitsync_hard_factor`` times the budget before
    # the reset fires regardless. 0 disables.
    reacq_no_bitsync_epochs: int = 4000
    reacq_no_bitsync_pll: float = 0.75
    reacq_no_bitsync_hard_factor: int = 4
    # Carrier-smoothed pseudoranges (Hatch filter): blend each raw code
    # pseudorange with the previous smoothed value propagated by the
    # integrated carrier phase (accumulated from the per-epoch tracked
    # Doppler). Cuts code thermal noise by ~sqrt(T/1s) while the carrier
    # keeps the absolute scale; an improvement over the reference, which
    # forms code-only pseudoranges (receiver_gps_l1ca.py:239). Time
    # constant in seconds; 0 disables. Default ON (production): at the
    # decimated 2.5 Msps cruise rate the raw code pseudoranges carry
    # ~4-5 m RMS thermal noise (tools/soak_debug.py round-4 forensics:
    # fix errors jumping 1-18 m with matching clock-bias jitter and no
    # systematic drift); a 20 s Hatch constant cuts that by ~sqrt(20)
    # while the 30 m raw-vs-predicted gate restarts the filter on any
    # cycle slip or lock transient, so cold-start behavior is unchanged.
    smoothing_time_s: float = 20.0
    # Persistence (None = no database).
    database_path: str | None = None
    log_tracking_decimation: int = 20


@dataclasses.dataclass
class PvtFix:
    tow: float                   # receiver time of fix [s of week]
    sample: int                  # absolute sample index of the epoch
    solution: PvtSolution
    n_satellites: int
    prns: tuple
    week: int = 0
    velocity: "np.ndarray | None" = None      # ECEF [m/s]
    clock_drift: float | None = None          # [s/s]


class _ChannelBookkeeping:
    """Host-side per-channel decode / timing state."""

    def __init__(self, prn: int):
        self.prn = prn
        self.decoder = LnavDecoder()
        self.n_codes = 0             # code boundaries crossed while tracking
        self.bits_pushed = 0
        self.tow_ref: float | None = None   # satellite time of subframe start
        self.boundary_ref: int = 0          # n_codes at that subframe start
        self.subframes_seen: set = set()
        self.eph = None              # completed broadcast ephemeris
        self._partial = None

    def push_outputs(self, active, bit_ready, bit_ip_sum):
        """Consume one block of per-epoch outputs; returns subframe events.

        Vectorised over the block: only actual data bits (50 Hz/channel, vs
        1 kHz epochs) reach the Python decoder loop.
        """
        active = np.asarray(active, dtype=bool)
        n_act = int(np.count_nonzero(active))
        if n_act == 0:
            return []
        ready = active & np.asarray(bit_ready, dtype=bool)
        events = []
        if ready.any():
            # n_codes *including* the bit epoch: that epoch is the first
            # code period of the *next* bit; the finished bit spans
            # boundaries [n_codes - 21, n_codes - 1].
            cum = np.cumsum(active)
            bits = np.asarray(bit_ip_sum)[ready] > 0
            for n_at, bit in zip(cum[ready], bits):
                self.bits_pushed += 1
                ev = self.decoder.push_bit(1 if bit else 0)
                if ev is not None:
                    events.append(
                        self._apply_subframe(ev, self.n_codes + int(n_at)))
        self.n_codes += n_act
        return [ev for ev in events if ev is not None]

    def _apply_subframe(self, ev, n_codes_at):
        # Code-boundary count at the subframe's first bit start.
        # ``n_codes_at`` includes the bit epoch (ms 0 of the NEXT bit); the
        # finished bit (index bits_pushed-1) spans code periods with counts
        # [n_codes_at-20, n_codes_at-1], i.e. it starts at boundary
        # n_codes_at-21. Earlier bits are 20 boundaries apart.
        start_boundary = (
            n_codes_at - 1 - 20 * (self.bits_pushed - ev.bit_index)
        )
        self.tow_ref = float(ev.tow_label - 6)
        self.boundary_ref = start_boundary
        self.subframes_seen.add(ev.subframe_id)
        if ev.subframe_id in (1, 2, 3):
            if self._partial is None:
                self._partial = Ephemeris(prn=self.prn)
            self._partial.apply_subframe(ev.bits)
            if self._partial.complete:
                self.eph = self._partial
        return ev

    @property
    def has_tow(self) -> bool:
        return self.tow_ref is not None


class Receiver:
    """Streaming GPS L1 C/A receiver over the TPU channel runtime."""

    def __init__(self, cfg: ReceiverConfig, *, device):
        self.cfg = cfg
        self.session = TrackingSession(
            cfg.tracking, list(cfg.prns), cfg.acquisition,
            cruise=cfg.cruise_tracking, device=device,
        )
        self.channels = [_ChannelBookkeeping(p) for p in cfg.prns]
        self.fixes: list[PvtFix] = []
        # Receiver time at clock_sample; clock-assisted AGNSS starts with a
        # coarse time fix at sample 0.
        self.clock_tow: float | None = cfg.assisted_clock_tow
        self.clock_sample: int = 0
        self._next_meas_sample = None
        self.block_outputs: list[dict] = []
        self.keep_outputs = False
        self.last_outputs: dict | None = None
        self._low_cn0_ms = np.zeros(len(cfg.prns), dtype=int)
        self._dead_cn0_ms = np.zeros(len(cfg.prns), dtype=int)
        # consecutive measurement-epoch exclusions per channel (RAIM gate)
        self._excluded_epochs: dict[int, int] = {}
        # Carrier-smoothing state: integrated tracked Doppler [cycles] per
        # channel plus the per-channel Hatch filter memory.
        self._phase_cycles = np.zeros(len(cfg.prns), dtype=np.float64)
        self._smooth: dict[int, tuple] = {}   # i -> (phase_at, value, n)
        # Carrier-phase observable (RINEX L1C) anchors: i -> (phase0, L0)
        # with L0 = pr(t0)/lambda at the start of each continuous arc, so
        # L(t) = L0 - (phase(t) - phase0) tracks range in cycles with the
        # RINEX sign convention dL/dt = -D1C (the reference's RINEXObs
        # never exported phase; sydr/io/RINEXObs.py:14 is broken).
        self._l1c_anchor: dict[int, tuple] = {}
        self._acq_logged: set = set()
        self._block_index = 0
        self._epochs_done = 0          # tracking epochs (ms) processed
        self._pend_re = np.empty(0, dtype=np.float32)
        self._pend_im = np.empty(0, dtype=np.float32)
        from sydr_tpu_torch.utils.metrics import StageTimers

        self.timers = StageTimers()
        self.db = None
        if cfg.database_path:
            from sydr_tpu_torch.io.database import ResultDatabase

            self.db = ResultDatabase(cfg.database_path)
            for i, prn in enumerate(cfg.prns):
                self.db.add("channel", {"channel_id": i, "prn": prn})

    # ------------------------------------------------------------------
    @property
    def fs(self) -> float:
        return self.cfg.tracking.sampling_frequency

    def ephemeris_for(self, i: int):
        ch = self.channels[i]
        if ch.eph is not None:
            return ch.eph
        if self.cfg.assisted_ephemerides:
            return self.cfg.assisted_ephemerides.get(ch.prn)
        return None

    # ------------------------------------------------------------------
    def process_ms(self, iq) -> None:
        """Process IQ (complex ndarray or (re, im) float32 tuple).

        Any length: samples buffer internally and whole (super)blocks are
        consumed as they fill — required because the pull-in -> cruise
        handoff changes the block shape mid-run (``cruise_tracking``)."""
        if isinstance(iq, tuple):
            re, im = iq
        else:
            re = np.ascontiguousarray(np.real(iq), dtype=np.float32)
            im = np.ascontiguousarray(np.imag(iq), dtype=np.float32)
        self._pend_re = (np.concatenate([self._pend_re, re])
                         if len(self._pend_re) else np.float32(re))
        self._pend_im = (np.concatenate([self._pend_im, im])
                         if len(self._pend_im) else np.float32(im))
        while True:
            spb = self.session.block_input_samples
            if len(self._pend_re) < spb:
                break
            blk_re, self._pend_re = self._pend_re[:spb], self._pend_re[spb:]
            blk_im, self._pend_im = self._pend_im[:spb], self._pend_im[spb:]
            with self.timers.time("track_block"):
                out = self.session.process_block(blk_re, blk_im)
            self.last_outputs = out
            if self.keep_outputs:
                self.block_outputs.append(out)
            for i, ch in enumerate(self.channels):
                events = ch.push_outputs(
                    out["active"][:, i], out["bit_ready"][:, i],
                    out["bit_ip_sum"][:, i],
                )
                for ev in events:
                    self._on_subframe_event(i, ch, ev)
            with self.timers.time("decode"):
                self._post_block(out)
            with self.timers.time("measure"):
                self._maybe_measure(out)
            self._block_index += 1
            self._epochs_done += out["active"].shape[0]

    # ------------------------------------------------------------------
    def _on_subframe_event(self, i: int, ch, ev) -> None:
        """Record a decoded subframe and mirror the decode progress into
        the device flags (reference logs SUBFRAME_SYNC/TOW_DECODED/
        EPH_DECODED per ms, channel.py:205-228)."""
        from sydr_tpu_torch.channels.state import (
            FLAG_EPH_DECODED,
            FLAG_SUBFRAME_SYNC,
            FLAG_TOW_DECODED,
        )

        logger.debug(
            "PRN %d subframe %d tow=%d", ch.prn, ev.subframe_id,
            ev.tow_label,
        )
        if self.db is not None:
            self.db.add("decoding", {
                "channel_id": i, "prn": ch.prn,
                "subframe_id": int(ev.subframe_id),
                "tow": int(ev.tow_label),
                "bits": np.asarray(ev.bits, dtype=np.uint8),
            })
        mask = FLAG_SUBFRAME_SYNC | FLAG_TOW_DECODED
        if ch.eph is not None:
            mask |= FLAG_EPH_DECODED
        self.session.or_flags(i, mask)

    # ------------------------------------------------------------------
    def _post_block(self, out) -> None:
        """Per-block logging, lock monitoring and reacquisition."""
        cfg = self.cfg
        # Integrated carrier (for Hatch smoothing): each tracked epoch spans
        # one code period (1 ms to within dop/f_L1), so the accumulated
        # Doppler cycles are sum(active * (f_carrier - f_IF)) * 1 ms.
        # (accumulated unconditionally since round 5: the L1C carrier-phase
        # observable needs it even when Hatch smoothing is disabled —
        # review finding: with smoothing_time_s=0 the exported L1C froze
        # at its anchor)
        f_if = cfg.tracking.intermediate_frequency
        act = np.asarray(out["active"], dtype=bool)
        cf = np.asarray(out["carrier_freq"], dtype=np.float64)
        self._phase_cycles += 1e-3 * np.sum(
            np.where(act, cf - f_if, 0.0), axis=0)
        # Log acquisition results once per handoff.
        for i, res in self.session.acq_results.items():
            key = (i, res["code_index"], round(res["doppler"]))
            if key not in self._acq_logged:
                self._acq_logged.add(key)
                logger.info(
                    "PRN %d acquired: doppler=%+.0f Hz metric=%.2f",
                    res["prn"], res["doppler"], res["metric"])
                if self.db is not None:
                    spc = round(self.fs * 1023.0 / 1.023e6)
                    self.db.add("acquisition", {
                        "channel_id": i, "prn": res["prn"],
                        "doppler": res["doppler"],
                        "code_index": res["code_index"],
                        # normalised code phase [chips] (reference
                        # old/analysis.py:59 coarseCodeNorm column)
                        "code_chips": res["code_index"] * 1023.0 / spc,
                        "metric": res["metric"],
                        "corr_map": res.get("corr_map"),
                        "corr_dopplers": res.get("corr_dopplers"),
                        "sample": self.session.total_samples,
                    })

        # Tracking rows (decimated), vectorised: one fancy-index per column
        # and a single executemany-backed add_many instead of per-element
        # ``float(out[...][e, i])`` scalar extraction (the old per-epoch
        # Python loop was the host wall at high RTF).
        if self.db is not None and cfg.log_tracking_decimation > 0:
            step = cfg.log_tracking_decimation
            # Running epoch counter, not block_index * shape: the pull-in
            # -> cruise handoff changes the epochs-per-block mid-run.
            base_epoch = self._epochs_done
            es, chs = np.nonzero(out["active"][::step])
            if len(es):
                fkeys = ("i_early", "q_early", "i_prompt", "q_prompt",
                         "i_late", "q_late", "dll_error", "pll_error",
                         "carrier_freq", "code_freq", "cn0", "pll_lock",
                         "fll_lock")
                cols = [out[k][::step][es, chs].astype(float).tolist()
                        for k in fkeys]
                epochs = (base_epoch + es * step).tolist()
                flags = out["flags"][::step][es, chs].astype(int).tolist()
                self.db.add_many("tracking", [
                    dict(zip(fkeys, vals),
                         channel_id=int(c), epoch=ep, flags=fl)
                    for c, ep, fl, *vals in zip(
                        chs.tolist(), epochs, flags, *cols)
                ])

        # Lock-loss detection -> reacquisition (the reference has no
        # infrastructural recovery; lost channels just idle).
        from sydr_tpu_torch.channels.state import FLAG_BIT_SYNC

        n_epoch_ms = int(out["active"].shape[0])  # 1 ms epochs this block
        # C/N0 is only trustworthy in the cruise shape: the NWPR windows in
        # the 5 ms pull-in blocks read -120..20 dB-Hz on channels that are
        # demonstrably healthy (decoding subframes), and arming the C/N0
        # detectors on those readings produced a reset death-spiral in the
        # round-4 soak (every reset demotes to pull-in, whose junk C/N0
        # then kills the next healthy channel and blocks re-promotion).
        # During pull-in the PLL-based no-bitsync detector and the decode
        # timeout carry the failure detection instead.
        cn0_trust = self.session.promoted or self.session.cruise_cfg is None
        for i, ch in enumerate(self.channels):
            if self.session.mode_host[i] != MODE_TRACKING:
                continue
            cn0 = float(out["cn0"][-1, i])
            # cn0 == 0 means "not yet estimated"; anything else below the
            # threshold (including the degenerate negative estimates pure
            # noise produces) counts as low. The low test only arms after
            # the estimator warm-up; the dead test (noise floor) arms at
            # 1 s so a failed acquisition handoff resets promptly.
            low = (cn0_trust and ch.n_codes > cfg.reacq_warmup_codes
                   and cn0 != 0.0 and cn0 < cfg.reacq_cn0_threshold)
            dead = (cn0_trust and ch.n_codes > 1000 and cn0 != 0.0
                    and cn0 < cfg.reacq_dead_cn0)
            self._low_cn0_ms[i] = self._low_cn0_ms[i] + n_epoch_ms \
                if low else 0
            self._dead_cn0_ms[i] = self._dead_cn0_ms[i] + n_epoch_ms \
                if dead else 0
            # No bit sync: reset quickly when the PLL is NOT locked (false
            # lock / noise capture); a phase-locked channel is just waiting
            # for a data transition and only hits the hard backstop.
            synced = bool(int(out["flags"][-1, i]) & FLAG_BIT_SYNC)
            pll_weak = float(out["pll_lock"][-1, i]) < cfg.reacq_no_bitsync_pll
            budget = cfg.reacq_no_bitsync_epochs
            no_bitsync = (
                budget > 0 and not synced
                and ((ch.n_codes > budget and pll_weak)
                     or ch.n_codes > budget * cfg.reacq_no_bitsync_hard_factor)
            )
            # Decode-dead: bit sync declared (possibly on noise flips) and
            # bits flowing, but not one valid subframe — cross-PRN capture
            # or a Costas half-bit-rate alias; no power/PLL test sees it.
            no_subframe = (
                cfg.decode_timeout_bits > 0
                and ch.bits_pushed > cfg.decode_timeout_bits
                and not ch.subframes_seen
            )
            reason = None
            if self._dead_cn0_ms[i] >= cfg.reacq_dead_s * 1000.0:
                reason = f"C/N0 {cn0:.1f} dB-Hz (no signal)"
            elif self._low_cn0_ms[i] >= cfg.reacq_low_cn0_s * 1000.0:
                reason = f"C/N0 {cn0:.1f} dB-Hz"
            elif no_bitsync:
                kind = ("weak PLL" if pll_weak and ch.n_codes <= budget
                        * cfg.reacq_no_bitsync_hard_factor
                        else "hard backstop")
                reason = (f"no bit sync after {ch.n_codes} epochs "
                          f"({kind}, pll_lock="
                          f"{float(out['pll_lock'][-1, i]):.2f})")
            elif no_subframe:
                reason = (f"no subframe after {ch.bits_pushed} bits "
                          f"(decode-dead, C/N0 {cn0:.1f} dB-Hz)")
            if reason is not None:
                logger.warning(
                    "PRN %d lost lock (%s); reacquiring", ch.prn, reason)
                self.session.reset_channel(i)
                self.channels[i] = _ChannelBookkeeping(ch.prn)
                self._low_cn0_ms[i] = 0
                self._dead_cn0_ms[i] = 0
                self._smooth.pop(i, None)
                self._l1c_anchor.pop(i, None)

    # ------------------------------------------------------------------
    def _smooth_pseudorange(self, i: int, pr: float) -> float:
        """Hatch filter: carrier-propagate the previous smoothed value and
        blend the raw code pseudorange in with weight 1/n (n capped at
        ``smoothing_time_s`` / measurement period). A raw-vs-predicted gap
        beyond 30 m (cycle slip, lock transient) restarts the filter."""
        lam = SPEED_OF_LIGHT / GPS_L1CA_CARRIER_FREQ
        phase = float(self._phase_cycles[i])
        prev = self._smooth.get(i)
        if prev is not None:
            phase0, val0, n = prev
            predicted = val0 - lam * (phase - phase0)
            if abs(pr - predicted) <= 30.0:
                n_max = max(2, round(
                    self.cfg.smoothing_time_s * 1e3
                    / self.cfg.measurement_period_ms))
                n = min(n + 1, n_max)
                smoothed = pr / n + (n - 1) / n * predicted
                self._smooth[i] = (phase, smoothed, n)
                return smoothed
        self._smooth[i] = (phase, pr, 1)
        return pr

    # ------------------------------------------------------------------
    def _carrier_phase_obs(self, i: int, pr: float) -> float:
        """Carrier-phase observable (RINEX L1C, cycles) for channel ``i``.

        Anchored to ``pr/lambda`` at the start of each continuous arc (a
        Hatch-filter restart marks a cycle slip / lock transient), then
        advanced by the integrated tracked Doppler with the RINEX sign
        convention (range down -> phase observable down, dL/dt = -D1C).
        Call AFTER ``_smooth_pseudorange`` so a restart epoch re-anchors.
        """
        lam = SPEED_OF_LIGHT / GPS_L1CA_CARRIER_FREQ
        phase = float(self._phase_cycles[i])
        sm = self._smooth.get(i)
        fresh_arc = sm is not None and sm[2] == 1
        anchor = self._l1c_anchor.get(i)
        if anchor is None or fresh_arc:
            anchor = (phase, pr / lam)
            self._l1c_anchor[i] = anchor
        phase0, l0 = anchor
        return l0 - (phase - phase0)

    # ------------------------------------------------------------------
    def _transmit_time_at(self, i: int, sample: int,
                          snapshot=None) -> float | None:
        """Satellite transmit time observed at absolute ``sample``."""
        ch = self.channels[i]
        if not ch.has_tow:
            return None
        if snapshot is None:
            snapshot = self._state_snapshot()
        unread = int(snapshot["unread"][i])
        rem_code = float(snapshot["rem_code"][i])
        carrier = float(snapshot["carrier_freq"][i])
        f_if = self.cfg.tracking.intermediate_frequency
        # Effective code rate (aided; matches the runtime's rate model).
        if self.cfg.tracking.carrier_aiding:
            from sydr_tpu_torch.constants import GPS_L1CA_CARRIER_FREQ
            delta = float(snapshot["code_freq_offset"][i]) + (
                carrier - f_if) * (
                GPS_L1CA_CODE_FREQ / GPS_L1CA_CARRIER_FREQ
            )
        else:
            delta = float(snapshot["code_freq_offset"][i])
        step = (GPS_L1CA_CODE_FREQ + delta) / self.fs
        # Fractional sample position of the latest code boundary.
        p = (self.session.total_samples - unread) - rem_code / step
        t_boundary = ch.tow_ref + (ch.n_codes - ch.boundary_ref) * 1e-3
        return t_boundary + (sample - p) * step / GPS_L1CA_CODE_LENGTH * 1e-3

    # ------------------------------------------------------------------
    def _atmospheric_delay(self, eph, t_rx: float, t_tx: float) -> float:
        """Tropospheric + ionospheric delay [m] for one satellite.

        Needs a position estimate (last fix or approx); returns 0 before one
        is available or when both models are disabled.
        """
        cfg = self.cfg
        if not (cfg.tropo_enabled or cfg.iono_enabled):
            return 0.0
        if self.fixes:
            pos = self.fixes[-1].solution.position
        else:
            pos = np.asarray(cfg.approx_position, dtype=np.float64)
        if np.linalg.norm(pos) < 1e6:
            return 0.0
        from sydr_tpu_torch.nav import atmosphere, geodesy
        from sydr_tpu_torch.nav.kepler import satellite_position_velocity

        sat_pos, _, _ = satellite_position_velocity(eph, t_tx)
        el, az = geodesy.elevation_azimuth(sat_pos, pos)
        lat, lon, h = geodesy.ecef_to_geodetic(pos)
        delay = 0.0
        if cfg.tropo_enabled:
            delay += atmosphere.tropo_delay_collins(el, lat, max(h, 0.0))
        if cfg.iono_enabled:
            delay += atmosphere.iono_delay_klobuchar(
                el, az, lat, lon, t_rx, cfg.iono_alpha, cfg.iono_beta)
        return float(delay)

    def _state_snapshot(self) -> dict:
        """One bulk fetch of the per-channel scalars used by measurements."""
        st = self.session.state
        import torch

        packed = torch.stack(
            [st.unread.to(torch.float32), st.rem_code,
             st.carrier_freq, st.code_freq_offset], dim=0).cpu().numpy()
        return {
            "unread": packed[0].astype(np.int64),
            "rem_code": packed[1],
            "carrier_freq": packed[2],
            "code_freq_offset": packed[3],
        }

    # ------------------------------------------------------------------
    def _maybe_measure(self, out) -> None:
        sample = self.session.total_samples
        if self._next_meas_sample is not None and sample < self._next_meas_sample:
            return

        ready = []
        for i, ch in enumerate(self.channels):
            if self.session.mode_host[i] != MODE_TRACKING:
                continue
            if not ch.has_tow:
                continue
            eph = self.ephemeris_for(i)
            if eph is None:
                continue
            ready.append((i, ch, eph))
        if len(ready) < 4:
            return

        snapshot = self._state_snapshot()
        tx_times = {}
        for i, ch, eph in ready:
            tx = self._transmit_time_at(i, sample, snapshot)
            if tx is not None:
                tx_times[i] = tx
        if len(tx_times) < 4:
            return

        # Receiver clock: initialise from the earliest signal + nominal
        # travel time (reference receiver_gps_l1ca.py:214-220).
        if self.clock_tow is None:
            self.clock_tow = max(tx_times.values()) + AVG_TRAVEL_TIME_MS * 1e-3
            self.clock_sample = sample
        t_rx = self.clock_tow + (sample - self.clock_sample) / self.fs

        prs, raw_prs, ephs, prns, dops, ch_idx = [], [], [], [], [], []
        l1cs = []
        for i, ch, eph in ready:
            raw = (t_rx - tx_times[i]) * SPEED_OF_LIGHT
            pr = raw
            _, _, clk = _sat_clock(eph, tx_times[i])
            # L1 single-frequency: + c*dt_sv - c*TGD (IS-GPS-200 20.3.3.3.3.2;
            # the reference *adds* TGD, receiver_gps_l1ca.py:248 — spec sign
            # used here).
            pr += clk * SPEED_OF_LIGHT - eph.tgd * SPEED_OF_LIGHT
            pr -= self._atmospheric_delay(eph, t_rx, tx_times[i])
            if self.cfg.smoothing_time_s > 0:
                pr = self._smooth_pseudorange(i, pr)
            l1cs.append(self._carrier_phase_obs(i, pr))
            prs.append(pr)
            raw_prs.append(raw)
            ephs.append(eph)
            prns.append(ch.prn)
            dops.append(
                float(snapshot["carrier_freq"][i])
                - self.cfg.tracking.intermediate_frequency
            )
            ch_idx.append(i)

        sol = solve_pvt(
            np.asarray(prs), ephs, t_rx,
            approx_position=np.asarray(self.cfg.approx_position),
        )
        period = self.cfg.measurement_period_ms * self.cfg.tracking.samples_per_ms
        self._next_meas_sample = sample + period
        if sol is None or not sol.converged:
            return

        # --- Solution integrity (RAIM-lite) ---------------------------
        # A single faulty pseudorange — e.g. an integer-ms timing slip on
        # one channel (round-4 seed-7 soak: fixes walked hundreds of km
        # while every per-channel indicator looked healthy) — must never
        # reach the fix stream, because the solved clock bias STEERS the
        # receiver clock and would poison every later measurement. A
        # healthy overdetermined solve leaves cm-level residuals, so a
        # large worst-residual is unambiguous: drop the worst measurement
        # while > 4 remain; an excluded channel whose residual implies a
        # timing fault (not noise) is reset to reacquire; if no clean
        # subset exists the epoch produces NO fix (and no clock steer).
        gate = self.cfg.fix_residual_gate_m
        excluded_now: set = set()
        while (gate > 0 and len(prs) > 4
               and float(np.max(np.abs(sol.residuals))) > gate):
            worst = int(np.argmax(np.abs(sol.residuals)))
            w_res = float(sol.residuals[worst])
            i_bad = ch_idx[worst]
            excluded_now.add(i_bad)
            logger.warning(
                "PVT integrity: excluding PRN %d (residual %.1f m)",
                prns[worst], w_res)
            # A channel excluded at several consecutive epochs carries a
            # persistent measurement bias (not one noise event) — reset it
            # even below the km-scale fault threshold.
            self._excluded_epochs[i_bad] = \
                self._excluded_epochs.get(i_bad, 0) + 1
            if (abs(w_res) > self.cfg.fix_fault_reset_m
                    or self._excluded_epochs[i_bad] >= 5):
                ch_bad = self.channels[i_bad]
                logger.warning(
                    "PRN %d measurement fault (%.0f m residual, timing "
                    "slip); reacquiring", ch_bad.prn, w_res)
                self.session.reset_channel(i_bad)
                self.channels[i_bad] = _ChannelBookkeeping(ch_bad.prn)
                self._low_cn0_ms[i_bad] = 0
                self._dead_cn0_ms[i_bad] = 0
                self._excluded_epochs.pop(i_bad, None)
                self._smooth.pop(i_bad, None)
                self._l1c_anchor.pop(i_bad, None)
            for lst in (prs, raw_prs, ephs, prns, dops, ch_idx, l1cs):
                del lst[worst]
            sol = solve_pvt(
                np.asarray(prs), ephs, t_rx,
                approx_position=np.asarray(self.cfg.approx_position),
            )
            if sol is None or not sol.converged:
                return
        if gate > 0 and float(np.max(np.abs(sol.residuals))) > gate:
            logger.warning(
                "PVT integrity: no clean %d-satellite subset "
                "(max residual %.1f m); fix rejected",
                len(prs), float(np.max(np.abs(sol.residuals))))
            return
        # channels used in an accepted solution break their consecutive-
        # exclusion streak
        for i in ch_idx:
            if i not in excluded_now:
                self._excluded_epochs.pop(i, None)
        velocity, drift = None, None
        if self.cfg.enable_doppler:
            from sydr_tpu_torch.nav.lse import solve_velocity

            vel_sol = solve_velocity(
                np.asarray(dops), ephs, t_rx, sol.position)
            if vel_sol is not None:
                velocity, drift = vel_sol
        week = ephs[0].week if ephs else 0
        fix = PvtFix(
            tow=t_rx, sample=sample, solution=sol,
            n_satellites=len(prs), prns=tuple(prns), week=week,
            velocity=velocity, clock_drift=drift,
        )
        self.fixes.append(fix)
        if self.db is not None:
            pos_row = {
                "tow": t_rx, "sample": sample,
                "x": float(sol.position[0]), "y": float(sol.position[1]),
                "z": float(sol.position[2]),
                "clock_bias": sol.clock_bias_m,
                "n_satellites": len(prs), "gdop": sol.gdop,
            }
            if velocity is not None:
                # solved velocity + clock drift (reference kept the
                # velocity solve only in old/receiver_gps_l1.py:441-451
                # and never persisted it)
                pos_row.update({
                    "vx": float(velocity[0]), "vy": float(velocity[1]),
                    "vz": float(velocity[2]),
                    "clock_drift": float(drift),
                })
            self.db.add("position", pos_row)
            for k, i in enumerate(ch_idx):
                self.db.add("measurement", {
                    "tow": t_rx, "channel_id": i, "prn": prns[k],
                    "mtype": "pseudorange", "value": prs[k],
                    "raw_value": raw_prs[k],
                    "residual": float(sol.residuals[k]),
                })
                if self.cfg.enable_doppler:
                    self.db.add("measurement", {
                        "tow": t_rx, "channel_id": i, "prn": prns[k],
                        "mtype": "doppler", "value": dops[k],
                        "raw_value": dops[k], "residual": 0.0,
                    })
                self.db.add("measurement", {
                    "tow": t_rx, "channel_id": i, "prn": prns[k],
                    "mtype": "carrier_phase", "value": l1cs[k],
                    "raw_value": l1cs[k], "residual": 0.0,
                })
        # Steer the receiver clock with the solved bias (reference :378).
        self.clock_tow = t_rx - sol.clock_bias_m / SPEED_OF_LIGHT
        self.clock_sample = sample
        # The steering shifts every future raw pseudorange by -bias; keep
        # the Hatch memories in the steered frame so the carrier-propagated
        # prediction stays consistent.
        if self._smooth:
            self._smooth = {
                i: (ph, val - sol.clock_bias_m, n)
                for i, (ph, val, n) in self._smooth.items()
            }
        # The carrier-phase anchors live in the same steered range frame.
        if self._l1c_anchor:
            lam = SPEED_OF_LIGHT / GPS_L1CA_CARRIER_FREQ
            self._l1c_anchor = {
                i: (ph0, l0 - sol.clock_bias_m / lam)
                for i, (ph0, l0) in self._l1c_anchor.items()
            }
        logger.info(
            "fix @%0.3f: %s bias=%.1fm nsat=%d", t_rx,
            np.array2string(sol.position, precision=2), sol.clock_bias_m,
            len(prs),
        )


def _sat_clock(eph, t):
    from sydr_tpu_torch.nav.kepler import satellite_position_velocity
    return satellite_position_velocity(eph, t)
