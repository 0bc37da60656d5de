"""Configuration loading: reference-compatible .ini and native .yaml.

The reference configures through layered ``configparser`` files
(``config/receiver.ini`` + ``config/channels/*.ini``,
parsed ad hoc in ``receiver_gps_l1ca.py:59-83``). This loader accepts that
exact ini layout — a reference user can point this framework at their
existing configs — plus a native YAML format, both mapping onto the typed
dataclass configuration tree.
"""

from __future__ import annotations

import configparser
import dataclasses
import os

from sydr_tpu_torch.channels.runtime import TrackingConfig
from sydr_tpu_torch.receiver.receiver import ReceiverConfig
from sydr_tpu_torch.receiver.session import AcquisitionConfig


@dataclasses.dataclass
class RunConfig:
    """Everything needed for one receiver run."""

    receiver: ReceiverConfig
    name: str = "sydr_tpu_torch_run"
    ms_to_process: int = 60000
    out_folder: str = ".results"
    # RF source (file mode).
    rf_filepath: str | None = None
    rf_data_size: int = 8
    rf_is_complex: bool = True
    reference_position: tuple | None = None
    # AGNSS.
    agnss_enabled: bool = False
    agnss_clock: str | None = None
    agnss_ephemeris_path: str | None = None
    measurements_enabled: dict = dataclasses.field(
        default_factory=lambda: {"pseudorange": True, "doppler": True}
    )


def _parse_bool(v: str) -> bool:
    return str(v).strip().lower() in ("1", "true", "yes", "on")


def load_ini(path: str) -> RunConfig:
    """Load a reference-format receiver.ini (+ linked channel ini)."""
    cp = configparser.ConfigParser()
    if not cp.read(path):
        raise FileNotFoundError(path)
    base = os.path.dirname(os.path.abspath(path))

    d = cp["DEFAULT"]
    rf = cp["RFSIGNAL"] if cp.has_section("RFSIGNAL") else {}
    fs = float(rf.get("sampling_frequency", 10e6))
    f_if = float(rf.get("intermediate_frequency", 0.0))

    prns = tuple(
        int(p) for p in cp.get("SATELLITES", "include_prn",
                               fallback="").split(",") if p.strip()
    )

    # Optional pre-correlation decimation: the file rate stays ``fs``; the
    # tracking stack runs at fs / decimate (TrackingConfig.input_decimate).
    dec = max(1, int(float(rf.get("decimate", 1))))
    tracking = TrackingConfig(
        sampling_frequency=fs / dec,
        input_decimate=dec,
        intermediate_frequency=f_if,
        window_size=round(fs / dec * 1e-3) + 256,
    )
    acquisition = AcquisitionConfig()

    # Linked channel configuration file.
    chan_path = cp.get("CHANNELS", "gps_l1ca", fallback=None)
    if chan_path:
        if not os.path.isabs(chan_path):
            for cand in (os.path.join(base, chan_path), chan_path):
                if os.path.exists(cand):
                    chan_path = cand
                    break
        ch = configparser.ConfigParser()
        if ch.read(chan_path):
            if ch.has_section("ACQUISITION"):
                a = ch["ACQUISITION"]
                acquisition = AcquisitionConfig(
                    doppler_range=float(a.get("doppler_range", 5000)),
                    doppler_step=float(a.get("doppler_steps", 100)),
                    coherent=int(a.get("coherent_integration", 5)),
                    non_coherent=int(a.get("non_coherent_integration", 10)),
                    threshold=float(a.get("threshold", 1.5)),
                )
            if ch.has_section("TRACKING"):
                t = ch["TRACKING"]
                early = float(t.get("correlator_early", -0.5))
                late = float(t.get("correlator_late", 0.5))
                tracking = dataclasses.replace(
                    tracking,
                    spacings=(early, 0.0, late),
                    dll_bandwidth=float(t.get("dll_noise_bandwidth", 1.0)),
                    dll_damping=float(t.get("dll_damping_ratio", 0.7)),
                    dll_gain=float(t.get("dll_loop_gain", 1.0)),
                    dll_pdi=float(t.get("dll_pdi", 1e-3)),
                    pll_bandwidth=float(t.get("pll_noise_bandwidth", 8.0)),
                    pll_damping=float(t.get("pll_damping_ratio", 0.7)),
                    pll_gain=float(t.get("pll_loop_gain", 0.25)),
                    pll_pdi=float(t.get("pll_pdi", 1e-3)),
                    spacing_wide=float(t.get("correlator_epl_wide", 0.5)),
                    spacing_narrow=float(t.get("correlator_epl_narrow", 0.2)),
                    fll_bandwidth_pullin=float(
                        t.get("fll_bandwidth_pullin", 100.0)),
                    fll_bandwidth_wide=float(
                        t.get("fll_bandwidth_wide", 50.0)),
                    fll_bandwidth_narrow=float(
                        t.get("fll_bandwidth_narrow", 15.0)),
                    # Wired DSP variants (reference dsp/tracking.py:283-325,
                    # channel_l1ca_kaplan.py:465-502).
                    dlf_order=int(t.get("dlf_order", 2)),
                    fll_discriminator=t.get(
                        "fll_discriminator", "atan").strip().lower(),
                    cn0_estimator=t.get(
                        "cn0_estimator", "nwpr").strip().lower(),
                    quantize_spacing=_parse_bool(
                        t.get("quantize_spacing", "False")),
                )
        if "kaplan" in os.path.basename(str(chan_path)).lower():
            tracking = dataclasses.replace(tracking, profile="kaplan")

    approx = (
        float(d.get("approx_position_x", 0.0)),
        float(d.get("approx_position_y", 0.0)),
        float(d.get("approx_position_z", 0.0)),
    )
    ref_pos = None
    if "reference_position_x" in d:
        ref_pos = (
            float(d["reference_position_x"]),
            float(d["reference_position_y"]),
            float(d["reference_position_z"]),
        )

    meas = {"pseudorange": True, "doppler": False}
    if cp.has_section("MEASUREMENTS"):
        m = cp["MEASUREMENTS"]
        meas["pseudorange"] = _parse_bool(m.get("pseudorange", "True"))
        meas["doppler"] = _parse_bool(m.get("doppler", "False"))
        period = float(m.get("frequency", 1.0))
        period_ms = int(round(1000.0 / period)) if period > 0 else 1000
    else:
        period_ms = 1000

    receiver = ReceiverConfig(
        prns=prns,
        tracking=tracking,
        acquisition=acquisition,
        measurement_period_ms=period_ms,
        approx_position=approx,
    )
    return RunConfig(
        receiver=receiver,
        name=d.get("name", "sydr_tpu_torch_run"),
        ms_to_process=int(d.get("ms_to_process", 60000)),
        out_folder=d.get("outfolder", ".results"),
        rf_filepath=rf.get("filepath") if rf else None,
        rf_data_size=int(rf.get("data_size", 8)) if rf else 8,
        rf_is_complex=_parse_bool(rf.get("is_complex", "true")) if rf else True,
        reference_position=ref_pos,
        agnss_enabled=_parse_bool(
            cp.get("AGNSS", "agnss_enabled", fallback="False")),
        agnss_clock=cp.get("AGNSS", "clock", fallback=None),
        agnss_ephemeris_path=cp.get(
            "AGNSS", "broadcast_ephemeris_path", fallback=None),
        measurements_enabled=meas,
    )


def load_yaml(path: str) -> RunConfig:
    """Load the native YAML configuration format."""
    import yaml

    with open(path) as fh:
        doc = yaml.safe_load(fh)

    tr = doc.get("tracking", {})
    fs = float(doc.get("sampling_frequency", tr.get("sampling_frequency",
                                                    10e6)))
    dec = max(1, int(tr.get("input_decimate", 1)))
    tracking = TrackingConfig(
        sampling_frequency=fs / dec,
        window_size=round(fs / dec * 1e-3) + 256,
        **{k: (tuple(v) if isinstance(v, list) else v)
           for k, v in tr.items() if k != "sampling_frequency"},
    )
    acq = AcquisitionConfig(**doc.get("acquisition", {}))
    rcv = doc.get("receiver", {})
    receiver = ReceiverConfig(
        prns=tuple(doc.get("prns", ())),
        tracking=tracking,
        acquisition=acq,
        measurement_period_ms=int(rcv.get("measurement_period_ms", 1000)),
        approx_position=tuple(rcv.get("approx_position", (0.0, 0.0, 0.0))),
    )
    run = doc.get("run", {})
    rf = doc.get("rf", {})
    return RunConfig(
        receiver=receiver,
        name=run.get("name", "sydr_tpu_torch_run"),
        ms_to_process=int(run.get("ms_to_process", 60000)),
        out_folder=run.get("out_folder", ".results"),
        rf_filepath=rf.get("filepath"),
        rf_data_size=int(rf.get("data_size", 8)),
        rf_is_complex=bool(rf.get("is_complex", True)),
        reference_position=(
            tuple(run["reference_position"])
            if "reference_position" in run else None
        ),
        agnss_enabled=bool(doc.get("agnss", {}).get("enabled", False)),
        agnss_clock=doc.get("agnss", {}).get("clock"),
        agnss_ephemeris_path=doc.get("agnss", {}).get("ephemeris_path"),
        measurements_enabled=doc.get(
            "measurements", {"pseudorange": True, "doppler": True}),
    )


def load(path: str) -> RunConfig:
    if path.endswith((".yaml", ".yml")):
        return load_yaml(path)
    return load_ini(path)


def apply_agnss(run_cfg: RunConfig) -> RunConfig:
    """Resolve AGNSS + MEASUREMENTS settings into the ReceiverConfig.

    Mirrors the reference's assisted start-up (receiver_gps_l1ca.py:66-71):
    RINEX ephemerides become ``assisted_ephemerides``, GPSA/GPSB header
    Klobuchar parameters switch the iono correction on, and the AGNSS clock
    datetime seeds the receiver clock. MEASUREMENTS toggles map onto
    ``enable_doppler``.
    """
    updates: dict = {}
    if run_cfg.agnss_enabled and run_cfg.agnss_ephemeris_path:
        from sydr_tpu_torch.io.rinex import load_assisted

        ephs, hdr = load_assisted(run_cfg.agnss_ephemeris_path)
        updates["assisted_ephemerides"] = ephs
        if hdr.has_klobuchar:
            updates.update(
                iono_enabled=True,
                iono_alpha=hdr.iono_alpha,
                iono_beta=hdr.iono_beta,
            )
        if run_cfg.agnss_clock:
            from sydr_tpu_torch.nav.gpstime import GpsTime

            updates["assisted_clock_tow"] = GpsTime.from_string(
                run_cfg.agnss_clock).seconds
    if run_cfg.measurements_enabled:
        updates["enable_doppler"] = bool(
            run_cfg.measurements_enabled.get("doppler", True))
    if updates:
        run_cfg.receiver = dataclasses.replace(run_cfg.receiver, **updates)
    return run_cfg
