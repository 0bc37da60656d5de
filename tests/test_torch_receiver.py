"""The port's receiver entry point beside the JAX one: Receiver, LNAV decode,
PVT, configuration loading and the CLI.

(a) Side by side: the JAX and the port's ``Receiver`` take the same 5.5 s of
    tests/test_receiver_e2e.py's sky (six satellites at 47 dB-Hz, 4 Msps,
    seed 3), batch runtime, kaplan pull-in at 5 ms blocks and the
    narrow-only kaplan cruise at 20 ms blocks, each writing a database.
    5.5 s, because both promote only at ~5 s: PRN 6 finds no bit sync in
    pull-in and both reset it after 4020 epochs, the same way.
    Acquisition, promotion, sample accounting, the active/flags outputs,
    the decoded bit counts and the database's channel and acquisition rows
    must agree; the carrier within 1 Hz (tests/test_torch_session.py's
    closed-loop bound: the two float32 loops round their own way, and a
    chip-boundary tie moves a correlator by 2|x|).
(b) The port alone carries the same run on to 16 s, as
    tests/test_cruise.py's cold start does: promotion, TOW on at least 4
    channels, and a fix within the JAX package's 2 m of truth.
(c) Both configuration loaders give the same RunConfig; a YAML tracking
    block with ``use_pallas: true, boundary_mode: prefix`` reaches the
    prefix path.
(d) The CLI runs the demo on the CPU and refuses a missing CUDA device.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from sydr_tpu import config as jconfig
from sydr_tpu.channels.runtime import TrackingConfig as JaxTrackingConfig
from sydr_tpu.receiver.receiver import Receiver as JaxReceiver
from sydr_tpu.receiver.receiver import ReceiverConfig as JaxReceiverConfig
from sydr_tpu.signal import scenario as jscenario
from sydr_tpu_torch import config as tconfig
from sydr_tpu_torch import main as tmain
from sydr_tpu_torch.channels import batch_runtime as tbr
from sydr_tpu_torch.channels.runtime import TrackingConfig
from sydr_tpu_torch.ops import correlator_kernel as ck
from sydr_tpu_torch.receiver.receiver import Receiver, ReceiverConfig
from sydr_tpu_torch.signal import scenario as tscenario
from sydr_tpu_torch.utils.metrics import device_trace

torch.set_num_threads(2)

FS = 4e6
T0 = 302400.0
WEEK = 2190
RX_TRUTH = np.array(tscenario.DEMO_RX_TRUTH)
CHUNK_MS = 500
SIDE_MS = 5500
LONG_MS = 16000
CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _receiver_config(tracking_cls, receiver_cls, scenario_mod, db_path):
    sats = scenario_mod.demo_ephemerides(T0, WEEK)
    pull = tracking_cls(
        sampling_frequency=FS, tail_ms=4, window_size=4224,
        runtime="batch", profile="kaplan", block_ms=5, superblock=4)
    cruise = dataclasses.replace(pull, profile="kaplan", block_ms=20,
                                 kaplan_narrow_only=True, superblock=25)
    return receiver_cls(
        prns=tuple(e.prn for e in sats), tracking=pull,
        cruise_tracking=cruise,
        approx_position=tuple(RX_TRUTH + np.array([3000.0, -2000.0, 1500.0])),
        assisted_ephemerides={e.prn: e for e in sats},
        tropo_enabled=False, database_path=str(db_path))


def _summary(rx):
    """What (a) compares, read from a receiver after the side-by-side run."""
    outs = rx.block_outputs
    merged = {k: np.concatenate([np.asarray(o[k]) for o in outs])
              for k in ("active", "flags")}
    cruise_epochs = rx.cfg.cruise_tracking.block_ms \
        * rx.cfg.cruise_tracking.superblock
    # pull-in blocks run before promotion: the first cruise-shaped block,
    # or all of them when the promoted session has not filled one yet
    promoted_at = next((b for b, o in enumerate(outs)
                        if o["active"].shape[0] == cruise_epochs),
                       len(outs) if rx.session.promoted else None)
    return {
        "acq": {i: (r["doppler"], r["code_index"])
                for i, r in rx.session.acq_results.items()},
        "promoted_at": promoted_at,
        "snapshot": rx._state_snapshot(),
        "outputs": merged,
        "bits": [ch.bits_pushed for ch in rx.channels],
        "channel_rows": rx.db.fetch("channel"),
        "acq_rows": rx.db.fetch("acquisition"),
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(a)'s two receivers over SIDE_MS, then (b)'s port receiver carried
    on to LONG_MS. Both take the same IQ, made once."""
    tmp = tmp_path_factory.mktemp("rx")
    scn = tscenario.Scenario(RX_TRUTH, tscenario.demo_ephemerides(T0, WEEK),
                             T0, FS, cn0_dbhz=47.0, noise=True, seed=3)
    jrx = JaxReceiver(_receiver_config(
        JaxTrackingConfig, JaxReceiverConfig, jscenario, tmp / "jax.db"))
    trx = Receiver(_receiver_config(
        TrackingConfig, ReceiverConfig, tscenario, tmp / "port.db"),
        device=CPU)
    jrx.keep_outputs = trx.keep_outputs = True
    for _ in range(SIDE_MS // CHUNK_MS):
        iq = scn.generate_ms(CHUNK_MS)
        jrx.process_ms(iq)
        trx.process_ms(iq)
    side = {"jax": _summary(jrx), "port": _summary(trx)}
    trx.keep_outputs = False
    for _ in range((LONG_MS - SIDE_MS) // CHUNK_MS):
        trx.process_ms(scn.generate_ms(CHUNK_MS))
    return side, trx


def test_side_by_side_acquisition_and_promotion(runs):
    side, _ = runs
    j, t = side["jax"], side["port"]
    assert len(j["acq"]) == 6
    assert t["acq"] == j["acq"]
    assert j["promoted_at"] is not None
    assert t["promoted_at"] == j["promoted_at"]


def test_side_by_side_state_and_outputs(runs):
    side, _ = runs
    j, t = side["jax"], side["port"]
    np.testing.assert_array_equal(t["snapshot"]["unread"],
                                  j["snapshot"]["unread"])
    np.testing.assert_allclose(t["snapshot"]["carrier_freq"],
                               j["snapshot"]["carrier_freq"], atol=1.0)
    for key in ("active", "flags"):
        np.testing.assert_array_equal(t["outputs"][key], j["outputs"][key],
                                      err_msg=key)
    assert t["bits"] == j["bits"]
    assert sum(t["bits"]) > 0


def test_side_by_side_database_rows(runs):
    """Channel rows equal; acquisition rows equal in every field but the
    detection metric (within 1%, as tests/test_torch_session.py holds it)
    and the float32 correlation map it is the peak of."""
    side, _ = runs
    j, t = side["jax"], side["port"]
    assert t["channel_rows"] == j["channel_rows"]
    assert len(t["acq_rows"]) == len(j["acq_rows"]) >= 6   # + PRN 6 again
    for rt, rj in zip(t["acq_rows"], j["acq_rows"]):
        assert rt.keys() == rj.keys()
        for k in rt:
            if k == "metric":
                assert abs(rt[k] - rj[k]) < 0.01 * rj[k]
            elif k != "corr_map":
                assert rt[k] == rj[k], k


def test_port_receiver_fix_within_2m(runs):
    """(b): the port alone, cold start to a fix at 16 s."""
    _, rx = runs
    assert rx.session.promoted, "receiver never reached the cruise shape"
    n_with_tow = sum(ch.has_tow for ch in rx.channels)
    assert n_with_tow >= 4, f"only {n_with_tow} channels decoded TOW"
    assert len(rx.fixes) >= 1, "no PVT fix produced"
    err = np.linalg.norm(rx.fixes[-1].solution.position - RX_TRUTH)
    assert err < 2.0, f"position error {err:.2f} m"


INI_CHANNEL = (
    "[ACQUISITION]\ndoppler_range = 4000\ndoppler_steps = 200\n"
    "coherent_integration = 4\nnon_coherent_integration = 8\n"
    "threshold = 1.8\n"
    "[TRACKING]\ncorrelator_early = -0.4\ncorrelator_prompt = 0\n"
    "correlator_late = 0.4\ndll_noise_bandwidth = 2.0\n"
    "pll_noise_bandwidth = 12.0\n")
INI_RECEIVER = (
    "[DEFAULT]\nname = TEST\nms_to_process = 5000\n"
    "outfolder = out\napprox_position_x = 1.0\n"
    "approx_position_y = 2.0\napprox_position_z = 3.0\n"
    "reference_position_x = 10.0\nreference_position_y = 20.0\n"
    "reference_position_z = 30.0\n"
    "[RFSIGNAL]\nfilepath = iq.bin\nsampling_frequency = 5e6\n"
    "intermediate_frequency = 0.0\ndata_size = 16\nis_complex = true\n"
    "[SATELLITES]\ninclude_prn = 2,3,4\n"
    "[MEASUREMENTS]\nfrequency = 2\npseudorange = True\ndoppler = True\n")


def test_config_loaders_match_jax(tmp_path):
    """(c): the native YAML and the reference-format ini (the one
    tests/test_receiver_extras.py writes) load to the same RunConfig."""
    chan = tmp_path / "chan.ini"
    chan.write_text(INI_CHANNEL)
    ini = tmp_path / "receiver.ini"
    ini.write_text(INI_RECEIVER + f"[CHANNELS]\ngps_l1ca = {chan}\n")
    for path in (os.path.join(ROOT, "config", "receiver.yaml"), str(ini)):
        got = dataclasses.asdict(tconfig.load(path))
        want = dataclasses.asdict(jconfig.load(path))
        assert got == want, path
    rc = tconfig.load_ini(str(ini))
    assert rc.receiver.tracking.spacings == (-0.4, 0.0, 0.4)
    assert rc.receiver.acquisition.threshold == 1.8


def test_yaml_prefix_form_reaches_prefix_path(tmp_path, monkeypatch):
    """(c): ``use_pallas: true, boundary_mode: prefix`` in a YAML tracking
    block takes pass B's prefix form (K3) in the receiver, not K1."""
    y = tmp_path / "rx.yaml"
    y.write_text(
        "sampling_frequency: 2.5e6\nprns: [3, 7]\n"
        "tracking:\n  runtime: batch\n  profile: kaplan\n  block_ms: 5\n"
        "  use_pallas: true\n  boundary_mode: prefix\n")
    rc = tconfig.load_yaml(str(y))
    assert tbr.prefix_form(rc.receiver.tracking)
    calls = {"prefix": 0, "rowsum": 0}
    real_prefix, real_rowsum = (ck.block_cumsum_streams_ref,
                                ck.epoch_correlate_ref)

    def spy_prefix(*a):
        calls["prefix"] += 1
        return real_prefix(*a)

    def spy_rowsum(*a):
        calls["rowsum"] += 1
        return real_rowsum(*a)

    monkeypatch.setattr(ck, "block_cumsum_streams_ref", spy_prefix)
    monkeypatch.setattr(ck, "epoch_correlate_ref", spy_rowsum)
    rx = Receiver(rc.receiver, device=CPU)
    rng = np.random.default_rng(1)
    n = 2 * rx.session.block_input_samples
    rx.process_ms((np.float32(rng.normal(0, 1, n)),
                   np.float32(rng.normal(0, 1, n))))
    assert calls == {"prefix": 2, "rowsum": 0}


@pytest.fixture
def root_logging():
    """Restore the root logger after a CLI run (the CLI installs its own
    handlers on it)."""
    import logging

    root = logging.getLogger()
    saved = (root.handlers[:], root.level)
    yield
    for h in root.handlers[:]:
        if h not in saved[0]:
            root.removeHandler(h)
            h.close()
    for h in saved[0]:
        if h not in root.handlers:
            root.addHandler(h)
    root.setLevel(saved[1])


def test_cli_demo_on_cpu(tmp_path, capsys, root_logging):
    """(d): the demo end to end on the CPU (100 ms: acquisition and the
    first tracking blocks, no fix yet by construction)."""
    rc = tmain.main(["--demo", "--cpu", "--ms", "100", "--no-dashboard",
                     "--no-report", "--out", str(tmp_path)])
    assert rc == 0
    out = capsys.readouterr().out
    assert "processed 100 ms of signal" in out
    assert (tmp_path / "demo.db").exists()


def test_cli_refuses_missing_cuda_and_checkpointing(tmp_path, monkeypatch,
                                                    capsys):
    """(d): ``--device cuda`` without CUDA exits non-zero (the port never
    runs on the CPU when the card was asked for); ``--checkpoint-every``
    is not refused: on the CPU it runs and leaves a checkpoint that a
    receiver of the same configuration loads."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    common = ["--demo", "--ms", "100", "--no-dashboard", "--no-report",
              "--out", str(tmp_path)]
    assert tmain.main(common + ["--device", "cuda"]) != 0
    assert "CUDA is not available" in capsys.readouterr().err
    assert not (tmp_path / "demo.ckpt.npz").exists()


def test_cli_checkpoint_every_and_scan_runtime(tmp_path, capsys,
                                               root_logging):
    """(d): ``--runtime scan --checkpoint-every 100`` on the CPU: the scan
    runtime runs through the CLI (borre, 20 ms blocks) and the run leaves
    ``demo.ckpt.npz``, which a receiver of the demo's configuration
    loads."""
    import argparse

    from sydr_tpu_torch.receiver.checkpoint import load_checkpoint

    argv = ["--demo", "--cpu", "--runtime", "scan", "--ms", "200",
            "--checkpoint-every", "100", "--no-dashboard", "--no-report",
            "--out", str(tmp_path)]
    assert tmain.main(argv) == 0
    assert "processed 200 ms of signal" in capsys.readouterr().out
    path = tmp_path / "demo.ckpt.npz"
    assert path.exists()
    run_cfg, _ = tmain._build_demo(argparse.Namespace(
        fs=4e6, decimate=1, runtime="scan", pallas=False, superblock=1,
        quantize=False, no_cruise=False, cruise_superblock=50, ms=200,
        out=str(tmp_path)))
    assert run_cfg.receiver.tracking.profile == "borre"
    assert run_cfg.receiver.tracking.block_ms == 20
    rx = Receiver(run_cfg.receiver, device=CPU)
    load_checkpoint(rx, str(path))
    assert rx.session.total_samples == 200 * 4000
    assert rx._epochs_done == 200
    assert len(rx.session.acq_results) == 6


def test_device_trace_writes_chrome_trace(tmp_path):
    with device_trace(str(tmp_path / "trace")):
        torch.ones(8).sum()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
