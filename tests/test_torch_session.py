"""The slice end to end: the port's TrackingSession beside the JAX one.

Both sessions take the same 8 Msps stream (decimate 4 to 2 Msps, int8
upload): two satellites at 46 dB-Hz with random nav bits plus one absent
PRN; kaplan pull-in at 5 ms blocks, promotion to the narrow-only cruise at
20 ms blocks with superblock 5, quantised taps; 1.5 s of signal
(tests/test_decimate.py's shape, made short). Acquisition must agree
exactly (Doppler bin and code index) and promotion must happen at the same
call. The closed-loop correlators over the whole run are held to the
production parity gate's bounds against the JAX outputs: the amplitude-
scaled error and the prompt ratio over every correlator, the
``max |err| / (|ref| + 1)`` metric over 99% of them. That metric is the
gate's 4-block number; over 1500 closed-loop epochs its maximum is set by
near-zero Q prompts, where a carrier phase difference of a fraction of a
degree (two float32 loops, each rounding its own way) reads as an O(1)
relative error. The final carrier must agree within 1 Hz and the final
flags exactly.
"""

import dataclasses

import numpy as np
import pytest
import torch

from sydr_tpu.channels.runtime import TrackingConfig as JaxConfig
from sydr_tpu.receiver.session import TrackingSession as JaxSession
from sydr_tpu_torch import parity
from sydr_tpu_torch.channels.runtime import TrackingConfig
from sydr_tpu_torch.channels.state import FLAG_BIT_SYNC, MODE_TRACKING
from sydr_tpu_torch.receiver.session import TrackingSession
from sydr_tpu_torch.signal.synthetic import IQGenerator

torch.set_num_threads(2)

FS_IN = 8e6
DEC = 4
SIGNAL_MS = 1500
SATS = [dict(prn=5, doppler=1200.0, code_phase=321.4),
        dict(prn=12, doppler=-2600.0, code_phase=811.9)]
PRNS = [5, 12, 20]                 # PRN 20 is absent from the signal


def _generator():
    bits = np.random.default_rng(11).integers(0, 2, 200)
    gen = IQGenerator(FS_IN, noise=True, seed=11)
    for s in SATS:
        gen.add_satellite(s["prn"], doppler_hz=s["doppler"],
                          code_phase_chips=s["code_phase"], cn0_dbhz=46.0,
                          nav_bits=bits)
    return gen


def _configs(config_cls):
    fs = FS_IN / DEC
    pull_in = config_cls(
        sampling_frequency=fs, input_decimate=DEC,
        window_size=round(fs * 1e-3) + 256, runtime="batch",
        profile="kaplan", block_ms=5, quantize_spacing=True)
    cruise = dataclasses.replace(
        pull_in, kaplan_narrow_only=True, block_ms=20, superblock=5)
    return pull_in, cruise


def _drive(session):
    """Feed SIGNAL_MS of signal; return merged outputs and the call index
    at which the session promoted."""
    gen = _generator()
    outs, fed, calls, promoted_at = [], 0, 0, None
    while fed < SIGNAL_MS:
        n_ms = session.block_input_samples // (round(FS_IN * 1e-3))
        iq = gen.generate_ms(n_ms)
        outs.append(session.process_block(np.float32(iq.real),
                                          np.float32(iq.imag)))
        fed += n_ms
        calls += 1
        if promoted_at is None and session.promoted:
            promoted_at = calls
    merged = {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}
    return merged, promoted_at


@pytest.fixture(scope="module")
def runs():
    pull_in, cruise = _configs(JaxConfig)
    jax_session = JaxSession(pull_in, PRNS, cruise=cruise)
    out_j, prom_j = _drive(jax_session)
    pull_in, cruise = _configs(TrackingConfig)
    port = TrackingSession(pull_in, PRNS, cruise=cruise,
                           device=torch.device("cpu"))
    out_t, prom_t = _drive(port)
    return dict(jax=(jax_session, out_j, prom_j), port=(port, out_t, prom_t))


def test_acquisition_identical(runs):
    js, _, _ = runs["jax"]
    ts, _, _ = runs["port"]
    assert set(js.acq_results) == set(ts.acq_results)
    for i, ra in js.acq_results.items():
        rb = ts.acq_results[i]
        assert rb["doppler"] == ra["doppler"], i
        assert rb["code_index"] == ra["code_index"], i
        assert abs(rb["metric"] - ra["metric"]) < 0.01 * ra["metric"], i
    for i, s in enumerate(SATS):
        assert abs(ts.acq_results[i]["doppler"] - s["doppler"]) <= 50.0
    np.testing.assert_array_equal(ts.mode_host, js.mode_host)
    assert ts.mode_host[2] != MODE_TRACKING


def test_promotion_at_same_block(runs):
    _, _, prom_j = runs["jax"]
    ts, _, prom_t = runs["port"]
    assert prom_j is not None and prom_t == prom_j
    assert ts.promoted


def test_closed_loop_within_parity_gate(runs):
    _, out_j, _ = runs["jax"]
    _, out_t, _ = runs["port"]
    assert out_t.keys() == out_j.keys()
    visible = [0, 1]
    got = np.stack([out_t[k][:, visible] for k in parity.CORR_KEYS])
    ref = np.stack([out_j[k][:, visible] for k in parity.CORR_KEYS])
    res = parity.parity_metrics(got, ref)
    bounds = parity.PARITY_BOUNDS
    assert res["parity_scaled"] <= bounds["parity_scaled"], res
    lo, hi = bounds["prompt_ratio"]
    assert lo <= res["prompt_ratio"] <= hi, res
    rel = np.abs(got - ref) / (np.abs(ref) + 1.0)
    assert np.quantile(rel, 0.99) <= bounds["parity_metric"], res
    np.testing.assert_array_equal(out_t["active"], out_j["active"])


def test_final_loop_state_agrees(runs):
    _, out_j, _ = runs["jax"]
    _, out_t, _ = runs["port"]
    np.testing.assert_allclose(out_t["carrier_freq"][-1],
                               out_j["carrier_freq"][-1], atol=1.0)
    np.testing.assert_array_equal(out_t["flags"][-1], out_j["flags"][-1])
    for i, s in enumerate(SATS):
        assert out_t["flags"][-1, i] & FLAG_BIT_SYNC
        assert abs(out_t["carrier_freq"][-200:, i].mean() - s["doppler"]) < 5


def test_or_flags_and_reset_channel_in_place():
    """``or_flags`` and ``reset_channel`` touch only channel ``i``, and a
    reset demotes a promoted session to the pull-in configuration."""
    pull_in, cruise = _configs(TrackingConfig)
    s = TrackingSession(pull_in, PRNS, cruise=cruise,
                        device=torch.device("cpu"))
    s.state = dataclasses.replace(
        s.state, mode=torch.full((3,), MODE_TRACKING, dtype=torch.int32),
        carrier_freq=torch.tensor([1.0, 2.0, 3.0]),
        flags=torch.tensor([1, 1, 1], dtype=torch.int32))
    s.mode_host[:] = MODE_TRACKING
    s.or_flags(1, FLAG_BIT_SYNC)
    assert s.state.flags.tolist() == [1, 1 | FLAG_BIT_SYNC, 1]
    s._promote()
    assert s.cfg is cruise
    s.reset_channel(2)
    assert s.cfg is pull_in and not s.promoted
    assert s.state.carrier_freq.tolist() == [1.0, 2.0, 0.0]
    assert s.state.mode.tolist()[2] != MODE_TRACKING
    assert s.state.flags.tolist() == [1, 1 | FLAG_BIT_SYNC, 0]
    assert s.mode_host[2] != MODE_TRACKING


# chip_smoke.py's 70 Msps session: 8 channels, 4 visible at 45 dB-Hz,
# 300 ms at full rate (n = 70000, K2's Bluestein entry on the card), the
# scenario drawn as its make_scenario draws it from its seed.
SEED_70, FS_70, MS_70, CH_70 = 20261016, 70e6, 300, 8


def _scenario_70():
    rng = np.random.default_rng(SEED_70)
    prns = sorted(rng.choice(np.arange(1, CH_70 + 1), 4,
                             replace=False).tolist())
    dopplers = np.linspace(-4000.0, 4000.0, 4) + rng.uniform(-40.0, 40.0, 4)
    rng.shuffle(dopplers)
    sats = [dict(prn=p, doppler=float(d), code_phase=float(c))
            for p, d, c in zip(prns, dopplers, rng.uniform(0.0, 1023.0, 4))]
    gen = IQGenerator(FS_70, noise=True, seed=int(rng.integers(1 << 31)))
    for s in sats:
        gen.add_satellite(s["prn"], doppler_hz=s["doppler"],
                          code_phase_chips=s["code_phase"], cn0_dbhz=45.0,
                          nav_bits=rng.integers(0, 2, 300))
    iq = gen.generate_ms(MS_70)
    return sats, np.float32(iq.real), np.float32(iq.imag)


def _drive_70(session, re, im):
    outs, pos = [], 0
    while pos + session.block_input_samples <= len(re):
        n = session.block_input_samples
        outs.append(session.process_block(re[pos:pos + n], im[pos:pos + n]))
        pos += n
    return np.concatenate([np.asarray(o["carrier_freq"]) for o in outs])


@pytest.mark.slow
def test_session_at_70_msps_beside_jax():
    """chip_smoke.py's 70 Msps scenario through both sessions on the CPU
    (kaplan pull-in, 5 ms blocks; about 2 minutes and several GB): the
    same acquisition (Doppler bin and code index, within one bin and 7
    samples of the truth) and carrier tracks within 1 Hz over the first
    100 ms. Prints, per visible PRN, the carrier at 100-300 ms, its mean
    over the last 200 ms against the truth in each package, and the first
    millisecond at which the two tracks part by more than 1 Hz."""
    sats, re, im = _scenario_70()
    tracks, acqs = {}, {}
    for name, session_cls, config_cls, kw in (
            ("port", TrackingSession, TrackingConfig,
             dict(device=torch.device("cpu"))),
            ("jax", JaxSession, JaxConfig, {})):
        pull_in = config_cls(
            sampling_frequency=FS_70, input_decimate=1,
            window_size=round(FS_70 * 1e-3) + 256, runtime="batch",
            profile="kaplan", block_ms=5, quantize_spacing=True)
        cruise = dataclasses.replace(pull_in, kaplan_narrow_only=True,
                                     block_ms=20, superblock=50)
        session = session_cls(pull_in, list(range(1, CH_70 + 1)), None,
                              cruise=cruise, **kw)
        tracks[name] = _drive_70(session, re, im)
        acqs[name] = session.acq_results
    spms = round(FS_70 * 1e-3)
    at = (99, 149, 199, 249, MS_70 - 1)
    for s in sats:
        i = s["prn"] - 1
        a, b = acqs["port"][i], acqs["jax"][i]
        assert (a["doppler"], a["code_index"]) == (b["doppler"],
                                                   b["code_index"])
        truth_ci = round((-s["code_phase"]) % 1023.0 * spms / 1023.0) % spms
        assert abs(a["doppler"] - s["doppler"]) <= 100.0
        assert abs((a["code_index"] - truth_ci + spms // 2) % spms
                   - spms // 2) <= 7
        cf = {k: t[:, i] for k, t in tracks.items()}
        apart = np.flatnonzero(np.abs(cf["port"] - cf["jax"]) > 1.0)
        print(f"PRN {s['prn']} truth {s['doppler']:.1f} Hz, acquired "
              f"{a['doppler']:.0f}; " + "; ".join(
                  f"{k}: carrier at 100/150/200/250/300 ms "
                  f"{[round(float(v[j]), 1) for j in at]}, last 200 ms "
                  f"{float(v[-200:].mean()):.1f} ({abs(float(v[-200:].mean()) - s['doppler']):.1f} Hz off)"
                  for k, v in cf.items())
              + f"; tracks part by > 1 Hz from ms "
                f"{int(apart[0]) + 1 if len(apart) else None}")
        assert np.abs(cf["port"][:100] - cf["jax"][:100]).max() <= 1.0
