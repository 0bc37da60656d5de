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
