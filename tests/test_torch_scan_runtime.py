"""The port's per-ms scan runtime against the JAX one: ``epl_correlate``,
``run_block`` and a whole scan-runtime ``TrackingSession``.

The same numpy-seeded windows and channel states go through the compiled
JAX functions (JAX on CPU, its default ``epl_method="bitpack"``, whose
chips equal the gather form's by construction) and through the port, which
keeps the one gather form.

Tolerances. Correlators follow tests/test_torch_correlator_kernel.py's tie
rule: ``rtol 2e-3, atol 1.0`` on at least 95% of them, every one within
two chip-boundary ties (a sample whose chip index lies within one float32
rounding of an integer takes the chip on either side; one tie moves a
correlator by twice that sample's magnitude). Integers (``required``,
``unread``, ``flags``, ``bit_edge``, ``active``) must be equal: the port
writes the compiled reference's rounding forms for the epoch length
(``runtime.scan_phase_advance``). Loop floats are held within what the
correlators' float32 sums in another order allow: code phase within 1e-5
chips, carrier within 0.05 Hz over a few blocks, and within 1 Hz over a
closed-loop session (tests/test_torch_session.py's bound).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sydr_tpu.channels import runtime as jrt
from sydr_tpu.channels.state import MODE_TRACKING, code_table
from sydr_tpu.channels.state import init_state as jax_init
from sydr_tpu.ops import tracking as jtrk
from sydr_tpu.receiver.session import TrackingSession as JaxSession
from sydr_tpu_torch import parity
from sydr_tpu_torch.channels import runtime as trt
from sydr_tpu_torch.channels.state import FLAG_BIT_SYNC, state_from_numpy
from sydr_tpu_torch.ops import tracking as ttrk
from sydr_tpu_torch.parallel import mesh as pmesh
from sydr_tpu_torch.receiver.session import TrackingSession
from sydr_tpu_torch.signal.synthetic import IQGenerator

torch.set_num_threads(2)

CPU = torch.device("cpu")
CORR_KEYS = ("i_early", "q_early", "i_prompt", "q_prompt", "i_late",
             "q_late")
PRNS = [5, 12, 21]
DOPPLERS = [1200.0, -2600.0, 3900.0]


def assert_tie_rule(got, ref, peak_sample):
    err = np.abs(got - ref)
    outside = err > 1.0 + 2e-3 * np.abs(ref)
    assert outside.mean() <= 0.05, (outside.mean(), err.max())
    assert err.max() <= 1.0 + 2 * (2.0 * peak_sample), err.max()


@pytest.mark.parametrize("fs, spacings", [
    (2.5e6, (-0.5, 0.0, 0.5)),
    (4e6, (-0.5, -0.2, 0.0, 0.2, 0.5)),
    (10e6, (-0.5, 0.0, 0.5)),
])
def test_epl_correlate_matches_jax(fs, spacings):
    """32 random channels: windows, code phases and rates from a numpy seed
    through the compiled JAX correlator (bitpack and gather forms, mapped
    over channels) and the port's batched gather."""
    n_ch = 32
    spms = round(fs * 1e-3)
    w = spms + 240
    rng = np.random.default_rng(int(fs) % 1000 + len(spacings))
    wre = rng.normal(0, 1, (n_ch, w)).astype(np.float32)
    wim = rng.normal(0, 1, (n_ch, w)).astype(np.float32)
    codes = code_table([(i % 32) + 1 for i in range(n_ch)])
    cf = rng.uniform(-5000, 5000, n_ch).astype(np.float32)
    rem_ca = rng.uniform(0, 2 * np.pi, n_ch).astype(np.float32)
    rem_co = rng.uniform(0, 1, n_ch).astype(np.float32)
    step = ((1.023e6 + rng.uniform(-5, 5, n_ch)) / fs).astype(np.float32)
    # The epoch's length, as the runtime derives it: to the code period's
    # end, so that no chip index leaves the padded code.
    required = np.ceil((np.float32(1023.0) - rem_co) / step).astype(np.int32)

    got = ttrk.epl_correlate(
        *(torch.from_numpy(a) for a in (wre, wim, codes, required, cf,
                                        rem_ca, rem_co, step)),
        spacings=spacings, sampling_frequency=fs).numpy()
    assert got.shape == (n_ch, 2 * len(spacings))
    for method in ("bitpack", "gather"):
        one = jax.jit(jax.vmap(lambda *a: jtrk.epl_correlate(
            *a, spacings=spacings, sampling_frequency=fs, method=method)))
        ref = np.asarray(one(wre, wim, codes, required, cf, rem_ca, rem_co,
                             step))
        assert_tie_rule(got, ref, max(np.abs(wre).max(), np.abs(wim).max()))
    # Samples beyond ``required`` are masked: garbage there changes nothing.
    wre2 = wre.copy()
    for i in range(n_ch):
        wre2[i, required[i]:] = 1e6
    again = ttrk.epl_correlate(
        *(torch.from_numpy(a) for a in (wre2, wim, codes, required, cf,
                                        rem_ca, rem_co, step)),
        spacings=spacings, sampling_frequency=fs).numpy()
    np.testing.assert_array_equal(again, got)


def test_mix_and_advance_carrier_match_jax():
    rng = np.random.default_rng(3)
    fs, n_ch, w = 4e6, 5, 4000
    wre = rng.normal(0, 1, (n_ch, w)).astype(np.float32)
    wim = rng.normal(0, 1, (n_ch, w)).astype(np.float32)
    cf = rng.uniform(-5000, 5000, n_ch).astype(np.float32)
    rem = rng.uniform(0, 2 * np.pi, n_ch).astype(np.float32)
    got = ttrk.mix_carrier(*(torch.from_numpy(a) for a in
                             (wre, wim, cf, rem)), fs)
    ref = jax.vmap(lambda a, b, c, d: jtrk.mix_carrier(a, b, c, d, fs))(
        wre, wim, cf, rem)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=2e-4)
    n_samp = rng.integers(3990, 4010, n_ch).astype(np.int32)
    adv = ttrk.advance_carrier_phase(
        torch.from_numpy(rem), torch.from_numpy(cf),
        torch.from_numpy(n_samp), fs).numpy()
    adv_ref = np.asarray(jtrk.advance_carrier_phase(rem, cf, n_samp, fs))
    d = np.abs(adv - adv_ref)
    assert np.minimum(d, 2 * np.pi - d).max() < 1e-4
    assert (adv >= 0).all() and (adv < 2 * np.pi + 1e-6).all()


def _tracking_setup(fs, block_ms, n_blocks, profile):
    """PRNs 5/12/21 tracking from a hand-made acquisition state
    (tests/test_correlator_kernel.py's), and ``n_blocks`` windows."""
    gen = IQGenerator(fs, noise=True, seed=4)
    for prn, dop in zip(PRNS, DOPPLERS):
        gen.add_satellite(prn, doppler_hz=dop, code_phase_chips=100.0,
                          cn0_dbhz=48.0)
    spms = round(fs * 1e-3)
    iq = gen.generate_ms(4 + block_ms * n_blocks)
    n = len(PRNS)
    st = dataclasses.replace(
        jax_init(n),
        mode=jnp.full((n,), MODE_TRACKING, jnp.int32),
        carrier_freq=jnp.asarray(np.float32(DOPPLERS)),
        freq_anchor=jnp.asarray(np.float32(DOPPLERS)),
        rem_code=jnp.asarray(np.float32([0.02, 0.7, 0.4])),
        rem_carrier=jnp.asarray(np.float32([0.3, 2.1, 5.0])),
        code_freq_offset=jnp.asarray(np.float32([0.5, -1.2, 2.0])),
        unread=jnp.asarray(np.int32(
            [int(1.1 * spms), int(1.4 * spms), int(1.2345 * spms)])),
        # past the bit-sync arming delay, so the histogram runs
        code_counter=jnp.full((n,), 150, jnp.int32),
        pll_lock=jnp.full((n,), 0.9, jnp.float32),
    )
    cfg = dict(sampling_frequency=fs, block_ms=block_ms, tail_ms=4,
               window_size=spms + 240, runtime="scan", profile=profile)
    return cfg, st, np.float32(iq.real), np.float32(iq.imag)


@pytest.mark.parametrize("fs, profile", [
    (2.5e6, "borre"), (2.5e6, "kaplan"), (4e6, "borre"), (4e6, "kaplan")])
def test_run_block_matches_jax(fs, profile):
    """Three blocks of 10 ms, each package carrying its own state."""
    block_ms, n_blocks = 10, 3
    cfg, jst, re, im = _tracking_setup(fs, block_ms, n_blocks, profile)
    spms = round(fs * 1e-3)
    tst = state_from_numpy(
        {f.name: np.asarray(getattr(jst, f.name))
         for f in dataclasses.fields(jst)}, CPU)
    jcfg, tcfg = jrt.TrackingConfig(**cfg), trt.TrackingConfig(**cfg)
    jcodes = jnp.asarray(code_table(PRNS))
    tcodes = torch.from_numpy(code_table(PRNS))
    outs_j, outs_t = [], []
    for b in range(n_blocks):
        sl = slice(b * block_ms * spms, (b * block_ms + 4 + block_ms) * spms)
        jst, oj = jrt.run_block(jcfg, jcodes, jst, jnp.asarray(re[sl]),
                                jnp.asarray(im[sl]))
        tst, ot = trt.run_block(tcfg, tcodes, tst, torch.from_numpy(re[sl]),
                                torch.from_numpy(im[sl]))
        outs_j.append({k: np.asarray(v) for k, v in oj.items()})
        outs_t.append({k: v.numpy() for k, v in ot.items()})
    out_j = {k: np.concatenate([o[k] for o in outs_j]) for k in outs_j[0]}
    out_t = {k: np.concatenate([o[k] for o in outs_t]) for k in outs_t[0]}

    assert out_t.keys() == out_j.keys()
    for k in out_j:
        assert out_t[k].shape == out_j[k].shape == (30, 3), k
        assert out_t[k].dtype == out_j[k].dtype, k
    assert out_j["active"].all()
    for k in ("active", "required", "unread", "flags", "lock_state",
              "bit_ready"):
        np.testing.assert_array_equal(out_t[k], out_j[k], err_msg=k)
    for name in ("unread", "flags", "bit_edge", "ms_counter", "edge_hist",
                 "code_counter", "accum_count", "lock_state", "mode"):
        np.testing.assert_array_equal(
            getattr(tst, name).numpy(), np.asarray(getattr(jst, name)),
            err_msg=name)
    assert_tie_rule(np.stack([out_t[k] for k in CORR_KEYS]),
                    np.stack([out_j[k] for k in CORR_KEYS]),
                    max(np.abs(re).max(), np.abs(im).max()))
    np.testing.assert_allclose(out_t["rem_code"], out_j["rem_code"],
                               atol=1e-5)
    np.testing.assert_allclose(out_t["carrier_freq"], out_j["carrier_freq"],
                               atol=0.05)
    np.testing.assert_allclose(out_t["code_freq"], out_j["code_freq"],
                               rtol=1e-7)
    np.testing.assert_allclose(tst.freq_anchor.numpy(),
                               np.asarray(jst.freq_anchor), atol=0.05)
    d = np.abs(tst.rem_carrier.numpy() - np.asarray(jst.rem_carrier))
    assert np.minimum(d, 2 * np.pi - d).max() < 1e-3


def test_scan_last_epoch_not_clamped():
    """tests/test_batch_runtime.py's regression on the port: with leftover
    unread below ``window_size - samples_per_ms`` the last epoch's window
    read runs into the zero pad instead of being shifted back, so every
    epoch, the last included, correlates fully; and the block equals JAX's."""
    fs = 10e6
    kw = dict(sampling_frequency=fs, block_ms=20, tail_ms=4,
              window_size=10240, runtime="scan")
    cfg = trt.TrackingConfig(**kw)
    spms = cfg.samples_per_ms
    step = 1023.0 / spms
    rem_code, unread0 = 0.5, 100      # leftover < window_size - spms = 240
    a0 = (cfg.tail_ms + 1) * spms - (unread0 + spms)
    gen = IQGenerator(fs, noise=False)
    gen.add_satellite(1, doppler_hz=0.0,
                      code_phase_chips=(rem_code - a0 * step) % 1023.0,
                      cn0_dbhz=None, code_doppler=False)
    iq = gen.generate_ms(cfg.tail_ms + cfg.block_ms)
    re, im = np.float32(iq.real), np.float32(iq.imag)

    jst = dataclasses.replace(
        jax_init(1), mode=jnp.full((1,), MODE_TRACKING, jnp.int32),
        rem_code=jnp.full((1,), rem_code, jnp.float32),
        unread=jnp.full((1,), unread0, jnp.int32))
    tst = state_from_numpy(
        {f.name: np.asarray(getattr(jst, f.name))
         for f in dataclasses.fields(jst)}, CPU)
    _, out = trt.run_block(cfg, torch.from_numpy(code_table([1])), tst,
                           torch.from_numpy(re), torch.from_numpy(im))
    ip = out["i_prompt"].numpy()[:, 0]
    assert out["active"].numpy().all()
    assert ip.min() > 0.9 * ip.max(), ip
    assert ip[-1] > 0.9 * spms
    _, out_j = jrt.run_block(jrt.TrackingConfig(**kw),
                             jnp.asarray(code_table([1])), jst, re, im)
    np.testing.assert_array_equal(out["required"].numpy(),
                                  np.asarray(out_j["required"]))
    np.testing.assert_allclose(ip, np.asarray(out_j["i_prompt"])[:, 0],
                               rtol=2e-3, atol=1.0)


FS = 4e6
SATS = [dict(prn=5, doppler=1200.0, code_phase=321.4),
        dict(prn=12, doppler=-2600.0, code_phase=811.9)]
SESSION_PRNS = [5, 12, 20]         # PRN 20 is absent from the signal
SESSION_MS = 1200


def _drive(session):
    bits = np.random.default_rng(11).integers(0, 2, 200)
    gen = IQGenerator(FS, noise=True, seed=11)
    for s in SATS:
        gen.add_satellite(s["prn"], doppler_hz=s["doppler"],
                          code_phase_chips=s["code_phase"], cn0_dbhz=46.0,
                          nav_bits=bits)
    outs = []
    for _ in range(SESSION_MS // 20):
        iq = gen.generate_ms(20)
        outs.append(session.process_block(np.float32(iq.real),
                                          np.float32(iq.imag)))
    return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}


@pytest.fixture(scope="module")
def sessions():
    """tests/test_batch_runtime.py's scan session (4 Msps, borre, 20 ms
    blocks, the package default ``runtime="scan"``) in both packages."""
    kw = dict(sampling_frequency=FS, block_ms=20, tail_ms=4,
              window_size=4224)
    js = JaxSession(jrt.TrackingConfig(**kw), SESSION_PRNS)
    ts = TrackingSession(trt.TrackingConfig(**kw), SESSION_PRNS, device=CPU)
    assert ts.cfg.runtime == "scan"
    return js, _drive(js), ts, _drive(ts)


def test_scan_session_acquisition_identical(sessions):
    js, _, ts, _ = sessions
    assert set(js.acq_results) == set(ts.acq_results) == {0, 1, 2}
    for i, ra in js.acq_results.items():
        rb = ts.acq_results[i]
        assert rb["doppler"] == ra["doppler"], i
        assert rb["code_index"] == ra["code_index"], i
        assert abs(rb["metric"] - ra["metric"]) < 0.01 * ra["metric"], i
    np.testing.assert_array_equal(ts.mode_host, js.mode_host)
    assert ts.mode_host[2] != MODE_TRACKING


def test_scan_session_closed_loop_matches_jax(sessions):
    _, out_j, _, out_t = sessions
    assert out_t.keys() == out_j.keys()
    for k in ("active", "flags", "bit_ready"):
        np.testing.assert_array_equal(out_t[k], out_j[k], err_msg=k)
    visible = [0, 1]
    got = np.stack([out_t[k][:, visible] for k in parity.CORR_KEYS])
    ref = np.stack([out_j[k][:, visible] for k in parity.CORR_KEYS])
    res = parity.parity_metrics(got, ref)
    bounds = parity.PARITY_BOUNDS
    assert res["parity_scaled"] <= bounds["parity_scaled"], res
    lo, hi = bounds["prompt_ratio"]
    assert lo <= res["prompt_ratio"] <= hi, res
    np.testing.assert_allclose(out_t["carrier_freq"], out_j["carrier_freq"],
                               atol=1.0)
    for i, s in enumerate(SATS):
        assert out_t["flags"][-1, i] & FLAG_BIT_SYNC
        assert abs(out_t["carrier_freq"][-200:, i].mean() - s["doppler"]) < 5


def test_scan_runtime_refuses_superblock():
    """Under a mesh (here a CPU mesh of one rank) a scan configuration of
    more than one block a call raises: the sharded step runs one scan
    block a call. Without a mesh the session takes it
    (``tests/test_torch_scan_superblock.py``)."""
    cfg = trt.TrackingConfig(sampling_frequency=FS, window_size=4224,
                             runtime="scan", superblock=4)
    with pytest.raises(ValueError, match="superblock"):
        TrackingSession(cfg, [5], device=CPU, mesh=pmesh.make_mesh(1, 1))
