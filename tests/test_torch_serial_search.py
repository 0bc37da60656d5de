"""The port's serial-search acquisition against the JAX one.

``code_shift_matrix`` must be equal. ``serial_search`` runs the same
samples and bins through the compiled JAX function (JAX on CPU) and the
port: the map within 1e-4 of its maximum (two float32 matrix products
summing 2000 terms in different orders; the squares make that ~4e-6 of the
peak in practice), the same peak cell, and ``peak_metric_ss`` within 1e-3
relative on either map. A serial-search ``TrackingSession`` runs side by
side with the JAX one (tests/test_serial_search.py's session, made
shorter): acquisition results equal (metric within 1%), then the
scan-runtime closed loop within tests/test_torch_scan_runtime.py's session
bounds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sydr_tpu.channels.runtime import TrackingConfig as JaxConfig
from sydr_tpu.ops import acquisition as jacq
from sydr_tpu.receiver.session import AcquisitionConfig as JaxAcqConfig
from sydr_tpu.receiver.session import TrackingSession as JaxSession
from sydr_tpu_torch.channels.runtime import TrackingConfig
from sydr_tpu_torch.channels.state import MODE_TRACKING
from sydr_tpu_torch.ops import acq_kernel
from sydr_tpu_torch.ops import acquisition as tacq
from sydr_tpu_torch.receiver.session import AcquisitionConfig, TrackingSession
from sydr_tpu_torch.signal.synthetic import IQGenerator

torch.set_num_threads(2)

FS = 2e6
CPU = torch.device("cpu")


def _padded(bins):
    pad = (-len(bins)) % 8
    return np.concatenate([bins, np.repeat(bins[-1:], pad)])


def _case(prn_signal, prn_search, doppler, code_phase, seed, cn0):
    gen = IQGenerator(FS, noise=True, seed=seed)
    gen.add_satellite(prn_signal, doppler_hz=doppler,
                      code_phase_chips=code_phase, cn0_dbhz=cn0)
    iq = gen.generate_ms(1)
    re, im = np.float32(iq.real), np.float32(iq.imag)
    shift = jacq.code_shift_matrix(prn_search, FS)
    bins = jacq.doppler_bins(3000, 250)              # 25 bins
    ref = np.asarray(jacq.serial_search(
        re, im, shift, _padded(bins), sampling_frequency=FS))[:len(bins)]
    got = tacq.serial_search(
        torch.from_numpy(re), torch.from_numpy(im), torch.from_numpy(shift),
        torch.from_numpy(bins), sampling_frequency=FS)
    return bins, ref, got


def test_code_shift_matrix_equals_jax():
    for prn, fs in ((7, 2e6), (22, 2.5e6)):
        a = tacq.code_shift_matrix(prn, fs)
        assert a.dtype == np.float32 and a.shape == (round(fs * 1e-3), 1023)
        np.testing.assert_array_equal(a, jacq.code_shift_matrix(prn, fs))


@pytest.mark.parametrize("present", [True, False])
def test_serial_search_matches_jax(present):
    """tests/test_serial_search.py's two cases: PRN 7 at 50 dB-Hz found at
    its Doppler bin and chip shift 1023 - 200, and an absent PRN below the
    metric that a present one exceeds."""
    if present:
        bins, ref, got = _case(7, 7, 1500.0, 200.0, 5, 50.0)
    else:
        bins, ref, got = _case(1, 22, 500.0, 0.0, 6, 48.0)
    assert got.shape == ref.shape == (len(bins), 1023)
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - ref).max() <= 1e-4 * ref.max()
    (fi_r, ci_r), m_r = jacq.peak_metric_ss(jnp.asarray(ref))
    for cmap in (got, torch.from_numpy(ref.copy())):
        (fi, ci), metric = tacq.peak_metric_ss(cmap)
        assert (int(fi), int(ci)) == (int(fi_r), int(ci_r))
        assert abs(float(metric) - float(m_r)) <= 1e-3 * float(m_r)
    if present:
        assert abs(float(bins[int(fi)]) - 1500.0) <= 125.0
        assert abs(int(ci) - 823) <= 1
        assert float(metric) > 2.0
    else:
        assert float(metric) < 2.0


def test_peak_metric_ss_first_maximum_and_exclusion_box():
    """Two equal maxima: the first (row-major) is the peak, as
    ``jnp.argmax`` takes it; the second peak is the largest cell outside
    the 3x3 box around it."""
    rng = np.random.default_rng(0)
    cmap = rng.uniform(0, 1, (9, 1023)).astype(np.float32)
    cmap[2, 40] = cmap[6, 900] = 9.0
    cmap[3, 41] = 8.0                       # inside the box: excluded
    cmap[2, 42] = 3.0                       # outside it
    (fi, ci), metric = tacq.peak_metric_ss(torch.from_numpy(cmap))
    (fi_r, ci_r), m_r = jacq.peak_metric_ss(jnp.asarray(cmap))
    assert (int(fi), int(ci)) == (int(fi_r), int(ci_r)) == (2, 40)
    assert float(metric) == float(m_r) == 1.0


SESSION_FS = 4e6
SESSION_MS = 600


def _drive(session):
    gen = IQGenerator(SESSION_FS, noise=True, seed=9)
    gen.add_satellite(5, doppler_hz=1250.0, code_phase_chips=321.4,
                      cn0_dbhz=48.0)
    outs = []
    for _ in range(SESSION_MS // 20):
        iq = gen.generate_ms(20)
        outs.append(session.process_block(np.float32(iq.real),
                                          np.float32(iq.imag)))
    return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}


@pytest.fixture(scope="module")
def sessions():
    kw = dict(sampling_frequency=SESSION_FS, block_ms=20, tail_ms=4,
              window_size=4224)
    # One code period's two-peak power metric reads ~2.1 on this signal
    # and up to ~1.55 on noise alone within these retries: 1.8 keeps the
    # absent PRN out where the default 1.5 would not.
    acq = dict(method="serial", doppler_step=250.0, threshold=1.8)
    js = JaxSession(JaxConfig(**kw), [5, 17], JaxAcqConfig(**acq))
    ts = TrackingSession(TrackingConfig(**kw), [5, 17],
                         AcquisitionConfig(**acq), device=CPU)
    before = acq_kernel.KERNEL.launches
    out = js, _drive(js), ts, _drive(ts)
    assert acq_kernel.KERNEL.launches == before
    return out


def test_serial_session_acquires_as_jax(sessions):
    """PRN 5 is found in the first block (one code period of history is
    all a serial search needs); the absent PRN 17 keeps re-arming."""
    js, _, ts, _ = sessions
    assert ts.acq_cfg.required_ms == 1
    assert len(ts._hist_re) == round(SESSION_FS * 1e-3)
    np.testing.assert_array_equal(ts._hist_re, js._hist_re)
    assert set(ts.acq_results) == set(js.acq_results) == {0, 1}
    for i, ra in js.acq_results.items():
        rb = ts.acq_results[i]
        assert rb.keys() == ra.keys()
        assert rb["doppler"] == ra["doppler"], i
        assert rb["code_index"] == ra["code_index"], i
        assert abs(rb["metric"] - ra["metric"]) < 0.01 * ra["metric"], i
    assert ts.acq_results[0]["metric"] > 2.0
    assert abs(ts.acq_results[0]["doppler"] - 1250.0) <= 125.0
    np.testing.assert_array_equal(ts.mode_host, js.mode_host)
    assert ts.mode_host[0] == MODE_TRACKING
    assert ts.mode_host[1] != MODE_TRACKING
    assert ts._acq_retry_at.keys() == js._acq_retry_at.keys() == {1}
    # the found PRN's shift matrix is dropped, the retrying one's is kept
    assert set(ts._shift_matrices) == {1}


def test_serial_session_tracks_as_jax(sessions):
    _, out_j, _, out_t = sessions
    for k in ("active", "flags", "required"):
        np.testing.assert_array_equal(out_t[k], out_j[k], err_msg=k)
    np.testing.assert_allclose(out_t["carrier_freq"], out_j["carrier_freq"],
                               atol=1.0)
    assert abs(out_t["carrier_freq"][-100:, 0].mean() - 1250.0) < 10.0
    ip_t = np.abs(out_t["i_prompt"][-200:, 0]).mean()
    ip_j = np.abs(out_j["i_prompt"][-200:, 0]).mean()
    assert abs(ip_t - ip_j) < 0.01 * ip_j
