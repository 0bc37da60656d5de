"""The port's Monte-Carlo acquisition benchmark
(``sydr_tpu_torch.tools.acq_benchmark``) beside the JAX one.

(a) The four cases of tests/test_acq_benchmark.py, on the port (CPU).
(b) ``run_config`` side by side with ``tools.acq_benchmark.run_config`` at
    the same keyword arguments and seed: the trials are drawn on the host
    from one seed in both, so Pd, Pfa and the share of correct peaks are
    equal; the two-peak metric's mean and p10 within 1e-4 relative (two
    float32 FFTs, the port's torch.fft against the JAX package's matmul
    DFT); the RMS estimate errors within 1e-3.
"""

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from sydr_tpu_torch.tools.acq_benchmark import (  # noqa: E402
    render_table, run_config)
from tools.acq_benchmark import run_config as jax_run_config  # noqa: E402

torch.set_num_threads(2)
CPU = torch.device("cpu")
GRID = dict(sampling_frequency=2e6, coherent=4, non_coherent=3,
            doppler_range=3000.0, doppler_step=200.0, threshold=1.5)


def test_detection_at_strong_cn0():
    r = run_config(prn=13, cn0_dbhz=45.0, trials=6, seed=7, device=CPU,
                   **GRID)
    assert r["pd"] == 1.0
    assert r["metric_p10"] > 2.0
    assert r["code_rms_chips"] < 0.5
    assert r["doppler_rms_hz"] <= 120.0
    assert r["grid_pts_per_s"] > 0


def test_false_alarm_silent_without_signal():
    r = run_config(prn=13, cn0_dbhz=None, trials=6, seed=11, device=CPU,
                   **GRID)
    assert r["pfa"] == 0.0
    assert r["metric_mean"] < 1.4


def test_render_table_includes_rows():
    rows = [
        {"cn0_dbhz": 40.0, "coherent": 5, "non_coherent": 10, "pd": 0.9,
         "metric_mean": 2.5, "metric_p10": 2.0, "doppler_rms_hz": 30.0,
         "code_rms_chips": 0.2},
        {"cn0_dbhz": None, "trials": 8, "coherent": 5, "non_coherent": 10,
         "pfa": 0.125, "metric_mean": 1.1, "metric_p10": 1.0},
    ]
    out = render_table(rows, 1.5)
    assert "| 40 | 5x10 | 0.90 |" in out
    assert "Pfa = 1/8 trials" in out


def test_seed_reproducible():
    kw = dict(prn=2, cn0_dbhz=42.0, trials=4, seed=3, device=CPU, **GRID)
    a = run_config(**kw)
    b = run_config(**kw)
    for k in ("pd", "metric_mean", "metric_p10"):
        assert np.isclose(a[k], b[k])


@pytest.mark.parametrize("cn0_dbhz,nav_bits,seed", [
    (45.0, False, 7), (33.0, True, 330), (30.0, False, 300),
    (None, False, 11)])
def test_run_config_side_by_side_with_jax(cn0_dbhz, nav_bits, seed):
    kw = dict(prn=7, cn0_dbhz=cn0_dbhz, trials=8, seed=seed,
              nav_bits=nav_bits, **GRID)
    t = run_config(device=CPU, **kw)
    j = jax_run_config(**kw)
    for k in ("pd", "pfa", "p_correct_peak"):
        assert (k in t) == (k in j), k
        if k in j:
            assert t[k] == j[k], (k, t[k], j[k])
    for k in ("metric_mean", "metric_p10"):
        assert abs(t[k] - j[k]) <= 1e-4 * abs(j[k]), (k, t[k], j[k])
    for k in ("doppler_rms_hz", "code_rms_chips"):
        assert (k in t) == (k in j), k
        if k in j:
            assert abs(t[k] - j[k]) <= 1e-3, (k, t[k], j[k])
