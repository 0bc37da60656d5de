"""The port's tracking-sensitivity benchmark
(``sydr_tpu_torch.tools.track_benchmark``) beside the JAX one.

``run_trial`` of both packages at 45 dB-Hz, kaplan cruise, 4 Msps, with
``WARMUP_S`` / ``HOLD_S`` shortened to 1 s each by ``monkeypatch`` on both
modules (the hold still decodes 50 bits). Lock at the drop, retention, the
decoded bit count and the BER are equal; the float summaries are within
what two float32 loops that round their own way leave (1e-3 of PLL lock
indicator, 0.05 dB of C/N0 estimate, 0.01 cycles of net slip: measured
differences 8e-5, 2e-3 dB and 2e-4 cycles). ``render_table`` prints the
JAX tool's table from the same rows.
"""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import tools.track_benchmark as jtb  # noqa: E402
from sydr_tpu_torch.tools import track_benchmark as ttb  # noqa: E402

torch.set_num_threads(2)
SEED = ttb.trial_seed(0, 45.0, 0)


@pytest.fixture(scope="module")
def trials():
    with pytest.MonkeyPatch.context() as mp:
        for mod in (ttb, jtb):
            mp.setattr(mod, "WARMUP_S", 1.0)
            mp.setattr(mod, "HOLD_S", 1.0)
        port = ttb.run_trial(45.0, "kaplan", SEED, device=torch.device("cpu"))
        ref = jtb.run_trial(45.0, "kaplan", SEED)
    return port, ref


def test_run_trial_outcome_equals_jax(trials):
    port, ref = trials
    assert ref["locked_at_drop"] and ref["retained"], ref
    for key in ("locked_at_drop", "retained", "n_bits", "ber"):
        assert port[key] == ref[key], (key, port[key], ref[key])
    assert port["n_bits"] >= 40 and port["ber"] == 0.0


def test_run_trial_summaries_within_float32_spread(trials):
    port, ref = trials
    assert abs(port["pll_lock_mean"] - ref["pll_lock_mean"]) <= 1e-3
    assert abs(port["cn0_est_mean"] - ref["cn0_est_mean"]) <= 0.05
    assert abs(port["slip_cycles"] - ref["slip_cycles"]) <= 0.01


def test_trial_seed_is_the_sweeps():
    """``channel_sweep``'s seeds, as the JAX sweep derives them."""
    assert [ttb.trial_seed(5, 35.0, t) for t in range(3)] == \
        [5 + 3500, 5 + 3501, 5 + 3502]


@pytest.mark.parametrize("pvt", [False, True])
def test_render_table_format_is_the_jax_tools(pvt):
    if pvt:
        rows = [{"profile": "kaplan", "cn0_dbhz": 33.0, "fixes_late_10s": 9,
                 "availability": 0.9, "err_mean_m": 1.23},
                {"profile": "borre", "cn0_dbhz": 27.0, "fixes_late_10s": 0,
                 "availability": 0.0, "err_mean_m": None}]
    else:
        rows = [{"profile": "kaplan", "cn0_dbhz": 45.0, "retention": 1.0,
                 "pll_lock_mean": 0.94, "cn0_est_mean": 44.6,
                 "slipped_frac": 0.0, "ber_mean": 0.0},
                {"profile": "borre", "cn0_dbhz": 35.0, "retention": 0.67,
                 "pll_lock_mean": 0.12, "cn0_est_mean": 11.5,
                 "slipped_frac": 1.0, "ber_mean": 0.442}]
    out = ttb.render_table(rows, pvt=pvt)
    assert out == jtb.render_table(rows, pvt=pvt)
    assert out.splitlines()[0].startswith("| profile | C/N0 [dB-Hz] |")
    assert ("| kaplan | 33 | 9 | 0.90 | 1.23 |" if pvt
            else "| kaplan | 45 | 1.00 | 0.94 | 44.6 | 0.00 | 0.000 |") in out
