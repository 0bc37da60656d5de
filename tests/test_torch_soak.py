"""The port's soak (``sydr_tpu_torch.tools.soak``) beside the JAX one.

(a) Side by side: ``run_soak`` of both packages over 2 s of the soak's
    scenario at 4 Msps, decimate 2, ``chunk_ms`` 250 (the pull-in shape:
    both promote only at ~5 s, tests/test_torch_receiver.py). The fix count
    is exact (none yet: the demo sky's first fixes need ~14 s of
    subframes) and so is the truth Doppler drift; the prompt ratio and the
    steady C/N0 within 1% (the bound tests/test_torch_receiver.py holds the
    acquisition metric to: two float32 loops round their own way), the late
    C/N0 drift within 0.1 dB.
(b) The scenario stream made by worker processes
    (``soak.scenario_chunks``) equals the in-line ``generate_ms`` stream.
(c) Slow, as tests/test_soak.py: the four 300 s bounds on the port.
"""

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from sydr_tpu_torch.tools import soak as tsoak  # noqa: E402
from tools.soak import run_soak as jax_run_soak  # noqa: E402

torch.set_num_threads(2)
CPU = torch.device("cpu")
SIDE = dict(seconds=2, fs=4e6, decimate=2, superblock=25, chunk_ms=250)


@pytest.fixture(scope="module")
def side_by_side():
    return tsoak.run_soak(device=CPU, **SIDE), jax_run_soak(**SIDE)


def test_soak_side_by_side_fields_and_counts(side_by_side):
    port, ref = side_by_side
    assert port.keys() == ref.keys()
    for key in ("seconds", "fs", "decimate", "pallas", "superblock",
                "n_fixes", "fix_err_mean_m", "fix_err_max_m",
                "conv_err_max_m", "doppler_drift_hz"):
        assert port[key] == ref[key], (key, port[key], ref[key])


def test_soak_side_by_side_prompt_and_cn0(side_by_side):
    port, ref = side_by_side
    for key in ("prompt_ratio_late_vs_early", "cn0_steady_db"):
        assert abs(port[key] - ref[key]) <= 0.01 * abs(ref[key]), (
            key, port[key], ref[key])
    assert abs(port["cn0_late_minus_steady_db"]
               - ref["cn0_late_minus_steady_db"]) <= 0.1
    assert abs(port["prompt_ratio_late_vs_early"] - 1.0) < 0.2


def test_soak_signature_is_the_jax_tools_plus_device_and_chunks():
    import inspect

    from tools.soak import run_soak

    want = dict(inspect.signature(run_soak).parameters)
    got = dict(inspect.signature(tsoak.run_soak).parameters)
    assert list(got) == list(want) + ["device", "chunks"]
    for name, par in want.items():
        assert got[name].default == par.default, name


def test_worker_stream_equals_in_line_generation():
    fs, chunk_ms = 1.023e6, 250
    got = list(tsoak.scenario_chunks(1, fs, chunk_ms=chunk_ms, workers=2))
    scn = tsoak.demo_scenario(fs)
    assert len(got) == 4
    for re, im in got:
        want = scn.generate_ms(chunk_ms)
        np.testing.assert_array_equal(re, want.real.astype(np.float32))
        np.testing.assert_array_equal(im, want.imag.astype(np.float32))


def test_run_soak_reads_chunks_up_to_its_length():
    """``chunks`` feeds the receiver; reading stops at ``seconds``."""
    fs = 2e6
    scn = tsoak.demo_scenario(fs)
    fed = []

    def chunks():
        while True:
            iq = scn.generate_ms(500)
            fed.append(iq)
            yield iq

    res = tsoak.run_soak(seconds=1, fs=fs, decimate=2, device=CPU,
                         chunks=chunks())
    assert len(fed) == 2
    assert res["n_fixes"] == 0 and res["seconds"] == 1


@pytest.mark.slow
def test_soak_300s_bounds_on_the_port():
    """tests/test_soak.py's four bounds, on the port (CPU)."""
    soak = tsoak.run_soak(seconds=300, fs=10e6, decimate=4, superblock=25,
                          device=CPU)
    assert soak["n_fixes"] > 150, soak
    assert soak["fix_err_mean_m"] < 1.0, soak
    assert soak["fix_err_max_m"] < 3.0, soak
    assert abs(soak["prompt_ratio_late_vs_early"] - 1.0) < 0.2, soak
    assert abs(soak["cn0_late_minus_steady_db"]) < 1.5, soak
    assert soak["doppler_drift_hz"] > 50.0, soak
    assert tsoak.within_bounds(soak, 300), soak
