"""The port's production parity gate on CPU: its 4-block ``run_superblock``
(10 Msps, quantised taps) against the committed CPU truth of the JAX dense
path, ``tools/parity_truth.npz``, under the gate's bounds (metric 0.85,
scaled 0.15, prompt ratio [0.93, 1.07]), in both boundary forms of pass B
(K1 row sums and the K3 prefix form).

No JAX compile there: the truth is read from the file, as the JAX gate does
when its source key matches.

Pass A's scan form (``pass_a="scan"``, the oracle) against the compiled JAX
scan form and against the port's closed form, as tests/test_pass_a_closed.py
holds the two JAX forms: integer geometry exact, code phase within 2e-4
chips and carrier phase within 2e-2 rad.
"""

import dataclasses

import os

import numpy as np
import pytest
import torch

from sydr_tpu_torch import parity
from sydr_tpu_torch.channels import batch_runtime as br

torch.set_num_threads(2)

FS = 10e6
CPU = torch.device("cpu")

TRUTH = os.path.join(os.path.dirname(__file__), "..", "tools",
                     "parity_truth.npz")


def _truth():
    return np.load(TRUTH, allow_pickle=False)["superblock"]


@pytest.mark.parametrize("boundary_mode", ["rowsum", "prefix"])
def test_parity_gate_within_bounds(boundary_mode):
    res = parity.production_parity(_truth(), torch.device("cpu"),
                                   boundary_mode)
    assert res["parity_ok"], res


def test_parity_gate_setup_matches_jax_bounds():
    """The copied bounds and setup are the JAX gate's."""
    from tools import chip_parity

    assert parity.PARITY_BOUNDS["parity_metric"] == \
        chip_parity.PARITY_BOUNDS["parity_metric"]
    assert parity.PARITY_BOUNDS["parity_scaled"] == \
        chip_parity.PARITY_BOUNDS["parity_scaled"]
    assert list(parity.PARITY_BOUNDS["prompt_ratio"]) == \
        chip_parity.PARITY_BOUNDS["prompt_ratio"]
    for token in ("prns = [5, 12, 21]", "dops = [1200.0, -2600.0, 3900.0]",
                  "seed=4", "cn0_dbhz=48.0", "generate_ms(9)",
                  "generate_ms(15)", "block_ms=5, tail_ms=4",
                  'profile="borre"'):
        assert token in chip_parity.SETUP, token


def test_parity_gate_fails_on_one_chip_code_offset():
    """The gate gates: a 1-chip code misalignment (the fault the JAX gate's
    ablation injects) must fail it."""
    state, bits3x, sre, sim = parity.parity_setup(torch.device("cpu"))
    bits3x = torch.roll(bits3x, 1, dims=1)
    _, out = br.run_superblock(parity.CONFIG, 4, bits3x, state, sre, sim)
    got = np.stack([out[k].numpy() for k in parity.CORR_KEYS])
    res = parity.parity_metrics(got, _truth())
    assert not res["parity_ok"], res


def _tracking_leaves(n_ch=8, seed=0, unread_ms=5.5):
    """tests/test_pass_a_closed.py's random tracking state, as numpy."""
    from sydr_tpu_torch.channels.state import (
        MODE_TRACKING, init_state, state_to_numpy)

    rng = np.random.default_rng(seed)
    leaves = state_to_numpy(init_state(n_ch, CPU))
    leaves["mode"][:] = MODE_TRACKING
    leaves["carrier_freq"] = rng.uniform(-5000, 5000, n_ch).astype(np.float32)
    leaves["rem_code"] = rng.uniform(0, 1, n_ch).astype(np.float32)
    leaves["rem_carrier"] = rng.uniform(
        0, 2 * np.pi, n_ch).astype(np.float32)
    leaves["code_freq_offset"] = rng.uniform(-3, 3, n_ch).astype(np.float32)
    leaves["unread"][:] = int(unread_ms * FS * 1e-3)
    return leaves


def _pass_a_cfg(cls, **kw):
    base = dict(sampling_frequency=FS, block_ms=20, tail_ms=4,
                window_size=10240, runtime="batch")
    base.update(kw)
    return cls(**base)


def _assert_geometry(a, b, exact_phases=False):
    for k in ("required", "b_start", "consumed_end", "unread_end",
              "unread_after", "active"):
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)
    for k, tol in (("rem_code", 2e-4), ("rem_code_end", 2e-4),
                   ("rem_carrier", 2e-2), ("rem_carrier_end", 2e-2)):
        d = np.abs(np.asarray(a[k]) - np.asarray(b[k]))
        if "carrier" in k:  # circular
            d = np.minimum(d, 2 * np.pi - d)
        assert d.max() < (1e-5 if exact_phases and "code" in k else tol), \
            (k, d.max())


@pytest.mark.parametrize("seed, unread_ms", [
    (0, 5.5), (1, 5.5), (2, 5.5), (3, 5.5), (7, 4.9), (4, 0.3)])
def test_pass_a_scan_matches_jax_and_closed(seed, unread_ms):
    """tests/test_pass_a_closed.py's states (every epoch runs; 4.9 ms takes
    the availability clamp, 0.3 ms the small deficit): the port's scan form
    equals the compiled JAX scan form (code phase within 1e-5 chips: the
    same recurrence in the same rounding forms) and the port's closed
    form."""
    import jax.numpy as jnp

    from sydr_tpu.channels import batch_runtime as jbr
    from sydr_tpu.channels.runtime import TrackingConfig as JaxConfig
    from sydr_tpu.channels.state import ChannelState as JaxState
    from sydr_tpu_torch.channels.runtime import TrackingConfig
    from sydr_tpu_torch.channels.state import state_from_numpy

    leaves = _tracking_leaves(seed=seed, unread_ms=unread_ms)
    st = state_from_numpy(leaves, CPU)
    cfg = _pass_a_cfg(TrackingConfig, pass_a="scan")
    scan = {k: v.numpy() for k, v in br._pass_a(cfg, st).items()}
    jscan = jbr._pass_a_scan(
        _pass_a_cfg(JaxConfig, pass_a="scan"),
        JaxState(**{k: jnp.asarray(v) for k, v in leaves.items()}))
    assert scan.keys() == set(jscan)
    assert scan["active"].all()
    _assert_geometry(scan, jscan, exact_phases=True)
    for k in ("code_step", "omega", "delta"):
        np.testing.assert_allclose(scan[k], np.asarray(jscan[k]), rtol=1e-6)
    closed = br._pass_a(dataclasses.replace(cfg, pass_a="closed"), st)
    _assert_geometry(scan, {k: v.numpy() for k, v in closed.items()})


def test_pass_a_scan_runs_a_suffix_under_a_true_deficit():
    """The scan form's one semantic difference from the closed form
    (tests/test_pass_a_closed.py::test_true_deficit_is_all_or_nothing): a
    starving first epoch is skipped and the rest of the block runs, where
    the closed form defers the whole block."""
    from sydr_tpu_torch.channels.runtime import TrackingConfig
    from sydr_tpu_torch.channels.state import state_from_numpy

    leaves = _tracking_leaves(n_ch=3, seed=4)
    leaves["rem_code"][:] = 0.001
    leaves["code_freq_offset"][:] = -3.0
    leaves["carrier_freq"][:] = 0.0
    leaves["unread"][:] = 0
    st = state_from_numpy(leaves, CPU)
    cfg = _pass_a_cfg(TrackingConfig, pass_a="scan")
    scan = br._pass_a(cfg, st)
    active = scan["active"].numpy()
    assert (scan["required"][0].numpy() > cfg.samples_per_ms).all()
    assert not active[0].any() and active[1:].all()
    closed = br._pass_a(dataclasses.replace(cfg, pass_a="closed"), st)
    assert not closed["active"].numpy().any()


def test_pass_a_rejects_unknown_mode():
    from sydr_tpu_torch.channels.runtime import TrackingConfig
    from sydr_tpu_torch.channels.state import state_from_numpy

    st = state_from_numpy(_tracking_leaves(n_ch=2), CPU)
    with pytest.raises(ValueError, match="pass_a"):
        br._pass_a(_pass_a_cfg(TrackingConfig, pass_a="close"), st)


def test_run_block_batched_scan_form_tracks_closed_form():
    """``pass_a="scan"`` through ``run_block_batched`` on the parity
    gate's capture: where the closed form's integer geometry is the scan
    form's, the block's correlators and end state agree to float32
    rounding of the phases."""
    state, bits3x, sre, sim = parity.parity_setup(CPU)
    win = parity.CONFIG.window_samples
    outs = {}
    for form in ("closed", "scan"):
        cfg = dataclasses.replace(parity.CONFIG, pass_a=form)
        st, out = br.run_block_batched(cfg, bits3x, state, sre[:win],
                                       sim[:win])
        outs[form] = (st, out)
    (st_c, out_c), (st_s, out_s) = outs["closed"], outs["scan"]
    for k in ("active", "required", "unread"):
        np.testing.assert_array_equal(out_s[k].numpy(), out_c[k].numpy())
    got = np.stack([out_s[k].numpy() for k in parity.CORR_KEYS])
    ref = np.stack([out_c[k].numpy() for k in parity.CORR_KEYS])
    # a 2e-4 chip / 2e-2 rad phase difference at most, on ~1e4-sample sums
    assert np.abs(got - ref).max() <= 1.0 + 2e-2 * np.abs(ref).max()
    np.testing.assert_allclose(st_s.carrier_freq.numpy(),
                               st_c.carrier_freq.numpy(), atol=0.2)
