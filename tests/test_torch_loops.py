"""Port's per-epoch loop arithmetic against the JAX package on random states.

``loop_update`` (borre, kaplan, kaplan narrow-only; with and without the
batched runtime's virtual-NCO compensation), the discriminators, the C/N0
estimators and the bit-sync declaration rule get the same numpy-seeded
inputs in both packages. Tolerance: float32 rounding (``rtol 1e-5``,
``atol 1e-5``) — the two sides evaluate the same float32 expressions, but
XLA fuses multiply-adds and its ``atan``/``log10`` differ from PyTorch's
in the last ulp; integer outputs (lock state, bit-sync declarations) must
be equal.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sydr_tpu.channels import runtime as jrt
from sydr_tpu.ops import profiles as jprof
from sydr_tpu.ops import tracking as jtrk
from sydr_tpu_torch.channels import runtime as trt
from sydr_tpu_torch.ops import profiles as tprof
from sydr_tpu_torch.ops import tracking as ttrk

torch.set_num_threads(2)

N = 64
TOL = dict(rtol=1e-5, atol=1e-5)


def _state(rng):
    f = lambda lo, hi: rng.uniform(lo, hi, N).astype(np.float32)  # noqa
    return {
        "dll_memory": f(-0.5, 0.5), "pll_memory": f(-0.2, 0.2),
        "fll_vel": f(-5, 5), "fll_acc": f(-1, 1),
        "i_prompt_prev": f(-200, 200), "q_prompt_prev": f(-200, 200),
        "pll_lock": f(-1, 1), "fll_lock": f(0, 1),
        "lock_state": rng.integers(0, 3, N).astype(np.int32),
        "code_counter": rng.integers(0, 4, N).astype(np.int32),
    }


def _both(leaves):
    jst = types.SimpleNamespace(**{k: jnp.asarray(v) for k, v in leaves.items()})
    tst = types.SimpleNamespace(
        **{k: torch.from_numpy(v.copy()) for k, v in leaves.items()})
    return jst, tst


@pytest.mark.parametrize("profile, narrow_only, dlf_order, fll", [
    ("borre", False, 2, "atan"),
    ("kaplan", False, 2, "atan"),
    ("kaplan", False, 3, "atan2"),
    ("kaplan", True, 2, "atan"),
])
@pytest.mark.parametrize("with_comp", [False, True])
def test_loop_update_matches_jax(profile, narrow_only, dlf_order, fll,
                                 with_comp):
    rng = np.random.default_rng(7)
    n_sp = 3 if (profile == "borre" or narrow_only) else 5
    corr = rng.normal(0, 100, (N, 2 * n_sp)).astype(np.float32)
    corr[:3] = 0.0                        # exercise the zero guards
    active = rng.random(N) > 0.2
    leaves = _state(rng)
    kw = dict(profile=profile, kaplan_narrow_only=narrow_only,
              dlf_order=dlf_order, fll_discriminator=fll, runtime="batch",
              block_ms=5)
    jst, tst = _both(leaves)
    comp = None
    if with_comp:
        comp = {k: rng.normal(0, s, N).astype(np.float32)
                for k, s in (("freq", 20.0), ("phase", 0.2), ("code", 0.05))}
    out_j = jprof.loop_update(
        jrt.TrackingConfig(**kw), jnp.asarray(corr), jst, jnp.asarray(active),
        comp=None if comp is None else {k: jnp.asarray(v)
                                        for k, v in comp.items()})
    out_t = tprof.loop_update(
        trt.TrackingConfig(**kw), torch.from_numpy(corr), tst,
        torch.from_numpy(active),
        comp=None if comp is None else {k: torch.from_numpy(v)
                                        for k, v in comp.items()})
    assert set(out_j) == set(out_t)
    for key in out_j:
        a, b = np.asarray(out_j[key]), out_t[key].numpy()
        if key == "lock_state":
            np.testing.assert_array_equal(b, a, err_msg=key)
        else:
            np.testing.assert_allclose(b, a, err_msg=key, **TOL)


def test_discriminators_and_cn0_match_jax():
    rng = np.random.default_rng(11)
    x = [rng.normal(0, 50, N).astype(np.float32) for _ in range(4)]
    x[0][:4] = 0.0
    x[2][4:8] = 0.0
    jx = [jnp.asarray(v) for v in x]
    tx = [torch.from_numpy(v) for v in x]
    pairs = [
        (jtrk.dll_nneml(*jx), ttrk.dll_nneml(*tx)),
        (jtrk.pll_costas(jx[0], jx[1]), ttrk.pll_costas(tx[0], tx[1])),
        (jtrk.fll_atan(*jx, 1e-3), ttrk.fll_atan(*tx, 1e-3)),
        (jtrk.fll_atan2(*jx, 1e-3), ttrk.fll_atan2(*tx, 1e-3)),
        (jtrk.pll_lock_indicator(jx[0], jx[1], jx[2] / 100),
         ttrk.pll_lock_indicator(tx[0], tx[1], tx[2] / 100)),
        (jtrk.fll_lock_indicator(*jx, jx[0] / 100),
         ttrk.fll_lock_indicator(*tx, tx[0] / 100)),
        (jtrk.beaulieu_ratio_term(*jx), ttrk.beaulieu_ratio_term(*tx)),
    ]
    sums = [np.abs(v) * k for v, k in zip(x, (20, 20, 400, 400))]
    for est in ("nwpr", "beaulieu"):
        cfg_j = jrt.TrackingConfig(cn0_estimator=est)
        cfg_t = trt.TrackingConfig(cn0_estimator=est)
        done = rng.random(N) > 0.5
        prev = rng.uniform(20, 50, N).astype(np.float32)
        ratio = rng.uniform(0, 2, N).astype(np.float32)
        pairs.append((
            jtrk.cn0_update(cfg_j, jnp.asarray(done),
                            *[jnp.asarray(s) for s in sums],
                            jnp.asarray(ratio), jnp.asarray(prev)),
            ttrk.cn0_update(cfg_t, torch.from_numpy(done),
                            *[torch.from_numpy(s) for s in sums],
                            torch.from_numpy(ratio), torch.from_numpy(prev))))
    for i, (a, b) in enumerate(pairs):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), err_msg=str(i),
                                   rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("unanimous", [0, 5])
def test_bit_sync_declare_matches_jax(unanimous):
    rng = np.random.default_rng(3)
    hist = rng.integers(0, 4, (256, 20)).astype(np.int32)
    hist[::3] = 0
    hist[::3, 7] = rng.integers(0, 12, hist[::3].shape[0])   # unanimous rows
    hist[1::5, 3] += 9                                       # dominant rows
    kw = dict(bit_sync_unanimous=unanimous)
    a = jrt._bit_sync_declare(jrt.TrackingConfig(**kw), jnp.asarray(hist))
    b = trt._bit_sync_declare(trt.TrackingConfig(**kw), torch.from_numpy(hist))
    np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert 0 < int(np.asarray(a).sum()) < len(hist)
