"""Port's pass B (K1 ``epoch_correlate``) against the JAX batched runtime.

The same numpy-seeded window and channel state go through JAX
``run_block_batched`` (its Pallas row-sum kernel in interpret mode, and its
dense XLA path) and through the port's ``run_block_batched``, whose pass B
runs ``epoch_correlate_ref`` on CPU tensors. Tolerance ``rtol 2e-3, atol
1.0`` is the JAX package's own kernel-vs-dense budget
(tests/test_correlator_kernel.py), and it holds for at least 95% of the
correlators. The rest are chip-boundary ties: a sample whose chip index
lies within one float32 rounding of an integer takes the chip on either
side, depending on how the expression was rounded, and the compiled
reference rounds its code intercept in a form the port cannot reproduce
for every channel (XLA rewrites ``x / c`` as ``x * (1 / c)`` and fuses
``a * b + c``, not uniformly across vector lanes). One tie moves a
correlator by twice that sample's magnitude, so every correlator must lie
within two ties. The integer epoch geometry of pass A must match exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sydr_tpu.channels import batch_runtime as jbr
from sydr_tpu.channels.runtime import TrackingConfig as JaxConfig
from sydr_tpu.channels.state import MODE_TRACKING, init_state as jax_init
from sydr_tpu_torch.channels import batch_runtime as tbr
from sydr_tpu_torch.channels.runtime import TrackingConfig
from sydr_tpu_torch.channels.state import state_from_numpy
from sydr_tpu_torch.ops import correlator_kernel as ck
from sydr_tpu_torch.signal.synthetic import IQGenerator

torch.set_num_threads(2)

CORR_KEYS = ("i_early", "q_early", "i_prompt", "q_prompt", "i_late",
             "q_late")


def _setup(fs, block_ms=4, n_ch=3):
    """3 channels tracking PRNs 5/12/21 mid-block (tests/
    test_correlator_kernel.py's state), window and state as numpy."""
    prns = [5, 12, 21][:n_ch]
    dops = [1200.0, -2600.0, 3900.0][:n_ch]
    gen = IQGenerator(fs, noise=True, seed=4)
    for prn, dop in zip(prns, dops):
        gen.add_satellite(prn, doppler_hz=dop, code_phase_chips=100.0,
                          cn0_dbhz=48.0)
    iq = gen.generate_ms(4 + block_ms)
    spms = round(fs * 1e-3)
    st = dataclasses.replace(
        jax_init(n_ch),
        mode=jnp.full((n_ch,), MODE_TRACKING, jnp.int32),
        carrier_freq=jnp.asarray(np.float32(dops)),
        rem_code=jnp.asarray(np.float32([0.02, 0.7, 0.4][:n_ch])),
        rem_carrier=jnp.asarray(np.float32([0.3, 2.1, 5.0][:n_ch])),
        code_freq_offset=jnp.asarray(np.float32([0.5, -1.2, 2.0][:n_ch])),
        unread=jnp.asarray(np.int32(
            [int(1.1 * spms), int(1.4 * spms), int(1.2345 * spms)][:n_ch])),
    )
    leaves = {f.name: np.asarray(getattr(st, f.name))
              for f in dataclasses.fields(st)}
    cfg = dict(sampling_frequency=fs, block_ms=block_ms, tail_ms=4,
               window_size=spms + 240, runtime="batch", profile="kaplan")
    return cfg, prns, st, leaves, np.float32(iq.real), np.float32(iq.imag)


def assert_correlators_close(out_t, out_j, peak_sample):
    """rtol 2e-3, atol 1.0 on >= 95% of the correlators; every correlator
    within two chip-boundary ties (2 * 2|x| each, see the module note)."""
    got = np.stack([out_t[k].numpy() for k in CORR_KEYS])
    ref = np.stack([np.asarray(out_j[k]) for k in CORR_KEYS])
    err = np.abs(got - ref)
    outside = err > 1.0 + 2e-3 * np.abs(ref)
    assert outside.mean() <= 0.05, (outside.mean(), err.max())
    assert err.max() <= 1.0 + 2 * (2.0 * peak_sample), err.max()


@pytest.mark.parametrize("fs, quantize, jax_mode", [
    (10e6, False, "dense"), (10e6, True, "dense"),
    (2.5e6, False, "dense"), (2.5e6, True, "dense"),
    (10e6, False, "pallas_rowsum"), (10e6, True, "pallas_rowsum"),
    (2.5e6, True, "pallas_rowsum"),
])
def test_pass_b_matches_jax(fs, quantize, jax_mode):
    """Quantised and plain taps at full and decimated rate against the JAX
    dense path; the production Pallas row-sum kernel (interpret mode, 2 ms
    blocks to keep the interpreter's time down) at full rate with both tap
    forms and at the decimated cruise rate with quantised taps."""
    cfg_args, prns, jst, leaves, wre, wim = _setup(
        fs, block_ms=2 if jax_mode == "pallas_rowsum" else 4)
    cfg_args["quantize_spacing"] = quantize
    extra = (dict(use_pallas=True, pallas_interpret=True,
                  boundary_mode="rowsum") if jax_mode == "pallas_rowsum"
             else {})
    st_j, out_j = jbr.run_block_batched(
        JaxConfig(**cfg_args, **extra), jnp.asarray(jbr.tiled_code_bits(prns)),
        jst, jnp.asarray(wre), jnp.asarray(wim))

    cpu = torch.device("cpu")
    st_t, out_t = tbr.run_block_batched(
        TrackingConfig(**cfg_args), torch.from_numpy(
            tbr.tiled_code_bits(prns)), state_from_numpy(leaves, cpu),
        torch.from_numpy(wre), torch.from_numpy(wim))

    assert_correlators_close(out_t, out_j, max(np.abs(wre).max(),
                                               np.abs(wim).max()))
    for key in ("active", "required", "unread"):
        np.testing.assert_array_equal(out_t[key].numpy(),
                                      np.asarray(out_j[key]), err_msg=key)
    np.testing.assert_array_equal(st_t.unread.numpy(), np.asarray(st_j.unread))
    np.testing.assert_allclose(st_t.carrier_freq.numpy(),
                               np.asarray(st_j.carrier_freq), atol=0.2)


@pytest.mark.parametrize("fs", [10e6, 2.5e6])
def test_pass_a_integer_geometry_exact(fs):
    """Pass A's integer geometry and the intercept's whole chip agree
    exactly with the compiled JAX functions; the fractional intercept
    within a few float32 ulps of the O(1000)-chip phase it is cut from
    (the module note: the compiled form's rounding is not uniform across
    channels)."""
    cfg_args, _, jst, leaves, _, _ = _setup(fs, block_ms=20)
    jcfg = JaxConfig(**cfg_args)
    geo_j = jax.jit(jbr._pass_a_closed, static_argnums=0)(jcfg, jst)
    st_t = state_from_numpy(leaves, torch.device("cpu"))
    cfg_t = TrackingConfig(**cfg_args)
    geo_t = tbr._pass_a_closed(cfg_t, st_t)
    for key in ("required", "active", "b_start", "unread_after",
                "unread_end", "consumed_end"):
        np.testing.assert_array_equal(geo_t[key].numpy(),
                                      np.asarray(geo_j[key]), err_msg=key)
    for key in ("rem_code", "rem_carrier", "code_step", "omega"):
        np.testing.assert_allclose(geo_t[key].numpy(), np.asarray(geo_j[key]),
                                   rtol=1e-5, atol=1e-5, err_msg=key)
    base_j, _, _, c_int_j, fb_j = jax.jit(jbr._intercept, static_argnums=0)(
        jcfg, jst)
    bg_t = tbr.block_geometry(cfg_t, st_t, geo_t)
    np.testing.assert_array_equal(bg_t["base"].numpy(), np.asarray(base_j))
    np.testing.assert_array_equal(bg_t["c_int"].numpy(), np.asarray(c_int_j))
    _, _, _, _, fb_t = tbr._intercept(cfg_t, st_t)
    np.testing.assert_allclose(fb_t.numpy(), np.asarray(fb_j), atol=1e-4)


def test_epoch_correlate_cpu_runs_plain_version():
    """On CPU tensors the wrapper is the plain version and launches
    nothing."""
    cfg_args, prns, _, leaves, wre, wim = _setup(2.5e6, block_ms=2, n_ch=2)
    cfg = TrackingConfig(**cfg_args, quantize_spacing=True)
    st = state_from_numpy(leaves, torch.device("cpu"))
    geo = tbr._pass_a_closed(cfg, st)
    bg = tbr.block_geometry(cfg, st, geo)
    args = (torch.from_numpy(wre), torch.from_numpy(wim),
            torch.from_numpy(tbr.tiled_code_bits(prns)), bg["c_int"],
            geo["omega"], geo["code_step"], bg["fb_q"], bg["phic_q"],
            tbr.epoch_bounds(cfg, geo, bg["base"]), tbr.taps_for(cfg),
            cfg.samples_per_ms)
    before = ck.KERNEL.launches
    got = ck.epoch_correlate(*args)
    ref = ck.epoch_correlate_ref(*args)
    assert ck.KERNEL.launches == before
    assert got.shape == (2, 2, 10)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)

