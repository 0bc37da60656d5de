"""Port's pass B (K1 ``epoch_correlate``, K3 ``block_cumsum_streams``)
against the JAX batched runtime.

The same numpy-seeded window and channel state go through JAX
``run_block_batched`` (its Pallas row-sum and prefix kernels in interpret
mode, and its dense XLA path) and through the port's ``run_block_batched``,
whose pass B runs ``epoch_correlate_ref`` (or, in the prefix boundary
form, ``block_cumsum_streams_ref``) on CPU tensors. Tolerance ``rtol 2e-3,
atol 1.0`` is the JAX package's own kernel-vs-dense budget
(tests/test_correlator_kernel.py), and it holds for at least 95% of the
correlators. The rest are chip-boundary ties: a sample whose chip index
lies within one float32 rounding of an integer takes the chip on either
side, depending on how the expression was rounded, and the compiled
reference rounds its code intercept in a form the port cannot reproduce
for every channel (XLA rewrites ``x / c`` as ``x * (1 / c)`` and fuses
``a * b + c``, not uniformly across vector lanes). One tie moves a
correlator by twice that sample's magnitude, so every correlator must lie
within two ties. The integer epoch geometry of pass A must match exactly.
The JAX prefix kernel rounds every per-sample value to bf16 before its
lane prefix (the port accumulates in f32), which the same budget covers,
as it covers JAX prefix against JAX dense.
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
from sydr_tpu.constants import GPS_L1CA_CODE_FREQ
from sydr_tpu.ops import correlator_kernel as jck
from sydr_tpu.ops import profiles as jprof
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
    (10e6, False, "pallas_prefix"), (10e6, True, "pallas_prefix"),
    (2.5e6, False, "pallas_prefix"), (2.5e6, True, "pallas_prefix"),
])
def test_pass_b_matches_jax(fs, quantize, jax_mode, monkeypatch):
    """Quantised and plain taps at full and decimated rate against the JAX
    dense path; the production Pallas row-sum kernel (interpret mode, 2 ms
    blocks to keep the interpreter's time down) at full rate with both tap
    forms and at the decimated cruise rate with quantised taps; the Pallas
    prefix kernel (interpret mode, 2 ms blocks) against the port's prefix
    form, both tap forms at both rates. The port takes the same
    ``use_pallas`` / ``boundary_mode`` as the JAX run. The JAX kernels run
    at their smallest program (``SYDR_KERNEL_PROGRAM``, as
    tests/test_timeshard.py sets it), which changes only their padding and
    keeps the interpreter's time down."""
    monkeypatch.setenv("SYDR_KERNEL_PROGRAM", "8192")
    cfg_args, prns, jst, leaves, wre, wim = _setup(
        fs, block_ms=2 if jax_mode.startswith("pallas") else 4)
    cfg_args["quantize_spacing"] = quantize
    extra = (dict(use_pallas=True, pallas_interpret=True,
                  boundary_mode=jax_mode.split("_")[1])
             if jax_mode.startswith("pallas") else {})
    st_j, out_j = jbr.run_block_batched(
        JaxConfig(**cfg_args, **extra), jnp.asarray(jbr.tiled_code_bits(prns)),
        jst, jnp.asarray(wre), jnp.asarray(wim))

    cpu = torch.device("cpu")
    st_t, out_t = tbr.run_block_batched(
        TrackingConfig(**cfg_args, **extra), torch.from_numpy(
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



def _block_inputs(cfg, prns, leaves, wre, wim):
    """The port's pass B inputs for one block: the K3 arguments and the
    epoch bounds."""
    st = state_from_numpy(leaves, torch.device("cpu"))
    geo = tbr._pass_a_closed(cfg, st)
    bg = tbr.block_geometry(cfg, st, geo)
    args = (torch.from_numpy(wre), torch.from_numpy(wim),
            torch.from_numpy(tbr.tiled_code_bits(prns)), bg["c_int"],
            geo["omega"], geo["code_step"], bg["fb_q"].contiguous(),
            bg["phic_q"].contiguous(), tbr.taps_for(cfg), cfg.samples_per_ms)
    return args, tbr.epoch_bounds(cfg, geo, bg["base"])


def test_prefix_form_runs_prefix_path(monkeypatch):
    """``use_pallas=True, boundary_mode="prefix"`` takes the prefix path
    (K3's plain version on CPU tensors) and never K1's; the default takes
    K1."""
    calls = {"prefix": 0, "rowsum": 0}
    real_prefix, real_rowsum = (ck.block_cumsum_streams_ref,
                                ck.epoch_correlate_ref)

    def spy_prefix(*a, **k):
        calls["prefix"] += 1
        return real_prefix(*a, **k)

    def spy_rowsum(*a, **k):
        calls["rowsum"] += 1
        return real_rowsum(*a, **k)

    monkeypatch.setattr(ck, "block_cumsum_streams_ref", spy_prefix)
    monkeypatch.setattr(ck, "epoch_correlate_ref", spy_rowsum)
    cfg_args, prns, _, leaves, wre, wim = _setup(2.5e6, block_ms=2, n_ch=2)
    bits = torch.from_numpy(tbr.tiled_code_bits(prns))
    for extra, expect in (
            (dict(use_pallas=True, boundary_mode="prefix"), (1, 0)),
            (dict(use_pallas=True, boundary_mode="rowsum"), (1, 1)),
            (dict(use_pallas=False, boundary_mode="prefix"), (1, 2))):
        tbr.run_block_batched(
            TrackingConfig(**cfg_args, **extra), bits,
            state_from_numpy(leaves, torch.device("cpu")),
            torch.from_numpy(wre), torch.from_numpy(wim))
        assert (calls["prefix"], calls["rowsum"]) == expect, (extra, calls)


def test_prefix_form_condition_is_jax():
    """The prefix form needs ``use_pallas``, a non-rowsum boundary mode and
    >= 1024 samples per ms, as the JAX ``_pass_b`` requires."""
    base = TrackingConfig(sampling_frequency=2.5e6, use_pallas=True,
                          boundary_mode="prefix")
    assert tbr.prefix_form(base)
    assert not tbr.prefix_form(dataclasses.replace(base, use_pallas=False))
    assert not tbr.prefix_form(dataclasses.replace(
        base, boundary_mode="rowsum"))
    assert not tbr.prefix_form(dataclasses.replace(
        base, sampling_frequency=1.0e6))


@pytest.mark.parametrize("fs, quantize", [(10e6, True), (2.5e6, False)])
def test_block_cumsum_streams_ref_matches_jax_kernel(fs, quantize):
    """The plain K3 against the JAX prefix kernel (interpret mode) on the
    same block: every stream's prefix picked at the epoch bounds and
    differenced, under the module's budget."""
    cfg_args, prns, jst, leaves, wre, wim = _setup(fs, block_ms=2)
    cfg_args["quantize_spacing"] = quantize
    jcfg = JaxConfig(**cfg_args)
    spms, n_win = jcfg.samples_per_ms, jcfg.window_samples
    geo = jbr._pass_a_closed(jcfg, jst)
    bg = jbr.block_geometry(jcfg, jnp.asarray(jbr.tiled_code_bits(prns)),
                            jst, geo)
    gsize, local = jbr._group_size(fs)
    chunk = min(8192, 1024 * (spms // 1024))
    super_n = jck.SUPER        # the smallest program, as above
    pad = np.zeros((-n_win) % (super_n * chunk), np.float32)
    zeros = jnp.zeros_like(geo["omega"])
    prefix_j = jck.block_cumsum_streams(
        jnp.asarray(np.concatenate([wre, pad])),
        jnp.asarray(np.concatenate([wim, pad])),
        jbr._kernel_word_table(jcfg, bg["words"]), bg["fb_q"], bg["phic_q"],
        jnp.stack([geo["omega"], geo["code_step"]] + [zeros] * 6, axis=1),
        spacings=tuple(jprof.spacings_for(jcfg)), spms=spms,
        n_q=jcfg.tail_ms + jcfg.block_ms, local=local,
        step0=GPS_L1CA_CODE_FREQ / fs, gsize=gsize, chunk=chunk,
        super_n=super_n, n_win=n_win, interpret=True,
        shifts=jprof.spacing_shifts(jcfg))

    cfg = TrackingConfig(**cfg_args)
    args, bounds = _block_inputs(cfg, prns, leaves, wre, wim)
    prefix_t = ck.block_cumsum_streams_ref(*args)
    assert prefix_t.shape == (3, 2 * len(args[8]), n_win)
    got = tbr.prefix_epoch_sums(prefix_t, bounds)
    ref = tbr.prefix_epoch_sums(
        torch.from_numpy(np.array(prefix_j)[..., :n_win]), bounds)
    peak = max(np.abs(wre).max(), np.abs(wim).max())
    err = (got - ref).abs().numpy()
    outside = err > 1.0 + 2e-3 * ref.abs().numpy()
    assert outside.mean() <= 0.05, (outside.mean(), err.max())
    assert err.max() <= 1.0 + 2 * (2.0 * peak), err.max()


@pytest.mark.parametrize("fs, quantize", [(10e6, True), (10e6, False),
                                          (2.5e6, True)])
def test_prefix_form_matches_rowsum_form(fs, quantize):
    """On the port, the prefix form's correlators equal K1's on the same
    inputs up to float32 rounding: the same per-sample values (one
    ``_dense_streams``), summed per epoch or differenced from a running
    prefix. Each prefix pick carries at most ``4 * sqrt(n_win) * 2^-24``
    of the largest prefix magnitude (a random walk of roundings, four
    sigma), and a correlator is the difference of two picks."""
    cfg_args, prns, _, leaves, wre, wim = _setup(fs, block_ms=4)
    cfg = TrackingConfig(**cfg_args, quantize_spacing=quantize)
    args, bounds = _block_inputs(cfg, prns, leaves, wre, wim)
    prefix = ck.block_cumsum_streams_ref(*args)
    got = tbr.prefix_epoch_sums(prefix, bounds)
    ref = ck.epoch_correlate_ref(*args[:8], bounds, *args[8:])
    n_win = prefix.shape[-1]
    bound = 2 * 4.0 * n_win ** 0.5 * 2.0 ** -24 * float(prefix.abs().max())
    assert got.shape == ref.shape
    assert float((got - ref).abs().max()) <= bound

    # and through run_block_batched: the same correlators in the outputs
    st = state_from_numpy(leaves, torch.device("cpu"))
    runs = [tbr.run_block_batched(
        dataclasses.replace(cfg, use_pallas=True, boundary_mode=mode),
        args[2], st, args[0], args[1])[1] for mode in ("prefix", "rowsum")]
    for key in CORR_KEYS:
        assert float((runs[0][key] - runs[1][key]).abs().max()) <= bound
    for key in ("active", "required", "unread"):
        assert torch.equal(runs[0][key], runs[1][key]), key


@pytest.mark.parametrize("n_epochs, n_ch, spms, expect", [
    (20, 32, 2500, (4, 2)),      # cruise: (10, 32) blocks of 256 threads
    (5, 32, 2500, (8, 1)),       # pull-in: one epoch a block, 8 warps
    (20, 32, 10000, (8, 1)),     # full rate: (20, 32) blocks of 256
    (20, 32, 25000, (8, 1)),
    (20, 8, 4092, (8, 1)),
    (1, 1, 1023, (3, 1)),        # never more than a warp per 256 samples
])
def test_launch_shape_of_k1(n_epochs, n_ch, spms, expect):
    """K1's launch shape: a block holds at most 8 warps, whole epochs of
    one channel, and the grid covers every epoch."""
    wpe, epb = ck.launch_shape(n_epochs, n_ch, spms)
    assert (wpe, epb) == expect
    assert wpe >= 1 and epb >= 1 and wpe * epb <= ck.MAX_BLOCK_WARPS
    assert -(-n_epochs // epb) * epb >= n_epochs


@pytest.mark.parametrize("n_win, n_ch, expect", [
    (60000, 32, (8, 8)),         # cruise: 24 ms at 2.5 Msps
    (22500, 32, (3, 8)),         # pull-in: 9 ms
    (240000, 32, (30, 8)),       # full rate: 24 ms at 10 Msps
    (18423, 32, (3, 6)),         # 9 ms at 2.047 Msps: a ragged last segment
    (60000, 8, (2, 30)),
    (1000, 32, (1, 1)),
    (60000, 500, (59, 1)),       # more channels than blocks the card holds
])
def test_cumsum_shape_of_k3(n_win, n_ch, expect):
    """K3's launch shape: segments of whole 1024-sample chunks that cover
    the window with none to spare, on a grid of at most one block for
    each block the card holds at once (or one segment a channel)."""
    seg_chunks, n_seg = ck.cumsum_shape(n_win, n_ch)
    assert (seg_chunks, n_seg) == expect
    seg = seg_chunks * ck.CUMSUM_CHUNK
    assert (n_seg - 1) * seg < n_win <= n_seg * seg
    assert n_seg == 1 or \
        n_seg * n_ch <= ck.CUMSUM_BLOCKS_PER_SM * ck.SM_COUNT


def test_check_all_names_the_fault():
    """The one-pass argument check of the kernel wrappers still raises on
    a wrong dtype, shape, device or a non-contiguous tensor, naming it."""
    from sydr_tpu_torch.ops import native

    cpu = torch.device("cpu")
    good = torch.zeros(4, 6)
    native.check_all(cpu, ((good, "a", torch.float32, (4, 6)),))
    for bad, word in (
            (good.to(torch.float64), "dtype"),
            (torch.zeros(4, 5), "shape"),
            (torch.zeros(6, 4).t(), "not contiguous"),
            (torch.zeros(4, 6, device="meta"), "expected cpu")):
        with pytest.raises(ValueError, match=f"b: .*{word}"):
            native.check_all(cpu, ((good, "a", torch.float32, (4, 6)),
                                   (bad, "b", torch.float32, (4, 6))))
