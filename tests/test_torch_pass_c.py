"""Pass C (``ops.loop_kernel.pass_c``) against the JAX package's
``_pass_c`` on the CPU, and the host side of its CUDA kernel.

The same numpy-seeded mid-track state and correlators
(``tests/_pass_c_inputs.py``: bit-sync declarations and bit completions
inside the block, inactive channels, every clamp acting, lock states
across the kaplan state machine) go through the JAX ``_pass_c`` (jitted,
its ``lax.scan``, then its ``_slew_anchor``) and the port's ``pass_c`` on
CPU tensors (``_pass_c`` and the anchor slew), each with the geometry of
its own package's ``_pass_a``, for every branch the kernel has: profile
borre, kaplan and kaplan narrow-only; ``dlf_order`` 2 and 3;
``fll_discriminator`` atan and atan2; ``cn0_estimator`` nwpr and
beaulieu; the rails on and off; the anchor slew on (the default rail and
slew, and a faster slew) and off; pass A's closed and scan forms.

Bounds: integer outputs and state (flags, counters, histogram, bit edge,
lock state, activity, bit completions) exact; every float within 1e-5 of
the largest magnitude of its key. Both run the same float32 operations;
XLA contracts ``a * b + c``, multiplies by reciprocals and has its own
``atan``, so last-ulp differences ride the loop filters through the
block's epochs (measured: below 4e-7 of the key's scale). The new
carrier phase is pass A's end-of-block phase, a remainder mod 2 pi that
the two packages round in other orders, less the virtual NCO's phase:
within 2e-4 rad (measured: 7.6e-5).

The host side of the kernel (no CUDA needed): the constants it takes
against the expressions of the plain version, the C structures and enums
of ``csrc/`` against their ctypes mirrors and the state's field order,
the launch arguments' pointers, strides and checks, and the output
tensors unpacked into the plain version's state and outputs, bit for bit.
"""

import ctypes
import dataclasses
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _pass_c_inputs import (
    CLAIMS,
    SHAPE_CASES,
    activity,
    mid_track,
    n_streams,
    reached,
    shaped_block,
)
from sydr_tpu.channels import batch_runtime as jbr
from sydr_tpu.channels.runtime import TrackingConfig as JaxConfig
from sydr_tpu.channels.runtime import _slew_anchor as jax_slew_anchor
from sydr_tpu.channels.state import ChannelState as JaxState
from sydr_tpu_torch.channels import batch_runtime as tbr
from sydr_tpu_torch.channels.runtime import TrackingConfig
from sydr_tpu_torch.channels.state import (
    F32_FIELDS,
    FIELDS,
    I32_FIELDS,
    I32_SCALAR_FIELDS,
    state_from_numpy,
)
from sydr_tpu_torch.constants import (
    DLF_W0_SCALE_1ST,
    DLF_W0_SCALE_2ND,
    DLF_W0_SCALE_3RD,
)
from sydr_tpu_torch.ops import loop_kernel as lk
from sydr_tpu_torch.ops import native
from sydr_tpu_torch.ops import tracking as trk

torch.set_num_threads(2)

CPU = torch.device("cpu")
N_CH = 32
FLOAT_TOL = 1e-5
PHASE_TOL = 2e-4    # rad: pass A's end-of-block carrier phase (module note)
RAILS_OFF = dict(freq_rail_hz=0.0, max_block_freq_step=0.0, code_rail_hz=0.0)

# (id, block_ms, TrackingConfig fields): every branch of the kernel.
CASES = [
    ("borre-nwpr-rails", 10, dict(profile="borre")),
    ("borre-beaulieu-norails", 10,
     dict(profile="borre", cn0_estimator="beaulieu", **RAILS_OFF)),
    ("kaplan-o2-atan-nwpr-rails", 5, dict(profile="kaplan")),
    ("kaplan-o3-atan2-beaulieu-rails", 5,
     dict(profile="kaplan", dlf_order=3, fll_discriminator="atan2",
          cn0_estimator="beaulieu")),
    ("kaplan-o2-atan2-nwpr-norails", 5,
     dict(profile="kaplan", fll_discriminator="atan2", **RAILS_OFF)),
    ("kaplan-o3-atan-beaulieu-norails", 5,
     dict(profile="kaplan", dlf_order=3, cn0_estimator="beaulieu",
          **RAILS_OFF)),
    ("kaplan-o2-scan-pass-a", 5, dict(profile="kaplan", pass_a="scan")),
    ("narrow-o2-atan-nwpr-rails", 20,
     dict(profile="kaplan", kaplan_narrow_only=True)),
    ("narrow-o3-atan2-beaulieu-rails", 10,
     dict(profile="kaplan", kaplan_narrow_only=True, dlf_order=3,
          fll_discriminator="atan2", cn0_estimator="beaulieu")),
    ("narrow-o2-atan2-beaulieu-norails", 10,
     dict(profile="kaplan", kaplan_narrow_only=True,
          fll_discriminator="atan2", cn0_estimator="beaulieu", **RAILS_OFF)),
    ("narrow-o3-atan-nwpr-norails", 10,
     dict(profile="kaplan", kaplan_narrow_only=True, dlf_order=3,
          **RAILS_OFF)),
    ("narrow-o2-fast-slew", 20,
     dict(profile="kaplan", kaplan_narrow_only=True, freq_rail_hz=400.0,
          anchor_slew_hz_per_s=30.0)),
]


def _fields(block_ms, extra):
    fields = dict(sampling_frequency=2.5e6, block_ms=block_ms, tail_ms=4,
                  window_size=2756, runtime="batch", quantize_spacing=True)
    fields.update(extra)
    return fields


def _port_inputs(fields, seed=3):
    cfg = TrackingConfig(**fields)
    leaves, corr = mid_track(cfg, N_CH, seed)
    st = state_from_numpy(leaves, CPU)
    return cfg, leaves, st, tbr._pass_a(cfg, st), torch.tensor(corr)


@pytest.mark.parametrize("name, block_ms, extra", CASES,
                         ids=[c[0] for c in CASES])
def test_pass_c_matches_jax(name, block_ms, extra):
    fields = _fields(block_ms, extra)
    cfg, leaves, st, geo, corr = _port_inputs(fields)
    new_st, out = lk.pass_c(cfg, st, geo, corr)

    jcfg = JaxConfig(**fields)
    jst = JaxState(**{k: jnp.asarray(v) for k, v in leaves.items()})
    jgeo = jbr._pass_a(jcfg, jst)
    jnew, jout = jax.jit(jbr._pass_c, static_argnums=0)(
        jcfg, jst, jgeo, jnp.asarray(corr.numpy()))
    jnew = jax_slew_anchor(jcfg, jnew)

    def same(key, got, want):
        want = np.asarray(want)
        assert got.shape == want.shape, key
        if got.dtype.kind in "biu" or want.dtype.kind in "biu":
            np.testing.assert_array_equal(got, want, err_msg=key)
        else:
            bound = FLOAT_TOL * float(np.abs(want).max())
            if key == "state rem_carrier":
                bound = PHASE_TOL
            err = float(np.abs(got - want).max())
            assert err <= bound, (key, err, bound)

    assert set(out) == set(jout)
    for key in out:
        same(key, out[key].numpy(), jout[key])
    for key in FIELDS:
        same(f"state {key}", getattr(new_st, key).numpy(),
             getattr(jnew, key))

    # The branches this case is meant to reach did run.
    active = out["active"].numpy()
    assert not active[:, [3, N_CH - 2]].any() and active[:, :3].all()
    declared = (new_st.flags.numpy() & 2) & ~(leaves["flags"] & 2)
    assert declared.any()
    if block_ms >= 10:
        assert out["bit_ready"].numpy().any()
    if fields.get("freq_rail_hz", 1.0) > 0:
        rail = float(np.float32(leaves["freq_anchor"][0] + np.float32(400)))
        assert out["carrier_freq"][:, 0].max() == rail
        assert float(new_st.code_freq_offset[4]) == -6.0
        if fields["profile"] == "kaplan":
            step = np.float32(leaves["carrier_freq"][1] + np.float32(125))
            assert float(out["carrier_freq"][0, 1]) == step
    # The anchor slew moves the synced channels' anchors, and only theirs.
    moved = new_st.freq_anchor.numpy() != leaves["freq_anchor"]
    synced = (new_st.flags.numpy() & 2) != 0
    slews = fields.get("anchor_slew_hz_per_s", 5.0) > 0 \
        and fields.get("freq_rail_hz", 400.0) > 0
    assert moved.any() == slews and not (moved & ~synced).any()


@pytest.mark.parametrize("fields", [
    _fields(20, dict(profile="kaplan", kaplan_narrow_only=True)),
    _fields(5, dict(profile="kaplan", dlf_order=3)),
    _fields(20, dict(profile="borre", runtime="scan")),
    _fields(10, dict(profile="kaplan", lock_indicator_alpha=0.02,
                     fll_bandwidth_narrow=7.5, runtime="scan")),
], ids=["cruise", "pull-in-o3", "borre", "kaplan-uncapped"])
def test_loop_consts_match_plain_expressions(fields):
    """Each constant is the float32 value the plain version's op sees on
    the card: a Python float rounded by its op, a division of a tensor by
    a Python scalar the multiplication by the scalar's reciprocal rounded
    to float32 (PyTorch's CUDA form; at 1e-3 that is 1000, where the
    float32 reciprocal of float32 1e-3 is 999.99994)."""
    cfg = TrackingConfig(**fields)
    k = lk.loop_consts(cfg)
    f32 = torch.float32

    def t(x):
        return torch.tensor([x], dtype=f32)

    def rcp_mul(x, scalar):       # PyTorch's CUDA ``tensor / scalar``
        return float(t(x) * t(1.0 / scalar))

    assert lk.rcp(1e-3) == 1000.0 and lk.rcp(0.53) == float(t(1 / 0.53))

    # The Borre filters: borre_loop_filter's two products, read apart.
    for prefix, bw, damp, gain, pdi in (
            ("dll", cfg.dll_bandwidth, cfg.dll_damping, cfg.dll_gain,
             cfg.dll_pdi),
            ("pll", cfg.pll_bandwidth, cfg.pll_damping, cfg.pll_gain,
             cfg.pll_pdi)):
        t1, t2 = trk.loop_filter_taus(bw, damp, gain)
        assert getattr(k, f"{prefix}_k1") == float(
            trk.borre_loop_filter(t(0.0), t(-1.0), t1, t2, pdi))
        assert getattr(k, f"{prefix}_k2") == float(
            trk.borre_loop_filter(t(1.0), t(1.0), t1, t2, pdi))
    # The DLF's natural frequencies by lock state (pull-in, wide, narrow).
    cap = 0.12 / (cfg.block_ms * 1e-3) if cfg.runtime == "batch" \
        else math.inf
    fll = [cfg.fll_bandwidth_pullin, cfg.fll_bandwidth_wide,
           cfg.fll_bandwidth_narrow]
    pll = [0.0, cfg.pll_bandwidth_wide, cfg.pll_bandwidth_narrow]
    if cfg.kaplan_narrow_only:
        fll, pll = [fll[2]] * 3, [pll[2]] * 3
    sf, sp = ((DLF_W0_SCALE_2ND, DLF_W0_SCALE_3RD) if cfg.dlf_order == 3
              else (DLF_W0_SCALE_1ST, DLF_W0_SCALE_2ND))
    assert list(k.w0f) == [rcp_mul(min(b, cap), sf) for b in fll]
    assert list(k.w0p) == [rcp_mul(min(b, cap), sp) for b in pll]
    # The low-pass filters' weights, read from low_pass itself.
    alpha = cfg.lock_indicator_alpha if cfg.profile == "kaplan" else 0.01
    assert k.alpha == float(trk.low_pass(t(1.0), t(0.0), alpha))
    assert k.one_minus_alpha == float(trk.low_pass(t(0.0), t(1.0), alpha))
    assert k.cn0_alpha == float(trk.low_pass(t(1.0), t(0.0), 0.1))
    assert k.cn0_one_minus_alpha == float(trk.low_pass(t(0.0), t(1.0), 0.1))
    # Reciprocals of the scalar divisors and the plain float constants.
    assert k.rcp_two_pi == rcp_mul(1.0, 2.0 * math.pi)
    assert k.rcp_dt == rcp_mul(1.0, 1e-3)
    assert k.rcp_ten == rcp_mul(1.0, 10.0)
    for name, value in (("t_int", 1e-3), ("two_pi", 2.0 * math.pi),
                        ("pi", math.pi), ("half_pi", math.pi / 2.0),
                        ("cn0_floor", 1e-12), ("n_accum", 20.0),
                        ("code_freq", 1.023e6),
                        ("freq_rail", cfg.freq_rail_hz),
                        ("block_step", cfg.max_block_freq_step),
                        ("code_rail", cfg.code_rail_hz),
                        ("dominance", cfg.bit_sync_dominance),
                        ("fll_thr_wide", cfg.fll_threshold_wide),
                        ("fll_thr_narrow", cfg.fll_threshold_narrow),
                        ("pll_thr_narrow", cfg.pll_threshold_narrow)):
        assert getattr(k, name) == float(t(value)), name
    assert (k.profile, k.dlf_order, k.min_convergence_ms,
            k.bit_sync_unanimous, k.bit_sync_flips) == (
        lk.profile_code(cfg), cfg.dlf_order, cfg.min_convergence_ms,
        cfg.bit_sync_unanimous, cfg.bit_sync_flips)
    # The anchor slew's clamp bound (runtime._slew_anchor's max_step, a
    # Python float that torch.clamp rounds) and its switch.
    max_step = cfg.anchor_slew_hz_per_s * cfg.block_ms * 1e-3
    assert k.slew_step == float(torch.clamp(t(1e9), -max_step, max_step))
    assert k.slew_on == int(cfg.anchor_slew_hz_per_s > 0
                            and cfg.freq_rail_hz > 0)


def _c_source(name):
    return (native.CSRC_DIR / name).read_text()


def _c_block(text, head):
    """The body of ``struct NAME {`` or ``enum NAME {`` in ``text``."""
    start = text.index(head + " {") + len(head) + 2
    return text[start:text.index("}", start)]


def _c_enum(text, name):
    return [m.strip() for m in _c_block(text, f"enum {name}").split(",")
            if m.strip()]


def _camel(field):
    return "k" + "".join(part[:1].upper() + part[1:]
                         for part in field.split("_"))


def test_structures_match_the_sources():
    """The ctypes mirrors have the C structures' fields in order, with
    their types and counts, and the kernel's enums follow the state's
    field order and the output layout."""
    cuh, cu = _c_source("loop_update.cuh"), _c_source("pass_c.cu")
    layout = _c_source("channel_layout.cuh")
    assert '#include "channel_layout.cuh"' in cu
    consts = re.findall(r"^\s*(int|float)\s+(\w+)(?:\[(\d+)\])?;",
                        _c_block(cuh, "struct LoopConsts"), re.M)
    want = [(n, (ctypes.c_int if ty == "int" else ctypes.c_float)
             * int(count) if count else
             (ctypes.c_int if ty == "int" else ctypes.c_float))
            for ty, n, count in consts]
    got = lk.LoopConsts._fields_
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, a), (_, b) in zip(got, want):
        assert ctypes.sizeof(a) == ctypes.sizeof(b), name
        assert getattr(a, "_length_", 1) == getattr(b, "_length_", 1), name
    ptrs = re.findall(r"^\s*(?:const\s+)?\w+\*\s+(\w+)(?:\[(\w+)\])?;",
                      _c_block(cu, "struct PassCArgs"), re.M)
    counts = {"kNumStateF": len(F32_FIELDS),
              "kNumStateI": len(I32_SCALAR_FIELDS)}
    assert [(n, counts.get(c, 1)) for n, c in ptrs] == [
        (n, getattr(t, "_length_", 1)) for n, t in lk.PassCArgs._fields_]
    assert _c_enum(layout, "StateF") == [_camel(n) for n in F32_FIELDS] + [
        "kNumStateF"]
    assert _c_enum(layout, "StateI") == [_camel(n)
                                         for n in I32_SCALAR_FIELDS] \
        + ["kNumStateI"]
    assert re.search(r"constexpr int kMaxWarps = (\d+);", cu).group(1) \
        == str(lk.PASS_C_MAX_WARPS)
    assert 1 <= lk.PASS_C_WARPS <= lk.PASS_C_MAX_WARPS
    assert re.search(r"constexpr int kTile = (\d+);", cu).group(1) \
        == str(lk.TILE_EPOCHS)
    assert "kTile) * warps *\n         (4 * streams + 13 + 4 * kOutRows)" in cu
    assert "kOutRows = kRowB + kNumOutB;" in cu
    assert lk.slab_bytes(4, 6) == 32 * 4 * (4 * 6 + 13 + 4 * 24)
    for enum, keys, end in (("OutF", lk.OUT_F32, "kNumOutF"),
                            ("OutI", lk.OUT_I32, "kNumOutI"),
                            ("OutB", lk.OUT_BOOL, "kNumOutB")):
        assert _c_enum(layout, enum) == [_camel("out_" + k)
                                         for k in keys] + [end]
    assert sorted(lk.OUTPUT_KEYS) == sorted(
        lk.OUT_F32 + lk.OUT_I32 + lk.OUT_BOOL)


def _write_plain(bufs, new_st, out):
    """The plain version's results written into the kernel's buffers in
    its layout, as the kernel writes them."""
    for j, key in enumerate(lk.OUT_F32):
        bufs["out_f"][j] = out[key]
    for j, key in enumerate(lk.OUT_I32):
        bufs["out_i"][j] = out[key]
    for j, key in enumerate(lk.OUT_BOOL):
        bufs["out_b"][j] = out[key]
    for j, key in enumerate(F32_FIELDS):
        bufs["new_f"][j] = getattr(new_st, key)
    for j, key in enumerate(I32_SCALAR_FIELDS):
        bufs["new_i"][j] = getattr(new_st, key)
    bufs["new_hist"][:] = new_st.edge_hist


@pytest.mark.parametrize("name, block_ms, extra", [
    c for c in CASES if c[0] in (
        "borre-nwpr-rails", "kaplan-o2-atan-nwpr-rails",
        "kaplan-o2-scan-pass-a", "narrow-o2-atan-nwpr-rails")],
    ids=["borre", "kaplan", "kaplan-scan-pass-a", "narrow"])
def test_launch_args_round_trip(name, block_ms, extra):
    """The launch arguments point at the tensors the kernel reads, with
    ``active`` read at its own row stride (0 where pass A's closed form
    expands one row); the output buffers, filled in the kernel's layout
    with the plain version's results, unpack to those results: the same
    keys, dtypes, shapes and values."""
    cfg, _, st, geo, corr = _port_inputs(_fields(block_ms, extra))
    bufs, args = lk.pass_c_launch_args(cfg, st, geo, corr)
    consts, ptrs = args[0]._obj, args[1]._obj
    assert consts is lk.loop_consts(cfg)
    assert args[2:5] == (N_CH, block_ms, n_streams(cfg))
    assert args[5] == (0 if cfg.pass_a == "closed" else N_CH)
    assert args[6] == lk.PASS_C_WARPS
    assert lk.pass_c_launch_args(cfg, st, geo, corr, warps=1)[1][6] == 1
    assert not geo["active"].is_contiguous() or cfg.pass_a == "scan"
    assert list(ptrs.state_f) == [getattr(st, n).data_ptr()
                                  for n in F32_FIELDS]
    assert list(ptrs.state_i) == [getattr(st, n).data_ptr()
                                  for n in I32_SCALAR_FIELDS]
    assert ptrs.edge_hist == st.edge_hist.data_ptr()
    assert ptrs.corr == corr.data_ptr()
    for key in ("active", "required", "unread_after", "rem_code",
                "rem_code_end", "rem_carrier_end", "delta", "unread_end"):
        assert getattr(ptrs, key) == geo[key].data_ptr(), key
    for key, buf in bufs.items():
        assert getattr(ptrs, key) == buf.data_ptr(), key
        assert buf.is_contiguous()

    new_st, out = tbr._pass_c(cfg, st, geo, corr)
    _write_plain(bufs, new_st, out)
    got_st, got = lk.unpack(bufs)
    assert list(got) == list(out)
    for key in out:
        assert got[key].dtype == out[key].dtype, key
        assert got[key].shape == out[key].shape, key
        assert got[key].is_contiguous(), key
        assert torch.equal(got[key], out[key]), key
    for key in FIELDS:
        a, b = getattr(got_st, key), getattr(new_st, key)
        assert a.dtype == b.dtype == (
            torch.int32 if key in I32_FIELDS else torch.float32), key
        assert a.is_contiguous() and torch.equal(a, b), key


def test_launch_args_reject_bad_input():
    cfg, _, st, geo, corr = _port_inputs(_fields(
        5, dict(profile="kaplan", kaplan_narrow_only=True)))
    bad = [
        ("code_counter", (dataclasses.replace(
            st, code_counter=st.code_counter.long()), geo, corr)),
        ("edge_hist", (dataclasses.replace(
            st, edge_hist=st.edge_hist[:, :19]), geo, corr)),
        ("cn0", (dataclasses.replace(
            st, cn0=torch.stack([st.cn0, st.cn0], 1)[:, 0]), geo, corr)),
        ("required", (st, {**geo, "required": geo["required"][:, :-1]},
                      corr)),
        ("active", (st, {**geo, "active": geo["active"].int()}, corr)),
        ("active", (st, {**geo, "active": geo["active"].t().contiguous()
                         .t()[:, :]}, corr)),
        ("corr", (st, geo, corr[:, :, :4])),
        ("corr", (st, geo, corr[0])),
    ]
    for what, args in bad:
        with pytest.raises(ValueError, match=what):
            lk.pass_c_launch_args(cfg, *args)
    kaplan = dataclasses.replace(cfg, kaplan_narrow_only=False)
    with pytest.raises(ValueError, match="streams"):
        lk.pass_c_launch_args(kaplan, st, geo, corr)
    for warps in (0, 3, lk.PASS_C_MAX_WARPS + 1):
        with pytest.raises(ValueError, match="warps"):
            lk.pass_c_launch_args(cfg, st, geo, corr, warps=warps)


@pytest.mark.parametrize("case", SHAPE_CASES, ids=[c[0] for c in SHAPE_CASES])
def test_shaped_blocks_reach_their_branches(case):
    """The plain version on each shape and activity the kernel's ``cuda``
    tests hold it to (tests/_pass_c_inputs.py) reaches every branch the
    case claims, so that no card test passes for want of its branch: a
    declaration inside the block, a bit completion, an inactive stretch
    between active epochs, a bit completion past the first 32-epoch tile
    with a stretch across the tiles' boundary, no epoch active, a
    declaration of another bit edge than the state's. The
    outputs keep the block's shape and the activity given."""
    name, block_ms, n_ch, kind, extra, claims = case
    assert set(claims) <= set(CLAIMS)
    cfg, st, geo, corr = shaped_block(block_ms, n_ch, kind, extra, CPU)
    assert geo["active"].is_contiguous() and corr.shape[:2] == (
        block_ms, n_ch)
    new_st, out = tbr._pass_c(cfg, st, geo, corr)
    assert set(claims) <= reached(st, new_st, out), name
    assert torch.equal(out["active"], geo["active"])
    assert out["i_prompt"].shape == (block_ms, n_ch)
    # Inactive epochs move no counter: no epoch active leaves them.
    n_active = geo["active"].sum(0).to(torch.int32)
    assert torch.equal(new_st.code_counter, st.code_counter + n_active)
    if "idle" in claims:
        for key in ("ms_counter", "flags", "accum_count", "edge_hist"):
            assert torch.equal(getattr(new_st, key), getattr(st, key)), key


def test_activity_patterns():
    """``"gaps"`` cuts stretches out of every third channel and, past 33
    epochs, epochs 30-33 of channels 2 and 5 (across the 32-epoch tiles);
    ``"idle"`` clears every epoch; pass A's own activity passes through."""
    base = torch.ones((1, 8), dtype=torch.bool).expand(45, 8)
    gaps = activity("gaps", base)
    assert base.all() and activity("gaps", base.contiguous()).sum() \
        == gaps.sum()
    assert gaps.flags["C_CONTIGUOUS"] and gaps.shape == (45, 8)
    assert not gaps[5:10, 1].any() and gaps[:5, 1].all()
    assert gaps[10:, 1].all()
    assert not gaps[8:13, 4].any() and gaps[13:, 4].all()
    assert not gaps[30:34, 2].any() and gaps[:30, 2].all()
    assert gaps[34:, 2].all()
    assert gaps[:, 0].all() and gaps[:, 3].all()
    assert activity("gaps", base[:20])[:, 2].all()
    assert activity("pass-a", base).all()
    assert activity("moved-edge", base).all()
    assert not activity("idle", base).any()
    with pytest.raises(ValueError, match="activity"):
        activity("some", base)


def test_pass_c_on_cpu_is_the_plain_version():
    """On CPU tensors ``pass_c`` is ``_pass_c`` followed by the anchor
    slew (``pass_c_plain``) and launches nothing; so is
    ``run_block_batched``'s pass C."""
    from sydr_tpu_torch.channels.runtime import _slew_anchor

    cfg, leaves, st, geo, corr = _port_inputs(_fields(
        20, dict(profile="kaplan", kaplan_narrow_only=True)))
    before = lk.PASS_C_KERNEL.launches + lk.PASS_C_KERNEL.captured
    new_st, out = lk.pass_c(cfg, st, geo, corr)
    ref_st, ref = tbr._pass_c(cfg, st, geo, corr)
    ref_st = _slew_anchor(cfg, ref_st)
    for key in out:
        assert torch.equal(out[key], ref[key]), key
    for key in FIELDS:
        assert torch.equal(getattr(new_st, key), getattr(ref_st, key)), key
    plain_st, plain = lk.pass_c_plain(cfg, st, geo, corr)
    for key in FIELDS:
        assert torch.equal(getattr(plain_st, key), getattr(ref_st, key)), key
    assert all(torch.equal(plain[k], ref[k]) for k in ref)
    # The slew moved a synced channel's anchor toward its carrier, by at
    # most the block's step and the anchor's rounding.
    step = np.float32(cfg.anchor_slew_hz_per_s * cfg.block_ms * 1e-3)
    moved = new_st.freq_anchor.numpy() - leaves["freq_anchor"]
    ulp = np.spacing(np.abs(new_st.freq_anchor.numpy()))
    assert (moved != 0).any() and (np.abs(moved) <= step + ulp).all()
    assert lk.PASS_C_KERNEL.launches + lk.PASS_C_KERNEL.captured == before
    with pytest.raises(ValueError, match="device"):
        lk.pass_c(cfg, st, geo, corr.to("meta"))
