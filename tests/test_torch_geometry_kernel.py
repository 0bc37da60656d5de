"""Pass A and pass B's geometry (``ops.geometry_kernel.block_geometry_all``)
on the CPU: against the plain composition of the port, against the JAX
package, and the host side of its CUDA kernel.

On CPU tensors the wrapper is the plain composition (``_pass_a`` then
``pass_b_inputs``), bit for bit, and launches nothing. Against the JAX
package's ``_pass_a_closed``, ``_intercept`` and ``block_geometry``, jitted
on the CPU as one program (as its ``run_block_batched`` fuses them), on
``tests/test_pass_a_closed.py``'s states and more: every integer exact
(required, activity, consumed-sample offsets, unread counts, the
intercept's whole chip and the epoch bounds), and every float within
``tests/test_pass_a_closed.py``'s bars: 2e-4 chips on a code phase and
2e-2 rad on a carrier phase (circular) at IF 0, and its nonzero-IF bars,
5e-4 chips and 0.05 rad (at ~1.6 rad a sample the two packages' carrier
phases, O(1e4) rad before their remainder, round apart by a few float32
ulp); 1e-5 relative on the rates.

The host side of the kernel (no CUDA needed): the constants against the
plain version's ops, the C structures and enums of
``csrc/block_geometry.cu`` against their ctypes mirrors, the launch
arguments' pointers and checks, and the output buffers unpacked into the
plain version's results, bit for bit.
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

from sydr_tpu.channels import batch_runtime as jbr
from sydr_tpu.channels.runtime import TrackingConfig as JaxConfig
from sydr_tpu.channels.state import ChannelState as JaxState
from sydr_tpu_torch.channels import batch_runtime as br
from sydr_tpu_torch.channels.runtime import TrackingConfig
from sydr_tpu_torch.channels.state import (
    MODE_IDLE,
    MODE_TRACKING,
    init_state,
    state_from_numpy,
    state_to_numpy,
)
from sydr_tpu_torch.ops import geometry_kernel as gk
from sydr_tpu_torch.ops import loop_kernel as lk
from sydr_tpu_torch.ops import native

torch.set_num_threads(2)

CPU = torch.device("cpu")
FS = 10e6
# tests/test_pass_a_closed.py's bars: (code phase [chips], carrier phase
# [rad], circular) at IF 0 (test_geometry_matches_scan) and at nonzero IF
# (test_geometry_nonzero_if_one_sample_ties, without its tie-break term).
TOLS = {False: (2e-4, 2e-2), True: (5e-4, 0.05)}
RATE_RTOL = 1e-5


def _cfg(cls=TrackingConfig, **kw):
    base = dict(sampling_frequency=FS, block_ms=20, tail_ms=4,
                window_size=10240, runtime="batch")
    base.update(kw)
    return cls(**base)


def _leaves(n_ch=8, seed=0, unread_ms=5.5):
    """tests/test_pass_a_closed.py's random tracking state, as numpy."""
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


def _deficit(leaves):
    """tests/test_pass_a_closed.py::test_true_deficit_is_all_or_nothing's
    starving state: no channel can run its first epoch."""
    leaves["rem_code"][:] = 0.001
    leaves["code_freq_offset"][:] = -3.0
    leaves["carrier_freq"][:] = 0.0
    leaves["unread"][:] = 0
    return leaves


def _idle(leaves):
    leaves["mode"][[1, 3]] = MODE_IDLE
    return leaves


def _offsets(sign):
    def apply(leaves):
        leaves["code_freq_offset"] = (
            sign * np.abs(leaves["code_freq_offset"])).astype(np.float32)
        return leaves
    return apply


# (id, seed, unread_ms, TrackingConfig fields, state edit): the states of
# tests/test_pass_a_closed.py (every epoch runs; 4.9 ms takes the
# availability clamp, 0.3 ms the small deficit), a true deficit (the block
# all-or-nothing: no epoch runs), idle channels, nonzero IF (the carrier
# shifted by it), code-rate offsets of one sign, and 5 ms blocks.
CASES = [
    ("seed0", 0, 5.5, {}, None),
    ("seed1", 1, 5.5, {}, None),
    ("seed2", 2, 5.5, {}, None),
    ("seed3", 3, 5.5, {}, None),
    ("clamp", 7, 4.9, {}, None),
    ("small-deficit", 4, 0.3, {}, None),
    ("true-deficit", 4, 5.5, {}, _deficit),
    ("idle", 2, 5.5, {}, _idle),
    ("if-2.58e6", 0, 5.5, dict(intermediate_frequency=2.58e6), None),
    ("if-4.13e6", 1, 5.5, dict(intermediate_frequency=4.13e6), None),
    ("negative-offsets", 5, 5.5, {}, _offsets(-1.0)),
    ("positive-offsets", 6, 5.5, {}, _offsets(1.0)),
    ("block5", 3, 5.5, dict(block_ms=5), None),
    ("block5-if-deficit", 4, 5.5,
     dict(block_ms=5, intermediate_frequency=2.58e6), _deficit),
    ("no-aiding", 1, 5.5, dict(carrier_aiding=False), None),
]


def _case(seed, unread_ms, fields, edit, n_ch=8):
    leaves = _leaves(n_ch=n_ch, seed=seed, unread_ms=unread_ms)
    if edit is not None:
        leaves = edit(leaves)
    if fields.get("intermediate_frequency"):
        leaves["carrier_freq"] = (
            leaves["carrier_freq"]
            + np.float32(fields["intermediate_frequency"])).astype(np.float32)
    return _cfg(**fields), leaves


def _jax_geometry(jcfg, jst, bits3x):
    """The JAX closed form's pass A, intercept and anchors, and the epoch
    bounds as its pass B takes them (``_pass_b``: ``b_start + base``
    clipped to the window, then the last epoch's end)."""
    geo = jbr._pass_a_closed(jcfg, jst)
    base, _, _, c_int, _ = jbr._intercept(jcfg, jst)
    bg = jbr.block_geometry(jcfg, bits3x, jst, geo)
    n_win = jcfg.window_samples
    req_eff = jnp.where(geo["active"], geo["required"], 0)
    b_start = jnp.clip(geo["b_start"] + base[None, :], 0, n_win)
    last_end = jnp.clip(b_start[-1:] + req_eff[-1:], 0, n_win)
    bounds = jnp.concatenate([b_start, last_end], axis=0)
    return geo, c_int, bg["fb_q"], bg["phic_q"], bounds


_JAX_GEOMETRY = jax.jit(_jax_geometry, static_argnums=0)


def _circular(a, b):
    d = np.abs(a - b)
    return np.minimum(d, 2 * np.pi - d)


@pytest.mark.parametrize("name, seed, unread_ms, fields, edit", CASES,
                         ids=[c[0] for c in CASES])
def test_geometry_matches_jax(name, seed, unread_ms, fields, edit):
    cfg, leaves = _case(seed, unread_ms, fields, edit)
    geo, inputs, bounds = gk.block_geometry_all(cfg, state_from_numpy(
        leaves, CPU))
    c_int, omega, code_step, fb_q, phic_q = inputs

    n_ch = len(leaves["mode"])
    jgeo, jc_int, jfb_q, jphic_q, jbounds = _JAX_GEOMETRY(
        _cfg(JaxConfig, **fields),
        JaxState(**{k: jnp.asarray(v) for k, v in leaves.items()}),
        jnp.asarray(jbr.tiled_code_bits(list(range(1, n_ch + 1)))))

    code_tol, carrier_tol = TOLS[bool(fields.get("intermediate_frequency"))]
    assert set(geo) == set(jgeo)
    for key in ("required", "active", "b_start", "unread_after",
                "unread_end", "consumed_end"):
        np.testing.assert_array_equal(geo[key].numpy(),
                                      np.asarray(jgeo[key]), err_msg=key)
    np.testing.assert_array_equal(c_int.numpy(), np.asarray(jc_int))
    np.testing.assert_array_equal(bounds.numpy(), np.asarray(jbounds))
    for key in ("rem_code", "rem_code_end"):
        err = np.abs(geo[key].numpy() - np.asarray(jgeo[key])).max()
        assert err <= code_tol, (key, err)
    err = np.abs(fb_q.numpy() - np.asarray(jfb_q)).max()
    assert err <= code_tol, ("fb_q", err)
    for key, got, want in (
            ("rem_carrier", geo["rem_carrier"], jgeo["rem_carrier"]),
            ("rem_carrier_end", geo["rem_carrier_end"],
             jgeo["rem_carrier_end"]),
            ("phic_q", phic_q, jphic_q)):
        err = _circular(got.numpy(), np.asarray(want)).max()
        assert err <= carrier_tol, (key, err)
    for key in ("delta", "code_step", "omega"):
        np.testing.assert_allclose(geo[key].numpy(), np.asarray(jgeo[key]),
                                   rtol=RATE_RTOL, atol=1e-6, err_msg=key)
    assert omega is geo["omega"] and code_step is geo["code_step"]

    # The branches the case is named for.
    active = geo["active"].numpy()
    if edit is _deficit:
        assert not active.any()
        assert (geo["required"][0].numpy() > cfg.samples_per_ms).all()
        np.testing.assert_array_equal(geo["rem_code_end"].numpy(),
                                      leaves["rem_code"])
    elif edit is _idle:
        assert not active[:, [1, 3]].any() and active[:, [0, 2]].all()
    else:
        assert active.all()


def test_cpu_wrapper_is_the_plain_composition():
    """On CPU tensors ``block_geometry_all`` is ``_pass_a`` and
    ``pass_b_inputs`` bit for bit (the same keys, dtypes, shapes and
    layout) and launches nothing; another device is refused."""
    cfg, leaves = _case(1, 5.5, dict(intermediate_frequency=2.58e6), None)
    st = state_from_numpy(leaves, CPU)
    before = gk.GEOMETRY_KERNEL.launches + gk.GEOMETRY_KERNEL.captured
    geo, inputs, bounds = gk.block_geometry_all(cfg, st)
    assert gk.GEOMETRY_KERNEL.launches + gk.GEOMETRY_KERNEL.captured \
        == before
    ref_geo = br._pass_a(cfg, st)
    ref_inputs, ref_bounds = br.pass_b_inputs(cfg, st, ref_geo)
    assert list(geo) == list(ref_geo) == list(gk.GEO_KEYS)
    for key in geo:
        assert geo[key].dtype == ref_geo[key].dtype, key
        assert torch.equal(geo[key], ref_geo[key]), key
    assert len(inputs) == len(ref_inputs) == 5
    for got, want in zip(inputs, ref_inputs):
        assert got.dtype == want.dtype and torch.equal(got, want)
    assert inputs[3].is_contiguous() and inputs[4].is_contiguous()
    assert torch.equal(bounds, ref_bounds) and bounds.dtype == torch.int32
    assert bounds.shape == (cfg.block_ms + 1, 8)
    with pytest.raises(ValueError, match="device"):
        gk.block_geometry_all(cfg, dataclasses.replace(
            st, rem_code=st.rem_code.to("meta")))


def test_scan_form_keeps_the_plain_ops():
    """``pass_a="scan"`` (the per-epoch oracle form) gives the scan form's
    geometry through the wrapper, and an unknown form is refused."""
    cfg, leaves = _case(0, 5.5, {}, None)
    st = state_from_numpy(leaves, CPU)
    scan = dataclasses.replace(cfg, pass_a="scan")
    geo, _, bounds = gk.block_geometry_all(scan, st)
    ref = br._pass_a_scan(scan, st)
    for key in ref:
        assert torch.equal(geo[key], ref[key]), key
    assert torch.equal(bounds, br.pass_b_inputs(scan, st, ref)[1])
    with pytest.raises(ValueError, match="pass_a"):
        gk.block_geometry_all(dataclasses.replace(cfg, pass_a="close"), st)


@pytest.mark.parametrize("fields", [
    {}, dict(block_ms=5, intermediate_frequency=2.58e6),
    dict(sampling_frequency=2.5e6, window_size=2756, carrier_aiding=False),
    dict(sampling_frequency=16.368e6, window_size=16624, tail_ms=2),
], ids=["10msps", "pull-in-if", "2.5msps-no-aiding", "16.368msps"])
def test_geometry_consts_match_plain_expressions(fields):
    """Each constant is the float32 value the plain version's op sees: a
    Python float rounded by its op, and ``x * (1.0 / s)`` a multiplication
    by ``f32(1 / s)`` (``loop_kernel.rcp``)."""
    cfg = _cfg(**fields)
    k = gk.geometry_consts(cfg)
    spms, fs = cfg.samples_per_ms, cfg.sampling_frequency

    def t(x):
        return torch.tensor([x], dtype=torch.float32)

    assert (k.n_epochs, k.n_anchors, k.samples_per_ms, k.tail_ms,
            k.window_samples, k.carrier_aiding) == (
        cfg.block_ms, cfg.tail_ms + cfg.block_ms, spms, cfg.tail_ms,
        cfg.window_samples, int(cfg.carrier_aiding))
    assert k.rcp_fs == lk.rcp(fs) == float(t(1.0) * (1.0 / fs))
    assert k.rcp_spms == lk.rcp(spms) == float(t(1.0) * (1.0 / spms))
    assert k.spms_over_fs == float(t(1.0) * (float(spms) / fs))
    assert k.spms == float(t(1.0) * spms)
    assert k.aiding == float(t(1.0) * (1.023e6 / 1575.42e6))
    for name, value in (("intermediate_frequency",
                         cfg.intermediate_frequency),
                        ("code_freq", 1.023e6), ("two_pi", 2.0 * math.pi),
                        ("code_length", 1023.0)):
        assert getattr(k, name) == float(t(value)), name
    assert gk.geometry_consts(cfg) is k


def _c_block(text, head):
    start = text.index(head + " {") + len(head) + 2
    return text[start:text.index("}", start)]


def test_structures_match_the_source():
    """The ctypes mirrors have the C structures' fields in order and type,
    the output rows follow the kernel's enums, and the kernel's constants
    are the package's."""
    cu = (native.CSRC_DIR / "block_geometry.cu").read_text()
    fields = re.findall(r"^\s*(int|float)\s+(\w+);",
                        _c_block(cu, "struct GeoConsts"), re.M)
    assert [(n, ctypes.c_int if ty == "int" else ctypes.c_float)
            for ty, n in fields] == gk.GeoConsts._fields_
    ptrs = re.findall(r"^\s*(?:const\s+)?\w+\*\s+(\w+);",
                      _c_block(cu, "struct GeoArgs"), re.M)
    assert ptrs == [n for n, _ in gk.GeoArgs._fields_]
    assert all(t is ctypes.c_void_p for _, t in gk.GeoArgs._fields_)

    def enum(name):
        return [m.strip() for m in _c_block(cu, f"enum {name}").split(",")
                if m.strip()]

    def camel(prefix, key):
        return prefix + "".join(p[:1].upper() + p[1:] for p in key.split("_"))

    for name, prefix, keys, end in (("VecF", "kVec", gk.VEC_F32, "kNumVecF"),
                                    ("VecI", "kVec", gk.VEC_I32, "kNumVecI"),
                                    ("SeqF", "kSeq", gk.SEQ_F32, "kNumSeqF"),
                                    ("SeqI", "kSeq", gk.SEQ_I32,
                                     "kNumSeqI")):
        assert enum(name) == [camel(prefix, k) for k in keys] + [end]
    assert sorted(gk.GEO_KEYS) == sorted(
        set(gk.VEC_F32 + gk.VEC_I32 + gk.SEQ_F32 + gk.SEQ_I32 + ("active",))
        - {"c_int"})
    assert re.search(r"constexpr int kModeTracking = (\d+);", cu).group(1) \
        == str(MODE_TRACKING)
    assert re.search(r"constexpr int kWarps = (\d+);", cu).group(1) \
        == str(gk.GEO_WARPS)
    assert gk.GEOMETRY_KERNEL.symbol in cu


def _write_plain(bufs, geo, inputs, bounds):
    """The plain version's results written into the kernel's buffers in
    its layout, as the kernel writes them."""
    rows = dict(geo, c_int=inputs[0])
    for name, keys in (("vec_f", gk.VEC_F32), ("vec_i", gk.VEC_I32),
                       ("seq_f", gk.SEQ_F32), ("seq_i", gk.SEQ_I32)):
        for j, key in enumerate(keys):
            bufs[name][j] = rows[key]
    bufs["active"][:] = geo["active"]
    bufs["anchors"][0] = inputs[3]
    bufs["anchors"][1] = inputs[4]
    bufs["bounds"][:] = bounds


@pytest.mark.parametrize("fields", [{}, dict(block_ms=5, tail_ms=2)],
                         ids=["cruise", "pull-in"])
def test_launch_args_round_trip(fields):
    """The launch arguments point at the state fields the kernel reads and
    at its output buffers; the buffers, filled in the kernel's layout with
    the plain version's results, unpack to those results: the same keys,
    dtypes, shapes and values, every tensor contiguous."""
    cfg, leaves = _case(2, 5.5, fields, _idle)
    st = state_from_numpy(leaves, CPU)
    bufs, args = gk.geometry_launch_args(cfg, st)
    consts, ptrs = args[0]._obj, args[1]._obj
    assert consts is gk.geometry_consts(cfg)
    assert args[2:] == (8,)
    for name in gk.STATE_F32 + gk.STATE_I32:
        assert getattr(ptrs, name) == getattr(st, name).data_ptr(), name
    for key, buf in bufs.items():
        assert getattr(ptrs, key) == buf.data_ptr(), key
        assert buf.is_contiguous()
    n_e, n_q = cfg.block_ms, cfg.tail_ms + cfg.block_ms
    assert bufs["anchors"].shape == (2, 8, n_q)
    assert bufs["bounds"].shape == (n_e + 1, 8)

    ref = gk.geometry_plain(cfg, st)
    _write_plain(bufs, *ref)
    geo, inputs, bounds = gk.unpack(bufs)
    assert list(geo) == list(ref[0])
    for key in geo:
        assert geo[key].dtype == ref[0][key].dtype, key
        assert geo[key].shape == ref[0][key].shape, key
        assert geo[key].is_contiguous(), key
        assert torch.equal(geo[key], ref[0][key]), key
    for got, want in zip(inputs, ref[1]):
        assert got.is_contiguous() and got.dtype == want.dtype
        assert torch.equal(got, want)
    assert inputs[1] is geo["omega"] and inputs[2] is geo["code_step"]
    assert torch.equal(bounds, ref[2])
    # pass C reads the contiguous activity at its own row stride.
    assert lk.active_stride(geo["active"]) == 8
    assert lk.active_stride(ref[0]["active"]) == 0


def test_launch_args_reject_bad_input():
    cfg, leaves = _case(0, 5.5, {}, None)
    st = state_from_numpy(leaves, CPU)
    bad = [
        ("unread", dataclasses.replace(st, unread=st.unread.long())),
        ("mode", dataclasses.replace(st, mode=st.mode.float())),
        ("carrier_freq", dataclasses.replace(
            st, carrier_freq=st.carrier_freq[:-1])),
        ("rem_carrier", dataclasses.replace(
            st, rem_carrier=st.rem_carrier.to("meta"))),
        ("code_freq_offset", dataclasses.replace(
            st, code_freq_offset=torch.stack(
                [st.code_freq_offset] * 2, 1)[:, 0])),
        ("rem_code", dataclasses.replace(st, rem_code=st.rem_code[:, None])),
    ]
    for what, state in bad:
        with pytest.raises(ValueError, match=what):
            gk.geometry_launch_args(cfg, state)
