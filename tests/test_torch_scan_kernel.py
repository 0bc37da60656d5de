"""The scan runtime's block (``ops.scan_kernel.scan_block``) against the
JAX package's ``run_block`` on the CPU, and the host side of its CUDA
kernel.

The same numpy-seeded mid-track state and window
(``tests/_scan_inputs.py``: a bit-sync declaration and a bit completion
inside the block, acquiring channels, a channel whose first epoch is
inactive, channels not converged, the carrier and code rails acting) go
through the jitted JAX ``run_block`` (its ``lax.scan``) and the port's
``scan_block`` on CPU tensors, which is the plain ``_run_block_plain``,
for the loop shapes the kernel is specialised on: borre, kaplan and
narrow-only kaplan, DLF orders 2 and 3, ``fll_discriminator="atan2"``,
``cn0_estimator="beaulieu"``, rails off, no carrier aiding, quantised
spacings.

Bounds, ``tests/_scan_inputs.py``'s ``bound_faults`` (those of
``tests/test_torch_scan_runtime.py``): correlators by its tie rule;
integers (activity, lengths, unread counts, flags, lock states, bit
completions and the new state's counters, histogram and bit edge) equal;
code phase within 1e-5 chips and carrier within 0.05 Hz; every other
float within 1e-3 of its key's largest magnitude.

The host side of the kernel (no CUDA needed): its constants against the
expressions of the plain version, the C structures of
``csrc/scan_block.cu`` against their ctypes mirrors, the launch arguments'
pointers and checks, and the output tensors unpacked into the plain
version's state and outputs, bit for bit.
"""

import ctypes
import dataclasses
import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _scan_inputs import bound_faults, reached, scan_block_inputs, \
    scan_config
from sydr_tpu.channels import runtime as jrt
from sydr_tpu.channels.state import ChannelState as JaxState
from sydr_tpu_torch.channels import runtime as trt
from sydr_tpu_torch.channels.state import (
    F32_FIELDS,
    FIELDS,
    I32_FIELDS,
    I32_SCALAR_FIELDS,
    state_from_numpy,
)
from sydr_tpu_torch.constants import (
    GPS_L1CA_CARRIER_FREQ,
    GPS_L1CA_CODE_FREQ,
)
from sydr_tpu_torch.ops import loop_kernel as lk
from sydr_tpu_torch.ops import native
from sydr_tpu_torch.ops import profiles as prof
from sydr_tpu_torch.ops import scan_kernel as sk

torch.set_num_threads(2)

CPU = torch.device("cpu")
N_CH = 16
RAILS_OFF = dict(freq_rail_hz=0.0, code_rail_hz=0.0, anchor_slew_hz_per_s=0.0)

# (id, TrackingConfig fields): the kernel's specialisations and options.
CASES = [
    ("borre", dict(profile="borre")),
    ("borre-norails-noaiding-quantised",
     dict(profile="borre", carrier_aiding=False, quantize_spacing=True,
          **RAILS_OFF)),
    ("kaplan-o2-atan-nwpr", dict(profile="kaplan", block_ms=10)),
    ("kaplan-o3-atan2-beaulieu",
     dict(profile="kaplan", block_ms=10, dlf_order=3,
          fll_discriminator="atan2", cn0_estimator="beaulieu")),
    ("narrow-o2-quantised",
     dict(profile="kaplan", kaplan_narrow_only=True, quantize_spacing=True,
          sampling_frequency=4e6)),
    ("narrow-o3-atan2-beaulieu-norails",
     dict(profile="kaplan", kaplan_narrow_only=True, dlf_order=3,
          fll_discriminator="atan2", cn0_estimator="beaulieu", **RAILS_OFF)),
]


def _port_inputs(extra, n_ch=N_CH, seed=7):
    cfg = scan_config(**extra)
    leaves, codes, wre, wim = scan_block_inputs(cfg, n_ch, seed)
    return (cfg, leaves, torch.from_numpy(codes),
            state_from_numpy(leaves, CPU), torch.from_numpy(wre),
            torch.from_numpy(wim))


@pytest.mark.parametrize("name, extra", CASES, ids=[c[0] for c in CASES])
def test_scan_block_matches_jax(name, extra):
    cfg, leaves, codes, st, wre, wim = _port_inputs(extra)
    new_st, out = sk.scan_block(cfg, codes, st, wre, wim)
    assert {"declare", "bit", "idle", "late"} <= reached(st, new_st, out)

    jst = JaxState(**{k: jnp.asarray(v) for k, v in leaves.items()})
    jcfg = jrt.TrackingConfig(**dataclasses.asdict(cfg))
    jnew, jout = jrt.run_block(jcfg, jnp.asarray(codes.numpy()), jst,
                               jnp.asarray(wre.numpy()),
                               jnp.asarray(wim.numpy()))
    # JAX's outputs in the port's key order, its state as the port's.
    ref = {k: torch.from_numpy(np.array(jout[k])) for k in out}
    ref_st = state_from_numpy({k: np.asarray(getattr(jnew, k))
                               for k in FIELDS}, CPU)
    assert set(jout) == set(out)
    for k in out:
        assert ref[k].shape == (cfg.block_ms, N_CH), k
    peak = max(float(wre.abs().max()), float(wim.abs().max()))
    faults, _ = bound_faults((new_st, out), (ref_st, ref), peak)
    assert not faults, faults
    got = {k: v.numpy() for k, v in out.items()}
    ref = {k: v.numpy() for k, v in ref.items()}
    np.testing.assert_allclose(got["code_freq"], ref["code_freq"],
                               rtol=1e-7)
    d = np.abs(new_st.rem_carrier.numpy() - np.asarray(jnew.rem_carrier))
    assert np.minimum(d, 2 * np.pi - d).max() < 1e-3
    if cfg.freq_rail_hz > 0:
        # Channel 0's anchor is past the rail: the clamp holds its carrier.
        rail = float(np.float32(leaves["freq_anchor"][0]
                                + np.float32(cfg.freq_rail_hz)))
        assert got["carrier_freq"][:, 0].max() == rail


def test_scan_block_on_cpu_is_the_plain_version():
    """On CPU tensors ``scan_block`` and ``run_block`` are
    ``_run_block_plain``, bit for bit, and launch nothing; any other
    device than the CPU or CUDA is refused."""
    cfg, _, codes, st, wre, wim = _port_inputs(CASES[0][1], n_ch=8)
    before = sk.SCAN_KERNEL.launches + sk.SCAN_KERNEL.captured
    ref_st, ref = trt._run_block_plain(cfg, codes, st, wre, wim)
    for new_st, out in (sk.scan_block(cfg, codes, st, wre, wim),
                        trt.run_block(cfg, codes, st, wre, wim)):
        assert list(out) == list(ref)
        for key in ref:
            assert torch.equal(out[key], ref[key]), key
        for key in FIELDS:
            assert torch.equal(getattr(new_st, key),
                               getattr(ref_st, key)), key
    assert sk.SCAN_KERNEL.launches + sk.SCAN_KERNEL.captured == before
    with pytest.raises(ValueError, match="device"):
        sk.scan_block(cfg, codes, st, wre.to("meta"), wim.to("meta"))


@pytest.mark.parametrize("name, extra", CASES, ids=[c[0] for c in CASES])
def test_scan_consts_match_plain_expressions(name, extra):
    """Each constant is the float32 value the plain version's op sees."""
    cfg = scan_config(**extra)
    k = sk.scan_consts(cfg)
    sp = prof.spacings_for(cfg)
    spms = cfg.samples_per_ms
    assert (k.samples_per_ms, k.tail_ms, k.window_size, k.n_spacings,
            k.carrier_aiding) == (spms, cfg.tail_ms, cfg.window_size,
                                  len(sp), int(cfg.carrier_aiding))
    assert list(k.spacing)[:len(sp)] == [float(np.float32(s)) for s in sp]
    assert k.slew_on == int(cfg.anchor_slew_hz_per_s > 0
                            and cfg.freq_rail_hz > 0)
    # scan_phase_advance's ratio, as its float32 tensors compute it.
    assert k.code_ratio == (torch.tensor(1023.0, dtype=torch.float32)
                            * torch.tensor(1.0 / spms,
                                           dtype=torch.float32)).item()
    for name_, value in (
            ("intermediate_frequency", cfg.intermediate_frequency),
            ("aiding", GPS_L1CA_CODE_FREQ / GPS_L1CA_CARRIER_FREQ),
            ("rcp_fs", 1.0 / cfg.sampling_frequency),
            ("code_length", 1023.0),
            ("slew_step", cfg.anchor_slew_hz_per_s * cfg.block_ms * 1e-3)):
        assert getattr(k, name_) == float(np.float32(value)), name_
    assert sk.scan_consts(cfg) is k


def _c_source(name):
    return (native.CSRC_DIR / name).read_text()


def _c_block(text, head):
    start = text.index(head + " {") + len(head) + 2
    return text[start:text.index("}", start)]


def test_structures_match_the_sources():
    """The ctypes mirrors have ``csrc/scan_block.cu``'s structures' fields
    in order, with their types and counts; its constants are the host's."""
    cu = _c_source("scan_block.cu")
    assert '#include "channel_layout.cuh"' in cu
    assert '#include "loop_update.cuh"' in cu
    types = {"int": ctypes.c_int, "float": ctypes.c_float,
             "double": ctypes.c_double}
    fields = re.findall(r"^\s*(int|float|double)\s+(\w+)(?:\[(\w+)\])?;",
                        _c_block(cu, "struct ScanConsts"), re.M)
    counts = {"kMaxSpacings": sk.MAX_SPACINGS}
    want = [(n, types[ty] * counts[c] if c else types[ty])
            for ty, n, c in fields]
    got = sk.ScanConsts._fields_
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, a), (_, b) in zip(got, want):
        assert ctypes.sizeof(a) == ctypes.sizeof(b), name
        assert getattr(a, "_length_", 1) == getattr(b, "_length_", 1), name
    ptrs = re.findall(r"^\s*(?:const\s+)?\w+\*\s+(\w+)(?:\[(\w+)\])?;",
                      _c_block(cu, "struct ScanArgs"), re.M)
    counts = {"kNumStateF": len(F32_FIELDS),
              "kNumStateI": len(I32_SCALAR_FIELDS)}
    assert [(n, counts.get(c, 1)) for n, c in ptrs] == [
        (n, getattr(t, "_length_", 1)) for n, t in sk.ScanArgs._fields_]
    for name, value in (("kMaxSpacings", sk.MAX_SPACINGS),
                        ("kThreads", sk.SCAN_THREADS),
                        ("kCluster", sk.SCAN_CLUSTER),
                        ("kCodeLen", sk.CODE_LEN)):
        assert re.search(rf"constexpr int {name} = (\d+);", cu).group(1) \
            == str(value), name
    assert f"window_size > (1 << {int(math.log2(sk.MAX_WINDOW))})" in cu
    # The launch's argument types: the three structures, n_ch, block_ms,
    # the window's length and the stream (no cluster size: it is compiled
    # in).
    assert sk.SCAN_KERNEL.argtypes[3:] == [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    assert "extern \"C\" int scan_block_max_clusters(" in cu
    # The protocol check's fault kinds are the host's, in order.
    kinds = re.findall(r"^\s*(kFault\w+),", _c_block(cu, "enum Fault"), re.M)
    assert len(kinds) == len(sk.PROTOCOL_FAULTS) == 5, kinds
    assert "extern \"C\" int scan_block_protocol_faults(" in cu


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


@pytest.mark.parametrize("name, extra", CASES[::2],
                         ids=[c[0] for c in CASES[::2]])
def test_launch_args_round_trip(name, extra):
    """The launch arguments point at the tensors the kernel reads and the
    output buffers it writes; those buffers, filled in the kernel's layout
    with the plain version's results, unpack to those results: the same
    keys, dtypes, shapes and values."""
    cfg, _, codes, st, wre, wim = _port_inputs(extra, n_ch=8)
    bufs, args = sk.scan_launch_args(cfg, codes, st, wre, wim)
    consts, scan, ptrs = args[0]._obj, args[1]._obj, args[2]._obj
    assert consts is lk.loop_consts(cfg)
    assert scan is sk.scan_consts(cfg)
    assert args[3:] == (8, cfg.block_ms, cfg.window_samples)
    assert list(ptrs.state_f) == [getattr(st, n).data_ptr()
                                  for n in F32_FIELDS]
    assert list(ptrs.state_i) == [getattr(st, n).data_ptr()
                                  for n in I32_SCALAR_FIELDS]
    assert ptrs.edge_hist == st.edge_hist.data_ptr()
    assert ptrs.codes == codes.data_ptr()
    assert (ptrs.window_re, ptrs.window_im) == (wre.data_ptr(),
                                                wim.data_ptr())
    for key, buf in bufs.items():
        assert getattr(ptrs, key) == buf.data_ptr(), key
        assert buf.is_contiguous()

    new_st, out = trt._run_block_plain(cfg, codes, st, wre, wim)
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
    """What the kernel does not take is refused before any launch: a
    spacing count the loops' specialisation does not hold, a window_size
    out of range, no epoch, and tensors of the wrong dtype, device or
    shape."""
    cfg, _, codes, st, wre, wim = _port_inputs(CASES[0][1], n_ch=4)
    for spacings in ((-0.5, 0.5), (-0.5, -0.3, -0.1, 0.0, 0.1, 0.3)):
        bad = dataclasses.replace(cfg, spacings=spacings)
        with pytest.raises(ValueError, match="spacings"):
            sk.scan_launch_args(bad, codes, st, wre, wim)
    for size in (0, sk.MAX_WINDOW + 1):
        bad = dataclasses.replace(cfg, window_size=size)
        with pytest.raises(ValueError, match="window_size"):
            sk.scan_launch_args(bad, codes, st, wre, wim)
    with pytest.raises(ValueError, match="block_ms"):
        sk.scan_launch_args(dataclasses.replace(cfg, block_ms=0), codes, st,
                            wre, wim)
    wrong = [
        ("code_counter", (codes, dataclasses.replace(
            st, code_counter=st.code_counter.long()), wre, wim)),
        ("carrier_freq", (codes, dataclasses.replace(
            st, carrier_freq=st.carrier_freq.to("meta")), wre, wim)),
        ("edge_hist", (codes, dataclasses.replace(
            st, edge_hist=st.edge_hist[:, :19]), wre, wim)),
        ("cn0", (codes, dataclasses.replace(
            st, cn0=torch.stack([st.cn0, st.cn0], 1)[:, 0]), wre, wim)),
        ("codes", (codes[:, :1024], st, wre, wim)),
        ("codes", (codes[0], st, wre, wim)),
        ("codes", (codes.double(), st, wre, wim)),
        ("window_re", (codes, st, wre[:-1], wim)),
        ("window_im", (codes, st, wre, wim.double())),
    ]
    for what, args in wrong:
        with pytest.raises(ValueError, match=what):
            sk.scan_launch_args(cfg, *args)
    # kaplan's five spacings, narrow-only kaplan's three: the only counts.
    assert sk.spacing_counts(cfg) == (3, 4, 5)
    assert sk.spacing_counts(dataclasses.replace(cfg, profile="kaplan")) \
        == (5,)
    assert sk.spacing_counts(dataclasses.replace(
        cfg, profile="kaplan", kaplan_narrow_only=True)) == (3,)


# Rates the cluster size is held on: the scan runtime's, 1.023 to 99.375
# Msps.
RULE_RATES = (1.023e6, 2.5e6, 10e6, 16.368e6, 99.375e6)


def test_scan_cluster_rule():
    """The cluster size is one constant, the kernel's kCluster, whatever
    the configuration and the channel count: the launch takes no cluster
    argument, and its arguments at 1, 5, 8 and 32 channels differ only in
    the channel count, at each rate and loop shape."""
    cu = _c_source("scan_block.cu")
    assert re.search(r"constexpr int kCluster = (\d+);", cu).group(1) \
        == str(sk.SCAN_CLUSTER) == "4"
    assert "attr.val.clusterDim.x = kCluster;" in cu
    assert "cfg.gridDim = dim3(n_ch * kCluster);" in cu
    for extra in (dict(profile="borre"), dict(profile="kaplan"),
                  dict(profile="kaplan", kaplan_narrow_only=True)):
        for fs in RULE_RATES:
            cfg = scan_config(sampling_frequency=fs, block_ms=2, **extra)
            for n_ch in (1, 5, 8, 32):
                _, args = sk.scan_launch_args(cfg, *_tensors(cfg, n_ch))
                assert args[3:] == (n_ch, 2, cfg.window_samples), (fs, n_ch)


def _tensors(cfg, n_ch):
    """Inputs of ``cfg``'s block on the CPU at ``n_ch`` channels, as
    :func:`sk.scan_launch_args` takes them (values irrelevant)."""
    from sydr_tpu_torch.channels.state import init_state

    n = cfg.window_samples
    return (torch.zeros(n_ch, sk.CODE_LEN), init_state(n_ch, CPU),
            torch.zeros(n), torch.zeros(n))


def test_check_build_is_the_source():
    """The protocol check is the production kernel's source and entry
    point built with ``-DSCAN_CHECK_PROTOCOL`` alone, into a library of its
    own; every check in the source sits behind ``kCheck``."""
    prod, check = sk.SCAN_KERNEL, sk.SCAN_CHECK_KERNEL
    assert (check.source, check.symbol, check.argtypes, check.csrc_dir) == (
        prod.source, prod.symbol, prod.argtypes, prod.csrc_dir)
    assert prod.flags == () and check.flags == ("-DSCAN_CHECK_PROTOCOL",)
    assert check.library_path() != prod.library_path()
    assert check.library_path().parent == prod.library_path().parent
    cu = _c_source("scan_block.cu")
    assert cu.count("#ifdef SCAN_CHECK_PROTOCOL") == 1
    assert "constexpr bool kCheck = true;" in cu
    assert "constexpr bool kCheck = false;" in cu
    # A fault is counted only in the check build; its waits likewise.
    assert "if (kCheck && bad) atomicAdd(&scan_protocol_faults[kind], 1u);" \
        in cu
    assert "  if (!kCheck) return;\n  uint32_t h =" in cu


def _scan_variant_tool():
    from tools import torch_kernel_variants

    return torch_kernel_variants


@pytest.mark.parametrize(
    "label", [v[0] for v in _scan_variant_tool().SCAN_VARIANTS])
def test_scan_variants_apply_to_the_source(label):
    """Each of ``tools/torch_kernel_variants.py --scan``'s variants matches
    the kernel's source (its texts once each in the source and headers),
    and changes it, checked on the CPU before any build on the card."""
    tool = _scan_variant_tool()
    lines, swaps = {v[0]: v[1:] for v in tool.SCAN_VARIANTS}[label]
    texts = tool.variant_texts(sk.SCAN_KERNEL, lines, swaps)
    source = {name: (sk.SCAN_KERNEL.csrc_dir / name).read_text()
              for name in texts}
    assert set(texts) >= {"scan_block.cu", "loop_update.cuh"}
    assert texts != source
