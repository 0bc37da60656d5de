"""Time-sharded (``sp``) block correlation of the port
(``parallel.timeshard``) on four real processes, after
tests/test_timeshard.py.

One gloo world of 4 ranks (tests/_torch_distributed_worker.py, spawned
once for the module) runs tests/test_timeshard.py's block (4 Msps, 2
channels, 4 + 20 ms) on an ``sp`` mesh of 4 and on a ``(ch, sp)`` mesh of
(2, 2), in both pass B forms (K1 row sums and the K3 prefix), with plain
and with quantised taps (positive sample shifts, which read the next
millisecond's anchors at a shard's edge). Each is held

* against the JAX ``run_block_batched_timesharded`` on as many virtual
  devices (plain taps) and against the JAX unsharded block (both tap
  forms), both of which run the JAX dense pass B: correlators within
  ``rtol 1e-3, atol 1.0`` (the bounds tests/test_timeshard.py holds JAX to
  itself), ``unread`` exact, the carrier within 0.05 Hz;
* against the port's unsharded block: every per-sample stream value is the
  unsharded one and only the order of the sums differs, so correlators
  within 1e-5 of the largest, integers exact.

A block whose milliseconds do not divide over the shards raises, and
``run_superblock_timesharded`` over 2 blocks is held to the port's
unsharded superblock as above and to the JAX block loop at
tests/test_timeshard.py's superblock bounds. The JAX references are
computed once, while the ranks run.

The captured form, ``timeshard.TimeShardGraph``, runs every case and the
superblock on the same ranks through the graph's CPU stand-in
(``StepGraph(cpu, capture=False)``), twice: the first call (the warm-up)
and the second (where a replay runs) equal the eager call bit for bit. On
gloo its default is eager.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_distributed_worker as w
from sydr_tpu.channels import batch_runtime as jbr
from sydr_tpu.channels.runtime import TrackingConfig as JaxConfig
from sydr_tpu.channels.state import MODE_TRACKING, init_state as jax_init
from sydr_tpu.parallel import timeshard as jts
from sydr_tpu.signal.synthetic import IQGenerator
from sydr_tpu_torch.channels import batch_runtime as tbr
from sydr_tpu_torch.channels.runtime import TrackingConfig
from sydr_tpu_torch.channels.state import FIELDS, I32_FIELDS, state_from_numpy

FS = 4e6
PRNS = [5, 12]
DOPS = [1200.0, -2600.0]
CORR_KEYS = ("i_early", "q_early", "i_prompt", "q_prompt", "i_late",
             "q_late")
BASE = dict(sampling_frequency=FS, block_ms=20, tail_ms=4, window_size=4224,
            runtime="batch")
PREFIX = dict(use_pallas=True, boundary_mode="prefix")
CASES = {   # case: (shards, config fields)
    "rowsum_sp2": (2, {}),
    "rowsum_sp4": (4, {}),
    "prefix_sp2": (2, PREFIX),
    "prefix_sp4": (4, PREFIX),
    "rowsum_sp4_shifted": (4, dict(quantize_spacing=True)),
    "prefix_sp2_shifted": (2, dict(PREFIX, quantize_spacing=True)),
}
SUPERBLOCK = dict(BASE, use_pallas=True, boundary_mode="rowsum",
                  quantize_spacing=True, superblock=2)


def _samples(n_ms):
    gen = IQGenerator(FS, noise=True, seed=7)
    for prn, dop in zip(PRNS, DOPS):
        gen.add_satellite(prn, doppler_hz=dop, code_phase_chips=77.0,
                          cn0_dbhz=48.0)
    iq = gen.generate_ms(n_ms)
    return np.float32(iq.real), np.float32(iq.imag)


def _jax_state():
    n = len(PRNS)
    return dataclasses.replace(
        jax_init(n),
        mode=jnp.full((n,), MODE_TRACKING, jnp.int32),
        carrier_freq=jnp.asarray(np.float32(DOPS)),
        rem_code=jnp.asarray(np.float32([0.05, 0.6])),
        rem_carrier=jnp.asarray(np.float32([0.4, 2.2])),
        unread=jnp.asarray(np.int32([5000, 6500])),
    )


def _port_run(cfg, leaves, k, sre, sim):
    bits = torch.from_numpy(tbr.tiled_code_bits(PRNS))
    args = (bits, state_from_numpy(leaves, "cpu"), torch.from_numpy(sre),
            torch.from_numpy(sim))
    if k > 1:
        st, out = tbr.run_superblock(cfg, k, *args)
    else:
        st, out = tbr.run_block_batched(cfg, *args)
    return st, {key: v.numpy() for key, v in out.items()}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Spawn the 4-rank world once; meanwhile run the port unsharded."""
    workdir = str(tmp_path_factory.mktemp("torch_timeshard"))
    jst = _jax_state()
    leaves = {f.name: np.asarray(getattr(jst, f.name))
              for f in dataclasses.fields(jst)}
    wre, wim = _samples(24)
    sre, sim = _samples(44)
    wre21, wim21 = _samples(25)
    entries = {"cases": np.asarray(list(CASES)), "wre": wre, "wim": wim,
               "sre": sre, "sim": sim, "wre21": wre21, "wim21": wim21,
               "bits3x": tbr.tiled_code_bits(PRNS),
               **w.state_entries("state", leaves)}
    cfgs = {}
    for case, (n_sp, extra) in CASES.items():
        cfgs[case] = TrackingConfig(**BASE, **extra)
        entries.update(w.config_entries(case, cfgs[case]))
        entries[f"{case}__n_sp"] = np.asarray(n_sp)
    entries.update(w.config_entries(
        "block21", TrackingConfig(**dict(BASE, block_ms=21))))
    entries.update(w.config_entries("superblock",
                                    TrackingConfig(**SUPERBLOCK)))
    # Anchor columns 0..23, told apart by value, for the edge case.
    fb_q = np.tile(np.arange(24, dtype=np.float32), (2, 1))
    fb_q[1] += 100.0
    entries["edge__fb_q"] = fb_q
    np.savez(f"{workdir}/inputs.npz", **entries)
    procs = w.spawn("timeshard", 4, workdir)
    try:
        port = {case: _port_run(cfg, leaves, 1, wre, wim)
                for case, cfg in cfgs.items()}
        port["superblock"] = _port_run(TrackingConfig(**SUPERBLOCK), leaves,
                                       2, sre, sim)
        jax_refs = _jax_references(jst, wre, wim, sre, sim)
    finally:
        w.wait(procs)
    return dict(workdir=workdir, port=port, jax=jax_refs)


def _jax_cfg(fields):
    fields = dict(fields, use_pallas=False, boundary_mode="rowsum",
                  superblock=1)
    return JaxConfig(**fields)


def _jax_references(jst, wre, wim, sre, sim):
    """The JAX dense block, time-sharded on 2 and 4 virtual devices and
    unsharded with both tap forms, and its superblock as its block loop
    (the same compiled block twice)."""
    bits = jnp.asarray(jbr.tiled_code_bits(PRNS))
    wre, wim = jnp.asarray(wre), jnp.asarray(wim)
    refs = {("sp", n_sp): jts.run_block_batched_timesharded(
        _jax_cfg(BASE), jts.make_sp_mesh(n_sp), bits, jst, wre, wim)
        for n_sp in (2, 4)}
    for quantize in (False, True):
        refs[("unsharded", quantize)] = jbr.run_block_batched(
            _jax_cfg(dict(BASE, quantize_spacing=quantize)), bits, jst, wre,
            wim)
    cfg = _jax_cfg(SUPERBLOCK)
    st, outs = jst, []
    for k in range(2):
        lo = k * cfg.block_ms * cfg.samples_per_ms
        st, out = jbr.run_block_batched(
            cfg, bits, st, jnp.asarray(sre[lo:lo + cfg.window_samples]),
            jnp.asarray(sim[lo:lo + cfg.window_samples]))
        outs.append(out)
    refs["superblock"] = (st, {key: np.concatenate(
        [np.asarray(o[key]) for o in outs]) for key in outs[0]})
    return refs


def _gather(workdir, case):
    """A case's outputs and state over the channel rows, from the ranks
    of the first ``sp`` position; checks that the ranks of each ``sp``
    line agree."""
    n_sp = CASES[case][0] if case in CASES else 4
    parts = [w.load(workdir, case, r) for r in range(4)]
    lines = [[0, 1, 2, 3]] if n_sp == 4 else [[0, 1], [2, 3]]
    for line in lines:
        for r in line[1:]:
            for key in parts[line[0]]:
                np.testing.assert_array_equal(parts[r][key],
                                              parts[line[0]][key],
                                              err_msg=f"rank {r} {key}")
    heads = [parts[line[0]] for line in lines]
    out = {k[4:]: np.concatenate([p[k] for p in heads], axis=1)
           for k in heads[0] if k.startswith("out_")}
    st = {k[3:]: np.concatenate([p[k] for p in heads])
          for k in heads[0] if k.startswith("st_")}
    return out, st


def _assert_jax_bounds(out, st, jst, jout):
    for key in CORR_KEYS:
        np.testing.assert_allclose(out[key], np.asarray(jout[key]),
                                   rtol=1e-3, atol=1.0, err_msg=key)
    np.testing.assert_allclose(st["carrier_freq"],
                               np.asarray(jst.carrier_freq), atol=0.05)
    np.testing.assert_array_equal(st["unread"], np.asarray(jst.unread))
    np.testing.assert_array_equal(out["unread"], np.asarray(jout["unread"]))


@pytest.mark.parametrize("case", [c for c in CASES if "shifted" not in c])
def test_timesharded_matches_jax_timesharded(world, case):
    out, st = _gather(world["workdir"], case)
    _assert_jax_bounds(out, st, *world["jax"][("sp", CASES[case][0])])


@pytest.mark.parametrize("case", list(CASES))
def test_timesharded_matches_jax_unsharded(world, case):
    out, st = _gather(world["workdir"], case)
    quantize = CASES[case][1].get("quantize_spacing", False)
    _assert_jax_bounds(out, st, *world["jax"][("unsharded", quantize)])


def _assert_port_bounds(out, st, st_ref, out_ref):
    scale = max(np.abs(out_ref[k]).max() for k in CORR_KEYS)
    for key, ref in out_ref.items():
        if key in CORR_KEYS:
            np.testing.assert_allclose(out[key], ref, rtol=0,
                                       atol=1e-5 * scale, err_msg=key)
        elif ref.dtype.kind != "f":
            np.testing.assert_array_equal(out[key], ref, err_msg=key)
    for name in FIELDS:
        if name in I32_FIELDS:
            np.testing.assert_array_equal(
                st[name], getattr(st_ref, name).numpy(), err_msg=name)


@pytest.mark.parametrize("case", list(CASES))
def test_timesharded_matches_port_unsharded(world, case):
    out, st = _gather(world["workdir"], case)
    st_ref, out_ref = world["port"][case]
    _assert_port_bounds(out, st, st_ref, out_ref)
    np.testing.assert_allclose(st["carrier_freq"],
                               st_ref.carrier_freq.numpy(), atol=1e-3)


@pytest.mark.parametrize("rank", [0, 1, 2, 3])
def test_shard_reads_one_anchor_column_past_its_edge(world, rank):
    """4 shards of 24 ms: rank d owns ms [6d, 6d + 6) and is given the
    window and anchors of ms [6d, min(6d + 7, 24))."""
    got = w.load(world["workdir"], "edge", rank)
    spms = round(FS * 1e-3)
    q0, q1 = 6 * rank, min(6 * rank + 7, 24)
    fb_q = np.tile(np.arange(24, dtype=np.float32), (2, 1))
    fb_q[1] += 100.0
    np.testing.assert_array_equal(got["fb_l"], fb_q[:, q0:q1])
    assert int(got["n_win"]) == (q1 - q0) * spms
    assert int(got["m0"]) == q0 * spms


def test_timeshard_requires_divisible_ms(world):
    for r in range(4):
        raised = str(w.load(world["workdir"], "block21", r)["raised"])
        assert raised == "tail_ms + block_ms = 25 must divide over 4 shards"


def test_timesharded_superblock_matches_unsharded(world):
    out, st = _gather(world["workdir"], "superblock")
    st_ref, out_ref = world["port"]["superblock"]
    _assert_port_bounds(out, st, st_ref, out_ref)
    jst, jout = world["jax"]["superblock"]
    for key in ("i_prompt", "q_prompt"):
        ref = np.asarray(jout[key])
        np.testing.assert_allclose(out[key], ref, rtol=2e-2,
                                   atol=0.02 * np.abs(ref).max(),
                                   err_msg=key)
    np.testing.assert_allclose(st["carrier_freq"],
                               np.asarray(jst.carrier_freq), atol=0.1)


@pytest.mark.parametrize("case", [*CASES, "superblock"])
def test_timeshard_graph_stand_in_equals_eager(world, case):
    for r in range(4):
        want = w.load(world["workdir"], case, r)
        keys = sorted(k for k in want if k.startswith(("out_", "st_")))
        for call in (0, 1):
            got = w.load(world["workdir"], f"{case}_graph{call}", r)
            assert sorted(got) == keys
            for key in keys:
                np.testing.assert_array_equal(
                    got[key], want[key], err_msg=f"rank {r} call {call} {key}")


def test_timeshard_graph_default_on_gloo_is_eager(world):
    for r in range(4):
        assert bool(w.load(world["workdir"], "ts_graph_default", r)["eager"])
