"""Two real processes on ``torch.distributed`` (gloo, CPU tensors): the
port's ``parallel.distributed`` after tests/test_distributed.py.

Two ranks each own half of 4 channels (PRNs 5/12/21/29, 2 Msps) and run
the channel-sharded batch step on ``shard_from_hosts`` /
``replicate_from_host`` tensors (tests/_torch_distributed_worker.py,
spawned once for the module). Each rank's rows must equal the port's
single-process run bit for bit (the runtime is elementwise over channels
and the CPU plain versions are slice-invariant), and the JAX
``run_block_batched`` with integers exact and floats within the JAX
worker's own bounds (``rtol 1e-4, atol 1e-3``).
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
from sydr_tpu.signal.synthetic import IQGenerator
from sydr_tpu_torch.channels import batch_runtime as tbr
from sydr_tpu_torch.channels.runtime import TrackingConfig
from sydr_tpu_torch.channels.state import state_from_numpy
from sydr_tpu_torch.parallel import distributed, mesh as pmesh

FS = 2e6
N_CH = 4
PRNS = [5, 12, 21, 29]
DOPS = [1200.0, -2600.0, 3900.0, 700.0]
CASES = {   # case: (extra config fields, blocks)
    "block": ({}, 1),
    "prefix": (dict(use_pallas=True, boundary_mode="prefix"), 1),
    "superblock": (dict(superblock=2), 2),
}


def _inputs():
    gen = IQGenerator(FS, noise=True, seed=7)
    for prn, dop in zip(PRNS, DOPS):
        gen.add_satellite(prn, doppler_hz=dop, code_phase_chips=100.0,
                          cn0_dbhz=48.0)
    iq = gen.generate_ms(14)
    spms = round(FS * 1e-3)
    st = dataclasses.replace(
        jax_init(N_CH),
        mode=jnp.full((N_CH,), MODE_TRACKING, jnp.int32),
        carrier_freq=jnp.asarray(np.float32(DOPS)),
        rem_code=jnp.asarray(np.float32([0.02, 0.7, 0.4, 0.9])),
        rem_carrier=jnp.asarray(np.float32([0.3, 2.1, 5.0, 1.0])),
        code_freq_offset=jnp.asarray(np.float32([0.5, -1.2, 2.0, -0.4])),
        unread=jnp.asarray(np.int32(
            [int(1.1 * spms), int(1.4 * spms), int(1.2345 * spms),
             int(1.3 * spms)])),
    )
    leaves = {f.name: np.asarray(getattr(st, f.name))
              for f in dataclasses.fields(st)}
    base = dict(sampling_frequency=FS, block_ms=5, tail_ms=4,
                window_size=spms + 240, runtime="batch")
    entries, cases = {}, {}
    for case, (extra, k) in CASES.items():
        cfg = TrackingConfig(**base, **extra)
        n = (cfg.tail_ms + k * cfg.block_ms) * spms
        wre, wim = np.float32(iq.real[:n]), np.float32(iq.imag[:n])
        cases[case] = (cfg, k, wre, wim)
        entries.update(w.config_entries(case, cfg))
        entries.update(w.state_entries(case, leaves))
        entries[f"{case}__tables"] = tbr.tiled_code_bits(PRNS)
        entries[f"{case}__k_blocks"] = np.asarray(k)
        entries[f"{case}__wre"], entries[f"{case}__wim"] = wre, wim
    return entries, cases, st, leaves


def _port(cfg, k, leaves, wre, wim):
    bits = torch.from_numpy(tbr.tiled_code_bits(PRNS))
    st = state_from_numpy(leaves, "cpu")
    wre, wim = torch.from_numpy(wre), torch.from_numpy(wim)
    if k > 1:
        return tbr.run_superblock(cfg, k, bits, st, wre, wim)
    return tbr.run_block_batched(cfg, bits, st, wre, wim)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Spawn the 2-rank world once; meanwhile run the single-process port
    and JAX references here."""
    workdir = str(tmp_path_factory.mktemp("torch_distributed"))
    entries, cases, jst, leaves = _inputs()
    np.savez(f"{workdir}/inputs.npz", **entries)
    procs = w.spawn("distributed", 2, workdir)
    try:
        port, jax_out = {}, {}
        for case, (cfg, k, wre, wim) in cases.items():
            st, out = _port(cfg, k, leaves, wre, wim)
            port[case] = (st, {key: v.numpy() for key, v in out.items()})
            if case != "prefix":
                jcfg = JaxConfig(**{f.name: getattr(cfg, f.name)
                                    for f in dataclasses.fields(cfg)})
                bits = jnp.asarray(jbr.tiled_code_bits(PRNS))
                if k > 1:
                    jres = jbr.run_superblock(jcfg, k, bits, jst,
                                              jnp.asarray(wre),
                                              jnp.asarray(wim))
                else:
                    jres = jbr.run_block_batched(jcfg, bits, jst,
                                                 jnp.asarray(wre),
                                                 jnp.asarray(wim))
                jax_out[case] = (jres[0], {key: np.asarray(v)
                                           for key, v in jres[1].items()})
    finally:
        w.wait(procs)
    return workdir, port, jax_out


def _rank_rows(workdir, case, rank):
    got = w.load(workdir, case, rank)
    lo, hi = got["rows"]
    return got, slice(int(lo), int(hi))


@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("case", list(CASES))
def test_sharded_step_equals_single_process(world, case, rank):
    workdir, port, _ = world
    got, rows = _rank_rows(workdir, case, rank)
    assert rows == slice(2 * rank, 2 * rank + 2)
    st_ref, out_ref = port[case]
    for key, ref in out_ref.items():
        np.testing.assert_array_equal(got[f"out_{key}"], ref[:, rows],
                                      err_msg=key)
    for name in dataclasses.fields(st_ref):
        np.testing.assert_array_equal(
            got[f"st_{name.name}"], getattr(st_ref, name.name)[rows].numpy(),
            err_msg=name.name)


@pytest.mark.parametrize("case", ["block", "superblock"])
def test_sharded_step_matches_jax(world, case):
    workdir, _, jax_out = world
    jst, jout = jax_out[case]
    parts = [_rank_rows(workdir, case, r) for r in (0, 1)]
    for key, ref in jout.items():
        got = np.concatenate([g[f"out_{key}"] for g, _ in parts], axis=1)
        if ref.dtype.kind != "f":
            np.testing.assert_array_equal(got, ref, err_msg=key)
        else:
            np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-3,
                                       err_msg=key)
    for name in ("carrier_freq", "rem_code", "rem_carrier", "unread"):
        got = np.concatenate([g[f"st_{name}"] for g, _ in parts])
        want = np.asarray(getattr(jst, name))
        if name == "unread":
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4,
                                       err_msg=name)


@pytest.mark.parametrize("rank", [0, 1])
def test_broadcast_and_gather(world, rank):
    got = w.load(world[0], "collectives", rank)
    np.testing.assert_array_equal(got["broadcast"], np.full(3, 10.0))
    np.testing.assert_array_equal(got["local"], np.full(3, 10.0 * (rank + 1)))
    np.testing.assert_array_equal(
        got["gathered"], np.repeat(np.arange(2), 2)[:, None].repeat(3, 1))


def test_single_process_needs_no_group(monkeypatch):
    """No environment, no arguments: one process and no process group;
    a mesh over it has every axis of size 1."""
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    distributed.initialize("gloo")
    assert not torch.distributed.is_initialized()
    mesh = pmesh.make_mesh()
    assert mesh.shape == {"ch": 1, "dop": 1}
    assert mesh.coords == {"ch": 0, "dop": 0}
    assert pmesh.channel_slice(mesh, 5) == slice(0, 5)
    t = torch.arange(4.0)
    assert distributed.all_reduce(mesh, "ch", t) is t
    assert torch.equal(distributed.gather_axis(mesh, "dop", t), t)


def test_backend_is_named_not_sniffed():
    with pytest.raises(ValueError, match="backend"):
        distributed.initialize("auto")
    with pytest.raises(ValueError, match="rank and a world size"):
        distributed.initialize("gloo", rank=0)
    with pytest.raises(ValueError, match="needs 4 ranks"):
        distributed.Mesh(("ch", "dop"), (2, 2))


def test_dryrun_on_two_gloo_ranks():
    """``python -m sydr_tpu_torch.parallel.dryrun`` on two CPU ranks."""
    import subprocess
    import sys

    env = {k: v for k, v in w.os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = w.ROOT
    proc = subprocess.run(
        [sys.executable, "-m", "sydr_tpu_torch.parallel.dryrun", "--world",
         "2", "--backend", "gloo", "--device", "cpu"], cwd=w.ROOT, env=env,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert ("dryrun_multichip OK: mesh={'ch': 1, 'dop': 2} sp_shards=2 "
            "n_channels=8") in proc.stdout
    assert proc.stdout.count("launches {") == 2
