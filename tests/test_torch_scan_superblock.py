"""The scan runtime's superblock (``channels.runtime.run_superblock``) on
the CPU, where every block is the plain version (``_run_block_plain``).

(a) ``k`` blocks in one call equal ``k`` calls of ``run_block`` over the
    same windows bit for bit, at k = 1 and 3, on ``tests/_scan_inputs.py``'s
    mid-track inputs (8 channels, 2.5 Msps).
(b) They equal the benchmark's frozen plain copy
    (``benchmark/reference/scan_block.py``) run block by block, bit for
    bit.
(c) A ``TrackingSession`` whose scan configuration runs 5 blocks a call
    gives the outputs and state of one that runs one block a call over the
    same samples (no channel acquiring); a session takes a scan superblock without a mesh
    (``tests/test_torch_scan_runtime.py``: under a mesh it raises).

This module imports no JAX.
"""

import dataclasses

import numpy as np
import pytest
import torch
from _scan_inputs import scan_block_tensors, scan_config

from benchmark.reference import scan_block as ref
from sydr_tpu_torch.channels import runtime as rt
from sydr_tpu_torch.channels.state import (
    FIELDS,
    MODE_IDLE,
    MODE_TRACKING,
    ChannelState,
    state_to_numpy,
)
from sydr_tpu_torch.receiver.session import TrackingSession

CPU = torch.device("cpu")
N_CH = 8
SEED = 5


def _inputs(k):
    """The scan configuration (20 ms blocks at 2.5 Msps) and inputs over
    ``tail_ms + k * block_ms`` milliseconds."""
    cfg = scan_config(profile="borre")
    long_cfg = dataclasses.replace(cfg, block_ms=k * cfg.block_ms)
    return (cfg, *scan_block_tensors(long_cfg, N_CH, SEED, CPU))


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _assert_same(got, want):
    (got_st, got_out), (want_st, want_out) = got, want
    assert list(got_out) == list(want_out)
    for key in want_out:
        a, b = got_out[key], want_out[key]
        assert a.dtype == b.dtype and a.shape == b.shape, key
        assert torch.equal(_bits(a), _bits(b)), key
    got_st = got_st if isinstance(got_st, dict) else state_to_numpy(got_st)
    want_st = (want_st if isinstance(want_st, dict)
               else state_to_numpy(want_st))
    for name in FIELDS:
        np.testing.assert_array_equal(
            np.asarray(got_st[name]).view(np.int32),
            np.asarray(want_st[name]).view(np.int32), err_msg=name)


@pytest.mark.parametrize("k", [1, 3])
def test_superblock_equals_its_blocks(k):
    cfg, codes, st, sre, sim = _inputs(k)
    got = rt.run_superblock(cfg, k, codes, st, sre, sim)
    sb, outs = cfg.block_ms * cfg.samples_per_ms, []
    state = st
    for b in range(k):
        state, out = rt.run_block(
            cfg, codes, state, sre[b * sb:b * sb + cfg.window_samples],
            sim[b * sb:b * sb + cfg.window_samples])
        outs.append(out)
    _assert_same(got, (state, {key: torch.cat([o[key] for o in outs])
                               for key in outs[0]}))
    assert got[1]["i_prompt"].shape == (k * cfg.block_ms, N_CH)


def _ref_config(cfg, k):
    """The benchmark's configuration form of ``cfg`` at ``k`` blocks a
    superblock."""
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(cfg)}
    fields["window_extra_samples"] = cfg.window_size - cfg.samples_per_ms
    return {"sampling_frequency": cfg.sampling_frequency,
            "intermediate_frequency": cfg.intermediate_frequency,
            "tracking": fields, "cruise": {"superblock": k}}


def test_superblock_equals_the_plain_copy():
    k = 3
    cfg, codes, st, sre, sim = _inputs(k)
    got = rt.run_superblock(cfg, k, codes, st, sre, sim)
    prns = [i + 1 for i in range(N_CH)]
    ref_codes = torch.from_numpy(ref.code_table(prns))
    assert torch.equal(ref_codes, codes)
    want = ref.run_superblock(ref.Params(_ref_config(cfg, k)), ref_codes,
                              _leaves(st), sre, sim)
    _assert_same(got, want)
    # Past the first block the loops still track (a superblock that held
    # its state would match nothing past block 1).
    assert got[1]["active"][cfg.block_ms:].any()


def _leaves(st):
    return {name: getattr(st, name).clone() for name in FIELDS}


def test_the_plain_copy_covers_only_the_borre_scan_block():
    cfg = scan_config(profile="kaplan")
    with pytest.raises(ValueError, match="borre"):
        ref.Params(_ref_config(cfg, 1))


def _session(superblock, st, tail):
    """A session of ``superblock`` scan blocks a call, tracking from
    ``st`` with ``tail`` (re, im) as the previous block's last
    milliseconds."""
    cfg = scan_config(profile="borre", superblock=superblock,
                      upload_int8=False)
    session = TrackingSession(cfg, [i + 1 for i in range(N_CH)], device=CPU)
    leaves = _leaves(st)
    # The acquiring channels idle: a search would fall at another call in
    # each session.
    leaves["mode"] = torch.where(leaves["mode"] == MODE_TRACKING,
                                 MODE_TRACKING, MODE_IDLE).to(torch.int32)
    session.state = ChannelState(**leaves)
    session.mode_host = leaves["mode"].numpy().copy()
    session._tail_re, session._tail_im = (t.copy() for t in tail)
    return session


def test_session_superblock_equals_one_block_a_call():
    """The same tracking state and samples through a session that runs 5
    scan blocks a call and one that runs one a call: the same outputs and
    state bit for bit (no channel acquiring, float32 upload)."""
    k = 5
    cfg, codes, st, sre, sim = _inputs(k)
    tail = cfg.tail_ms * cfg.samples_per_ms
    fresh = sre[tail:].numpy(), sim[tail:].numpy()
    head = sre[:tail].numpy(), sim[:tail].numpy()
    one, many = _session(1, st, head), _session(k, st, head)
    assert (one.mode_host == MODE_TRACKING).sum() > 0
    outs, n = [], one.block_input_samples
    for b in range(k):
        outs.append(one.process_block(fresh[0][b * n:(b + 1) * n],
                                      fresh[1][b * n:(b + 1) * n]))
    got = many.process_block(*fresh)
    assert many.block_input_samples == k * n
    for key in got:
        np.testing.assert_array_equal(
            got[key], np.concatenate([o[key] for o in outs]), err_msg=key)
    _assert_same((many.state, {}), (one.state, {}))
    assert many.total_samples == one.total_samples
    assert got["active"][-cfg.block_ms:].any()


def test_scan_superblock_in_a_session_without_a_mesh():
    cfg = scan_config(profile="borre", superblock=4)
    session = TrackingSession(cfg, [5], device=CPU)
    assert session.block_input_samples == 4 * 20 * cfg.samples_per_ms


@pytest.mark.parametrize("runtime, superblock, cruise, want", [
    ("scan", 3, None, (3, None)),
    ("scan", 1, 50, (1, 50)),
    ("batch", 2, None, (2, 50)),
    ("batch", 1, 0, (1, 1)),
], ids=["scan-no-cruise", "scan-cruise", "batch-default-cruise",
        "batch-cruise-0"])
def test_cli_superblocks(runtime, superblock, cruise, want):
    """``--superblock`` sets the pull-in's blocks a call in either runtime;
    under ``--runtime scan`` a cruise configuration (the pull-in's loops,
    ``--cruise-superblock`` blocks a call) exists only when named, under
    ``--runtime batch`` it defaults to 50 blocks of narrow-only kaplan and
    takes at least 1 (``--cruise-superblock 0`` gives 1, as it always did)."""
    import argparse

    from sydr_tpu_torch import main as tmain

    run_cfg, _ = tmain._build_demo(argparse.Namespace(
        fs=4e6, decimate=1, runtime=runtime, pallas=False,
        superblock=superblock, quantize=False, no_cruise=False,
        cruise_superblock=cruise, ms=200, out="unused"))
    pull_in = run_cfg.receiver.tracking
    got = run_cfg.receiver.cruise_tracking
    assert pull_in.runtime == runtime and pull_in.superblock == want[0]
    assert (got and got.superblock) == want[1]
    if runtime == "scan" and got is not None:
        assert got == dataclasses.replace(pull_in, superblock=want[1])
        TrackingSession(pull_in, [1], cruise=got, device=CPU)
