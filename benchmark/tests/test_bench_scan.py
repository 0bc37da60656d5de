"""The scan cell (``track.scan.l1ca_10msps``) at a size the CPU holds
(``_tiny_scan``): the receiver's plain scan runtime against the frozen
plain copy, ``correct`` false for the control and for each fault, the
readers, and the bound's arithmetic."""

import pytest
import torch

from benchmark import harness, scan_roofline
from benchmark.engines import scan_stream
from benchmark.tests import _tiny_scan
from benchmark.trace import Trace, Tracer

READERS = ("scan.kernel_roofline", "scan.device_ms", "scan.graph_nodes",
           "device.idle.scan")


@pytest.fixture(scope="module")
def engine():
    spec = _tiny_scan.spec()
    eng = harness.engine(spec, _tiny_scan.SEED, "cpu")
    eng.setup()
    eng.window(0.4, Tracer(False))
    eng.release()
    assert eng.sample
    return spec, eng


def test_every_number_reads_zero_against_the_plain_copy(engine):
    """On the CPU the receiver's scan superblock is its plain version,
    which the reference copies operation for operation: every compared
    number reads 0."""
    spec, eng = engine
    nums = eng.compare(control=False)
    assert set(nums) == set(spec["limits"])
    assert all(v == 0.0 for v in nums.values()), nums


def test_control_is_not_correct(engine):
    spec, eng = engine
    nums = eng.compare(control=True)
    assert [k for k, v in nums.items() if v > spec["limits"][k]], nums
    # Step by step, every epoch parts by the control's rounding alone.
    assert nums["stepwise.corr_gap"] > spec["limits"]["stepwise.corr_gap"]


def test_stepwise_reference_along_its_own_path_is_its_own_run(engine):
    """The reference run step by step along its own outputs takes each
    epoch's state from them and reproduces its own run bit for bit, over
    every block of a sampled superblock; along the control's path it
    correlates at the control's code phases."""
    import numpy as np

    from benchmark.reference import scan_block as ref

    _, eng = engine
    _, (j, host) = eng.sample[0]
    state_in = {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in eng._named(host[0], host[1]).items()}
    win = eng._window(j % eng.passes)
    params = ref.Params(eng.cfg)
    codes = torch.from_numpy(ref.code_table(eng.prns))
    state, out = ref.run_superblock(params, codes, state_in, *win)
    follow = {k: out[k] for k in scan_stream.FOLLOW_KEYS}
    got_state, got = ref.run_superblock(params, codes, state_in, *win,
                                        follow=follow)
    assert all(torch.equal(got[k], out[k]) for k in out)
    assert all(torch.equal(got_state[k], state[k]) for k in state)
    _, control = ref.run_superblock(params, codes, state_in, *win,
                                    precision="bfloat16")
    _, along = ref.run_superblock(
        params, codes, state_in, *win,
        follow={k: control[k] for k in scan_stream.FOLLOW_KEYS})
    assert torch.equal(along["required"], control["required"])
    assert torch.equal(along["code_freq"], control["code_freq"])


@pytest.mark.parametrize("kind", scan_stream.FAULTS)
def test_planted_fault_is_not_correct(engine, kind):
    """The faults ``benchmark.readings`` plants in the sampled answers past
    the first block."""
    spec, eng = engine
    nums = eng.compare(faults=(kind,))
    prefix = f"fault.{kind}."
    failed = [k for k, v in nums.items() if k.startswith(prefix)
              and v > spec["limits"][k[len(prefix):]]]
    assert failed, nums


def _fault(kind):
    """``runtime.run_superblock`` broken under the window: its state
    returned unchanged, half of the channels given the mean of the rest,
    a data bit flipped in the last block, the correlators 3% low past the
    first block."""
    from sydr_tpu_torch.channels import runtime

    orig = runtime.run_superblock

    def broken(cfg, k_blocks, codes, state, re, im):
        new, out = orig(cfg, k_blocks, codes, state, re, im)
        if k_blocks == 1:       # the pull-in's one block a call, not the window
            return new, out
        out = {k: v.clone() for k, v in out.items()}
        if kind == "state_unchanged":
            return state, out
        if kind == "half_batch":
            n = codes.shape[0]
            for k, v in out.items():
                mean = v[:, :n // 2].to(torch.float32).mean(dim=1,
                                                            keepdim=True)
                v[:, n // 2:] = mean.to(v.dtype)
            return new, out
        block_ms = cfg.block_ms
        if kind == "late_scaled":
            for k in scan_stream.CORR_KEYS:
                out[k][block_ms:] *= 0.97
            return new, out
        e = out["i_prompt"].shape[0] - block_ms // 2
        c = int(torch.argmax(out["i_prompt"][e].abs()))
        out["i_prompt"][e, c] *= -1
        out["q_prompt"][e, c] *= -1
        return new, out

    return runtime, "run_superblock", broken


@pytest.mark.parametrize("kind", ["state_unchanged", "half_batch",
                                  "answer_altered", "late_scaled"])
def test_fault_in_the_program_is_not_correct(kind, monkeypatch):
    monkeypatch.setattr(*_fault(kind))
    result, lines = _tiny_scan.run(seconds=0.4)
    assert result["correct"] is False, result["checks"]
    assert any(ln.endswith("FAILED") for ln in lines)


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_has_the_required_keys(trace):
    result, lines = _tiny_scan.run(trace=trace, seconds=0.4)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    if trace:
        keys.append("breakdown")
    assert list(result) == keys + ["checks"]
    assert result["correct"] is True, result["checks"]
    if trace:
        # The CPU gives the trace no device rows and the eager stand-in
        # for the graph no node count: no per-layer metric reads.
        assert not set(READERS) & set(result["metrics"])
    else:
        assert set(result["metrics"]) == {"rtf", "setup_s"}
    checks = [ln for ln in lines if ln.startswith("check ")]
    assert lines[-len(checks):] == checks


def test_readers_return_none_without_a_trace():
    empty = Trace(events=[], host=[], spans={}, units=0, window_s=0.0,
                  counters={})
    for name in READERS:
        assert harness.reader(name)(empty) is None, name


def test_readers_read_a_trace():
    """A stretch of two superblocks of 50 blocks: the kernel's rows, a copy
    and idle between them."""
    counters = dict(tracking_channels=10, channels=32, blocks=50,
                    block_ms=20, spms=10000, taps=3, window_samples=240000)
    per_block_us = 100.0
    events, t = [], 0.0
    for _ in range(100):
        events.append((t, t + per_block_us,
                       "void scan_block_kernel<3>(LoopConsts, ScanConsts)"))
        t += per_block_us + 1.0
    events.append((t, t + 50.0, "Memcpy DtoH (Device -> Pinned)"))
    trace = Trace(events=events, host=[], spans={}, units=2,
                  window_s=2 * (t + 50.0) / 1e6, counters=counters)
    bound = scan_roofline.scan_bound_s(10, 32, 20, 10000, 3, 240000)
    assert harness.reader("scan.kernel_roofline")(trace) == pytest.approx(
        100.0 * bound / (per_block_us * 1e-6))
    assert harness.reader("scan.device_ms")(trace) == pytest.approx(
        (100 * per_block_us + 50.0) / 2 / 1e3)
    busy_us = 100 * per_block_us + 50.0
    assert harness.reader("device.idle.scan")(trace) == pytest.approx(
        100.0 * (1.0 - busy_us / (2 * (t + 50.0))))


def test_the_bound_is_the_carried_chain_at_the_cells_shape():
    """At 10 Msps the chain binds (PERF.md's 10 Msps scan row: latency
    0.00504 ms, operations 0.0084 ms with every channel tracking); with
    10 of 32 channels tracking the operations take 0.0021 ms."""
    lat = scan_roofline.scan_latency_s(20, 10000)
    assert lat == pytest.approx(5.04e-6, rel=2e-3)
    assert scan_roofline.scan_latency_s(20, 2500) == pytest.approx(
        4.96e-6, rel=2e-3)
    flops = scan_roofline.scan_flops(10, 32, 20, 10000, 3)
    assert flops == 10 * 20 * 10000 * 68 + 32 * 20 * 300
    assert scan_roofline.scan_bound_s(10, 32, 20, 10000, 3, 240000) == lat
