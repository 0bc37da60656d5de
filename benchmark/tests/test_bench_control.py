"""``correct`` comes out false for the control and for each fault a cell
can have, at a size the CPU holds.

The control is the plain reference computed in bfloat16 put in the
receiver's place. Each fault breaks the receiver's timed path underneath
a whole run of the tiny cell (the harness's look for a card skipped): a
step that returns its state unchanged, half of the batch left out with
the mean of the rest in its place, an answer altered where it is
produced (in tracking a data bit flipped in the superblock's last block),
and, past the superblock's first block, correlators a few percent low. One
card, so no exchange between cards can be left out.
"""

import pytest
import torch

from benchmark import harness
from benchmark.tests import _tiny
from benchmark.trace import Tracer


@pytest.mark.parametrize("workload", [_tiny.CRUISE, _tiny.COLD])
def test_control_is_not_correct(workload):
    spec = _tiny.spec(workload)
    eng = harness.engine(spec, _tiny.SEED, "cpu")
    eng.setup()
    eng.window(0.4, Tracer(False))
    eng.release()
    nums = eng.compare(control=True)
    failed = [k for k, v in nums.items() if v > spec["limits"][k]]
    assert failed, nums


def _half(x, n):
    """``x`` with its channel rows ``n // 2 ..`` replaced by the mean of the
    rows before them (channel axis 1 for ``[T, n_ch]``, else 0)."""
    if x.dim() == 0:
        return x
    axis = 1 if x.dim() >= 2 and x.shape[0] != n else 0
    head = x.narrow(axis, 0, n // 2)
    mean = head.to(torch.float32).mean(dim=axis, keepdim=True)
    tail = mean.expand_as(x.narrow(axis, n // 2, n - n // 2)).to(x.dtype)
    return torch.cat([head, tail], dim=axis)


def _cruise_fault(kind):
    from sydr_tpu_torch.channels import batch_runtime

    orig = batch_runtime.run_superblock

    def broken(cfg, k_blocks, bits3x, state, re, im, **kw):
        new, out = orig(cfg, k_blocks, bits3x, state, re, im, **kw)
        if kind == "state_unchanged":
            return state, out
        if kind == "half_batch":
            n = state.carrier_freq.shape[0]
            out = {k: _half(v, n) for k, v in out.items()}
            return new, out
        out = dict(out)
        block_ms = cfg.block_ms
        if kind == "late_scaled":
            for k in ("i_early", "q_early", "i_prompt", "q_prompt",
                      "i_late", "q_late"):
                out[k] = out[k].clone()
                out[k][block_ms:] *= 0.97
            return new, out
        # A data bit flipped: the prompt negated at one epoch of the last
        # block, in the channel with the strongest prompt there.
        e = out["i_prompt"].shape[0] - block_ms // 2
        c = int(torch.argmax(out["i_prompt"][e].abs()))
        for k in ("i_prompt", "q_prompt"):
            out[k] = out[k].clone()
            out[k][e, c] *= -1
        return new, out

    return batch_runtime, "run_superblock", broken


def _cold_fault(kind):
    from sydr_tpu_torch.ops import acquisition

    orig = acquisition.acquire

    def broken(iq, code_k, bins, **kw):
        doppler, ci, metric, cmap = orig(iq, code_k, bins, **kw)
        if kind == "half_batch":
            n = cmap.shape[0]
            return (_half(doppler, n), _half(ci, n), _half(metric, n),
                    _half(cmap, n))
        ci = ci.clone()
        ci[torch.argmax(metric)] += 1
        return doppler, ci, metric, cmap

    return acquisition, "acquire", broken


@pytest.mark.parametrize("workload,kind", [
    (_tiny.CRUISE, "state_unchanged"), (_tiny.CRUISE, "half_batch"),
    (_tiny.CRUISE, "answer_altered"), (_tiny.CRUISE, "late_scaled"),
    (_tiny.COLD, "half_batch"),
    (_tiny.COLD, "answer_altered")])
def test_fault_is_not_correct(workload, kind, monkeypatch):
    make = _cruise_fault if workload == _tiny.CRUISE else _cold_fault
    monkeypatch.setattr(*make(kind))
    result, lines = _tiny.run(workload, seconds=0.4)
    assert result["correct"] is False, result["checks"]
    assert any(ln.endswith("FAILED") for ln in lines)


@pytest.mark.parametrize("workload", [_tiny.CRUISE, _tiny.COLD])
def test_sound_run_is_correct(workload):
    result, _ = _tiny.run(workload, seconds=0.4)
    assert result["correct"] is True, result["checks"]
