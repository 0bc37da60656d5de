"""The port's production parity gate on CPU: its 4-block ``run_superblock``
(10 Msps, quantised taps) against the committed CPU truth of the JAX dense
path, ``tools/parity_truth.npz``, under the gate's bounds (metric 0.85,
scaled 0.15, prompt ratio [0.93, 1.07]).

No JAX compile: the truth is read from the file, as the JAX gate does when
its source key matches.
"""

import os

import numpy as np
import torch

from sydr_tpu_torch import parity
from sydr_tpu_torch.channels import batch_runtime as br

torch.set_num_threads(2)

TRUTH = os.path.join(os.path.dirname(__file__), "..", "tools",
                     "parity_truth.npz")


def _truth():
    return np.load(TRUTH, allow_pickle=False)["superblock"]


def test_parity_gate_within_bounds():
    res = parity.production_parity(_truth(), torch.device("cpu"))
    assert res["parity_ok"], res


def test_parity_gate_setup_matches_jax_bounds():
    """The copied bounds and setup are the JAX gate's."""
    from tools import chip_parity

    assert parity.PARITY_BOUNDS["parity_metric"] == \
        chip_parity.PARITY_BOUNDS["parity_metric"]
    assert parity.PARITY_BOUNDS["parity_scaled"] == \
        chip_parity.PARITY_BOUNDS["parity_scaled"]
    assert list(parity.PARITY_BOUNDS["prompt_ratio"]) == \
        chip_parity.PARITY_BOUNDS["prompt_ratio"]
    for token in ("prns = [5, 12, 21]", "dops = [1200.0, -2600.0, 3900.0]",
                  "seed=4", "cn0_dbhz=48.0", "generate_ms(9)",
                  "generate_ms(15)", "block_ms=5, tail_ms=4",
                  'profile="borre"'):
        assert token in chip_parity.SETUP, token


def test_parity_gate_fails_on_one_chip_code_offset():
    """The gate gates: a 1-chip code misalignment (the fault the JAX gate's
    ablation injects) must fail it."""
    state, bits3x, sre, sim = parity.parity_setup(torch.device("cpu"))
    bits3x = torch.roll(bits3x, 1, dims=1)
    _, out = br.run_superblock(parity.CONFIG, 4, bits3x, state, sre, sim)
    got = np.stack([out[k].numpy() for k in parity.CORR_KEYS])
    res = parity.parity_metrics(got, _truth())
    assert not res["parity_ok"], res
