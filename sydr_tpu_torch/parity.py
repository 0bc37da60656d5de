"""Production parity gate of the batched tracking runtime.

The port's counterpart of ``production_parity`` in the JAX repository's
``tools/chip_parity.py``: 4 closed-loop blocks of the production numeric
path (quantised taps, superblock dispatch) on a fixed 10 Msps synthetic
capture, compared against the committed CPU truth of the JAX dense path
(the ``superblock`` array of ``tools/parity_truth.npz``, which a caller
loads with numpy). The setup and bounds are copies of that tool's
``SETUP`` and ``PARITY_BOUNDS``; this module imports neither JAX nor the
tool.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sydr_tpu_torch.channels import batch_runtime as br
from sydr_tpu_torch.channels.runtime import TrackingConfig
from sydr_tpu_torch.channels.state import MODE_TRACKING, init_state
from sydr_tpu_torch.signal.synthetic import IQGenerator

PARITY_BOUNDS = {
    "parity_metric": 0.85,         # max |err|/(|ref|+1)
    "parity_scaled": 0.15,         # max |err|/rms(prompt)
    "prompt_ratio": (0.93, 1.07),  # ||prompt_got||/||prompt_ref||
}
CORR_KEYS = ("i_early", "q_early", "i_prompt", "q_prompt", "i_late",
             "q_late")
FS = 10e6
PRNS = (5, 12, 21)
DOPPLERS = (1200.0, -2600.0, 3900.0)
CONFIG = TrackingConfig(
    sampling_frequency=FS, block_ms=5, tail_ms=4, window_size=10240,
    runtime="batch", profile="borre", quantize_spacing=True)


def parity_setup(device):
    """(state, bits3x, samples_re, samples_im) of the gate's 4-block run:
    3 channels at 48 dB-Hz, 24 ms of capture (tail + 4 blocks of 5 ms)."""
    gen = IQGenerator(FS, noise=True, seed=4)
    for prn, dop in zip(PRNS, DOPPLERS):
        gen.add_satellite(prn, doppler_hz=dop, code_phase_chips=100.0,
                          cn0_dbhz=48.0)
    iq = np.concatenate([gen.generate_ms(9), gen.generate_ms(15)])

    def dev(x, dtype):
        return torch.tensor(np.asarray(x, dtype=dtype), device=device)

    state = dataclasses.replace(
        init_state(len(PRNS), device),
        mode=torch.full((len(PRNS),), MODE_TRACKING, dtype=torch.int32,
                        device=device),
        carrier_freq=dev(DOPPLERS, np.float32),
        rem_code=dev([0.02, 0.7, 0.4], np.float32),
        rem_carrier=dev([0.3, 2.1, 5.0], np.float32),
        code_freq_offset=dev([0.5, -1.2, 2.0], np.float32),
        unread=dev([11000, 14000, 12345], np.int32),
    )
    bits3x = dev(br.tiled_code_bits(list(PRNS)), np.float32)
    return state, bits3x, dev(iq.real, np.float32), dev(iq.imag, np.float32)


def parity_metrics(got: np.ndarray, ref: np.ndarray) -> dict:
    """The gate's three health numbers for stacked correlators
    ``[6, n_epochs, n_ch]`` (streams in ``CORR_KEYS`` order), and
    ``parity_ok``."""
    metric = float(np.max(np.abs(got - ref) / (np.abs(ref) + 1.0)))
    p_got = np.hypot(got[2], got[3])
    p_ref = np.hypot(ref[2], ref[3])
    scaled = float(np.max(np.abs(got - ref))
                   / max(float(np.sqrt(np.mean(p_ref ** 2))), 1e-12))
    ratio = float(np.linalg.norm(p_got) / max(np.linalg.norm(p_ref), 1e-12))
    lo, hi = PARITY_BOUNDS["prompt_ratio"]
    ok = (metric <= PARITY_BOUNDS["parity_metric"]
          and scaled <= PARITY_BOUNDS["parity_scaled"]
          and lo <= ratio <= hi)
    return {"parity_metric": metric, "parity_scaled": scaled,
            "prompt_ratio": ratio, "parity_ok": bool(ok)}


def production_parity(truth_superblock: np.ndarray, device) -> dict:
    """Run the gate's 4 blocks on ``device`` and compare with the truth."""
    state, bits3x, sre, sim = parity_setup(device)
    _, out = br.run_superblock(CONFIG, 4, bits3x, state, sre, sim)
    got = np.stack([out[k].cpu().numpy() for k in CORR_KEYS])
    return parity_metrics(got, np.asarray(truth_superblock))
