"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one. The file imports
no JAX, so it also runs on a machine without it:

    python -m pytest tests/test_torch_cuda.py --noconftest -o addopts="" -q

Bounds: K1 picks the same chips as its plain version (the same rounding of
the index arithmetic) and sums in another order: 1e-2 + 1e-4 of the
largest correlator. K2 is a direct-summation four-step DFT against cuFFT,
both float32: 1e-4 of the map's maximum.
"""

import dataclasses

import numpy as np
import pytest
import torch

from sydr_tpu_torch.channels import batch_runtime as br
from sydr_tpu_torch.channels.runtime import TrackingConfig
from sydr_tpu_torch.channels.state import MODE_TRACKING, init_state
from sydr_tpu_torch.ops import acq_kernel
from sydr_tpu_torch.ops import correlator_kernel as ck

torch.set_num_threads(2)

N_CH = 32


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _k1_args(fs, block_ms, narrow_only, quantize, dev):
    rng = np.random.default_rng(5)
    cfg = TrackingConfig(
        sampling_frequency=fs, block_ms=block_ms, tail_ms=4,
        window_size=round(fs * 1e-3) + 256, runtime="batch",
        profile="kaplan", kaplan_narrow_only=narrow_only,
        quantize_spacing=quantize)
    spms = cfg.samples_per_ms

    def t(x, dtype):
        return torch.tensor(np.asarray(x, dtype=dtype), device=dev)

    st = dataclasses.replace(
        init_state(N_CH, dev),
        mode=torch.full((N_CH,), MODE_TRACKING, dtype=torch.int32,
                        device=dev),
        carrier_freq=t(rng.uniform(-4000, 4000, N_CH), np.float32),
        rem_code=t(rng.uniform(0, 1, N_CH), np.float32),
        rem_carrier=t(rng.uniform(0, 2 * np.pi, N_CH), np.float32),
        code_freq_offset=t(rng.uniform(-2, 2, N_CH), np.float32),
        unread=t(spms + rng.integers(spms // 20, spms // 2, N_CH), np.int32))
    geo = br._pass_a_closed(cfg, st)
    bg = br.block_geometry(cfg, st, geo)
    return (t(rng.normal(0, 2, cfg.window_samples), np.float32),
            t(rng.normal(0, 2, cfg.window_samples), np.float32),
            t(br.tiled_code_bits(list(range(1, N_CH + 1))), np.float32),
            bg["c_int"], geo["omega"], geo["code_step"], bg["fb_q"],
            bg["phic_q"], br.epoch_bounds(cfg, geo, bg["base"]),
            br.taps_for(cfg), spms)


@pytest.mark.cuda
@pytest.mark.parametrize("fs, block_ms, narrow_only, quantize", [
    (2.5e6, 20, True, True),     # cruise: 6 streams
    (2.5e6, 5, False, True),     # pull-in: 10 streams
    (10e6, 20, True, True),      # full rate
    (10e6, 20, False, False),    # full rate, plain taps
])
def test_epoch_correlate_kernel_matches_plain(fs, block_ms, narrow_only,
                                              quantize):
    args = _k1_args(fs, block_ms, narrow_only, quantize, _cuda())
    before = ck.KERNEL.launches
    got = ck.epoch_correlate(*args)
    assert ck.KERNEL.launches == before + 1
    ref = ck.epoch_correlate_ref(*args)
    torch.cuda.synchronize()
    assert got.shape == ref.shape
    bound = 1e-2 + 1e-4 * float(ref.abs().max())
    assert float((got - ref).abs().max()) <= bound


@pytest.mark.cuda
def test_epoch_correlate_rejects_bad_input():
    args = list(_k1_args(2.5e6, 5, True, True, _cuda()))
    args[3] = args[3].to(torch.int64)            # c_int must be int32
    with pytest.raises(ValueError, match="c_int"):
        ck.epoch_correlate(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("n, n_ch", [(2500, 32), (10000, 12)])
def test_pcps_bins_kernel_matches_plain(n, n_ch):
    """The session's (n = 2500) and the bench's (n = 10000) acquisition
    shapes: 101 bins over 10 phases, 10 non-coherent blocks."""
    dev = _cuda()
    g = torch.Generator().manual_seed(0)
    spec = torch.randn(10, n_ch, 10, n, dtype=torch.complex64,
                       generator=g).to(dev)
    code = torch.randn(n_ch, n, dtype=torch.complex64, generator=g).to(dev)
    plan = tuple((b // 10 - 5, b % 10) for b in range(101))
    before = acq_kernel.KERNEL.launches
    got = acq_kernel.pcps_bins(spec, code, plan)
    assert acq_kernel.KERNEL.launches == before + 1
    ref = acq_kernel.pcps_bins_ref(spec, code, plan)
    torch.cuda.synchronize()
    assert float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
