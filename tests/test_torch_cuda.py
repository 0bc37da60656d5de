"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one. The file imports
no JAX, so it also runs on a machine without it:

    python -m pytest tests/test_torch_cuda.py --noconftest -o addopts="" -q

Bounds: K1 picks the same chips as its plain version (the same rounding of
the index arithmetic) and sums in another order: 1e-2 + 1e-4 of the
largest correlator. K2 is a float32 radix FFT in shared memory (or, for a
code period with a prime factor above 5, a direct-summation four-step DFT)
against cuFFT, both float32: 1e-4 of the map's maximum. K3 builds the same
per-sample values as K1 and scans them in another order than
``torch.cumsum``: the raw prefix within ``4 * sqrt(n_win) * 2^-24`` of its
largest magnitude (a random walk of float32 roundings over n_win additions,
four sigma), and the per-epoch correlators picked from it within K1's bound.
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


def prefix_bound(prefix):
    """K3 vs plain on the raw prefix (module note)."""
    n_win = prefix.shape[-1]
    return 4.0 * n_win ** 0.5 * 2.0 ** -24 * float(prefix.abs().max())


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
@pytest.mark.parametrize("fs, block_ms, narrow_only", [
    (2.5e6, 20, True),     # cruise: 32 ch x 6 streams x 60,000 samples
    (2.5e6, 5, False),     # pull-in: 32 x 10 x 22,500
    (10e6, 20, True),      # full rate: 32 x 6 x 240,000
])
def test_block_cumsum_streams_kernel_matches_plain(fs, block_ms, narrow_only):
    args = _k1_args(fs, block_ms, narrow_only, True, _cuda())
    bounds = args[8]
    k3_args = args[:8] + args[9:]
    before = ck.CUMSUM_KERNEL.launches
    got = ck.block_cumsum_streams(*k3_args)
    assert ck.CUMSUM_KERNEL.launches == before + 1
    ref = ck.block_cumsum_streams_ref(*k3_args)
    torch.cuda.synchronize()
    assert got.shape == ref.shape == (N_CH, 2 * len(args[9]),
                                      args[0].shape[0])
    assert float((got - ref).abs().max()) <= prefix_bound(ref)
    corr = br.prefix_epoch_sums(got, bounds)
    corr_ref = br.prefix_epoch_sums(ref, bounds)
    bound = 1e-2 + 1e-4 * float(corr_ref.abs().max())
    assert float((corr - corr_ref).abs().max()) <= bound
    # and against K1's per-epoch sums of the same streams
    k1 = ck.epoch_correlate(*args)
    assert float((corr - k1).abs().max()) <= bound


def _k2_inputs(n, n_ch, dev):
    """101 bins over 10 phases, 10 non-coherent blocks."""
    g = torch.Generator().manual_seed(0)
    spec = torch.randn(10, n_ch, 10, n, dtype=torch.complex64,
                       generator=g).to(dev)
    code = torch.randn(n_ch, n, dtype=torch.complex64, generator=g).to(dev)
    plan = tuple((b // 10 - 5, b % 10) for b in range(101))
    return spec, code, plan


@pytest.mark.cuda
@pytest.mark.parametrize("n, n_ch", [(2500, 32), (10000, 12), (4000, 8),
                                     (5000, 4), (2048, 4)])
def test_pcps_bins_kernel_matches_plain(n, n_ch):
    """The FFT entry at the session's (n = 2500) and the bench's
    (n = 10000) acquisition shapes and at three more lengths with a radix
    plan: the wrapper launches it, and only it."""
    spec, code, plan = _k2_inputs(n, n_ch, _cuda())
    before = (acq_kernel.KERNEL.launches,
              acq_kernel.FOURSTEP_KERNEL.launches)
    got = acq_kernel.pcps_bins(spec, code, plan)
    assert (acq_kernel.KERNEL.launches,
            acq_kernel.FOURSTEP_KERNEL.launches) == (before[0] + 1,
                                                     before[1])
    ref = acq_kernel.pcps_bins_ref(spec, code, plan)
    torch.cuda.synchronize()
    assert float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


@pytest.mark.cuda
def test_pcps_bins_fourstep_kernel_matches_plain():
    """n = 4092 has no radix plan: the wrapper launches the four-step
    entry, chosen from n alone, and only it."""
    spec, code, plan = _k2_inputs(4092, 8, _cuda())
    before = (acq_kernel.KERNEL.launches,
              acq_kernel.FOURSTEP_KERNEL.launches)
    got = acq_kernel.pcps_bins(spec, code, plan)
    assert (acq_kernel.KERNEL.launches,
            acq_kernel.FOURSTEP_KERNEL.launches) == (before[0],
                                                     before[1] + 1)
    ref = acq_kernel.pcps_bins_ref(spec, code, plan)
    torch.cuda.synchronize()
    assert float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


@pytest.mark.cuda
def test_pcps_bins_rejects_bad_input():
    spec, code, plan = _k2_inputs(2500, 2, _cuda())
    with pytest.raises(ValueError, match="code_k"):
        acq_kernel.pcps_bins(spec, code[:, :-1].contiguous(), plan)
    with pytest.raises(ValueError, match="not contiguous"):
        acq_kernel.pcps_bins(spec.transpose(1, 2), code, plan)
    with pytest.raises(ValueError, match="phase index"):
        acq_kernel.pcps_bins(spec, code, ((0, 10),))


@pytest.mark.cuda
def test_epoch_correlate_ragged_epochs_and_unaligned_window():
    """An epoch of 0 samples, bounds off the 4-sample grid and a window
    that starts off a 16-byte address (a slice at an odd offset, as a
    superblock's later windows are): the kernel's masked edge groups
    against the plain version, and against K3's picks."""
    dev = _cuda()
    args = list(_k1_args(2.5e6, 5, False, True, dev))
    n_win = args[0].shape[0]
    for i in (0, 1):                       # windows at element offset 3
        pad = torch.zeros(n_win + 3, dtype=torch.float32, device=dev)
        pad[3:] = args[i]
        args[i] = pad[3:]
        assert args[i].data_ptr() % 16 == 12 and args[i].is_contiguous()
    bounds = args[8].clone()
    bounds[2] = bounds[1]                  # epoch 1 has no samples
    bounds[3] += 1                         # an odd boundary
    bounds[0, ::2] = 7                     # long epochs from the window's head
    args[8] = bounds.contiguous()
    got = ck.epoch_correlate(*args)
    ref = ck.epoch_correlate_ref(*args)
    torch.cuda.synchronize()
    assert float(got[1].abs().max()) == 0.0
    bound = 1e-2 + 1e-4 * float(ref.abs().max())
    assert float((got - ref).abs().max()) <= bound
    prefix = ck.block_cumsum_streams(*(args[:8] + args[9:]))
    picks = br.prefix_epoch_sums(prefix, args[8])
    assert float((picks - got).abs().max()) <= bound


@pytest.mark.cuda
def test_epoch_correlate_mismatched_plane_alignment():
    """Window planes at different offsets from a 16-byte address: the
    kernel takes its scalar loads and still agrees."""
    dev = _cuda()
    args = list(_k1_args(2.5e6, 5, True, True, dev))
    pad = torch.zeros(args[1].shape[0] + 1, dtype=torch.float32, device=dev)
    pad[1:] = args[1]
    args[1] = pad[1:]
    got = ck.epoch_correlate(*args)
    ref = ck.epoch_correlate_ref(*args)
    torch.cuda.synchronize()
    bound = 1e-2 + 1e-4 * float(ref.abs().max())
    assert float((got - ref).abs().max()) <= bound
