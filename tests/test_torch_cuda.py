"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one. The file imports
no JAX, so it also runs on a machine without it:

    python -m pytest tests/test_torch_cuda.py --noconftest -o addopts="" -q

Bounds: K1 picks the same chips as its plain version (the same rounding of
the index arithmetic) and sums in another order: 1e-2 + 1e-4 of the
largest correlator. K2 is a float32 radix FFT in shared memory, on one
block or on a cluster of blocks (a prime factor above 31 a generic pass,
a direct sum), or Bluestein's chirp convolution as power-of-two FFTs
through global memory, against cuFFT, both float32: 1e-4 of the map's
maximum.
K3 builds the same per-sample values as K1 and scans them in another
order than ``torch.cumsum``: the raw prefix within ``4 * sqrt(n_win) *
2^-24`` of its largest magnitude (a random walk of float32 roundings over
n_win additions, four sigma), and the per-epoch correlators picked from it
within K1's bound.
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


@pytest.mark.cuda
@pytest.mark.parametrize("n_taps", [1, 3, 5])
def test_block_cumsum_streams_ragged_window_and_determinism(n_taps):
    """2.047 Msps: 2047 samples a millisecond, so the window's 18,423
    samples are no multiple of 4 (scalar stores, rows off 16-byte
    addresses), of the 1024-sample chunk or of the segment; 1, 3 and 5
    taps. Against the plain version, and twice in a row bit for bit."""
    args = _k1_args(2.047e6, 5, n_taps <= 3, True, _cuda())
    taps = args[9][:n_taps]
    assert len(taps) == n_taps
    k3_args = args[:8] + (taps, args[10])
    n_win = args[0].shape[0]
    seg_chunks, n_seg = ck.cumsum_shape(n_win, N_CH)
    assert n_win % 4 and n_win % (seg_chunks * ck.CUMSUM_CHUNK) and n_seg > 1
    got = ck.block_cumsum_streams(*k3_args)
    again = ck.block_cumsum_streams(*k3_args)
    ref = ck.block_cumsum_streams_ref(*k3_args)
    torch.cuda.synchronize()
    assert got.shape == ref.shape == (N_CH, 2 * n_taps, n_win)
    assert torch.equal(got, again)
    assert float((got - ref).abs().max()) <= prefix_bound(ref)


def _k2_inputs(n, n_ch, dev, n_bins=101, nc=10):
    """``n_bins`` bins over 10 phases, ``nc`` non-coherent blocks."""
    g = torch.Generator().manual_seed(0)
    spec = torch.randn(10, n_ch, nc, n, dtype=torch.complex64,
                       generator=g).to(dev)
    code = torch.randn(n_ch, n, dtype=torch.complex64, generator=g).to(dev)
    plan = tuple((b // 10 - 5, b % 10) for b in range(n_bins))
    return spec, code, plan


@pytest.mark.cuda
@pytest.mark.parametrize("n, n_ch", [
    (2500, 32), (10000, 12), (4000, 8), (5000, 4), (2048, 4),
    (4092, 8), (2046, 4), (1023, 4), (8184, 2),      # 1023 = 3 * 11 * 31
    (7 * 13 * 20, 2), (17 * 19 * 6, 2), (23 * 29 * 4, 2), (7000, 2)])
def test_pcps_bins_kernel_matches_plain(n, n_ch):
    """The FFT entry at the session's (n = 2500) and the bench's
    (n = 10000) acquisition shapes, at three more lengths with radices up
    to 10, at the code periods of the 1.023 MHz family (radices 31 and 11;
    n = 8184 in the 512-thread variant), at one length for each other
    prime radix and at n = 7000, plan (7, 10, 10, 10), whose launch the
    card refused while its block was sized as if it had no prime radix
    (704 threads): the wrapper launches it, and only it."""
    spec, code, plan = _k2_inputs(n, n_ch, _cuda())
    before = _k2_launches()
    got = acq_kernel.pcps_bins(spec, code, plan)
    assert _k2_launches() == (before[0] + 1, before[1], before[2])
    ref = acq_kernel.pcps_bins_ref(spec, code, plan)
    torch.cuda.synchronize()
    assert float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


def _k2_launches():
    """Launch counts of K2's one-block, cluster and Bluestein entries."""
    return (acq_kernel.KERNEL.launches, acq_kernel.CLUSTER_KERNEL.launches,
            acq_kernel.BLUESTEIN_KERNEL.launches)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [16368, 20000, 40920, 65536])
def test_pcps_bins_cluster_kernel_matches_plain(n):
    """Code periods above one block's shared memory (16.368, 20, 40.92 and
    65.536 Msps: clusters of 2, 2, 8 and 8 blocks): the wrapper launches
    the cluster entry, and only it."""
    spec, code, plan = _k2_inputs(n, 2, _cuda())
    before = _k2_launches()
    got = acq_kernel.pcps_bins(spec, code, plan)
    assert _k2_launches() == (before[0], before[1] + 1, before[2])
    ref = acq_kernel.pcps_bins_ref(spec, code, plan)
    torch.cuda.synchronize()
    assert float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("n, why", [
    (4093, "N=4093 has no useful factorisation"),
    (1048578, "n=1048578: no K2 kernel on the card above 1048576")])
def test_pcps_bins_refuses_n_without_entry(n, why):
    """A prime n (4093), and n = 1048578 = 2 * 3 * 174763, above the
    Bluestein entry's 2^20: the wrapper raises ValueError and launches
    nothing."""
    spec, code, plan = _k2_inputs(n, 1, _cuda(), n_bins=1, nc=1)
    before = _k2_launches()
    with pytest.raises(ValueError, match=why):
        acq_kernel.pcps_bins(spec, code, plan)
    torch.cuda.synchronize()
    assert _k2_launches() == before


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4070, 1517, 9722, 16370, 26500, 65231,
                               65498])
def test_pcps_bins_generic_pass_matches_plain(n):
    """Code periods with a prime factor above 31, its radix a generic
    pass, at 1 channel x 11 bins x 2 blocks, on the radix entry that holds
    the plan (``entry="radix"``, whichever entry ``kernel_for`` routes n
    to): 4070 = 2 * 5 * 11 * 37 (one block), 1517 = 37 * 41 (radix-1
    ends), 9722 = 2 * 4861 and 16370 = 2 * 5 * 1637 (a cluster of 2),
    26500 = 2^2 * 5^3 * 53 (4), 65231 = 37 * 41 * 43 and 65498 = 2 *
    32749 (8)."""
    spec, code, plan = _k2_inputs(n, 1, _cuda(), n_bins=11, nc=2)
    kernel, got, args = acq_kernel.pcps_bins_launch_args(
        spec, code, plan, entry="radix")
    assert kernel is acq_kernel.radix_kernel_for(n)[0]
    before = _k2_launches()
    kernel.launch(*args)
    one_block = kernel is acq_kernel.KERNEL
    assert _k2_launches() == (before[0] + one_block,
                              before[1] + (not one_block), before[2])
    ref = acq_kernel.pcps_bins_ref(spec, code, plan)
    torch.cuda.synchronize()
    assert float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [9722, 65498, 70000, 131074])
def test_pcps_bins_bluestein_matches_plain(n):
    """The Bluestein entry at a large prime factor (9722 = 2 * 4861,
    65498 = 2 * 32749), at 70 Msps (70000 = 2^4 * 5^4 * 7, above the
    clusters) and at 131074 = 2 * 65537, 1 channel x 11 bins x 2 blocks:
    the wrapper launches it, and only it, once; a second run is
    bit-identical (the nc blocks are summed in order, no atomics)."""
    spec, code, plan = _k2_inputs(n, 1, _cuda(), n_bins=11, nc=2)
    assert acq_kernel.kernel_for(n)[0] is acq_kernel.BLUESTEIN_KERNEL
    before = _k2_launches()
    got = acq_kernel.pcps_bins(spec, code, plan)
    assert _k2_launches() == (before[0], before[1], before[2] + 1)
    again = acq_kernel.pcps_bins(spec, code, plan)
    ref = acq_kernel.pcps_bins_ref(spec, code, plan)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


@pytest.mark.cuda
def test_pcps_bins_bluestein_chunks_the_pairs():
    """More (bin, channel) pairs than the scratch holds: the entry runs
    them in chunks inside one call and equals the plain version."""
    spec, code, plan = _k2_inputs(9722, 3, _cuda(), n_bins=7, nc=2)
    cap = acq_kernel.BLUESTEIN_SCRATCH_BYTES
    acq_kernel.BLUESTEIN_SCRATCH_BYTES = 2 * 2 * 32768 * 8   # 2 pairs
    try:
        kernel, got, args = acq_kernel.pcps_bins_launch_args(spec, code,
                                                             plan)
    finally:
        acq_kernel.BLUESTEIN_SCRATCH_BYTES = cap
    assert kernel is acq_kernel.BLUESTEIN_KERNEL and args[14] == 2
    kernel.launch(*args)
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


@pytest.mark.cuda
@pytest.mark.parametrize("prefix", [False, True])
def test_channel_slice_with_full_launch_shape_is_bit_identical(prefix):
    """K1 (or K3) on the last 16 of 32 channels with the 32-channel launch
    shape (``grid_ch``) gives those rows of the full launch bit for bit:
    the sharded step's rows do not depend on the sharding."""
    dev = _cuda()
    args = list(_k1_args(2.5e6, 20, True, True, dev))
    rows = slice(16, 32)
    part = [a[rows].contiguous() for a in args[2:8]]
    if prefix:
        full = ck.block_cumsum_streams(*(args[:8] + args[9:]))
        got = ck.block_cumsum_streams(*args[:2], *part, *args[9:],
                                      grid_ch=N_CH)
    else:
        full = ck.epoch_correlate(*args)
        got = ck.epoch_correlate(*args[:2], *part,
                                 args[8][:, rows].contiguous(), *args[9:],
                                 grid_ch=N_CH)
    torch.cuda.synchronize()
    assert torch.equal(got, full[rows] if prefix else full[:, rows])


@pytest.mark.cuda
def test_sharded_step_on_nccl_world_of_one():
    """``make_sharded_batch_step`` on a (1, 1) mesh of a one-rank NCCL
    process group: the same state and outputs as the unsharded block, and
    K1 launched."""
    import socket

    from sydr_tpu_torch.parallel import distributed, mesh as pmesh

    dev = _cuda()
    rng = np.random.default_rng(9)
    cfg = TrackingConfig(sampling_frequency=2.5e6, block_ms=20, tail_ms=4,
                         window_size=2756, runtime="batch",
                         profile="kaplan", kaplan_narrow_only=True,
                         quantize_spacing=True)
    spms = cfg.samples_per_ms
    st = dataclasses.replace(
        init_state(N_CH, dev),
        mode=torch.full((N_CH,), MODE_TRACKING, dtype=torch.int32,
                        device=dev),
        carrier_freq=torch.tensor(rng.uniform(-4000, 4000, N_CH),
                                  dtype=torch.float32, device=dev),
        unread=torch.full((N_CH,), spms + 300, dtype=torch.int32,
                          device=dev))
    bits = torch.tensor(br.tiled_code_bits(list(range(1, N_CH + 1))),
                        device=dev)
    wre = torch.tensor(rng.normal(0, 2, cfg.window_samples),
                       dtype=torch.float32, device=dev)
    wim = torch.tensor(rng.normal(0, 2, cfg.window_samples),
                       dtype=torch.float32, device=dev)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    distributed.initialize("nccl", rank=0, world_size=1,
                           init_method=f"tcp://127.0.0.1:{port}")
    try:
        mesh = pmesh.make_mesh(1, 1)
        before = ck.KERNEL.launches
        st_s, out_s = pmesh.make_sharded_batch_step(cfg, mesh)(
            bits, st, wre, wim)
        assert ck.KERNEL.launches == before + 1
        gathered = distributed.gather_axis(mesh, "ch", out_s["i_prompt"],
                                           dim=1)
    finally:
        distributed.shutdown()
    st_u, out_u = br.run_block_batched(cfg, bits, st, wre, wim)
    for key in out_u:
        assert torch.equal(out_s[key], out_u[key]), key
    assert torch.equal(gathered, out_u["i_prompt"])
    for f in dataclasses.fields(st_u):
        assert torch.equal(getattr(st_s, f.name), getattr(st_u, f.name))
