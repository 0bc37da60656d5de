"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one. The file imports
no JAX, so it also runs on a machine without it:

    python -m pytest tests/test_torch_cuda.py --noconftest -o addopts="" -q

Bounds: K1 picks the same chips as its plain version (the same rounding of
the index arithmetic) and sums in another order: 1e-2 + 1e-4 of the
largest correlator. K2 is a float32 radix FFT in shared memory, on one
block or on a cluster of blocks (a prime factor above 31 a generic pass,
a direct sum), the same butterflies and generic pass over tiles of a
length-n FFT in two passes through global memory, or Bluestein's chirp
convolution at a 13-smooth length on those tile FFTs through global
memory, against cuFFT, both float32: 1e-4 of the map's maximum.
K3 builds the same per-sample values as K1 and scans them in another
order than ``torch.cumsum``: the raw prefix within ``4 * sqrt(n_win) *
2^-24`` of its largest magnitude (a random walk of float32 roundings over
n_win additions, four sigma), and the per-epoch correlators picked from it
within K1's bound.

Pass C's kernel (with the anchor slew it carries) and the geometry kernel
(``csrc/block_geometry.cu``: pass A and pass B's geometry) are held to
their plain versions bit for bit. The scan
runtime's kernel (``csrc/scan_block.cu``) sums each correlator in its own
order: it is held to its plain version by the scan runtime's bounds
(``_scan_inputs.bound_faults``), and to itself bit for bit across runs,
channel slices, a graph replay and the mesh's scan step.

The session's step as a captured CUDA graph (``ops/step_graph.py``)
is held to the eager step bit for bit: every output, the final state and
the kernels' launch counts, in the K1, prefix (K3) and scan forms, across
a promotion and a ``reset_channel``; a capture that fails raises. The
scan form's graph holds one kernel launch a block.
"""

import ctypes
import dataclasses

import numpy as np
import pytest
import torch

from _pass_c_inputs import SHAPE_CASES
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
    assert _k2_launches() == (before[0] + 1, *before[1:])
    ref = acq_kernel.pcps_bins_ref(spec, code, plan)
    torch.cuda.synchronize()
    assert float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


def _k2_launches():
    """Launch counts of K2's one-block, cluster, Bluestein and two-step
    entries."""
    return (acq_kernel.KERNEL.launches, acq_kernel.CLUSTER_KERNEL.launches,
            acq_kernel.BLUESTEIN_KERNEL.launches,
            acq_kernel.TWOSTEP_KERNEL.launches)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [16368, 20000, 40920, 65536])
def test_pcps_bins_cluster_kernel_matches_plain(n):
    """Code periods above one block's shared memory (16.368, 20, 40.92 and
    65.536 Msps: clusters of 2, 2, 8 and 8 blocks): the wrapper launches
    the cluster entry, and only it."""
    spec, code, plan = _k2_inputs(n, 2, _cuda())
    before = _k2_launches()
    got = acq_kernel.pcps_bins(spec, code, plan)
    assert _k2_launches() == (before[0], before[1] + 1, *before[2:])
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
                              before[1] + (not one_block), *before[2:])
    ref = acq_kernel.pcps_bins_ref(spec, code, plan)
    torch.cuda.synchronize()
    assert float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [9722, 65498, 65538, 99300, 131074, 16370])
def test_pcps_bins_bluestein_matches_plain(n):
    """The Bluestein entry at a large prime factor (9722 = 2 * 4861,
    65498 = 2 * 32749; above the clusters: 65538 = 2 * 3^2 * 11 * 331,
    99300 = 2^2 * 3 * 5^2 * 331 near 99.375 Msps, whose 99375 = 3 * 5^4 *
    53 now takes the two-step entry, and 131074 = 2 * 65537), and at
    16370 = 2 * 5 * 1637, M = 2^15 = 256 x 128 (plans (16, 16) and (16,
    8): the tile's radix-16 variant; 9722's M = 176 x 112 mixes radix 16
    with 11 and 7), 1 channel x 11 bins x 2 blocks: the wrapper launches
    it, and only it, once; a second run is bit-identical (the nc blocks
    are summed in order, no atomics)."""
    spec, code, plan = _k2_inputs(n, 1, _cuda(), n_bins=11, nc=2)
    assert acq_kernel.kernel_for(n)[0] is acq_kernel.BLUESTEIN_KERNEL
    before = _k2_launches()
    got = acq_kernel.pcps_bins(spec, code, plan)
    assert _k2_launches() == (before[0], before[1], before[2] + 1,
                              before[3])
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
    m = acq_kernel.bluestein_lengths(9722)[0]
    cap = acq_kernel.SCRATCH_BYTES
    acq_kernel.SCRATCH_BYTES = 2 * 2 * m * 8   # 2 pairs of 2 transforms
    try:
        kernel, got, args = acq_kernel.pcps_bins_launch_args(spec, code,
                                                             plan)
    finally:
        acq_kernel.SCRATCH_BYTES = cap
    assert kernel is acq_kernel.BLUESTEIN_KERNEL and args[19] == 2
    kernel.launch(*args)
    ref = acq_kernel.pcps_bins_ref(spec, code, plan)
    torch.cuda.synchronize()
    assert float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("n, n_ch, n_bins, nc", [
    (70000, 8, 101, 10), (122880, 1, 11, 2), (245520, 1, 11, 2),
    (1 << 20, 1, 3, 2), (99375, 8, 101, 10), (98688, 1, 11, 2),
    (65792, 1, 11, 2), (131072, 1, 11, 2)])
def test_pcps_bins_twostep_matches_plain(n, n_ch, n_bins, nc):
    """The two-step entry at the 70 Msps session's shape (n = 70000 = 250
    x 280, 8 ch x 101 bins x 10 blocks, its pairs in 9 chunks), at 122.88
    and 245.52 Msps (radices 11 and 31; 122880 = 320 x 384, plans (16,
    10, 2) and (16, 8, 3); 245520's row (16, 31)), at 2^20 = 1024 x 1024
    and 2^17 = 256 x 512 (radix-16 passes alone, and one of 4 or 2), and
    through the tile's generic pass: 99.375 Msps at the session's shape
    (99375 = 265 x 375, column plan (53, 5)) and the largest prime factor
    that the entry takes, 257: 98688 = 257 x 384 (column plan (257,), one
    generic pass from the product to the scratch, rows (16, 8, 3)) and
    65792 = 256 x 257 (row plan (257, 1)): the wrapper launches it, and
    only it, once; a second run is bit-identical (the nc blocks are summed
    in order, no atomics)."""
    spec, code, plan = _k2_inputs(n, n_ch, _cuda(), n_bins=n_bins, nc=nc)
    assert acq_kernel.kernel_for(n)[0] is acq_kernel.TWOSTEP_KERNEL
    before = _k2_launches()
    got = acq_kernel.pcps_bins(spec, code, plan)
    assert _k2_launches() == (*before[:3], before[3] + 1)
    again = acq_kernel.pcps_bins(spec, code, plan)
    ref = acq_kernel.pcps_bins_ref(spec, code, plan)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4000, 16368, 4070, 13100])
def test_pcps_bins_twostep_forced_and_chunked(n):
    """The two-step entry forced below the clusters (``entry="twostep"``:
    4000 = 50 x 80 in one tile each way, 16368 = 93 x 176, rows (16,
    11); with a
    generic radix, 4070 = 37 x 110, column plan (37,), and 13100 = 10 x
    1310, row plan (131, 10), whose radix plans the one-block and 2-block
    entries keep) with its pairs in chunks of 2 (the scratch cap
    lowered): equal to the plain version."""
    spec, code, plan = _k2_inputs(n, 3, _cuda(), n_bins=7, nc=2)
    cap = acq_kernel.SCRATCH_BYTES
    acq_kernel.SCRATCH_BYTES = 2 * 2 * n * 8   # 2 pairs
    try:
        kernel, got, args = acq_kernel.pcps_bins_launch_args(
            spec, code, plan, entry="twostep")
    finally:
        acq_kernel.SCRATCH_BYTES = cap
    assert kernel is acq_kernel.TWOSTEP_KERNEL and args[16] == 2
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
@pytest.mark.parametrize("fs, rows", [
    (16.368e6, 32),     # K2's cluster entry: the cold-start snapshot server
    (4e6, 32),          # one-block entry: the session's pull-in rate
    (70e6, 8),          # two-step entry, n = 70000 = 250 x 280
])
def test_acquire_on_one_snapshot_equals_its_rows(fs, rows):
    """``acquire`` on one 50 ms snapshot expanded over the PRN rows (forward
    spectra once, for all phases in one batch) against the same snapshot
    materialised as contiguous rows (forward spectra a row): the same
    Doppler and code index, each row's map within 1e-6 of its peak (cuFFT
    may pick other kernels for another batch), the metric within 1e-6
    relative; the shared call's ``sydr.acq.spectra`` reads ``rows`` 1 and
    counts ``sydr.acq.spectra.shared`` once."""
    from sydr_tpu_torch.ops import acquisition as acq
    from sydr_tpu_torch.signal.synthetic import IQGenerator
    from sydr_tpu_torch.utils import metrics

    dev = _cuda()
    gen = IQGenerator(fs, noise=True, seed=7)
    gen.add_satellite(3, doppler_hz=-2360.0, code_phase_chips=77.7,
                      cn0_dbhz=45.0)
    gen.add_satellite(7, doppler_hz=1420.0, code_phase_chips=512.3,
                      cn0_dbhz=42.0)
    iq = gen.generate_ms(50)
    re = torch.tensor(np.float32(iq.real), device=dev)
    im = torch.tensor(np.float32(iq.imag), device=dev)
    code = np.stack([acq.code_fft_conj(p, fs) for p in range(1, rows + 1)])
    bins = acq.doppler_bins(5000, 100)
    kw = dict(sampling_frequency=fs, coherent=5, non_coherent=10)
    shared = (re[None].expand(rows, -1), im[None].expand(rows, -1))
    metrics.enable()
    try:
        rec = metrics.StageTimers()
        with rec.time("shared"):
            got = acq.acquire(shared, code, bins, **kw)
        with rec.time("per_row"):
            ref = acq.acquire(tuple(x.contiguous() for x in shared), code,
                              bins, **kw)
    finally:
        metrics.enable(False)
    torch.cuda.synchronize()
    assert [s.attrs["rows"] for s in rec.find("sydr.acq.spectra")] == \
        [1, rows]
    assert rec.counters == {"sydr.acq.spectra.shared": 1}
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    peak = ref[3].amax(dim=(1, 2))
    assert bool(((got[3] - ref[3]).abs().amax(dim=(1, 2))
                 <= 1e-6 * peak).all())
    assert bool(((got[2] - ref[2]).abs() <= 1e-6 * ref[2].abs()).all())
    assert abs(float(got[0][2]) + 2360.0) <= 50.0      # PRN 3
    assert abs(float(got[0][6]) - 1420.0) <= 50.0      # PRN 7


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


# Pass C's kernel (ops/loop_kernel.py, csrc/pass_c.cu) against its plain
# version on the card, ``loop_kernel.pass_c_plain`` (``batch_runtime._pass_c``
# and the anchor slew), on tests/_pass_c_inputs.py's
# mid-track blocks at 32 channels: the Session cell's cruise (narrow-only
# kaplan, 20 epochs) and pull-in (kaplan, 5 epochs) shapes and every other
# branch (profile, DLF order, FLL discriminator, C/N0 estimator, rails, pass
# A's form). The kernel rounds each operation as the plain version's op
# does: outputs and state are held bit for bit.
PASS_C_CASES = [
    ("cruise", 20, dict(profile="kaplan", kaplan_narrow_only=True)),
    ("pull-in", 5, dict(profile="kaplan")),
    ("borre-nwpr", 20, dict(profile="borre")),
    ("borre-beaulieu-norails", 20,
     dict(profile="borre", cn0_estimator="beaulieu", freq_rail_hz=0.0,
          max_block_freq_step=0.0, code_rail_hz=0.0)),
    ("kaplan-o3-atan2-beaulieu", 5,
     dict(profile="kaplan", dlf_order=3, fll_discriminator="atan2",
          cn0_estimator="beaulieu")),
    ("kaplan-o2-atan2-norails", 20,
     dict(profile="kaplan", fll_discriminator="atan2", freq_rail_hz=0.0,
          max_block_freq_step=0.0, code_rail_hz=0.0)),
    ("narrow-o3-atan2-beaulieu", 20,
     dict(profile="kaplan", kaplan_narrow_only=True, dlf_order=3,
          fll_discriminator="atan2", cn0_estimator="beaulieu")),
    ("narrow-o3-atan-norails", 20,
     dict(profile="kaplan", kaplan_narrow_only=True, dlf_order=3,
          freq_rail_hz=0.0, max_block_freq_step=0.0, code_rail_hz=0.0)),
    ("kaplan-scan-pass-a", 5, dict(profile="kaplan", pass_a="scan")),
    ("narrow-fast-slew", 20,
     dict(profile="kaplan", kaplan_narrow_only=True, freq_rail_hz=400.0,
          anchor_slew_hz_per_s=30.0)),
    ("narrow-no-slew", 20,
     dict(profile="kaplan", kaplan_narrow_only=True,
          anchor_slew_hz_per_s=0.0)),
]


def _pass_c_args(block_ms, extra, dev, seed=3):
    from _pass_c_inputs import mid_track

    from sydr_tpu_torch.channels.state import state_from_numpy

    cfg = TrackingConfig(sampling_frequency=2.5e6, block_ms=block_ms,
                         tail_ms=4, window_size=2756, runtime="batch",
                         quantize_spacing=True, **extra)
    leaves, corr = mid_track(cfg, N_CH, seed)
    st = state_from_numpy(leaves, dev)
    return cfg, st, br._pass_a(cfg, st), torch.tensor(corr, device=dev)


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _assert_pass_c_equal(got, ref, what=""):
    """Two ``(state, outputs)`` bit for bit; a failure names every key
    that differs and by how many ulp at most."""
    (got_st, got_out), (ref_st, ref_out) = got, ref
    assert list(got_out) == list(ref_out)
    pairs = [(k, got_out[k], ref_out[k]) for k in ref_out] + [
        (f"state {f.name}", getattr(got_st, f.name), getattr(ref_st, f.name))
        for f in dataclasses.fields(ref_st)]
    diff = {}
    for key, a, b in pairs:
        assert a.dtype == b.dtype and a.shape == b.shape, key
        if not torch.equal(_bits(a), _bits(b)):
            ulp = (_bits(a).long() - _bits(b).long()).abs().max()
            diff[key] = int(ulp)
    assert not diff, f"{what}: keys that differ (max ulp or count): {diff}"


@pytest.mark.cuda
@pytest.mark.parametrize("name, block_ms, extra", PASS_C_CASES,
                         ids=[c[0] for c in PASS_C_CASES])
def test_pass_c_kernel_matches_plain(name, block_ms, extra):
    from sydr_tpu_torch.ops import loop_kernel as lk

    cfg, st, geo, corr = _pass_c_args(block_ms, extra, _cuda())
    before = lk.PASS_C_KERNEL.launches
    got = lk.pass_c(cfg, st, geo, corr)
    assert lk.PASS_C_KERNEL.launches == before + 1
    ref = lk.pass_c_plain(cfg, st, geo, corr)
    torch.cuda.synchronize()
    _assert_pass_c_equal(got, ref, name)
    assert got[1]["bit_ready"].any() or block_ms < 20


@pytest.mark.cuda
@pytest.mark.parametrize("case", SHAPE_CASES, ids=[c[0] for c in SHAPE_CASES])
def test_pass_c_kernel_matches_plain_on_shapes(case):
    """The kernel = the plain version bit for bit where it tiles the
    epochs (2, 45 and 64: a partial tile, tiles after the first) and
    spreads channels over CTAs (1, 13, 33, 64: partial CTAs), and on
    activity pass A does not give (inactive stretches between active
    epochs, one across two tiles; no epoch active); each case reaches the
    branches it claims (tests/_pass_c_inputs.py)."""
    from _pass_c_inputs import reached, shaped_block

    from sydr_tpu_torch.ops import loop_kernel as lk

    name, block_ms, n_ch, kind, extra, claims = case
    cfg, st, geo, corr = shaped_block(block_ms, n_ch, kind, extra, _cuda())
    got = lk.pass_c(cfg, st, geo, corr)
    ref = lk.pass_c_plain(cfg, st, geo, corr)
    torch.cuda.synchronize()
    _assert_pass_c_equal(got, ref, name)
    assert set(claims) <= reached(st, *got), (name, reached(st, *got))


@pytest.mark.cuda
@pytest.mark.parametrize("warps", [1, 2, 4, 8])
def test_pass_c_kernel_any_warps_per_cta(warps):
    """Every CTA width the entry point takes gives the plain version's
    results, at 33 channels (the last CTA partial at 2, 4 and 8) over two
    tiles with inactive stretches."""
    from _pass_c_inputs import NARROW, shaped_block

    from sydr_tpu_torch.ops import loop_kernel as lk
    from sydr_tpu_torch.ops import native

    cfg, st, geo, corr = shaped_block(45, 33, "gaps", NARROW, _cuda())
    bufs, args = lk.pass_c_launch_args(cfg, st, geo, corr, warps=warps)
    assert lk.PASS_C_KERNEL.function()(*args, native.stream_of(corr)) == 0
    ref = lk.pass_c_plain(cfg, st, geo, corr)
    torch.cuda.synchronize()
    _assert_pass_c_equal(lk.unpack(bufs), ref, f"{warps} warps a CTA")


@pytest.mark.cuda
def test_pass_c_channel_slice_is_bit_identical():
    """The kernel on the last 16 of 32 channels gives those channels of
    the 32-channel launch bit for bit (no step crosses channels)."""
    from sydr_tpu_torch.channels.state import ChannelState
    from sydr_tpu_torch.ops import loop_kernel as lk

    cfg, st, geo, corr = _pass_c_args(20, PASS_C_CASES[0][2], _cuda())
    rows = slice(16, 32)
    full_st, full = lk.pass_c(cfg, st, geo, corr)
    part_st = ChannelState(**{f.name: getattr(st, f.name)[rows]
                              for f in dataclasses.fields(st)})
    part_geo = {k: v[..., rows].contiguous() for k, v in geo.items()}
    got_st, got = lk.pass_c(cfg, part_st, part_geo,
                            corr[:, rows].contiguous())
    torch.cuda.synchronize()
    _assert_pass_c_equal(
        (got_st, got),
        (ChannelState(**{f.name: getattr(full_st, f.name)[rows]
                         for f in dataclasses.fields(full_st)}),
         {k: v[:, rows] for k, v in full.items()}), "16 of 32 channels")


@pytest.mark.cuda
def test_pass_c_kernel_in_a_graph_equals_eager():
    """The launch captured into a CUDA graph and replayed gives the eager
    launch's results bit for bit, and counts as captured."""
    from sydr_tpu_torch.ops import loop_kernel as lk

    cfg, st, geo, corr = _pass_c_args(20, PASS_C_CASES[0][2], _cuda())
    eager = lk.pass_c(cfg, st, geo, corr)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        lk.pass_c(cfg, st, geo, corr)          # warm-up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    captured = lk.PASS_C_KERNEL.captured
    with torch.cuda.graph(graph):
        static = lk.pass_c(cfg, st, geo, corr)
    assert lk.PASS_C_KERNEL.captured == captured + 1
    graph.replay()
    torch.cuda.synchronize()
    _assert_pass_c_equal(static, eager, "graph replay")


@pytest.mark.cuda
def test_pass_c_rejects_bad_input():
    from sydr_tpu_torch.ops import loop_kernel as lk
    from sydr_tpu_torch.ops import native

    dev = _cuda()
    cfg, st, geo, corr = _pass_c_args(5, PASS_C_CASES[0][2], dev)
    with pytest.raises(ValueError, match="ms_counter"):
        lk.pass_c(cfg, dataclasses.replace(st, ms_counter=st.ms_counter
                                           .cpu()), geo, corr)
    with pytest.raises(ValueError, match="rem_code_end"):
        lk.pass_c(cfg, st, {**geo, "rem_code_end": geo["rem_code_end"]
                            .double()}, corr)
    # The C entry point refuses what the kernel cannot read, and launches
    # nothing.
    _, args = lk.pass_c_launch_args(cfg, st, geo, corr)
    fn = lk.PASS_C_KERNEL.function()
    for at, value in ((4, 4),                    # fewer than 6 streams
                      (6, 0), (6, 3), (6, 16)):  # warps a CTA: 1, 2, 4, 8
        bad = list(args)
        bad[at] = value
        assert fn(*bad, native.stream_of(corr)) != 0


@pytest.mark.cuda
def test_run_block_batched_launches_pass_c_once_a_block():
    """``run_superblock`` on the card runs the geometry and pass C as one
    kernel launch a block each, and its block equals the plain geometry,
    pass B and the plain pass C with the anchor slew, bit for bit."""
    from sydr_tpu_torch.ops import geometry_kernel as gk
    from sydr_tpu_torch.ops import loop_kernel as lk

    dev = _cuda()
    cfg = TrackingConfig(sampling_frequency=2.5e6, block_ms=20, tail_ms=4,
                         window_size=2756, runtime="batch",
                         profile="kaplan", kaplan_narrow_only=True,
                         quantize_spacing=True)
    rng = np.random.default_rng(5)
    st = dataclasses.replace(
        init_state(N_CH, dev),
        mode=torch.full((N_CH,), MODE_TRACKING, dtype=torch.int32,
                        device=dev),
        carrier_freq=torch.tensor(rng.uniform(-4000, 4000, N_CH),
                                  dtype=torch.float32, device=dev),
        unread=torch.full((N_CH,), cfg.samples_per_ms + 300,
                          dtype=torch.int32, device=dev))
    n_in = (cfg.tail_ms + 3 * cfg.block_ms) * cfg.samples_per_ms
    sre, sim = (torch.tensor(rng.normal(0, 2, n_in), dtype=torch.float32,
                             device=dev) for _ in range(2))
    bits = torch.tensor(br.tiled_code_bits(list(range(1, N_CH + 1))),
                        device=dev)
    before = lk.PASS_C_KERNEL.launches, gk.GEOMETRY_KERNEL.launches
    br.run_superblock(cfg, 3, bits, st, sre, sim)
    assert lk.PASS_C_KERNEL.launches == before[0] + 3
    assert gk.GEOMETRY_KERNEL.launches == before[1] + 3
    win = cfg.window_samples
    geo, inputs, bounds = gk.geometry_plain(cfg, st)
    corr = br._pass_b(cfg, bits, inputs, bounds, sre[:win], sim[:win])
    _assert_pass_c_equal(
        br.run_block_batched(cfg, bits, st, sre[:win], sim[:win]),
        lk.pass_c_plain(cfg, st, geo, corr), "run_block_batched")


# The geometry kernel (ops/geometry_kernel.py, csrc/block_geometry.cu)
# against its plain version on the card, ``geometry_kernel.geometry_plain``
# (``_pass_a`` and ``pass_b_inputs``), bit for bit: every output, integers
# and floats, on tests/_geometry_inputs.py's states (random channels,
# chip-boundary ties, carrier phases at 0 and 2 pi, sample deficits).
GEOMETRY_CONFIGS = [
    # (id, TrackingConfig fields, channels)
    ("cruise", dict(sampling_frequency=2.5e6, block_ms=20), 32),
    ("pull-in", dict(sampling_frequency=2.5e6, block_ms=5), 32),
    ("full-rate-if", dict(sampling_frequency=10e6, block_ms=20,
                          intermediate_frequency=2.58e6), 33),
    ("no-aiding-45-epochs", dict(sampling_frequency=4.092e6, block_ms=45,
                                 tail_ms=3, carrier_aiding=False), 7),
    ("64-epochs-1-ch", dict(sampling_frequency=16.368e6, block_ms=64), 1),
    ("1.023msps-no-tail", dict(sampling_frequency=1.023e6, block_ms=33,
                               tail_ms=0), 13),
]


def _geometry_cfg(fields):
    fs = fields["sampling_frequency"]
    base = dict(tail_ms=4, window_size=round(fs * 1e-3) + 256,
                runtime="batch", profile="kaplan", kaplan_narrow_only=True,
                quantize_spacing=True)
    base.update(fields)
    return TrackingConfig(**base)


def _assert_geometry_equal(got, ref, what=""):
    """Two ``(geo, inputs, bounds)`` bit for bit; a failure names every
    output that differs."""
    (geo, inputs, bounds), (rgeo, rinputs, rbounds) = got, ref
    assert list(geo) == list(rgeo)
    pairs = [(k, geo[k], rgeo[k]) for k in rgeo] + [
        (f"input {i}", a, b) for i, (a, b) in enumerate(zip(inputs, rinputs))]
    pairs.append(("bounds", bounds, rbounds))
    diff = {}
    for key, a, b in pairs:
        assert a.dtype == b.dtype and a.shape == b.shape, key
        if not torch.equal(_bits(a), _bits(b)):
            diff[key] = int((_bits(a).long() - _bits(b).long()).abs().max())
    assert not diff, f"{what}: outputs that differ (max ulp or count): {diff}"


@pytest.mark.cuda
@pytest.mark.parametrize("name, fields, n_ch", GEOMETRY_CONFIGS,
                         ids=[c[0] for c in GEOMETRY_CONFIGS])
def test_geometry_kernel_matches_plain(name, fields, n_ch):
    """40 states a configuration (240 in all), ten of each kind, one
    launch each, every output bit for bit the plain version's."""
    from _geometry_inputs import KINDS, geometry_state

    from sydr_tpu_torch.ops import geometry_kernel as gk

    dev = _cuda()
    cfg = _geometry_cfg(fields)
    rng = np.random.default_rng(23)
    kinds = KINDS * 10
    active = 0
    for i, kind in enumerate(kinds):
        st = geometry_state(cfg, n_ch, kind, rng, dev)
        before = gk.GEOMETRY_KERNEL.launches
        got = gk.block_geometry_all(cfg, st)
        assert gk.GEOMETRY_KERNEL.launches == before + 1
        ref = gk.geometry_plain(cfg, st)
        torch.cuda.synchronize()
        _assert_geometry_equal(got, ref, f"{name} {kind} {i}")
        active += int(got[0]["active"][0].sum())
    assert 0 < active < len(kinds) * n_ch or n_ch == 1


@pytest.mark.cuda
def test_geometry_kernel_partial_cta_and_chunks():
    """33 channels (the last CTA partial) over 45 epochs (two 32-epoch
    chunks, the second partial) give the plain version's results."""
    from _geometry_inputs import geometry_state

    from sydr_tpu_torch.ops import geometry_kernel as gk

    dev = _cuda()
    cfg = _geometry_cfg(GEOMETRY_CONFIGS[3][1])
    st = geometry_state(cfg, 33, "random", np.random.default_rng(29), dev)
    got = gk.block_geometry_all(cfg, st)
    ref = gk.geometry_plain(cfg, st)
    torch.cuda.synchronize()
    _assert_geometry_equal(got, ref, "33 channels x 45 epochs")


@pytest.mark.cuda
def test_geometry_kernel_channel_slice_and_graph():
    """The kernel on the last 16 of 32 channels gives those channels of
    the 32-channel launch bit for bit; the launch captured into a CUDA
    graph and replayed gives the eager launch's results and counts once
    as captured."""
    from _geometry_inputs import geometry_state

    from sydr_tpu_torch.channels.state import ChannelState
    from sydr_tpu_torch.ops import geometry_kernel as gk

    dev = _cuda()
    cfg = _geometry_cfg(GEOMETRY_CONFIGS[0][1])
    st = geometry_state(cfg, 32, "random", np.random.default_rng(31), dev)
    geo, inputs, bounds = gk.block_geometry_all(cfg, st)
    rows = slice(16, 32)
    part = gk.block_geometry_all(cfg, ChannelState(**{
        f.name: getattr(st, f.name)[rows].contiguous()
        for f in dataclasses.fields(st)}))
    torch.cuda.synchronize()
    _assert_geometry_equal(part, (
        {k: v[..., rows].contiguous() for k, v in geo.items()},
        tuple(t[rows].contiguous() for t in inputs),
        bounds[:, rows].contiguous()), "16 of 32 channels")

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        gk.block_geometry_all(cfg, st)           # warm-up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    captured = gk.GEOMETRY_KERNEL.captured
    with torch.cuda.graph(graph):
        static = gk.block_geometry_all(cfg, st)
    assert gk.GEOMETRY_KERNEL.captured == captured + 1
    graph.replay()
    torch.cuda.synchronize()
    _assert_geometry_equal(static, (geo, inputs, bounds), "graph replay")


@pytest.mark.cuda
def test_geometry_kernel_rejects_bad_input():
    """The wrapper refuses a field on another device or of another dtype;
    the C entry point refuses what the kernel cannot run and launches
    nothing; the scan form keeps the plain ops on the card."""
    from _geometry_inputs import geometry_state

    from sydr_tpu_torch.ops import geometry_kernel as gk
    from sydr_tpu_torch.ops import native

    dev = _cuda()
    cfg = _geometry_cfg(GEOMETRY_CONFIGS[1][1])
    st = geometry_state(cfg, 8, "random", np.random.default_rng(37), dev)
    with pytest.raises(ValueError, match="unread"):
        gk.block_geometry_all(cfg, dataclasses.replace(
            st, unread=st.unread.cpu()))
    with pytest.raises(ValueError, match="carrier_freq"):
        gk.block_geometry_all(cfg, dataclasses.replace(
            st, carrier_freq=st.carrier_freq.double()))
    _, args = gk.geometry_launch_args(cfg, st)
    fn = gk.GEOMETRY_KERNEL.function()
    stream = native.stream_of(st.rem_code)
    assert fn(*args[:2], 0, stream) != 0             # no channel
    k = gk.GeoConsts.from_buffer_copy(args[0]._obj)
    k.n_anchors += 1                                   # not tail + block
    assert fn(ctypes.byref(k), args[1], args[2], stream) != 0
    before = gk.GEOMETRY_KERNEL.launches
    scan = dataclasses.replace(cfg, pass_a="scan")
    _assert_geometry_equal(gk.block_geometry_all(scan, st),
                           gk.geometry_plain(scan, st), "scan form")
    assert gk.GEOMETRY_KERNEL.launches == before


# The scan runtime's kernel (ops/scan_kernel.py, csrc/scan_block.cu) against
# its plain version on the card, ``runtime._run_block_plain``, on
# tests/_scan_inputs.py's mid-track blocks at 32 channels (a declaration
# and a bit completion inside the block, acquiring channels, a late first
# epoch, the rails acting): the scan session's shape (borre, 2.5 Msps,
# 20 epochs) and every specialisation and option of the kernel. The
# kernel sums each correlator in its own fixed order, so it is held to the
# plain version by the scan runtime's bounds (``_scan_inputs.bound_faults``:
# integers equal, correlators by the tie rule, code phase within 1e-5
# chips, carrier within 0.05 Hz, every other float within 1e-3 of its
# key's largest magnitude).
SCAN_CASES = [
    ("session-borre", dict(profile="borre")),
    ("borre-quantised", dict(profile="borre", quantize_spacing=True)),
    ("borre-norails-noaiding",
     dict(profile="borre", carrier_aiding=False, freq_rail_hz=0.0,
          code_rail_hz=0.0, anchor_slew_hz_per_s=0.0)),
    ("borre-5-spacings",
     dict(profile="borre", spacings=(-0.5, -0.25, 0.0, 0.25, 0.5))),
    ("kaplan-o2", dict(profile="kaplan", quantize_spacing=True)),
    ("kaplan-o3-atan2-beaulieu",
     dict(profile="kaplan", dlf_order=3, fll_discriminator="atan2",
          cn0_estimator="beaulieu")),
    ("narrow-o2", dict(profile="kaplan", kaplan_narrow_only=True)),
    ("narrow-o3-atan2-beaulieu-norails",
     dict(profile="kaplan", kaplan_narrow_only=True, dlf_order=3,
          fll_discriminator="atan2", cn0_estimator="beaulieu",
          freq_rail_hz=0.0, code_rail_hz=0.0)),
    ("full-rate-kaplan", dict(profile="kaplan", sampling_frequency=10e6)),
]


def _scan_args(extra, dev, n_ch=N_CH, seed=7):
    from _scan_inputs import scan_block_tensors, scan_config

    cfg = scan_config(**extra)
    return (cfg, *scan_block_tensors(cfg, n_ch, seed, dev))


def _assert_scan_close(got, ref, peak, what=""):
    """The kernel's ``(state, outputs)`` against the plain version's under
    the scan runtime's bounds (``_scan_inputs.bound_faults``)."""
    from _scan_inputs import bound_faults

    faults, _ = bound_faults(got, ref, peak)
    assert not faults, (what, faults)


@pytest.mark.cuda
@pytest.mark.parametrize("name, extra", SCAN_CASES,
                         ids=[c[0] for c in SCAN_CASES])
def test_scan_kernel_matches_plain(name, extra):
    from _scan_inputs import reached

    from sydr_tpu_torch.channels import runtime as rt
    from sydr_tpu_torch.ops import scan_kernel as sk

    cfg, codes, st, wre, wim = _scan_args(extra, _cuda())
    before = sk.SCAN_KERNEL.launches
    got = rt.run_block(cfg, codes, st, wre, wim)
    assert sk.SCAN_KERNEL.launches == before + 1
    ref = rt._run_block_plain(cfg, codes, st, wre, wim)
    torch.cuda.synchronize()
    peak = max(float(wre.abs().max()), float(wim.abs().max()))
    _assert_scan_close(got, ref, peak, name)
    assert {"declare", "bit", "idle", "late"} <= reached(st, *got), (
        name, reached(st, *got))


@pytest.mark.cuda
def test_scan_kernel_channel_slices_and_repeats_are_bit_identical():
    """The kernel on the last 16 (and on one) of 32 channels gives those
    channels of the 32-channel launch bit for bit (no step crosses
    channels), and a second launch repeats the first bit for bit."""
    from sydr_tpu_torch.channels.state import ChannelState
    from sydr_tpu_torch.ops import scan_kernel as sk

    cfg, codes, st, wre, wim = _scan_args(SCAN_CASES[0][1], _cuda())
    assert sk.SCAN_CLUSTER > 1
    full = sk.scan_block(cfg, codes, st, wre, wim)
    _assert_pass_c_equal(sk.scan_block(cfg, codes, st, wre, wim), full,
                         "a second launch")
    for rows in (slice(16, 32), slice(5, 6)):
        part_st = ChannelState(**{f.name: getattr(st, f.name)[rows]
                                  .contiguous()
                                  for f in dataclasses.fields(st)})
        got = sk.scan_block(cfg, codes[rows].contiguous(), part_st, wre, wim)
        torch.cuda.synchronize()
        _assert_pass_c_equal(
            got,
            (ChannelState(**{f.name: getattr(full[0], f.name)[rows]
                             for f in dataclasses.fields(full[0])}),
             {k: v[:, rows] for k, v in full[1].items()}),
            f"channels {rows}")


@pytest.mark.cuda
def test_scan_kernel_in_a_graph_equals_eager():
    """The launch captured into a CUDA graph and replayed gives the eager
    launch's results bit for bit, and counts as captured."""
    from sydr_tpu_torch.ops import scan_kernel as sk

    cfg, codes, st, wre, wim = _scan_args(SCAN_CASES[0][1], _cuda())
    assert sk.SCAN_CLUSTER > 1
    eager = sk.scan_block(cfg, codes, st, wre, wim)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        sk.scan_block(cfg, codes, st, wre, wim)     # warm-up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    captured = sk.SCAN_KERNEL.captured
    with torch.cuda.graph(graph):
        static = sk.scan_block(cfg, codes, st, wre, wim)
    assert sk.SCAN_KERNEL.captured == captured + 1
    graph.replay()
    torch.cuda.synchronize()
    _assert_pass_c_equal(static, eager, "graph replay")


@pytest.mark.cuda
def test_scan_superblock_graph_equals_eager_launches():
    """``runtime.run_superblock`` over three blocks captured as one graph
    (``StepGraph``) and replayed gives the eager launches' state and
    outputs bit for bit; eager and captured alike, one ``scan_block``
    launch a block."""
    from _scan_inputs import scan_block_tensors, scan_config

    from sydr_tpu_torch.channels import runtime as rt
    from sydr_tpu_torch.channels.state import pack_state, unpack_state
    from sydr_tpu_torch.ops import scan_kernel as sk
    from sydr_tpu_torch.ops.step_graph import StepGraph

    k = 3
    cfg = scan_config(profile="borre", sampling_frequency=10e6)
    long_cfg = scan_config(profile="borre", sampling_frequency=10e6,
                           block_ms=k * cfg.block_ms)
    codes, st, sre, sim = scan_block_tensors(long_cfg, N_CH, 7, _cuda())
    before = sk.SCAN_KERNEL.launches
    eager = rt.run_superblock(cfg, k, codes, st, sre, sim)
    assert sk.SCAN_KERNEL.launches == before + k
    keys = list(eager[1])

    def step(state_f, state_i, wre, wim):
        new, out = rt.run_superblock(cfg, k, codes,
                                     unpack_state(state_f, state_i), wre, wim)
        return (*pack_state(new), *(out[key] for key in keys))

    graph = StepGraph(_cuda())
    args = (*pack_state(st), sre, sim)
    graph.run("scan", step, args)              # warm-up and capture
    replayed = graph.run("scan", step, args)
    torch.cuda.synchronize()
    assert graph.graphs["scan"].launches == {sk.SCAN_KERNEL: k}
    _assert_pass_c_equal(
        (unpack_state(*replayed[:2]), dict(zip(keys, replayed[2:]))),
        eager, "superblock graph replay")


# The three rates of chip_smoke.py's scan cases: the scan session's 2.5
# Msps borre, a full-rate 10 Msps front end with kaplan's 5 taps, and the
# classic 16.368 Msps front end, borre.
SCAN_RATES = [
    ("2.5msps-borre", dict(profile="borre", quantize_spacing=True)),
    ("10msps-kaplan", dict(profile="kaplan", sampling_frequency=10e6)),
    ("16.368msps-borre", dict(profile="borre", sampling_frequency=16.368e6)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("name, extra", SCAN_RATES,
                         ids=[c[0] for c in SCAN_RATES])
def test_scan_kernel_at_each_rate_matches_plain(name, extra):
    """Each rate: within the scan runtime's bounds of the plain version
    (every integer equal), the branches reached, a second launch bit for
    bit, and the card runs clusters of the kernel."""
    from _scan_inputs import reached

    from sydr_tpu_torch.channels import runtime as rt
    from sydr_tpu_torch.ops import scan_kernel as sk

    cfg, codes, st, wre, wim = _scan_args(extra, _cuda())
    before = sk.SCAN_KERNEL.launches
    got = sk.scan_block(cfg, codes, st, wre, wim)
    again = sk.scan_block(cfg, codes, st, wre, wim)
    assert sk.SCAN_KERNEL.launches == before + 2
    ref = rt._run_block_plain(cfg, codes, st, wre, wim)
    torch.cuda.synchronize()
    peak = max(float(wre.abs().max()), float(wim.abs().max()))
    _assert_scan_close(got, ref, peak, name)
    _assert_pass_c_equal(again, got, f"{name}: a second launch")
    assert {"declare", "bit", "idle", "late"} <= reached(st, *got)
    assert sk.max_active_clusters(cfg) >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("name, extra", SCAN_RATES,
                         ids=[c[0] for c in SCAN_RATES])
def test_scan_kernel_protocol_check(name, extra):
    """The kernel's protocol-check build (slots poisoned once consumed,
    geometries tagged with their epoch, warps delayed at hashed points) at
    each rate, on 32 channels and on one: no fault in 20 launches, each
    bit for bit with the production kernel; it is not counted as a launch
    of the production kernel."""
    from sydr_tpu_torch.channels.state import ChannelState
    from sydr_tpu_torch.ops import scan_kernel as sk

    cfg, codes, st, wre, wim = _scan_args(extra, _cuda())
    one = ChannelState(**{f.name: getattr(st, f.name)[5:6].contiguous()
                          for f in dataclasses.fields(st)})
    for args in ((codes, st, wre, wim), (codes[5:6].contiguous(), one, wre,
                                         wim)):
        ref = sk.scan_block(cfg, *args)
        before = sk.SCAN_KERNEL.launches
        for k in range(20):
            got, faults = sk.check_protocol(cfg, *args)
            assert not any(faults.values()), (name, k, faults)
            _assert_pass_c_equal(got, ref, f"{name}: check launch {k}")
        assert sk.SCAN_KERNEL.launches == before


@pytest.mark.cuda
def test_scan_kernel_rejects_bad_input():
    """The wrapper refuses a tensor on another device; the C entry point
    refuses what the kernel cannot take and launches nothing."""
    import ctypes

    from sydr_tpu_torch.ops import native
    from sydr_tpu_torch.ops import scan_kernel as sk

    cfg, codes, st, wre, wim = _scan_args(SCAN_CASES[0][1], _cuda(), n_ch=4)
    with pytest.raises(ValueError, match="ms_counter"):
        sk.scan_block(cfg, codes, dataclasses.replace(
            st, ms_counter=st.ms_counter.cpu()), wre, wim)
    with pytest.raises(ValueError, match="codes"):
        sk.scan_block(cfg, codes.cpu(), st, wre, wim)
    _, args = sk.scan_launch_args(cfg, codes, st, wre, wim)
    fn = sk.SCAN_KERNEL.function()
    stream = native.stream_of(wre)
    before = sk.SCAN_KERNEL.launches
    for at, value in ((3, 0), (4, 0), (5, -1)):     # n_ch, epochs, window
        bad = list(args)
        bad[at] = value
        assert fn(*bad, stream) != 0
    for field, value in (("n_spacings", 2), ("n_spacings", 6),
                         ("window_size", 0), ("samples_per_ms", 0)):
        consts = sk.ScanConsts.from_buffer_copy(args[1]._obj)
        setattr(consts, field, value)
        assert fn(args[0], ctypes.byref(consts), *args[2:], stream) != 0, \
            field
    assert sk.SCAN_KERNEL.launches == before


@pytest.mark.cuda
def test_sharded_scan_step_on_nccl_world_of_one():
    """The mesh's scan step (``make_sharded_batch_step`` and
    ``make_sharded_run_block`` with ``runtime="scan"``) on a (1, 1) mesh of
    a one-rank NCCL process group: one kernel launch each, and the
    unsharded block's state and outputs bit for bit."""
    import socket

    from sydr_tpu_torch.channels import runtime as rt
    from sydr_tpu_torch.ops import scan_kernel as sk
    from sydr_tpu_torch.parallel import distributed, mesh as pmesh

    cfg, codes, st, wre, wim = _scan_args(SCAN_CASES[0][1], _cuda())
    assert sk.SCAN_CLUSTER > 1
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    distributed.initialize("nccl", rank=0, world_size=1,
                           init_method=f"tcp://127.0.0.1:{port}")
    try:
        mesh = pmesh.make_mesh(1, 1)
        before = sk.SCAN_KERNEL.launches
        steps = [pmesh.make_sharded_batch_step(cfg, mesh)(
                     codes, st, wre, wim),
                 pmesh.make_sharded_run_block(cfg, mesh)(
                     codes, st, wre, wim)]
        assert sk.SCAN_KERNEL.launches == before + 2
    finally:
        distributed.shutdown()
    ref = rt.run_block(cfg, codes, st, wre, wim)
    torch.cuda.synchronize()
    for got in steps:
        _assert_pass_c_equal(got, ref, "the mesh's scan step")


# The session's step as a captured CUDA graph (ops/step_graph.py)
# against the eager step: tests/test_torch_session.py's stream (8 Msps
# decimated to 2 Msps, the satellites at 46 dB-Hz) over 8 channels, the
# pull-in at 5 ms blocks and the narrow-only cruise at 20 ms x 5 blocks,
# then a reset of channel 1 (a demotion) and three more calls; the scan
# runtime at 20 ms blocks. A graph replays the same kernels in the same
# order, so outputs and state are held bit for bit.
GRAPH_FS_IN, GRAPH_DEC, GRAPH_MS = 8e6, 4, 1500
GRAPH_PRNS = [5, 12, 20, 3, 7, 9, 14, 30]       # 5 and 12 in the signal


def _graph_configs(form):
    fs = GRAPH_FS_IN / GRAPH_DEC
    common = dict(sampling_frequency=fs, input_decimate=GRAPH_DEC,
                  window_size=round(fs * 1e-3) + 256, quantize_spacing=True)
    if form == "scan":
        return TrackingConfig(runtime="scan", profile="borre", block_ms=20,
                              **common), None
    extra = (dict(use_pallas=True, boundary_mode="prefix")
             if form == "prefix" else {})
    pull_in = TrackingConfig(runtime="batch", profile="kaplan", block_ms=5,
                             **common, **extra)
    return pull_in, dataclasses.replace(
        pull_in, kaplan_narrow_only=True, block_ms=20, superblock=5)


def _kernel_counts():
    from sydr_tpu_torch.ops import geometry_kernel as gk
    from sydr_tpu_torch.ops import loop_kernel as lk
    from sydr_tpu_torch.ops import scan_kernel as sk

    return {"k1": ck.KERNEL.launches, "k3": ck.CUMSUM_KERNEL.launches,
            "k2": acq_kernel.KERNEL.launches,
            "geometry": gk.GEOMETRY_KERNEL.launches,
            "pass_c": lk.PASS_C_KERNEL.launches,
            "scan": sk.SCAN_KERNEL.launches}


def _graph_session_run(form, graph, dev, mesh=None):
    """One session over the stream (on ``mesh``, if given): every call's
    outputs, the final packed state, the kernels' and the collectives'
    launches, the calls at which it promoted and was reset, and the
    session."""
    from sydr_tpu_torch.channels.state import pack_state
    from sydr_tpu_torch.parallel import distributed
    from sydr_tpu_torch.receiver.session import TrackingSession
    from sydr_tpu_torch.signal.synthetic import IQGenerator

    bits = np.random.default_rng(11).integers(0, 2, 200)
    gen = IQGenerator(GRAPH_FS_IN, noise=True, seed=11)
    for prn, dop, cp in ((5, 1200.0, 321.4), (12, -2600.0, 811.9)):
        gen.add_satellite(prn, doppler_hz=dop, code_phase_chips=cp,
                          cn0_dbhz=46.0, nav_bits=bits)
    pull_in, cruise = _graph_configs(form)
    session = TrackingSession(pull_in, GRAPH_PRNS, cruise=cruise,
                              device=dev, graph=graph, mesh=mesh)
    per_ms = round(GRAPH_FS_IN * 1e-3)
    before = _kernel_counts()
    gathers = distributed.COLLECTIVES["all_gather"].launches
    outs, fed, promoted_at, reset_at = [], 0, None, None

    def call():
        iq = gen.generate_ms(session.block_input_samples // per_ms)
        outs.append(session.process_block(np.float32(iq.real),
                                          np.float32(iq.imag)))

    while fed < GRAPH_MS:
        fed += session.block_input_samples // per_ms
        call()
        if promoted_at is None and session.promoted:
            promoted_at = len(outs)
    session.reset_channel(1)
    reset_at = len(outs)
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    launches = {k: v - before[k] for k, v in _kernel_counts().items()}
    gathers = distributed.COLLECTIVES["all_gather"].launches - gathers
    state = [t.cpu() for t in pack_state(session.state)]
    return dict(outs=outs, state=state, launches=launches, gathers=gathers,
                promoted_at=promoted_at, reset_at=reset_at, session=session,
                calls=len(outs))


@pytest.fixture(scope="module", params=["k1", "prefix", "scan"])
def graph_runs(request):
    dev = _cuda()
    form = request.param
    return form, {graph: _graph_session_run(form, graph, dev)
                  for graph in (False, True)}


@pytest.mark.cuda
def test_graphed_session_equals_eager_bit_for_bit(graph_runs):
    form, runs = graph_runs
    eager, graphed = runs[False], runs[True]
    assert graphed["session"].graph is not None
    assert eager["session"].graph is None
    assert len(graphed["outs"]) == len(eager["outs"])
    for i, (a, b) in enumerate(zip(eager["outs"], graphed["outs"])):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(b[k], a[k], err_msg=f"{i} {k}")
    for a, b in zip(eager["state"], graphed["state"]):
        assert torch.equal(a, b)
    assert torch.equal(eager["session"]._ring_re.cpu(),
                       graphed["session"]._ring_re.cpu())


@pytest.mark.cuda
def test_graphed_session_promotes_resets_and_replays(graph_runs):
    form, runs = graph_runs
    graphed = runs[True]
    assert graphed["promoted_at"] == runs[False]["promoted_at"]
    assert graphed["reset_at"] is not None
    graphs = graphed["session"].graph.graphs
    if form == "scan":
        assert len(graphs) == 1
    else:
        assert graphed["promoted_at"] is not None
        # pull-in and cruise; the demotion replays the pull-in graph
        assert len(graphs) == 2
        assert not graphed["session"].promoted
    assert all(entry.replays > 0 for entry in graphs.values())


@pytest.mark.cuda
def test_graphed_session_launch_counts_equal_eager(graph_runs):
    """The first call of a configuration runs eagerly and captures; each
    replay counts the launches its graph holds: the same counts as the
    eager run over the same blocks."""
    form, runs = graph_runs
    assert runs[True]["launches"] == runs[False]["launches"]
    want = {"k1": form == "k1", "k3": form == "prefix", "k2": True,
            "geometry": form != "scan", "pass_c": form != "scan",
            "scan": form == "scan"}
    assert {k: n > 0 for k, n in runs[True]["launches"].items()} == want
    held = {}
    for entry in runs[True]["session"].graph.graphs.values():
        for kern, n in entry.launches.items():
            held[kern] = held.get(kern, 0) + n
    assert acq_kernel.KERNEL not in held
    if form == "scan":
        from sydr_tpu_torch.ops import scan_kernel as sk

        # One kernel launch a 20 ms block, eager or replayed: the graph
        # holds that launch and no other kernel of the package.
        assert held == {sk.SCAN_KERNEL: 1}
        assert runs[True]["launches"]["scan"] == runs[True]["calls"]
    else:
        from sydr_tpu_torch.ops import geometry_kernel as gk
        from sydr_tpu_torch.ops import loop_kernel as lk

        # A block is three launches: the geometry, K1 or K3, pass C.
        corr = ck.KERNEL if form == "k1" else ck.CUMSUM_KERNEL
        assert held.get(corr, 0) > 0
        assert held.get(lk.PASS_C_KERNEL, 0) == held[corr]
        assert held.get(gk.GEOMETRY_KERNEL, 0) == held[corr]
        assert set(held) == {corr, lk.PASS_C_KERNEL, gk.GEOMETRY_KERNEL}
        assert runs[True]["launches"]["geometry"] \
            == runs[True]["launches"]["pass_c"]


@pytest.mark.cuda
def test_graphed_session_default_on_cuda():
    from sydr_tpu_torch.receiver.session import TrackingSession

    dev = _cuda()
    pull_in, cruise = _graph_configs("k1")
    assert TrackingSession(pull_in, GRAPH_PRNS, cruise=cruise,
                           device=dev).graph is not None
    assert TrackingSession(pull_in, GRAPH_PRNS, cruise=cruise, device=dev,
                           graph=False).graph is None


@pytest.mark.cuda
def test_failed_capture_raises():
    """A step that reads a CUDA tensor on the host cannot be captured: the
    runner raises, after the warm-up ran it eagerly once, and does not
    keep a graph for it."""
    from sydr_tpu_torch.ops.step_graph import StepGraph

    dev = _cuda()
    runner = StepGraph(dev)

    def step(x):
        return (x * float(x.sum().item()),)

    x = torch.ones(8, device=dev)
    with pytest.raises(RuntimeError):
        runner.run("host read", step, (x,))
    assert "host read" not in runner.graphs
    torch.cuda.synchronize()
    assert float((x + 1).sum()) == 16.0


@pytest.mark.cuda
def test_capture_survives_a_collected_graph():
    """A graph that becomes cyclic garbage while another step is captured
    is not collected inside that capture (its destructor's CUDA call would
    invalidate the capture): the runner holds the collector off."""
    import gc

    from sydr_tpu_torch.ops.step_graph import StepGraph

    dev = _cuda()
    x = torch.ones(256, device=dev)
    doomed = StepGraph(dev)
    doomed.run("old", lambda t: (t + 1.0,), (x,))
    doomed.run("old", lambda t: (t + 1.0,), (x,))
    holder = [doomed]
    del doomed

    def step(t):
        if holder and torch.cuda.is_current_stream_capturing():
            cycle = [holder.pop()]       # garbage, made mid-capture
            cycle.append(cycle)
            del cycle
        for _ in range(200):             # allocations that would collect
            t = t * 1.0001 + [0.0][0]
        return (t,)

    threshold = gc.get_threshold()
    gc.set_threshold(1)
    try:
        runner = StepGraph(dev)
        first = runner.run("new", step, (x,))[0].clone()
        again = runner.run("new", step, (x,))[0]
    finally:
        gc.set_threshold(*threshold)
    torch.cuda.synchronize()
    assert torch.equal(first, again)


# The multi-device steps as captured graphs on a one-rank NCCL process
# group, whose collectives run through NCCL at world size 1: the mesh
# session's step (the channel shard's step and its two all_gathers over
# ch) graphed by default and eager, and the unsharded session beside them,
# on the stream above through pull-in, promotion, cruise, a reset and
# three more calls, in the batch (K1) and the scan runtime; the
# time-sharded full-rate block and superblock, captured and eager, in both
# forms of pass B.
def _nccl_world_of_one():
    import socket

    from sydr_tpu_torch.parallel import distributed

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    distributed.initialize("nccl", rank=0, world_size=1,
                           init_method=f"tcp://127.0.0.1:{port}")


@pytest.fixture(scope="module", params=["k1", "scan"])
def mesh_graph_runs(request):
    from sydr_tpu_torch.parallel import distributed, mesh as pmesh

    dev = _cuda()
    form = request.param
    runs = {"unsharded": _graph_session_run(form, None, dev)}
    _nccl_world_of_one()
    try:
        mesh = pmesh.make_mesh(1, 1)
        runs["graphed"] = _graph_session_run(form, None, dev, mesh)
        runs["eager"] = _graph_session_run(form, False, dev, mesh)
    finally:
        distributed.shutdown()
    return form, mesh, runs


@pytest.mark.cuda
def test_mesh_graphed_session_equals_eager_bit_for_bit(mesh_graph_runs):
    form, mesh, runs = mesh_graph_runs
    assert mesh.backend == "nccl" and mesh.captures
    graphed = runs["graphed"]
    assert graphed["session"].graph is not None
    assert runs["eager"]["session"].graph is None
    for name in ("eager", "unsharded"):
        other = runs[name]
        assert len(graphed["outs"]) == len(other["outs"])
        for i, (a, b) in enumerate(zip(other["outs"], graphed["outs"])):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(b[k], a[k],
                                              err_msg=f"{name} {i} {k}")
        for a, b in zip(other["state"], graphed["state"]):
            assert torch.equal(a, b), name
        assert other["promoted_at"] == graphed["promoted_at"]
        assert other["launches"] == graphed["launches"], name
    if form == "k1":
        assert graphed["promoted_at"] is not None


@pytest.mark.cuda
def test_mesh_graph_holds_the_collectives(mesh_graph_runs):
    """Each graph of the mesh session holds its two all_gathers (state and
    outputs) as launches a replay counts, and more nodes than the
    unsharded session's graph of the same configuration; the collective
    launches equal the eager mesh session's, two a call."""
    from sydr_tpu_torch.parallel import distributed

    form, _, runs = mesh_graph_runs
    gather = distributed.COLLECTIVES["all_gather"]
    graphs = runs["graphed"]["session"].graph.graphs
    plain = runs["unsharded"]["session"].graph.graphs
    assert graphs.keys() == plain.keys()
    for key, entry in graphs.items():
        assert entry.launches.get(gather) == 2 and entry.replays > 0
        assert gather not in plain[key].launches
        assert entry.nodes > plain[key].nodes, (entry.node_kinds,
                                                plain[key].node_kinds)
        assert {k: n for k, n in entry.launches.items() if k is not gather} \
            == plain[key].launches
    calls = runs["graphed"]["calls"]
    assert runs["graphed"]["gathers"] == runs["eager"]["gathers"] == 2 * calls
    assert runs["unsharded"]["gathers"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["rowsum", "prefix"])
def test_timeshard_graph_on_nccl_world_of_one(form):
    """``TimeShardGraph`` on a one-rank NCCL ``sp`` mesh (graphed by
    default): the full-rate block (10 Msps, 32 channels, 4 + 20 ms) and a
    superblock of 2 such blocks, captured, then replayed on the next
    state, each equal to the eager time-sharded call bit for bit; the
    graphs hold the pass B collectives and K1 or K3."""
    from sydr_tpu_torch.ops import geometry_kernel as gk
    from sydr_tpu_torch.ops import loop_kernel as lk
    from sydr_tpu_torch.parallel import distributed, timeshard

    dev = _cuda()
    rng = np.random.default_rng(17)
    cfg = TrackingConfig(sampling_frequency=10e6, block_ms=20, tail_ms=4,
                         window_size=10256, runtime="batch",
                         profile="kaplan", kaplan_narrow_only=True,
                         quantize_spacing=True, use_pallas=form == "prefix",
                         boundary_mode=form)
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
    n_in = (cfg.tail_ms + 2 * cfg.block_ms) * spms
    sre, sim = (torch.tensor(rng.normal(0, 2, n_in), dtype=torch.float32,
                             device=dev) for _ in range(2))
    wre, wim = sre[:cfg.window_samples], sim[:cfg.window_samples]
    _nccl_world_of_one()
    try:
        mesh = timeshard.make_sp_mesh()
        runner = timeshard.TimeShardGraph(mesh, dev)
        assert runner.graph is not None
        calls = [("block", lambda s: runner.block(cfg, bits, s, wre, wim),
                  lambda s: timeshard.run_block_batched_timesharded(
                      cfg, mesh, bits, s, wre, wim)),
                 ("superblock",
                  lambda s: runner.superblock(cfg, 2, bits, s, sre, sim),
                  lambda s: timeshard.run_superblock_timesharded(
                      cfg, mesh, 2, bits, s, sre, sim))]
        for name, graphed, eager in calls:
            state = st
            for call in range(3):            # capture, replay, replay
                got, want = graphed(state), eager(state)
                _assert_pass_c_equal(got, want, f"{form} {name} {call}")
                state = want[0]
    finally:
        distributed.shutdown()
    corr = ck.KERNEL if form == "rowsum" else ck.CUMSUM_KERNEL
    reduce = distributed.COLLECTIVES["all_reduce"]
    entries = list(runner.graph.graphs.values())
    assert len(entries) == 2 and all(e.replays == 2 for e in entries)
    for entry, blocks in zip(entries, (1, 2)):
        assert entry.launches[corr] == entry.launches[lk.PASS_C_KERNEL] \
            == entry.launches[gk.GEOMETRY_KERNEL] == blocks
        assert entry.launches[reduce] == blocks


@pytest.mark.cuda
def test_span_counts_host_waits_and_reads_device_time():
    """The recorder on the card (``utils.metrics``): a span around
    ``.item()`` counts one wait on the device, a non-blocking
    device-to-device copy none, a span with ``device=`` reads its kernel's
    time on the device, and the sync debug mode is restored after."""
    from sydr_tpu_torch.utils import metrics

    dev = _cuda()
    rec = metrics.StageTimers()
    x = torch.ones(1 << 20, device=dev)
    y = torch.empty_like(x)
    metrics.enable()
    try:
        with rec.time("stage"):
            with metrics.span("item") as item:
                x.sum().item()
            with metrics.span("copy") as copy:
                y.copy_(x, non_blocking=True)
            with metrics.span("kernel", device=dev) as kernel:
                torch.cuda._sleep(1_000_000)
    finally:
        metrics.enable(False)
    torch.cuda.synchronize()
    assert (item.syncs, copy.syncs, kernel.syncs) == (1, 0, 0)
    assert kernel.device_ms > 0 and item.device_ms is None
    assert torch.cuda.get_sync_debug_mode() == 0
    assert rec.summary()["item"]["syncs"] == 1
