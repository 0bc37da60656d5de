"""The receiver against the benchmark's plain references at tiny sizes, and
the roofline arithmetic."""

import numpy as np
import pytest
import torch

from benchmark import roofline, sky
from benchmark.engines import snapshots, stream
from benchmark.reference import acquisition as ref_acq
from benchmark.reference import cruise_block as ref_cruise
from benchmark.tests import _tiny
from benchmark.trace import Tracer


def test_k2_flops_at_the_cold_start_shape():
    flops = roofline.k2_flops(32, 101, 10, 16368)
    assert f"{flops:.2e}" == "4.23e+10"
    assert roofline.bound_s(flops, 0.0) == pytest.approx(flops / 67e12)


def test_stream_flops_counts_mix_and_taps():
    assert roofline.stream_flops(1000, 3) == 1000 * (28 + 3 * 8)


@pytest.mark.parametrize("fs", [2.046e6, 4e6])
def test_acquire_matches_the_direct_map(fs):
    from sydr_tpu_torch.ops import acquisition as acq

    prns = [3, 7, 19]
    rng = sky.seed_rng(5)
    sats = sky.draw_sky(rng, prns, visible=[2, 2], cn0_dbhz=[44.0, 48.0],
                        doppler_hz=[-4500.0, 4500.0])
    n = round(fs * 1e-3)
    re, im = sky.render(sats, fs, 0.0, 0, 50 * n, "cpu",
                        sky.torch_generator(5, "cpu"))
    code_k = np.stack([acq.code_fft_conj(p, fs) for p in prns])
    bins = acq.doppler_bins(5000.0, 100.0)
    doppler, ci, metric, cmap = acq.acquire(
        (re[None].expand(3, -1), im[None].expand(3, -1)), code_k, bins,
        sampling_frequency=fs)
    ref = ref_acq.pcps_map(re, im, prns, fs=fs, f_if=0.0,
                           bins=ref_acq.doppler_bins(5000.0, 100.0),
                           coherent=5, non_coherent=10)
    fi = snapshots._bin_index(doppler.numpy(), ref_acq.doppler_bins(
        5000.0, 100.0), "cpu")
    nums = snapshots.numbers(cmap, fi, ci.to(torch.int64), metric, ref, fs)
    assert nums["map_gap"] < 1e-5
    assert nums["cell_gap"] < 1e-5
    assert nums["metric_gap"] < 1e-5


def test_cruise_superblock_matches_the_plain_copy():
    """The receiver's superblock (its plain versions on the CPU) from a
    pulled-in state against the frozen plain copy: bit for bit."""
    spec = _tiny.spec(_tiny.CRUISE)
    eng = stream.Engine(spec["config"], spec["traffic"], _tiny.SEED, "cpu")
    eng.setup()
    eng.window(0.3, Tracer(False))
    eng.release()
    assert eng.sample
    nums = eng.compare(control=False)
    assert nums and all(v == 0.0 for v in nums.values()), nums


def test_tiled_code_bits_match_the_receivers():
    from sydr_tpu_torch.channels import batch_runtime

    prns = [0, 1, 17, 32]
    np.testing.assert_array_equal(ref_cruise.tiled_code_bits(prns),
                                  batch_runtime.tiled_code_bits(prns))


def test_taps_match_the_receivers():
    from sydr_tpu_torch.channels import batch_runtime

    spec = _tiny.spec(_tiny.CRUISE)
    for fs in (2.046e6, 4e6, 16.368e6):
        cfg = dict(spec["config"], sampling_frequency=fs)
        eng = stream.Engine(cfg, spec["traffic"], 1, "cpu")
        _, cruise = eng._tracking_configs()
        assert ref_cruise.Params(cfg).taps() == batch_runtime.taps_for(cruise)
