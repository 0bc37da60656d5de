"""The sky generator: seeded, and its satellites where it put them."""

import numpy as np
import torch

from benchmark import sky
from benchmark.cacode import code_bits
from benchmark.reference import acquisition as ref_acq


def test_gold_codes_match_is_gps_200():
    # First 10 chips in octal (IS-GPS-200 table 3-Ia) of PRN 1, 2, 19, 32.
    for prn, octal in ((1, 1440), (2, 1620), (19, 1633), (32, 1712)):
        bits = code_bits(prn)[:10]
        assert int("".join(map(str, bits)), 2) == int(str(octal), 8)


def test_same_seed_same_samples():
    def make(seed):
        rng = sky.seed_rng(seed)
        sats = sky.draw_sky(rng, list(range(1, 33)), visible=[6, 12],
                            cn0_dbhz=[35.0, 50.0], doppler_hz=[-4500, 4500])
        return sats, sky.render(sats, 2.046e6, 0.0, 0, 5000, "cpu",
                                sky.torch_generator(seed, "cpu"))

    (s1, (a1, b1)), (s2, (a2, b2)) = make(2**31 + 5), make(2**31 + 5)
    assert [s.prn for s in s1] == [s.prn for s in s2]
    assert torch.equal(a1, a2) and torch.equal(b1, b2)
    _, (a3, _) = make(2**31 + 6)
    assert not torch.equal(a1, a3)


def test_chunks_join_without_a_seam():
    rng = sky.seed_rng(3)
    sats = sky.draw_sky(rng, [1, 2], visible=[2, 2], cn0_dbhz=[50, 50],
                        doppler_hz=[-4000, 4000], doppler_rate_hz_s=[-1, 1])
    whole = sky.render(sats, 1e6, 0.0, 0, 3000, "cpu", None)
    tail = sky.render(sats, 1e6, 0.0, 1000, 2000, "cpu", None)
    assert torch.allclose(whole[0][1000:], tail[0], atol=1e-6)


def test_reference_acquires_each_satellite_where_it_was_put():
    fs = 2.046e6
    n = round(fs * 1e-3)
    rng = sky.seed_rng(2**31 + 17)
    prns = [4, 9, 23]
    sats = sky.draw_sky(rng, prns, visible=[3, 3], cn0_dbhz=[42.0, 48.0],
                        doppler_hz=[-4500.0, 4500.0])
    re, im = sky.render(sats, fs, 0.0, 0, 50 * n, "cpu",
                        sky.torch_generator(17, "cpu"))
    bins = ref_acq.doppler_bins(5000.0, 100.0)
    cmap = ref_acq.pcps_map(re, im, prns, fs=fs, f_if=0.0, bins=bins,
                            coherent=5, non_coherent=10)
    fi, ci, metric = ref_acq.peak_metric(cmap, fs)
    for row, s in enumerate(sats):
        assert abs(bins[int(fi[row])] - s.doppler_hz) <= 100.0
        d = (int(ci[row]) - s.code_index(fs) + n // 2) % n - n // 2
        assert abs(d) <= 2
        assert float(metric[row]) > 1.5


def test_visible_counts_and_ranges_hold():
    rng = sky.seed_rng(9)
    for _ in range(20):
        sats = sky.draw_sky(rng, list(range(1, 33)), visible=[6, 12],
                            cn0_dbhz=[35.0, 50.0], doppler_hz=[-4500, 4500])
        assert 6 <= len(sats) <= 12
        assert len({s.prn for s in sats}) == len(sats)
        assert all(35.0 <= s.cn0_dbhz <= 50.0 for s in sats)
        assert all(abs(s.doppler_hz) <= 4500 for s in sats)
        assert all(set(np.unique(s.nav_bits)) <= {-1, 1} for s in sats)
