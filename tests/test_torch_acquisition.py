"""Port's PCPS acquisition (K2 ``pcps_bins`` plain version on CPU) against
the JAX shift-theorem map and its fused Pallas kernel (interpret mode), and
the port's direct map against the JAX direct map and the port's own shift
map (within 1e-4 of the map's maximum: the same float32 transforms in
another grouping; the JAX map runs a matmul DFT, held to 5e-3 as below).

Shape and bounds of tests/test_acquisition.py::test_fused_map_matches_shift_map:
the map within 5e-3 of its maximum (the JAX fused kernel's bf16 budget;
the port's complex64 FFT sits far inside it), the same Doppler bin and
code index, and a two-peak metric within 0.05.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sydr_tpu.ops import acquisition as jacq
from sydr_tpu.ops import fft as mmfft
from sydr_tpu.signal.synthetic import IQGenerator
from sydr_tpu_torch.ops import acq_kernel
from sydr_tpu_torch.ops import acquisition as tacq

torch.set_num_threads(2)

FS = 2.046e6
N = int(FS * 1e-3)
COHER, NONCOH = 3, 4


@pytest.fixture(scope="module")
def case():
    gen = IQGenerator(FS, noise=True, seed=5)
    gen.add_satellite(17, doppler_hz=-2360.0, code_phase_chips=77.7,
                      cn0_dbhz=45.0)
    iq = gen.generate_ms(COHER * NONCOH)
    iq_re = np.float32(iq.real)[None]
    iq_im = np.float32(iq.imag)[None]
    k = jacq.code_fft_conj(17, FS)[None]
    bins = jacq.doppler_bins(3000, 100)
    phases, bin_shifts = jacq.shift_plan(bins, FS, N, mode="shift")
    plans = (mmfft.make_plan(N), mmfft.make_plan(N, inverse=True))
    common = dict(sampling_frequency=FS, coherent=COHER,
                  non_coherent=NONCOH, phases=phases, bin_shifts=bin_shifts)
    jargs = (jnp.asarray(iq_re), jnp.asarray(iq_im),
             jnp.asarray(np.float32(k.real)), jnp.asarray(np.float32(k.imag)),
             plans[0], plans[1])
    shift_map = np.asarray(jacq.pcps_shift_map(*jargs, **common))
    fused_map = np.asarray(jacq.pcps_shift_map_fused(
        *jargs, interpret=True, **common))
    return dict(iq_re=iq_re, iq_im=iq_im, k=k, bins=bins, phases=phases,
                bin_shifts=bin_shifts, maps={"shift": shift_map,
                                             "fused": fused_map})


def test_shift_plan_matches_jax(case):
    assert tacq.shift_plan(case["bins"], FS, N) == \
        (case["phases"], case["bin_shifts"])
    bins = jacq.doppler_bins(5000, 100)             # the session's grid
    assert tacq.shift_plan(bins, 2.5e6, 2500) == \
        jacq.shift_plan(bins, 2.5e6, 2500, mode="auto")
    phases, _ = tacq.shift_plan(bins + 37.0, 2.5e6, 2500)
    assert len(phases) == 10


# Three bin grids at fs/n = 1000 Hz: the session's (10 phases, reused ten
# times), a 130 Hz step (77 bins, 77 phases: no reuse) and a grid that does
# not decompose at all (a phase within 1e-6 of the next DFT bin).
GRIDS = {
    "step100": lambda: jacq.doppler_bins(5000, 100),
    "step130": lambda: jacq.doppler_bins(5000, 130),
    "offgrid": lambda: jacq.doppler_bins(5000, 500).astype(np.float64)
    + 999.9999995,
}


@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("mode", ["auto", "shift", "direct"])
def test_shift_plan_modes_match_jax(grid, mode, monkeypatch):
    monkeypatch.delenv("SYDR_ACQ_MODE", raising=False)
    bins = GRIDS[grid]()
    got = tacq.shift_plan(bins, 2.5e6, 2500, mode=mode)
    assert got == jacq.shift_plan(bins, 2.5e6, 2500, mode=mode)
    expect_plan = {"step100": mode != "direct", "step130": mode == "shift",
                   "offgrid": False}[grid]
    assert (got is not None) == expect_plan


def test_shift_plan_declines_a_grid_without_phase_reuse(monkeypatch):
    """The default mode is the JAX package's ``"auto"``: the 130 Hz grid
    (77 bins on 77 distinct phases) has no plan, so ``acquire`` takes the
    direct map, a few bins at a time, instead of holding one forward
    spectrum set per bin."""
    monkeypatch.delenv("SYDR_ACQ_MODE", raising=False)
    bins = jacq.doppler_bins(5000, 130)
    assert len(bins) == 77
    assert jacq.shift_plan(bins, 2.5e6, 2500) is None
    assert tacq.shift_plan(bins, 2.5e6, 2500) is None
    assert tacq.ACQ_MODE_DEFAULT == jacq.ACQ_MODE_DEFAULT == "auto"
    assert len(tacq.shift_plan(bins, 2.5e6, 2500, mode="shift")[0]) == 77


@pytest.fixture(scope="module")
def direct_case(case):
    """The module's capture on a 130 Hz grid (47 bins, no plan)."""
    bins = jacq.doppler_bins(3000, 130)
    assert tacq.shift_plan(bins, FS, N) is None
    pad = (-len(bins)) % 4
    plans = (mmfft.make_plan(N), mmfft.make_plan(N, inverse=True))
    ref = np.asarray(jacq.pcps_map(
        jnp.asarray(case["iq_re"]), jnp.asarray(case["iq_im"]),
        jnp.asarray(np.float32(case["k"].real)),
        jnp.asarray(np.float32(case["k"].imag)),
        jnp.asarray(np.concatenate([bins, np.repeat(bins[-1:], pad)])),
        plans[0], plans[1], sampling_frequency=FS, coherent=COHER,
        non_coherent=NONCOH, doppler_chunk=4))[:, :len(bins)]
    return bins, ref


@pytest.mark.parametrize("doppler_chunk", [4, 5, 64])
def test_pcps_map_matches_jax(case, direct_case, doppler_chunk):
    """Any chunk size gives the same map (the last chunk may be short)."""
    bins, ref = direct_case
    got = tacq.pcps_map(
        torch.from_numpy(case["iq_re"]), torch.from_numpy(case["iq_im"]),
        torch.from_numpy(case["k"]).to(torch.complex64),
        torch.from_numpy(bins), sampling_frequency=FS, coherent=COHER,
        non_coherent=NONCOH, doppler_chunk=doppler_chunk).numpy()
    assert got.shape == ref.shape == (1, len(bins), N)
    assert (np.abs(got - ref) / ref.max()).max() < 5e-3


def test_acquire_takes_direct_map_without_plan(case, direct_case,
                                               monkeypatch):
    bins, ref = direct_case
    calls = []
    real = tacq.pcps_map
    monkeypatch.setattr(tacq, "pcps_map",
                        lambda *a, **k: calls.append(k) or real(*a, **k))
    monkeypatch.setattr(tacq, "pcps_shift_map", None)
    dop, ci, metric, got = tacq.acquire(
        (torch.from_numpy(case["iq_re"]), torch.from_numpy(case["iq_im"])),
        case["k"], bins, sampling_frequency=FS, coherent=COHER,
        non_coherent=NONCOH, doppler_chunk=8)
    assert len(calls) == 1 and calls[0]["doppler_chunk"] == 8
    spc = round(FS / 1.023e6)
    d_r, c_r, m_r = jacq.peak_metric(
        jnp.asarray(ref), jnp.asarray(bins), samples_per_chip=spc)
    assert float(d_r[0]) == float(dop[0])
    assert abs(float(dop[0]) + 2360.0) <= 65.0
    assert int(c_r[0]) == int(ci[0])
    assert abs(float(m_r[0]) - float(metric[0])) < 0.05


def test_pcps_map_matches_port_shift_map(case):
    """On a grid that has a plan the two maps of the port agree within 1e-4
    of the maximum."""
    args = (torch.from_numpy(case["iq_re"]), torch.from_numpy(case["iq_im"]),
            torch.from_numpy(case["k"]).to(torch.complex64))
    common = dict(sampling_frequency=FS, coherent=COHER, non_coherent=NONCOH)
    shift = tacq.pcps_shift_map(*args, phases=case["phases"],
                                bin_shifts=case["bin_shifts"], **common)
    direct = tacq.pcps_map(*args, torch.from_numpy(case["bins"]), **common)
    assert direct.shape == shift.shape
    assert float((direct - shift).abs().max()) <= 1e-4 * float(shift.max())


@pytest.mark.parametrize("jax_map", ["shift", "fused"])
def test_acquire_matches_jax_map(case, jax_map):
    ref = case["maps"][jax_map]
    dop, ci, metric, got = tacq.acquire(
        (torch.from_numpy(case["iq_re"]), torch.from_numpy(case["iq_im"])),
        case["k"], case["bins"], sampling_frequency=FS, coherent=COHER,
        non_coherent=NONCOH)
    got = got.numpy()
    assert got.shape == ref.shape
    rel = np.abs(got - ref) / np.abs(ref).max()
    assert rel.max() < 5e-3, rel.max()
    spc = round(FS / 1.023e6)
    d_r, c_r, m_r = jacq.peak_metric(
        jnp.asarray(ref), jnp.asarray(case["bins"]), samples_per_chip=spc)
    assert float(d_r[0]) == float(dop[0])
    assert int(c_r[0]) == int(ci[0])
    assert abs(float(m_r[0]) - float(metric[0])) < 0.05


# A 16.368 Msps front end (the classic GPS L1 clock): n = 16368 =
# 2^4 * 3 * 11 * 31, whose transform the card runs on a cluster of two
# blocks; the JAX map factors it 124 x 132.
FS_16 = 16.368e6
N_16 = 16368


def test_acquire_matches_jax_at_16368_ksps():
    """The module's capture and bounds at 16.368 Msps, 1 channel, 61 bins,
    1 x 2 blocks: the port's ``acquire`` against JAX's ``pcps_shift_map``
    and ``peak_metric``."""
    coher, noncoh = 1, 2
    gen = IQGenerator(FS_16, noise=True, seed=5)
    gen.add_satellite(17, doppler_hz=-2360.0, code_phase_chips=77.7,
                      cn0_dbhz=45.0)
    iq = gen.generate_ms(coher * noncoh)
    iq_re, iq_im = np.float32(iq.real)[None], np.float32(iq.imag)[None]
    k = jacq.code_fft_conj(17, FS_16)[None]
    bins = jacq.doppler_bins(3000, 100)
    assert len(bins) == 61
    phases, bin_shifts = jacq.shift_plan(bins, FS_16, N_16, mode="shift")
    ref = np.asarray(jacq.pcps_shift_map(
        jnp.asarray(iq_re), jnp.asarray(iq_im),
        jnp.asarray(np.float32(k.real)), jnp.asarray(np.float32(k.imag)),
        mmfft.make_plan(N_16), mmfft.make_plan(N_16, inverse=True),
        sampling_frequency=FS_16, coherent=coher, non_coherent=noncoh,
        phases=phases, bin_shifts=bin_shifts))
    dop, ci, metric, got = tacq.acquire(
        (torch.from_numpy(iq_re), torch.from_numpy(iq_im)), k, bins,
        sampling_frequency=FS_16, coherent=coher, non_coherent=noncoh)
    got = got.numpy()
    assert got.shape == ref.shape == (1, 61, N_16)
    assert (np.abs(got - ref) / np.abs(ref).max()).max() < 5e-3
    spc = round(FS_16 / 1.023e6)
    d_r, c_r, m_r = jacq.peak_metric(jnp.asarray(ref), jnp.asarray(bins),
                                     samples_per_chip=spc)
    assert float(d_r[0]) == float(dop[0])
    assert abs(float(dop[0]) + 2360.0) <= 100.0
    assert int(c_r[0]) == int(ci[0])
    assert abs(float(m_r[0]) - float(metric[0])) < 0.05


# A 26.5 Msps front end: n = 26500 = 2^2 * 5^3 * 53, whose prime factor 53
# the card's FFT runs as a generic pass, on a cluster of four blocks; the
# JAX map factors it 125 x 212.
FS_26 = 26.5e6
N_26 = 26500


def test_acquire_matches_jax_at_26500_ksps():
    """The module's capture and bounds at 26.5 Msps, 1 channel, 61 bins,
    1 x 2 blocks: the port's ``acquire`` against JAX's ``pcps_shift_map``
    and ``peak_metric``, as at 16.368 Msps."""
    coher, noncoh = 1, 2
    assert mmfft._balanced_factors(N_26) == (125, 212)
    gen = IQGenerator(FS_26, noise=True, seed=5)
    gen.add_satellite(17, doppler_hz=-2360.0, code_phase_chips=77.7,
                      cn0_dbhz=45.0)
    iq = gen.generate_ms(coher * noncoh)
    iq_re, iq_im = np.float32(iq.real)[None], np.float32(iq.imag)[None]
    k = jacq.code_fft_conj(17, FS_26)[None]
    bins = jacq.doppler_bins(3000, 100)
    phases, bin_shifts = jacq.shift_plan(bins, FS_26, N_26, mode="shift")
    ref = np.asarray(jacq.pcps_shift_map(
        jnp.asarray(iq_re), jnp.asarray(iq_im),
        jnp.asarray(np.float32(k.real)), jnp.asarray(np.float32(k.imag)),
        mmfft.make_plan(N_26), mmfft.make_plan(N_26, inverse=True),
        sampling_frequency=FS_26, coherent=coher, non_coherent=noncoh,
        phases=phases, bin_shifts=bin_shifts))
    dop, ci, metric, got = tacq.acquire(
        (torch.from_numpy(iq_re), torch.from_numpy(iq_im)), k, bins,
        sampling_frequency=FS_26, coherent=coher, non_coherent=noncoh)
    got = got.numpy()
    assert got.shape == ref.shape == (1, 61, N_26)
    assert (np.abs(got - ref) / np.abs(ref).max()).max() < 5e-3
    spc = round(FS_26 / 1.023e6)
    d_r, c_r, m_r = jacq.peak_metric(jnp.asarray(ref), jnp.asarray(bins),
                                     samples_per_chip=spc)
    assert float(d_r[0]) == float(dop[0])
    assert abs(float(dop[0]) + 2360.0) <= 100.0
    assert int(c_r[0]) == int(ci[0])
    assert abs(float(m_r[0]) - float(metric[0])) < 0.05


def test_peak_metric_matches_jax(case):
    m = case["maps"]["shift"]
    spc = round(FS / 1.023e6)
    a = jacq.peak_metric(jnp.asarray(m), jnp.asarray(case["bins"]),
                         samples_per_chip=spc)
    b = tacq.peak_metric(torch.from_numpy(m), torch.from_numpy(case["bins"]),
                         samples_per_chip=spc)
    np.testing.assert_array_equal(b[0].numpy(), np.asarray(a[0]))
    np.testing.assert_array_equal(b[1].numpy(), np.asarray(a[1]))
    np.testing.assert_allclose(b[2].numpy(), np.asarray(a[2]), rtol=1e-6)


def test_pcps_bins_cpu_runs_plain_version(case):
    """On CPU tensors the wrapper is the plain version and launches
    nothing; the plain version equals a per-bin numpy evaluation."""
    spectra = tacq.phase_spectra(
        torch.from_numpy(case["iq_re"]), torch.from_numpy(case["iq_im"]),
        n=N, sampling_frequency=FS, coherent=COHER, non_coherent=NONCOH,
        phases=case["phases"])
    code_k = torch.from_numpy(case["k"]).to(torch.complex64)
    before = acq_kernel.KERNEL.launches
    got = acq_kernel.pcps_bins(spectra, code_k, case["bin_shifts"])
    assert acq_kernel.KERNEL.launches == before
    s = spectra.numpy().astype(np.complex128)
    k64 = case["k"][0]
    for b in (0, 17, len(case["bin_shifts"]) - 1):
        kb, p = case["bin_shifts"][b]
        ref = np.abs(np.fft.ifft(s[p, 0] * np.roll(k64, kb), axis=-1)).sum(0)
        np.testing.assert_allclose(got[0, b].numpy(), ref,
                                   rtol=1e-4, atol=1e-4 * ref.max())


def test_balanced_factors_matches_jax():
    for n in (2046, 2500, 10000, 4092):
        assert acq_kernel.balanced_factors(n) == mmfft._balanced_factors(n)


# 20000 (20 Msps) and 16368, 40920 (16.368 and 40.92 Msps) take the
# cluster kernel.
SMOOTH_N = (2048, 2500, 4000, 5000, 10000, 20000)
# Code periods of front ends clocked at a multiple of 1.023 MHz
# (1023 = 3 * 11 * 31), and one length for each other prime radix.
PRIME_N = (1023, 2046, 4092, 8184, 16368, 40920, 7 * 13 * 20, 17 * 19 * 6,
           23 * 29 * 4)
PRIME_RADICES = {7, 11, 13, 17, 19, 23, 29, 31}
SMALL_RADICES = {2, 3, 4, 5, 10}
SMEM = 232_448   # the H100's shared memory a block (227 KB)


def assert_block_fits(n, plan, cluster, threads):
    """A block of ``cluster`` sharing one transform of ``plan``: its two
    buffers of ceil(n / C) complex64 points fit 227 KB; its points fit its
    variant's block, 1024 threads x 20 points without a prime radix,
    512 x 16 with one (or with a generic radix above 31, or radix 1:
    the same variants); its threads hold its share of the last pass's
    outputs, floor(21 / r) (floor(32 / r) with a prime radix) butterflies
    of the last radix r a thread. A generic radix is neither first nor
    last, radix 1 at an end only (the kernels' ``parse_plan``)."""
    prime = not set(plan) <= SMALL_RADICES
    assert all(r <= 31 for r in (plan[0], plan[-1]))
    assert 1 not in plan[1:-1]
    share = -(-n // cluster)
    assert cluster in (1, 2, 4, 8)
    assert 16 * share <= SMEM
    assert share <= (512 * 16 if prime else 1024 * 20)
    assert threads % 32 == 0 and 128 <= threads <= (512 if prime else 1024)
    acc = 32 if prime else 21
    assert -(-(n // plan[-1]) // cluster) <= (acc // plan[-1]) * threads


@pytest.mark.parametrize("n", SMOOTH_N + PRIME_N)
def test_radix_plan_multiplies_to_n(n):
    """The FFT kernels' plan: radices they have butterflies for (10 = 2 x 5
    in registers, the odd primes 7 to 31), product n, and blocks that fit
    the card (:func:`assert_block_fits`) on the cluster that
    ``cluster_size`` gives."""
    plan = acq_kernel.radix_plan(n)
    assert set(plan) <= {2, 3, 4, 5, 10} | PRIME_RADICES and len(plan) >= 2
    assert int(np.prod(plan)) == n
    assert acq_kernel.has_radix_plan(n)
    prime = bool(set(plan) & PRIME_RADICES)
    assert prime == (n in PRIME_N)
    cluster = acq_kernel.cluster_size(n, plan)
    assert cluster == (1 if n <= 10000 else 2 if n <= 20000 else 8)
    assert_block_fits(n, plan, cluster,
                      acq_kernel.fft_threads(n, plan, cluster))
    if prime:   # the largest prime radix leads, the others close the plan
        wide = sorted((r for r in plan if r in PRIME_RADICES), reverse=True)
        assert plan[0] == wide[0]
        assert list(plan[len(plan) - len(wide) + 1:]) == wide[1:]


def test_radix_plan_refused_for_large_prime_factors():
    """A prime factor above the largest butterfly, 31, is a generic pass
    of its own, after the first pass: n = 4070 = 2 * 5 * 11 * 37 is
    (11, 37, 10), 2 * 1013 ends in a radix-1 (magnitude only) pass, and
    1517 = 37 * 41, with no factor up to 31, begins in one too (product
    only). A prime n is refused: 4093 and 65521 by ``kernel_for`` in the
    JAX package's words (``_balanced_factors`` refuses a prime above 64),
    37 and 7 by ``radix_plan`` for their single pass (JAX would take 37 as
    1 x 37; no front end samples at 37 ksps). A prime radix has no
    whole-n cap: n = 10230 (10.23 Msps), above the one-block kernel's
    8192 points with a prime radix, has a plan and a cluster of two.
    n = 4092 = 2^2 * 3 * 11 * 31 (4.092 Msps) has a plan and goes to the
    FFT kernel."""
    assert acq_kernel.radix_plan(4070) == (11, 37, 10)
    assert acq_kernel.radix_plan(2 * 1013) == (2, 1013, 1)
    assert acq_kernel.radix_plan(1517) == (1, 41, 37, 1)
    assert acq_kernel.radix_plan(65231) == (1, 43, 41, 37, 1)
    assert acq_kernel.radix_plan(26500) == (10, 10, 53, 5)
    for n in (4070, 2 * 1013, 1517):
        assert acq_kernel.has_radix_plan(n)
        assert acq_kernel.has_prime_radix(acq_kernel.radix_plan(n))
    for n in (4093, 65521):
        with pytest.raises(ValueError, match="two passes"):
            acq_kernel.radix_plan(n)
        with pytest.raises(ValueError, match=f"N={n} has no useful "
                                             r"factorisation \(prime\?\)"):
            acq_kernel.kernel_for(n)
        with pytest.raises(ValueError, match="no useful factorisation"):
            mmfft._balanced_factors(n)
    for n in (37, 7):
        with pytest.raises(ValueError, match="two passes"):
            acq_kernel.radix_plan(n)
        assert not acq_kernel.has_radix_plan(n)
    assert acq_kernel.radix_plan(10230) == (31, 10, 3, 11)
    assert acq_kernel.has_radix_plan(10230)
    assert acq_kernel.cluster_size(10230) == 2
    assert acq_kernel.radix_plan(2500) == (10, 10, 5, 5)
    assert acq_kernel.radix_plan(10000) == (10, 10, 10, 10)
    assert acq_kernel.radix_plan(4092) == (31, 4, 3, 11)
    assert acq_kernel.radix_plan(1023) == (31, 3, 11)


@pytest.mark.parametrize("n, kernel", [
    (4092, "KERNEL"), (2046, "KERNEL"), (2500, "KERNEL"),
    (4070, "KERNEL"), (10230, "CLUSTER_KERNEL"),
    (16368, "CLUSTER_KERNEL"), (40920, "CLUSTER_KERNEL")])
def test_kernel_choice_from_n(n, kernel):
    """``pcps_bins_launch_args`` picks the entry from n alone
    (``kernel_for``): an FFT kernel with its plan, on one block or, with
    the cluster size last, on a cluster (4070 = 2 * 5 * 11 * 37, its
    radix 37 a generic pass, on one block)."""
    got, shape = acq_kernel.kernel_for(n)
    assert got is getattr(acq_kernel, kernel)
    plan = acq_kernel.radix_plan(n)
    cluster = 1 if kernel == "KERNEL" else shape[3]
    assert cluster == acq_kernel.cluster_size(n)
    assert len(shape) == (3 if cluster == 1 else 4)
    assert list(shape[0]) == list(plan) and shape[1] == len(plan)
    assert shape[2] == acq_kernel.fft_threads(n, plan, cluster)


def smooth_31(lo, hi):
    """Every n in [lo, hi] whose prime factors are at most 31."""
    out = []
    for n in range(lo, hi + 1):
        rest = n
        for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31):
            while rest % p == 0:
                rest //= p
        if rest == 1:
            out.append(n)
    return out


@pytest.mark.parametrize("lo, hi", [
    (64, 8192), (8193, 16384), (16385, 32768), (32769, 65536)])
def test_every_smooth_n_has_a_radix_entry(lo, hi):
    """Every 31-smooth code period in [64, 65536] with a radix plan gets an
    FFT kernel on the card: one block, or a cluster of at most 8 whose
    blocks fit (:func:`assert_block_fits`), never a refusal. (Before the
    cluster kernel, 16368 went to a four-step entry, since retired, with
    329 KB of buffers, above a block's 227 KB.)"""
    ns = [n for n in smooth_31(lo, hi) if acq_kernel.has_radix_plan(n)]
    assert ns
    for n in ns:
        kernel, shape = acq_kernel.kernel_for(n)
        assert kernel in (acq_kernel.KERNEL, acq_kernel.CLUSTER_KERNEL), n
        cluster = 1 if kernel is acq_kernel.KERNEL else shape[3]
        assert cluster > 1 or len(shape) == 3
        assert_block_fits(n, tuple(shape[0]), cluster, shape[2])


def is_prime(n):
    return n > 1 and all(n % p for p in range(2, int(n ** 0.5) + 1))


# Non-prime n in each range: (31-smooth, a prime factor above 31 on a
# radix entry, on the Bluestein entry).
NON_PRIME_COUNTS = {(64, 8192): (1530, 2974, 2615),
                    (8193, 16384): (760, 2586, 3974),
                    (16385, 32768): (1068, 4528, 9176),
                    (32769, 65536): (1484, 7661, 20593)}


@pytest.mark.parametrize("lo, hi", sorted(NON_PRIME_COUNTS))
def test_every_non_prime_n_has_a_radix_entry(lo, hi):
    """Every code period in [64, 65536] that is not prime gets a kernel
    on the card, never a refusal: 4,842 n are 31-smooth and take an FFT
    kernel, one block or a cluster of at most 8 whose blocks fit
    (:func:`assert_block_fits`); 54,107 have a prime factor above 31,
    17,749 of them on the radix entries (their largest prime factor at
    most ``GENERIC_MAX_PRIME``, 233: generic passes) and 36,358 on the
    Bluestein entry (above it), 58,949 in all. Every prime raises
    ``ValueError``."""
    smooth = generic = bluestein = 0
    for n in range(lo, hi + 1):
        if is_prime(n):
            with pytest.raises(ValueError, match="factorisation"):
                acq_kernel.kernel_for(n)
            continue
        kernel, shape = acq_kernel.kernel_for(n)
        if kernel is acq_kernel.BLUESTEIN_KERNEL:
            assert acq_kernel.prime_factors(n)[-1] > \
                acq_kernel.GENERIC_MAX_PRIME, n
            assert shape == acq_kernel.bluestein_lengths(n)
            bluestein += 1
            continue
        assert kernel in (acq_kernel.KERNEL, acq_kernel.CLUSTER_KERNEL), n
        cluster = 1 if kernel is acq_kernel.KERNEL else shape[3]
        assert cluster > 1 or len(shape) == 3
        plan = tuple(shape[0])
        assert int(np.prod(plan)) == n
        assert max(plan) <= acq_kernel.GENERIC_MAX_PRIME
        assert_block_fits(n, plan, cluster, shape[2])
        if max(plan) > 31:
            generic += 1
        else:
            smooth += 1
    assert (smooth, generic, bluestein) == NON_PRIME_COUNTS[(lo, hi)]
    totals = np.sum(list(NON_PRIME_COUNTS.values()), axis=0)
    assert tuple(totals) == (4842, 17749, 36358)
    assert totals[1] + totals[2] == 54107 and totals.sum() == 58949


@pytest.mark.parametrize("n, cluster", [
    (12276, 2), (16368, 2), (20000, 2), (25000, 2), (20460, 4), (26000, 4),
    (30690, 4), (40000, 4), (50000, 4), (40920, 8), (65536, 8),
    (2500, 1), (10000, 1), (4092, 1), (8184, 1)])
def test_cluster_size_at_front_end_rates(n, cluster):
    """Code periods of front ends at 12.276 to 65.536 Msps: the smallest
    cluster whose blocks fit; the one-block shapes keep C = 1 and their
    thread counts."""
    assert acq_kernel.cluster_size(n) == cluster
    if cluster == 1:
        assert acq_kernel.fft_threads(n, None, 1) == acq_kernel.fft_threads(n)


@pytest.mark.parametrize("n, why", [
    (16381, r"N=16381 has no useful factorisation \(prime\?\)"),
    (65538, "BLUESTEIN_KERNEL"),          # 2 * 3^2 * 11 * 331
    (66000, "BLUESTEIN_KERNEL"),          # 2^4 * 3 * 5^3 * 11, prime radix
    (131072, "BLUESTEIN_KERNEL"),         # 2^17
    (1048578, "n=1048578: no K2 kernel on the card above 1048576 points")])
def test_kernel_for_refuses_n_without_entry(n, why):
    """An n that no kernel takes raises ValueError from ``kernel_for``,
    naming n and the limit, before any launch: a prime, in the JAX
    package's words, and an n above 2^20 (1048578 = 2 * 3 * 174763, the
    Bluestein entry's limit). The n that no cluster holds, which raised
    before the Bluestein entry, take it: a plan with a generic radix
    (65538, the first n above the clusters with a radix above 10: 8193
    points a block) or a prime radix (66000: 8250 points a block), or
    256 KB of buffers a block (2^17)."""
    if why == "BLUESTEIN_KERNEL":
        with pytest.raises(ValueError, match="more than 8 blocks"):
            acq_kernel.cluster_size(n)
        kernel, shape = acq_kernel.kernel_for(n)
        assert kernel is acq_kernel.BLUESTEIN_KERNEL
        assert shape == acq_kernel.bluestein_lengths(n) == (262144, 512, 512)
        return
    with pytest.raises(ValueError, match=why):
        acq_kernel.kernel_for(n)


# Lengths with prime factors above 31 (generic passes): 4070 = 2 * 5 *
# 11 * 37, 1517 = 37 * 41 and 3034 (radix-1 ends), 9722 = 2 * 4861, 16370
# = 2 * 5 * 1637, 26500 = 2^2 * 5^3 * 53, 65231 = 37 * 41 * 43.
GENERIC_N = (4070, 1517, 3034, 9722, 16370, 26500, 65231)


@pytest.mark.parametrize("n", SMOOTH_N + (90,) + PRIME_N + GENERIC_N)
def test_stockham_ifft_ref_matches_ifft(n):
    """The kernel's passes, strides and integer twiddle indices, walked in
    PyTorch, against torch.fft.ifft (unnormalised) on seeded inputs:
    within 1e-5 of the largest output."""
    rng = np.random.default_rng(n)
    x = torch.tensor(rng.normal(size=(3, n)) + 1j * rng.normal(size=(3, n)),
                     dtype=torch.complex64)
    tw = acq_kernel.twiddle_table(n, torch.device("cpu"))
    assert tw.dtype == torch.complex64 and tw.shape == (n,)
    assert acq_kernel.twiddle_table(n, torch.device("cpu")) is tw  # cached
    got = acq_kernel.stockham_ifft_ref(x, acq_kernel.radix_plan(n), tw)
    ref = torch.fft.ifft(x, norm="forward")
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


# Bluestein lengths: large prime factors (9722 = 2 * 4861, 16370 =
# 2 * 5 * 1637, 65498 = 2 * 32749), 1517 = 37 * 41, and front ends at 70
# and 122.88 Msps (70000 = 2^4 * 5^4 * 7, 122880 = 2^13 * 3 * 5).
BLUESTEIN_N = (1517, 9722, 16370, 65498, 70000, 122880)


@pytest.mark.parametrize("n", BLUESTEIN_N)
def test_bluestein_ifft_ref_matches_ifft(n):
    """The Bluestein entry's steps (chirp index, padding to M, the split
    M = M1 * M2 with its twiddle indices, the filter in its [k1, k2]
    order), walked in PyTorch, against torch.fft.ifft on seeded inputs:
    within 1e-5 of the largest output."""
    rng = np.random.default_rng(n)
    x = torch.tensor(rng.normal(size=(3, n)) + 1j * rng.normal(size=(3, n)),
                     dtype=torch.complex64)
    m, m1, m2 = acq_kernel.bluestein_lengths(n)
    assert m == 1 << (2 * n - 2).bit_length() and m // 2 < 2 * n - 1 <= m
    assert m1 * m2 == m and m1 <= m2 <= acq_kernel.BLUESTEIN_MAX_SUB
    filt = acq_kernel.bluestein_filter(n, torch.device("cpu"))
    assert filt.shape == (m1, m2) and filt.dtype == torch.complex64
    got = acq_kernel.bluestein_ifft_ref(x, n)
    ref = torch.fft.ifft(x)
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


@pytest.mark.parametrize("pairs, nc, m, chunk", [
    (808, 10, 1 << 18, 25),    # the 70 Msps session: 33 chunks
    (22, 2, 1 << 21, 16),      # 2^20 - 2 at 1 ch x 11 bins x 2 blocks
    (3, 1, 1 << 15, 3),        # fewer pairs than the cap holds
    (808, 32, 1 << 21, 1),     # one pair fills the cap exactly
    (808, 33, 1 << 21, 1),     # one pair passes the cap: still one
])
def test_bluestein_chunk_pairs_at_the_scratch_cap(pairs, nc, m, chunk):
    """Pairs a chunk of the Bluestein entry's scratch: as many as fit in
    :data:`BLUESTEIN_SCRATCH_BYTES`, at most ``pairs``, and at least one,
    whose nc x M x 8 bytes pass the cap from nc = 33 at M = 2^21."""
    cap = acq_kernel.BLUESTEIN_SCRATCH_BYTES
    assert cap == 512 << 20
    got = acq_kernel.bluestein_chunk_pairs(pairs, nc, m)
    assert got == chunk
    assert got * nc * m * 8 <= cap or got == 1
    assert (nc * m * 8 > cap) == (nc == 33)


def test_chirp_index_is_exact_at_large_j():
    """The chirp index ``j^2 mod 2n`` (the kernel takes j^2 in 64 bits)
    against Python's integers at j up to 2^20, where j^2 passes 2^32, for
    the largest n of the entry and two front ends; the table holds
    ``e^{i pi t / n}`` (float64 angles)."""
    for n in (1048574, 1048576, 245520, 70000):
        j = np.concatenate([np.arange(n - 4096, n), np.arange(65530, 65540),
                            np.arange(46340, 46345)])
        got = acq_kernel.chirp_index(torch.from_numpy(j), n).numpy()
        assert got.tolist() == [int(v) * int(v) % (2 * n) for v in j]
    table = acq_kernel.chirp_table(1517, torch.device("cpu")).numpy()
    t = np.arange(2 * 1517)
    np.testing.assert_allclose(table, np.exp(1j * np.pi * t / 1517),
                               atol=1e-7)


# A 70 Msps front end: n = 70000 = 2^4 * 5^4 * 7, above the clusters'
# 65,536 points, whose transform the card runs on the Bluestein entry;
# the JAX map factors it 250 x 280.
FS_70 = 70e6
N_70 = 70000


def test_acquire_matches_jax_at_70000_ksps():
    """The module's capture and bounds at 70 Msps, 1 channel, 61 bins,
    1 x 2 blocks: the port's ``acquire`` and a map built by the Bluestein
    entry's steps (``bluestein_bins_ref`` on the same spectra) against
    JAX's ``pcps_shift_map`` and ``peak_metric``, as at 16.368 Msps (5e-3
    of the map's maximum: the JAX map's matmul DFT)."""
    coher, noncoh = 1, 2
    assert mmfft._balanced_factors(N_70) == (250, 280)
    assert acq_kernel.kernel_for(N_70)[0] is acq_kernel.BLUESTEIN_KERNEL
    gen = IQGenerator(FS_70, noise=True, seed=5)
    gen.add_satellite(17, doppler_hz=-2360.0, code_phase_chips=77.7,
                      cn0_dbhz=45.0)
    iq = gen.generate_ms(coher * noncoh)
    iq_re, iq_im = np.float32(iq.real)[None], np.float32(iq.imag)[None]
    k = jacq.code_fft_conj(17, FS_70)[None]
    bins = jacq.doppler_bins(3000, 100)
    phases, bin_shifts = jacq.shift_plan(bins, FS_70, N_70, mode="shift")
    ref = np.asarray(jacq.pcps_shift_map(
        jnp.asarray(iq_re), jnp.asarray(iq_im),
        jnp.asarray(np.float32(k.real)), jnp.asarray(np.float32(k.imag)),
        mmfft.make_plan(N_70), mmfft.make_plan(N_70, inverse=True),
        sampling_frequency=FS_70, coherent=coher, non_coherent=noncoh,
        phases=phases, bin_shifts=bin_shifts))
    dop, ci, metric, got = tacq.acquire(
        (torch.from_numpy(iq_re), torch.from_numpy(iq_im)), k, bins,
        sampling_frequency=FS_70, coherent=coher, non_coherent=noncoh)
    got = got.numpy()
    assert got.shape == ref.shape == (1, 61, N_70)
    assert (np.abs(got - ref) / np.abs(ref).max()).max() < 5e-3
    spectra = tacq.phase_spectra(
        torch.from_numpy(iq_re), torch.from_numpy(iq_im), n=N_70,
        sampling_frequency=FS_70, coherent=coher, non_coherent=noncoh,
        phases=phases)
    walk = acq_kernel.bluestein_bins_ref(
        spectra, torch.from_numpy(k).to(torch.complex64), bin_shifts).numpy()
    assert (np.abs(walk - ref) / np.abs(ref).max()).max() < 5e-3
    spc = round(FS_70 / 1.023e6)
    d_r, c_r, m_r = jacq.peak_metric(jnp.asarray(ref), jnp.asarray(bins),
                                     samples_per_chip=spc)
    assert float(d_r[0]) == float(dop[0])
    assert abs(float(dop[0]) + 2360.0) <= 100.0
    assert int(c_r[0]) == int(ci[0])
    assert abs(float(m_r[0]) - float(metric[0])) < 0.05
    d_w, c_w, m_w = tacq.peak_metric(torch.from_numpy(walk),
                                     torch.from_numpy(bins),
                                     samples_per_chip=spc)
    assert float(d_w[0]) == float(d_r[0]) and int(c_w[0]) == int(c_r[0])
    assert abs(float(m_w[0]) - float(m_r[0])) < 0.05


@functools.lru_cache(maxsize=1)
def prime_sieve(limit=(1 << 20) + 8):
    """``sieve[n]``: whether n is prime, for n up to ``limit`` (numpy,
    once per module)."""
    sieve = np.ones(limit + 1, dtype=bool)
    sieve[:2] = False
    for p in range(2, int(limit ** 0.5) + 1):
        if sieve[p]:
            sieve[p * p::p] = False
    return sieve


# n above 65536 by range (every n in the first two, every 7th n from
# 262145 in the third): (radix entry, Bluestein entry, primes). The
# radix entries keep the 38 5-smooth n whose cluster of 8 fits (65610 to
# 115200); every other n that is not prime has the Bluestein entry:
# 59,827 + 120,323 non-prime n in (65536, 262144].
ABOVE_COUNTS = {(65537, 131072, 1): (38, 59789, 5709),
                (131073, 262144, 1): (0, 120323, 10749),
                (262145, 1048576, 7): (0, 102525, 9823)}


@pytest.mark.parametrize("lo, hi, step", sorted(ABOVE_COUNTS))
def test_every_non_prime_n_above_65536_has_an_entry(lo, hi, step):
    """Every n in (65536, 262144] and every 7th n in (262144, 2^20]
    that is not prime has a K2 entry on the card: a radix entry whose
    block or cluster of 8 fits (:func:`assert_block_fits`), or the
    Bluestein entry with M the least power of two >= 2n - 1 and M = M1 *
    M2, M1 <= M2 <= 2048. Every prime raises ``ValueError``, as JAX's
    ``_balanced_factors`` does."""
    sieve = prime_sieve()
    radix = bluestein = primes = 0
    for n in range(lo, hi + 1, step):
        if sieve[n]:
            with pytest.raises(ValueError, match=f"N={n} has no useful "
                                                 "factorisation"):
                acq_kernel.kernel_for(n)
            with pytest.raises(ValueError, match="no useful factorisation"):
                mmfft._balanced_factors(n)
            primes += 1
            continue
        kernel, shape = acq_kernel.kernel_for(n)
        if kernel is acq_kernel.BLUESTEIN_KERNEL:
            m, m1, m2 = shape
            assert m & (m - 1) == 0 and m // 2 < 2 * n - 1 <= m, n
            assert m1 * m2 == m and m1 <= m2 <= 2048, n
            bluestein += 1
            continue
        assert kernel is acq_kernel.CLUSTER_KERNEL, n
        plan = tuple(shape[0])
        assert int(np.prod(plan)) == n and max(plan) <= 10, n
        assert_block_fits(n, plan, shape[3], shape[2])
        radix += 1
    assert (radix, bluestein, primes) == ABOVE_COUNTS[(lo, hi, step)]
