"""Port's PCPS acquisition (K2 ``pcps_bins`` plain version on CPU) against
the JAX shift-theorem map and its fused Pallas kernel (interpret mode).

Shape and bounds of tests/test_acquisition.py::test_fused_map_matches_shift_map:
the map within 5e-3 of its maximum (the JAX fused kernel's bf16 budget;
the port's complex64 FFT sits far inside it), the same Doppler bin and
code index, and a two-peak metric within 0.05.
"""

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


SMOOTH_N = (2048, 2500, 4000, 5000, 10000)
# Code periods of front ends clocked at a multiple of 1.023 MHz
# (1023 = 3 * 11 * 31), and one length for each other prime radix.
PRIME_N = (1023, 2046, 4092, 8184, 7 * 13 * 20, 17 * 19 * 6, 23 * 29 * 4)
PRIME_RADICES = {7, 11, 13, 17, 19, 23, 29, 31}


@pytest.mark.parametrize("n", SMOOTH_N + PRIME_N)
def test_radix_plan_multiplies_to_n(n):
    """The FFT kernel's plan: radices it has butterflies for (10 = 2 x 5
    in registers, the odd primes 7 to 31), product n, and a block whose
    threads hold the last pass's outputs: floor(21 / r) butterflies of the
    last radix r without a prime radix (at most 20 points), floor(32 / r)
    in at most 512 threads with one."""
    plan = acq_kernel.radix_plan(n)
    assert set(plan) <= {2, 3, 4, 5, 10} | PRIME_RADICES and len(plan) >= 2
    assert int(np.prod(plan)) == n
    assert acq_kernel.has_radix_plan(n)
    threads = acq_kernel.fft_threads(n)
    prime = bool(set(plan) & PRIME_RADICES)
    assert prime == (n in PRIME_N)
    assert threads % 32 == 0 and 128 <= threads <= (512 if prime else 1024)
    acc = 32 if prime else 21
    assert n // plan[-1] <= (acc // plan[-1]) * threads
    if prime:   # the largest prime radix leads, the others close the plan
        wide = sorted((r for r in plan if r in PRIME_RADICES), reverse=True)
        assert plan[0] == wide[0]
        assert list(plan[len(plan) - len(wide) + 1:]) == wide[1:]


def test_radix_plan_refused_for_large_prime_factors():
    """n = 4070 = 2 * 5 * 11 * 37 has a prime factor above the largest
    radix, 31: no plan, so it goes to the four-step kernel, chosen from n
    alone; so does a prime radix above n = 8192. n = 7 has one pass only.
    n = 4092 = 2^2 * 3 * 11 * 31 (4.092 Msps) has a plan and goes to the
    FFT kernel."""
    for n in (4070, 37, 2 * 1013):
        with pytest.raises(ValueError, match="prime factor above 31"):
            acq_kernel.radix_plan(n)
        assert not acq_kernel.has_radix_plan(n)
    with pytest.raises(ValueError, match="two passes"):
        acq_kernel.radix_plan(7)
    with pytest.raises(ValueError, match="ends at n=8192"):
        acq_kernel.radix_plan(10230)
    assert not acq_kernel.has_radix_plan(7)
    assert not acq_kernel.has_radix_plan(10230)
    assert acq_kernel.radix_plan(2500) == (10, 10, 5, 5)
    assert acq_kernel.radix_plan(10000) == (10, 10, 10, 10)
    assert acq_kernel.radix_plan(4092) == (31, 4, 3, 11)
    assert acq_kernel.radix_plan(1023) == (31, 3, 11)


@pytest.mark.parametrize("n, kernel", [
    (4092, "KERNEL"), (2046, "KERNEL"), (2500, "KERNEL"),
    (4070, "FOURSTEP_KERNEL"), (10230, "FOURSTEP_KERNEL")])
def test_kernel_choice_from_n(n, kernel):
    """``pcps_bins_launch_args`` picks the entry from n alone
    (``kernel_for``): the FFT kernel with its plan where n has one, else
    the four-step kernel with its balanced factors."""
    got, shape = acq_kernel.kernel_for(n)
    assert got is getattr(acq_kernel, kernel)
    if kernel == "FOURSTEP_KERNEL":
        assert shape == acq_kernel.balanced_factors(n)
        assert shape[0] * shape[1] == n
    else:
        plan = acq_kernel.radix_plan(n)
        assert list(shape[0]) == list(plan) and shape[1] == len(plan)
        assert shape[2] == acq_kernel.fft_threads(n)


@pytest.mark.parametrize("n", SMOOTH_N + (90,) + PRIME_N)
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
