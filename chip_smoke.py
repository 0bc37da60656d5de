#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``sydr_tpu_torch``) on one GPU.

Usage, from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, each failing the run (non-zero exit) at its first fault, each
printing its wall time:

1. versions, the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``sydr_tpu_torch/csrc`` with ``nvcc``, one
   process per source, all at once;
3. each kernel against its plain PyTorch version on the card, at the shapes
   the receiver gives it, with its error bound: K1 ``epoch_correlate``, K2
   ``pcps_bins`` (the radix FFT, at n = 4092 through its prime radices 31
   and 11, and the four-step entry at n = 4070 = 2 * 5 * 11 * 37), K3
   ``block_cumsum_streams`` (with its two launches timed apart, the time
   of a kernel that only makes its stores, and a second run that must be
   bit-identical). Each case prints four times and a bound:
   ``ms``, the device time of the launch alone (:func:`device_ms`: the C
   entry point called in a tight loop from arguments prepared once, the
   launches queued behind a spinning kernel so that the CUDA events around
   them see the device's time, not the host's); ``call_ms``, the time
   through the Python wrapper as the receiver pays it; ``plain_ms``, the
   plain version; ``library_ms``, for K2, ``torch.fft.ifft`` alone over the
   pre-made product (the part of K2 that one PyTorch call computes; the
   port never calls it); and ``bound_ms``, the least time the card could
   take (:func:`roofline`). An empty kernel is timed the same way: the
   floor the microsecond-scale kernels are read against;
4. the production parity gate: 4 closed-loop blocks against the committed
   CPU truth ``tools/parity_truth.npz`` (read with numpy), in both boundary
   forms of pass B (K1 row sums, K3 prefix);
5. the receiver's device path: a 32-channel ``TrackingSession`` on 3 s of
   a synthetic 10 Msps capture (12 visible satellites at 45 dB-Hz, 20
   absent PRNs), decimate 4, kaplan pull-in at 5 ms blocks, promotion to
   the narrow-only cruise at 20 ms blocks x 50-block superblocks, quantised
   taps; acquisition, promotion, bit sync, carrier error and the kernels'
   launch counts are checked;
6. the receiver through its CLI, in process: ``sydr_tpu_torch.main.main``
   on the demo sky at the bench's input rate (10 Msps, decimate 4,
   quantised taps, 16 s): a position fix within 10 m of truth (K1 + K2);
7. the receiver at full width on the prefix form (K3 + K2): 16 s of the
   demo sky written to an int8 IQ file (by a child process, during phase
   6) and read back through ``RFFileSource``, 32 channels (6 visible),
   ``use_pallas=True, boundary_mode="prefix"`` in both loop shapes:
   acquisition against the scenario's truth, promotion, TOW, fixes within
   10 m, absent PRNs idle, and no K1 launch;
8. a session at 4.092 Msps (n = 4092 = 2^2 * 3 * 11 * 31): 8 channels,
   300 ms; acquisition must go through K2's FFT entry (radices 31, 4, 3,
   11) and find the visible satellites;
9. the same at 4.070 Msps (n = 4070 = 2 * 5 * 11 * 37, no radix plan):
   acquisition must go through K2's four-step entry;
10. the per-ms scan runtime at full width: phase 5's capture (its first
    2 s) through a 32-channel ``TrackingSession`` with ``runtime="scan"``,
    borre loops, 20 ms blocks: acquisition through K2, bit sync and the
    5 Hz carrier bound on the visible channels, no K1 or K3 launch; its
    real-time factor is printed, and ``torch.profiler`` over one more block
    counts its kernel launches per epoch and the device's busy share;
11. a serial-search session: 8 channels at 2.5 Msps, 4 visible at
    50 dB-Hz (one code period is all a serial search integrates),
    ``AcquisitionConfig(method="serial")`` on 250 Hz bins, 300 ms: the
    visible satellites within one Doppler bin and one chip, and no K2
    launch; one PRN's search is then timed apart (the host's shift-matrix
    build, its upload, the search on the card);
12. the direct PCPS map: phase 5's capture with ``doppler_step=130`` (77
    bins on 77 phases: no shift plan), where ``acquire`` must take
    ``pcps_map`` and launch no K2, the satellites within one bin; then
    ``pcps_map`` against ``pcps_shift_map`` (K2) on the same 50 ms at the
    production grid (step 100), within 1e-4 of the map's maximum;
13. checkpoint and resume (run right after phase 7, while its IQ file
    exists): a 6-channel ``Receiver`` on that file runs to a block
    boundary after promotion, saves, and continues; a
    fresh ``Receiver`` loads the checkpoint, is promoted without running
    pull-in, and continues on the same samples: integer outputs equal and
    the carrier within 1 Hz (the kernels sum in one fixed order, so the
    phase also prints whether the two runs were bit-identical). Then the
    CLI in process with ``--runtime scan --checkpoint-every``, which must
    leave a ``.ckpt.npz`` that a receiver of the demo's configuration
    loads.

Each of phases 5-13 sets every kernel's launch count to 0 just before it
and reads the counts just after. The last three lines are the kernels'
JSON record, the ``nvidia-smi`` line and ``{"ok": true, "device":
{...}}``. Without a CUDA device the script exits non-zero before printing
any result. It imports no JAX.

``python3 chip_smoke.py --kernels`` stops after phase 3 (a developer's
quick check of the kernels; it prints no final result line).
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import multiprocessing
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016
CARD_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader"]

# The receiver's production shapes (sydr_tpu/main.py and bench.py).
FS_IN = 10e6
DECIMATE = 4
N_CHANNELS = 32
N_VISIBLE = 12
CN0_DBHZ = 45.0
SIGNAL_MS = 3000
CRUISE_SUPERBLOCK = 50
# The demo sky (sydr_tpu_torch/main.py's --demo) for phases 6 and 7.
RX_MS = 16000
DEMO_T0, DEMO_WEEK = 302400.0, 2190
FIX_BOUND_M = 10.0   # 2.5 Msps code noise + a few seconds of Hatch filter
# The scan-runtime session: the first 2 s of the session's capture.
SCAN_SIGNAL_MS = 2000
# The serial search integrates one code period: 50 dB-Hz and 250 Hz bins
# (as tests/test_serial_search.py; one millisecond's Doppler lobe is 1 kHz
# wide, so with finer bins the second peak, taken outside a 3 x 3 box, is
# the main lobe itself). Its two-peak power metric reads about 2 on a
# satellite and up to ~1.6 on noise, so the threshold sits between; its
# code phase comes in chips, so the index is held to one chip (2.44
# samples at 2.5 Msps) plus the rounding.
SERIAL_CN0_DBHZ = 50.0
SERIAL_DOPPLER_STEP = 250.0
SERIAL_THRESHOLD = 1.8
SERIAL_CODE_INDEX_TOL = 3

# The card's published peaks (NVIDIA H100 SXM data sheet): device memory
# rate and the float32 rate outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# Operations counted per sample and channel of the correlation streams:
# the carrier phase (one multiply-add), sincosf (two short polynomials
# after the range reduction, ~20) and the complex mix (6); per tap the
# chip index (add, multiply-add, ceil) and two multiply-adds.
STREAM_MIX_FLOPS = 28
STREAM_TAP_FLOPS = 8

# Kernel-vs-plain bounds. K1: identical chips (same rounding of the index
# arithmetic), sums in another order: 1e-2 + 1e-4 of the largest correlator.
# K2: a float32 FFT (or the direct-summation four-step DFT) against cuFFT,
# both float32: 1e-4 of the map's maximum.
# K3: the same per-sample values as K1, scanned in another order than
# torch.cumsum: the raw prefix within 4 * sqrt(n_win) * 2^-24 of its largest
# magnitude (a random walk of float32 roundings, four sigma); the epoch
# correlators picked from it within K1's bound.
K1_ATOL, K1_RTOL = 1e-2, 1e-4
K2_RTOL = 1e-4
K3_PREFIX_SIGMAS = 4.0


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    proc = subprocess.run(CARD_QUERY, capture_output=True, text=True)
    check(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` between CUDA events, after
    two warm-up calls: the time a caller pays, host work included."""
    import torch

    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


_SPIN_CYCLES_PER_MS: list[float] = []


def spin_cycles_per_ms() -> float:
    """Cycles of ``torch.cuda._sleep`` per millisecond, measured once."""
    import torch

    if not _SPIN_CYCLES_PER_MS:
        cycles = 20_000_000
        torch.cuda._sleep(cycles)
        _SPIN_CYCLES_PER_MS.append(
            cycles / cuda_ms(lambda: torch.cuda._sleep(cycles), 2))
    return _SPIN_CYCLES_PER_MS[0]


def device_ms(launch, reps: int) -> float:
    """Mean device milliseconds per ``launch()``, a C entry point called
    with arguments prepared once (it must return 0).

    The ``reps`` launches are queued behind a spinning kernel that lasts
    longer than the host needs to enqueue them, so the events around them
    see the kernels back to back on the device and no host time. The spin
    is doubled until the host was indeed done first.
    """
    import torch

    def run():
        if launch() != 0:
            fail("a kernel launch returned a CUDA error while timing")

    for _ in range(3):
        run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        run()
    spin_ms = 2e3 * (time.perf_counter() - t0) + 0.5
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda._sleep(int(spin_ms * spin_cycles_per_ms()))
        start.record()
        for _ in range(reps):
            run()
        stop.record()
        host_ms = 1e3 * (time.perf_counter() - t0)
        torch.cuda.synchronize()
        if host_ms < spin_ms:
            return start.elapsed_time(stop) / reps
        spin_ms = 2.0 * host_ms
    fail(f"device_ms: the host never enqueued {reps} launches within the "
         f"spin ({spin_ms:.1f} ms)")


def roofline(n_bytes: float, flops: float) -> dict:
    """The least time the card could take: each input byte read once and
    each output byte written once at the memory rate, or the operations
    at the float32 rate, whichever is larger."""
    bytes_ms = 1e3 * n_bytes / PEAK_BYTES_PER_S
    flops_ms = 1e3 * flops / PEAK_F32_FLOPS
    return {"bound_ms": max(bytes_ms, flops_ms),
            "bound_by": "bytes" if bytes_ms >= flops_ms else "operations"}


def tensor_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def report(kind: str, name: str, shape, err_text: str, res: dict) -> None:
    lib = res["library_ms"]
    out = f"out {tuple(shape)} " if shape else ""
    print(f"{kind} {name}: {out}{err_text} | device "
          f"{res['ms']:.4f} ms, call {res['call_ms']:.4f} ms, plain "
          f"{res['plain_ms']:.4f} ms, library "
          f"{'none' if lib is None else f'{lib:.4f} ms'}, bound "
          f"{res['bound_ms']:.4f} ms ({res['bound_by']})", flush=True)


# ---------------------------------------------------------------------------
# Kernel checks
# ---------------------------------------------------------------------------

def random_block(fs, block_ms, profile, quantize, device, rng):
    """A random 32-channel tracking state and window: the K1 arguments."""
    import torch

    from sydr_tpu_torch.channels import batch_runtime as br
    from sydr_tpu_torch.channels.runtime import TrackingConfig
    from sydr_tpu_torch.channels.state import MODE_TRACKING, init_state

    cfg = TrackingConfig(
        sampling_frequency=fs, block_ms=block_ms, tail_ms=4,
        window_size=round(fs * 1e-3) + 256, runtime="batch",
        profile="kaplan", kaplan_narrow_only=profile == "narrow",
        quantize_spacing=quantize)
    spms, n = cfg.samples_per_ms, N_CHANNELS

    def dev(x, dtype):
        return torch.tensor(np.asarray(x, dtype=dtype), device=device)

    st = dataclasses.replace(
        init_state(n, device),
        mode=torch.full((n,), MODE_TRACKING, dtype=torch.int32,
                        device=device),
        carrier_freq=dev(rng.uniform(-4000, 4000, n), np.float32),
        rem_code=dev(rng.uniform(0, 1, n), np.float32),
        rem_carrier=dev(rng.uniform(0, 2 * np.pi, n), np.float32),
        code_freq_offset=dev(rng.uniform(-2, 2, n), np.float32),
        unread=dev(spms + rng.integers(spms // 20, spms // 2, n), np.int32))
    wre = dev(rng.normal(0, 2, cfg.window_samples), np.float32)
    wim = dev(rng.normal(0, 2, cfg.window_samples), np.float32)
    bits = dev(br.tiled_code_bits(list(range(1, n + 1))), np.float32)
    geo = br._pass_a_closed(cfg, st)
    bg = br.block_geometry(cfg, st, geo)
    return (wre, wim, bits, bg["c_int"], geo["omega"], geo["code_step"],
            bg["fb_q"].contiguous(), bg["phic_q"].contiguous(),
            br.epoch_bounds(cfg, geo, bg["base"]), br.taps_for(cfg), spms)


def stream_flops(n_samples: int, n_taps: int) -> float:
    """Operations of the correlation streams over ``n_samples`` (sample,
    channel) pairs."""
    return float(n_samples) * (STREAM_MIX_FLOPS + STREAM_TAP_FLOPS * n_taps)


def k1_case(name, fs, block_ms, profile, quantize, device, rng):
    """Kernel vs plain ``epoch_correlate`` on a random tracking state."""
    import torch

    from sydr_tpu_torch.ops import correlator_kernel as ck

    args = random_block(fs, block_ms, profile, quantize, device, rng)
    bounds, taps, spms = args[8], args[9], args[10]
    got = ck.epoch_correlate(*args)
    ref = ck.epoch_correlate_ref(*args)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    bound = K1_ATOL + K1_RTOL * float(ref.abs().max())
    out, cargs = ck.epoch_correlate_launch_args(*args)
    fn = ck.KERNEL.function()
    # The work this state needs: the samples inside the epochs' bounds.
    n_samples = int((bounds[-1] - bounds[0]).sum())
    wpe, epb = ck.launch_shape(bounds.shape[0] - 1, N_CHANNELS, spms)
    res = {"max_abs_err": err,
           "ms": device_ms(lambda: fn(*cargs), 200),
           "call_ms": cuda_ms(lambda: ck.epoch_correlate(*args), 50),
           "plain_ms": cuda_ms(lambda: ck.epoch_correlate_ref(*args), 5),
           "library_ms": None,
           **roofline(tensor_bytes(*args[:9], out),
                      stream_flops(n_samples, len(taps)))}
    report("K1", name, got.shape,
           f"max_abs_err {err:.3e} (bound {bound:.3e}), {n_samples} "
           f"samples, grid ({-(-(bounds.shape[0] - 1) // epb)}, "
           f"{N_CHANNELS}) x {32 * wpe * epb} threads ({epb} epochs x "
           f"{wpe} warps)", res)
    check(bool(torch.isfinite(got).all()), f"K1 {name}: non-finite output")
    check(err <= bound, f"K1 {name}: error {err} above bound {bound}")
    return res


def k3_case(name, fs, block_ms, profile, device, rng):
    """Kernel vs plain ``block_cumsum_streams`` on a random tracking state
    with quantised taps: the raw prefix, and the epoch correlators picked
    from each (``batch_runtime.prefix_epoch_sums``)."""
    import torch

    from sydr_tpu_torch.channels import batch_runtime as br
    from sydr_tpu_torch.ops import correlator_kernel as ck

    args = random_block(fs, block_ms, profile, True, device, rng)
    bounds = args[8]
    k3 = args[:8] + args[9:]
    got = ck.block_cumsum_streams(*k3)
    ref = ck.block_cumsum_streams_ref(*k3)
    torch.cuda.synchronize()
    n_ch, n_streams, n_win = ref.shape
    err = float((got - ref).abs().max())
    bound = K3_PREFIX_SIGMAS * n_win ** 0.5 * 2.0 ** -24 \
        * float(ref.abs().max())
    corr, corr_ref = (br.prefix_epoch_sums(p, bounds) for p in (got, ref))
    corr_err = float((corr - corr_ref).abs().max())
    corr_bound = K1_ATOL + K1_RTOL * float(corr_ref.abs().max())
    again = ck.block_cumsum_streams(*k3)
    check(bool(torch.equal(got, again)),
          f"K3 {name}: two launches on the same inputs differ")
    out, cargs, totals = ck.block_cumsum_streams_launch_args(*k3)
    fn = ck.CUMSUM_KERNEL.function()
    check(fn(*cargs) == 0, f"K3 {name}: launch failed")
    # The two launches apart (the second reads the first's totals), and a
    # kernel that only makes K3's stores.
    parts = []
    for launches in (1, 2):
        _, pargs, part_totals = ck.block_cumsum_streams_launch_args(
            *k3, launches=launches)
        part_totals.copy_(totals)
        parts.append(device_ms(lambda: fn(*pargs), 100))
    seg_chunks, n_seg = ck.cumsum_shape(n_win, n_ch)
    ceiling = ck.STORE_CEILING.function()
    ceiling_args = (n_ch, n_streams, n_win, seg_chunks, n_seg,
                    out.data_ptr(), cargs[-1])
    store_ms = device_ms(lambda: ceiling(*ceiling_args), 100)
    res = {"max_abs_err": err,
           "ms": device_ms(lambda: fn(*cargs), 100),
           "call_ms": cuda_ms(lambda: ck.block_cumsum_streams(*k3), 20),
           "plain_ms": cuda_ms(lambda: ck.block_cumsum_streams_ref(*k3), 3),
           "library_ms": None,
           **roofline(tensor_bytes(*args[:8], out),
                      stream_flops(n_ch * n_win, n_streams // 2)
                      + float(n_ch * n_streams * n_win))}
    report("K3", name, got.shape,
           f"({got.numel() * 4 / 1e6:.1f} MB) prefix max_abs_err {err:.3e} "
           f"(bound {bound:.3e}, max|prefix| {float(ref.abs().max()):.1f}) "
           f"epoch correlators max_abs_err {corr_err:.3e} (bound "
           f"{corr_bound:.3e}), grid ({n_seg}, {n_ch}) x 256 threads, "
           f"segments of {seg_chunks} x {ck.CUMSUM_CHUNK} samples, totals "
           f"launch {parts[0]:.4f} ms, prefix launch {parts[1]:.4f} ms, "
           f"stores alone {store_ms:.4f} ms, second run bit-identical", res)
    check(bool(torch.isfinite(got).all()), f"K3 {name}: non-finite output")
    check(err <= bound, f"K3 {name}: prefix error {err} above {bound}")
    check(corr_err <= corr_bound,
          f"K3 {name}: correlator error {corr_err} above {corr_bound}")
    return res


def ifft_library_ms(spectra, code_k, bin_shifts) -> float:
    """``torch.fft.ifft`` alone over the pre-made product ``[n_bins, n_ch,
    nc, n]`` complex64: the part of K2 that one PyTorch call computes."""
    import torch

    n_ph, n_ch, nc, n = spectra.shape
    prod = torch.empty((len(bin_shifts), n_ch, nc, n), dtype=torch.complex64,
                       device=spectra.device)
    for b, (k, p) in enumerate(bin_shifts):
        torch.mul(spectra[p], torch.roll(code_k, k, dims=-1)[:, None, :],
                  out=prod[b])
    ms = cuda_ms(lambda: torch.fft.ifft(prod, dim=-1), 5)
    print(f"   library yardstick: torch.fft.ifft over {tuple(prod.shape)} "
          f"complex64 ({tensor_bytes(prod) / 1e6:.0f} MB): {ms:.4f} ms",
          flush=True)
    return ms


def k2_case(name, fs, n_ch, entry, device, rng):
    """Kernel vs plain ``pcps_bins`` on the acquisition's spectra of a
    noise capture, with the receiver's 101-bin shift plan; ``entry`` names
    the kernel that the wrapper must pick for this ``n``."""
    import torch

    from sydr_tpu_torch.ops import acq_kernel
    from sydr_tpu_torch.ops import acquisition as acq

    n = round(fs * 1e-3)
    coherent, non_coherent = 5, 10
    bins = acq.doppler_bins(5000.0, 100.0)
    phases, bin_shifts = acq.shift_plan(bins, fs, n)
    iq = rng.normal(0, 2, (2, n_ch, coherent * non_coherent * n))
    spectra = acq.phase_spectra(
        torch.tensor(iq[0], dtype=torch.float32, device=device),
        torch.tensor(iq[1], dtype=torch.float32, device=device),
        n=n, sampling_frequency=fs, coherent=coherent,
        non_coherent=non_coherent, phases=phases)
    code_k = torch.tensor(
        np.stack([acq.code_fft_conj(p, fs) for p in range(1, n_ch + 1)]),
        dtype=torch.complex64, device=device)
    before = read_launches()
    got = acq_kernel.pcps_bins(spectra, code_k, bin_shifts)
    launched = {k: v - before[k] for k, v in read_launches().items() if
                v != before[k]}
    check(launched == {entry: 1},
          f"K2 {name}: the wrapper launched {launched}, expected {entry}")
    ref = acq_kernel.pcps_bins_ref(spectra, code_k, bin_shifts)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    bound = K2_RTOL * float(ref.abs().max())
    kernel, out, cargs = acq_kernel.pcps_bins_launch_args(
        spectra, code_k, bin_shifts)
    fn = kernel.function()
    n_transforms = n_ch * len(bin_shifts) * non_coherent
    flops = n_transforms * (5.0 * n * np.log2(n) + 10.0 * n)
    res = {"max_abs_err": err,
           "ms": device_ms(lambda: fn(*cargs), 10),
           "call_ms": cuda_ms(
               lambda: acq_kernel.pcps_bins(spectra, code_k, bin_shifts), 5),
           "plain_ms": cuda_ms(
               lambda: acq_kernel.pcps_bins_ref(spectra, code_k, bin_shifts),
               5),
           "library_ms": ifft_library_ms(spectra, code_k, bin_shifts),
           **roofline(tensor_bytes(spectra, code_k, out) + 8 * n
                      + 8 * len(bin_shifts), flops)}
    report("K2", f"[{entry}] {name}", got.shape,
           f"max_abs_err {err:.3e} (bound {bound:.3e}, "
           f"{err / float(ref.abs().max()):.2e} of the map's maximum)", res)
    check(bool(torch.isfinite(got).all()), f"K2 {name}: non-finite output")
    check(err <= bound, f"K2 {name}: error {err} above bound {bound}")
    return res


def empty_launch_ms() -> float:
    """Device time per launch of an empty kernel, timed as the kernels'
    ``ms`` is (:func:`device_ms`)."""
    import torch

    from sydr_tpu_torch.ops import native

    fn = native.EMPTY_LAUNCH.function()
    stream = native.stream_of(torch.empty(1, device="cuda"))
    ms = device_ms(lambda: fn(stream), 500)
    print(f"empty launch: device {ms:.5f} ms per launch (the floor of a "
          f"microsecond-scale kernel's device time)", flush=True)
    return ms


def kernel_phase(device) -> dict:
    """Every kernel against its plain version; per kernel name, per case,
    the numbers of the JSON record."""
    rng = np.random.default_rng(SEED)
    empty_launch_ms()
    k1 = {name: k1_case(name, fs, bm, prof, quant, device, rng)
          for name, fs, bm, prof, quant in (
              ("cruise 2.5 Msps 20 ms 6 streams", 2.5e6, 20, "narrow", True),
              ("pull-in 2.5 Msps 5 ms 10 streams", 2.5e6, 5, "kaplan", True),
              ("full-rate 10 Msps 20 ms 6 streams", 10e6, 20, "narrow",
               True),
              ("full-rate 10 Msps 20 ms 10 streams, plain taps", 10e6, 20,
               "kaplan", False))}
    k2 = {name: k2_case(name, fs, n_ch, "pcps_bins", device, rng)
          for name, fs, n_ch in (
              ("session 32 ch n=2500", 2.5e6, 32),
              ("bench 12 ch n=10000", 10e6, 12))}
    k2.update({name: k2_case(name, fs, n_ch, "pcps_bins", device, rng)
               for name, fs, n_ch in (("8 ch n=4092", 4.092e6, 8),)})
    k2f = {name: k2_case(name, fs, n_ch, "pcps_bins_fourstep", device, rng)
           for name, fs, n_ch in (("8 ch n=4070", 4.070e6, 8),)}
    k3 = {name: k3_case(name, fs, bm, prof, device, rng)
          for name, fs, bm, prof in (
              ("cruise 2.5 Msps 20 ms 6 streams", 2.5e6, 20, "narrow"),
              ("pull-in 2.5 Msps 5 ms 10 streams", 2.5e6, 5, "kaplan"),
              ("full-rate 10 Msps 20 ms 6 streams", 10e6, 20, "narrow"))}
    return {"epoch_correlate": k1, "pcps_bins": k2,
            "pcps_bins_fourstep": k2f, "block_cumsum_streams": k3}


# ---------------------------------------------------------------------------
# Parity gate
# ---------------------------------------------------------------------------

def parity_phase(device) -> None:
    from sydr_tpu_torch import parity

    truth = np.load(os.path.join(REPO, "tools", "parity_truth.npz"),
                    allow_pickle=False)["superblock"]
    b = parity.PARITY_BOUNDS
    for mode in ("rowsum", "prefix"):
        res = parity.production_parity(truth, device, mode)
        print(f"parity [{mode}] parity_metric {res['parity_metric']:.4f} "
              f"(<= {b['parity_metric']}) parity_scaled "
              f"{res['parity_scaled']:.4f} (<= {b['parity_scaled']}) "
              f"prompt_ratio {res['prompt_ratio']:.4f} "
              f"(in {list(b['prompt_ratio'])})", flush=True)
        check(res["parity_ok"], f"parity gate [{mode}] failed: {res}")


# ---------------------------------------------------------------------------
# The slice end to end
# ---------------------------------------------------------------------------

def make_scenario(rng, signal_ms, fs_in, n_channels, n_visible,
                  cn0_dbhz=CN0_DBHZ):
    """Visible satellites (PRN, Doppler, code phase) and the capture."""
    from sydr_tpu_torch.signal.synthetic import IQGenerator

    prns = sorted(rng.choice(np.arange(1, n_channels + 1), n_visible,
                             replace=False).tolist())
    dopplers = np.linspace(-4000.0, 4000.0, n_visible) \
        + rng.uniform(-40.0, 40.0, n_visible)
    rng.shuffle(dopplers)
    sats = [dict(prn=p, doppler=float(d), code_phase=float(c))
            for p, d, c in zip(prns, dopplers,
                               rng.uniform(0.0, 1023.0, n_visible))]
    gen = IQGenerator(fs_in, noise=True, seed=int(rng.integers(1 << 31)))
    for s in sats:
        gen.add_satellite(s["prn"], doppler_hz=s["doppler"],
                          code_phase_chips=s["code_phase"],
                          cn0_dbhz=cn0_dbhz,
                          nav_bits=rng.integers(0, 2, 300))
    t0 = time.perf_counter()
    iq = gen.generate_ms(signal_ms)
    print(f"capture: {signal_ms} ms at {fs_in / 1e6:g} Msps, "
          f"{n_visible} satellites at {cn0_dbhz:g} dB-Hz, made in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return sats, np.float32(iq.real), np.float32(iq.imag)


def session_configs(fs_in, superblock, runtime="batch"):
    """(pull-in, cruise) of the batch runtime, as the CLI builds them; or
    the CLI's scan-runtime configuration (borre, 20 ms blocks) and no
    cruise."""
    from sydr_tpu_torch.channels.runtime import TrackingConfig

    fs = fs_in / DECIMATE
    if runtime == "scan":
        return TrackingConfig(
            sampling_frequency=fs, input_decimate=DECIMATE,
            window_size=round(fs * 1e-3) + 256, runtime="scan",
            profile="borre", block_ms=20, quantize_spacing=True), None
    pull_in = TrackingConfig(
        sampling_frequency=fs, input_decimate=DECIMATE,
        window_size=round(fs * 1e-3) + 256, runtime="batch",
        profile="kaplan", block_ms=5, quantize_spacing=True)
    cruise = dataclasses.replace(
        pull_in, kaplan_narrow_only=True, block_ms=20, superblock=superblock)
    return pull_in, cruise


def slice_phase(device, capture=None, signal_ms=SIGNAL_MS, fs_in=FS_IN,
                n_channels=N_CHANNELS, n_visible=N_VISIBLE,
                superblock=CRUISE_SUPERBLOCK, sync=None, card="",
                acq_kernel_name="pcps_bins", settled=True, runtime="batch",
                acq_cfg=None, cn0_dbhz=CN0_DBHZ, code_index_tol=2) -> dict:
    """Drive the port's TrackingSession; check and return what it did.

    ``capture``: ``(sats, re, im)`` of :func:`make_scenario`, made here
    when None. ``acq_kernel_name``: the K2 entry the acquisition must
    launch at this rate, or None when it must launch neither (serial
    search, direct map). ``settled``: the run is long enough for bit
    sync and the 5 Hz carrier bound to be required (and promotion, in the
    batch runtime); a short run checks acquisition and finite outputs
    only. ``runtime``: ``"batch"`` (kaplan pull-in, promotion to cruise;
    K1 must launch) or ``"scan"`` (borre at 20 ms blocks; no K1)."""
    from sydr_tpu_torch.channels.state import FLAG_BIT_SYNC, MODE_TRACKING
    from sydr_tpu_torch.receiver.session import TrackingSession

    if capture is None:
        capture = make_scenario(np.random.default_rng(SEED), signal_ms,
                                fs_in, n_channels, n_visible, cn0_dbhz)
    sats, sig_re, sig_im = capture
    sig_re = sig_re[:signal_ms * round(fs_in * 1e-3)]
    sig_im = sig_im[:len(sig_re)]
    pull_in, cruise = session_configs(fs_in, superblock, runtime)
    session = TrackingSession(pull_in, list(range(1, n_channels + 1)),
                              acq_cfg, cruise=cruise, device=device)
    sync = sync or (lambda: None)
    in_per_ms = round(fs_in * 1e-3)

    reset_launches()
    outs, pos, calls, promoted_at = [], 0, 0, None
    cruise_signal_s, cruise_wall_s = 0.0, 0.0
    while pos + session.block_input_samples <= len(sig_re):
        n_in = session.block_input_samples
        # The timed shape: cruise; in the scan runtime, every block after
        # the acquisition handoff.
        in_cruise = session.promoted if cruise is not None \
            else bool(session.acq_results)
        sync()
        t_call = time.perf_counter()
        out = session.process_block(sig_re[pos:pos + n_in],
                                    sig_im[pos:pos + n_in])
        sync()
        if in_cruise:
            cruise_wall_s += time.perf_counter() - t_call
            cruise_signal_s += n_in / fs_in
        outs.append(out)
        pos += n_in
        calls += 1
        if promoted_at is None and session.promoted:
            promoted_at = calls
    launches = read_launches()
    merged = {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}
    ms_fed = pos // in_per_ms
    print(f"fed {ms_fed} ms in {calls} calls; promotion after call "
          f"{promoted_at} ({session.cfg.profile}"
          f"{'/narrow' if session.cfg.kaplan_narrow_only else ''}/"
          f"{session.cfg.block_ms} ms/sb{session.cfg.superblock})",
          flush=True)

    fs = fs_in / DECIMATE
    spms = round(fs * 1e-3)
    ok = True
    for s in sats:
        i = s["prn"] - 1
        acq = session.acq_results.get(i)
        if acq is None:
            print(f"PRN {s['prn']:2d}: not acquired", flush=True)
            ok = False
            continue
        ci_truth = round((-s["code_phase"]) % 1023.0 * fs / 1.023e6) % spms
        d_ci = (acq["code_index"] - ci_truth + spms // 2) % spms - spms // 2
        cf = merged["carrier_freq"][-200:, i]
        err_hz = abs(float(cf.mean()) - s["doppler"])
        synced = bool(merged["flags"][-1, i] & FLAG_BIT_SYNC)
        print(f"PRN {s['prn']:2d}: doppler {acq['doppler']:8.1f} Hz "
              f"(truth {s['doppler']:8.1f}) code_index {acq['code_index']:4d} "
              f"(truth {ci_truth:4d}) metric {acq['metric']:.2f} | "
              f"bit_sync {synced} carrier error (last 200 ms) "
              f"{err_hz:.3f} Hz", flush=True)
        ok &= (abs(acq["doppler"] - s["doppler"])
               <= session.acq_cfg.doppler_step
               and abs(d_ci) <= code_index_tol)
        if settled:
            ok &= synced and err_hz < 5.0
    visible = {s["prn"] - 1 for s in sats}
    absent_modes = {i + 1: int(session.mode_host[i])
                    for i in range(n_channels) if i not in visible}
    print(f"absent PRNs' modes: {absent_modes}", flush=True)
    rtf = cruise_signal_s / cruise_wall_s if cruise_wall_s else float("nan")
    print(f"{'cruise' if cruise is not None else 'scan-runtime tracking'} "
          f"real-time factor {rtf:.4f} ({cruise_signal_s:.2f} s of "
          f"signal in {cruise_wall_s:.3f} s) on {card}", flush=True)
    print(f"launches on the main path: {launches}", flush=True)

    check(ok, "a visible satellite failed acquisition, bit sync or the "
              "5 Hz carrier bound")
    check(promoted_at is not None or not settled or cruise is None,
          "the session never promoted to cruise")
    check(all(m != MODE_TRACKING for m in absent_modes.values()),
          "an absent PRN is tracking")
    # K1 in the batch runtime, the named K2 entry, and nothing else.
    expected = {name: name == acq_kernel_name
                or (name == "epoch_correlate" and runtime == "batch")
                for name in launches}
    check(all((launches[name] > 0) == hit for name, hit in expected.items()),
          f"the session's path launched {launches}: expected exactly "
          f"{[name for name, hit in expected.items() if hit]}")
    check(all(np.isfinite(merged[k]).all() for k in
              ("i_prompt", "q_prompt", "carrier_freq")),
          "non-finite tracking output")
    return {"launches": launches, "rtf": rtf, "promoted_at": promoted_at,
            "session": session}


def scan_block_profile(session, card) -> None:
    """``torch.profiler`` over one block of the scan runtime on the
    session's state: kernel launches per epoch and the device's busy
    share (the state is not advanced: ``run_block`` returns a new one)."""
    import torch

    from sydr_tpu_torch.channels import runtime

    cfg = session.cfg
    window = torch.randn(cfg.window_samples, device=session.device)
    def run():
        runtime.run_block(cfg, session.codes, session.state, window, window)

    run()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        run()
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    events = prof.key_averages()
    n_launch = sum(e.count for e in events if "LaunchKernel" in e.key)
    device_us = sum(getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0.0))
                    for e in events)
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    print(f"scan runtime, one {cfg.block_ms} ms block of "
          f"{session.n_channels} channels: {n_launch / cfg.block_ms:.1f} "
          f"kernel launches per epoch, {plain_ms:.2f} ms wall "
          f"({wall_ms:.2f} ms under the profiler), device time "
          f"{device_us / 1e3:.3f} ms "
          f"({100.0 * device_us / 1e3 / plain_ms:.1f}% of the unprofiled "
          f"wall) on {card}", flush=True)
    check(n_launch > 0, "the profiler saw no kernel launch")


def serial_search_times(session, card) -> None:
    """One PRN's serial search apart from the session: the host's build of
    the code-shift matrix, its upload, and the search on the card (all
    Doppler chunks and the peak metric, through the Python calls the
    session makes)."""
    import torch

    from sydr_tpu_torch.ops import acquisition as acq

    fs = session.cfg.sampling_frequency
    spms = session.cfg.samples_per_ms
    dev = session.device
    t0 = time.perf_counter()
    shift_host = acq.code_shift_matrix(session.prns[0], fs)
    build_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    shift = torch.from_numpy(shift_host).to(dev)
    torch.cuda.synchronize()
    upload_ms = 1e3 * (time.perf_counter() - t0)
    bins = torch.from_numpy(acq.doppler_bins(
        session.acq_cfg.doppler_range, session.acq_cfg.doppler_step)).to(dev)
    iq_re = torch.from_numpy(session._hist_re[-spms:].copy()).to(dev)
    iq_im = torch.from_numpy(session._hist_im[-spms:].copy()).to(dev)

    def search():
        return acq.peak_metric_ss(acq.serial_search(
            iq_re, iq_im, shift, bins, sampling_frequency=fs))

    search_ms = cuda_ms(search, 10)
    print(f"serial search, one PRN, n={spms} x {bins.shape[0]} bins: shift "
          f"matrix {tuple(shift_host.shape)} built on the host in "
          f"{build_ms:.1f} ms, uploaded ({shift_host.nbytes / 1e6:.1f} MB) "
          f"in {upload_ms:.2f} ms, search and peak metric {search_ms:.3f} "
          f"ms on {card}", flush=True)


def direct_map_phase(device, capture, card) -> dict:
    """The direct PCPS map on the session shape (32 channels, n = 2500).

    A session on a 130 Hz Doppler grid (77 bins on 77 distinct phases, so
    :func:`shift_plan` declines) must acquire through ``pcps_map`` without
    launching K2; then, at the production grid, ``pcps_map`` is held
    against ``pcps_shift_map`` (K2) on the same 50 ms of samples."""
    import torch

    from sydr_tpu_torch.ops import acquisition as acq
    from sydr_tpu_torch.receiver.session import AcquisitionConfig

    calls = []
    real_map = acq.pcps_map

    def spy(*args, **kwargs):
        calls.append(args[3].shape[0])
        return real_map(*args, **kwargs)

    acq.pcps_map = spy
    try:
        res = slice_phase(
            device, capture, signal_ms=60, settled=False, card=card,
            acq_kernel_name=None,
            acq_cfg=AcquisitionConfig(doppler_step=130.0))
    finally:
        acq.pcps_map = real_map
    check(calls == [77], f"acquire took pcps_map for {calls} bins, expected "
                         f"one search of 77")
    session = res["session"]

    # The two maps on the session's 50 ms ring, production grid.
    fs = session.cfg.sampling_frequency
    n = session.cfg.samples_per_ms
    need = session._ring_re.shape[0]
    n_ch = session.n_channels
    iq = (session._ring_re[None, :].expand(n_ch, need),
          session._ring_im[None, :].expand(n_ch, need))
    code_k = torch.tensor(
        np.stack([acq.code_fft_conj(p, fs) for p in session.prns]),
        dtype=torch.complex64, device=device)
    bins = acq.doppler_bins(5000.0, 100.0)
    phases, bin_shifts = acq.shift_plan(bins, fs, n)
    bins_dev = torch.from_numpy(bins).to(device)
    common = dict(sampling_frequency=fs, coherent=5, non_coherent=10)
    def shift():
        return acq.pcps_shift_map(*iq, code_k, phases=phases,
                                  bin_shifts=bin_shifts, **common)

    def direct():
        return acq.pcps_map(*iq, code_k, bins_dev, **common)

    before = read_launches()["pcps_bins"]
    ref, got = shift(), direct()
    check(read_launches()["pcps_bins"] == before + 1,
          "pcps_map launched K2, or pcps_shift_map did not")
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    bound = K2_RTOL * float(ref.abs().max())
    torch.cuda.reset_peak_memory_stats()
    direct_ms = cuda_ms(direct, 3)
    direct_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    shift_ms = cuda_ms(shift, 3)
    shift_peak = torch.cuda.max_memory_allocated()
    print(f"direct map vs shift map, {n_ch} ch x {len(bins)} bins x n={n}: "
          f"max_abs_err {err:.3e} (bound {bound:.3e}, "
          f"{err / float(ref.abs().max()):.2e} of the map's maximum) | "
          f"pcps_map {direct_ms:.3f} ms a search (peak memory "
          f"{direct_peak / 1e6:.0f} MB), pcps_shift_map with its spectra "
          f"{shift_ms:.3f} ms (peak {shift_peak / 1e6:.0f} MB) on {card}",
          flush=True)
    check(bool(torch.isfinite(got).all()), "direct map: non-finite output")
    check(err <= bound, f"direct map: error {err} above bound {bound}")
    return res


def checkpoint_phase(device, sky_path, card) -> dict:
    """Checkpoint and resume on the demo sky's IQ file, then the CLI with
    ``--runtime scan --checkpoint-every``.

    One block per ``process_ms`` call, so the receiver holds no pending
    samples when it saves. Both continuations run the same kernels on the
    same samples from the same state; the bound is the side-by-side one of
    the CPU tests (integer outputs equal, carrier within 1 Hz)."""
    import argparse

    import torch

    from sydr_tpu_torch import main as cli
    from sydr_tpu_torch.receiver.checkpoint import (
        load_checkpoint, save_checkpoint)
    from sydr_tpu_torch.receiver.receiver import Receiver, ReceiverConfig
    from sydr_tpu_torch.signal.rf import RFConfig, RFFileSource

    scn = demo_scenario()
    sats = [s.eph for s in scn.sats]
    pull_in, cruise = session_configs(FS_IN, 10)
    cfg = ReceiverConfig(
        prns=tuple(e.prn for e in sats), tracking=pull_in,
        cruise_tracking=cruise, approx_position=tuple(scn.rx + 1000.0),
        assisted_ephemerides={e.prn: e for e in sats}, tropo_enabled=False)
    in_per_ms = round(FS_IN * 1e-3)

    def source():
        return RFFileSource(RFConfig(filepath=sky_path,
                                     sampling_frequency=FS_IN, data_size=8,
                                     is_complex=True))

    def step(rx, src):
        rx.process_ms(src.read_ms(
            rx.session.block_input_samples // in_per_ms))

    keys = ("active", "flags", "required", "unread", "bit_ready",
            "carrier_freq", "i_prompt", "q_prompt")
    reset_launches()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        rx, src = Receiver(cfg, device=device), source()
        try:
            while not rx.session.promoted:
                step(rx, src)
                check(rx.session.total_samples * DECIMATE
                      < (RX_MS - 3000) * in_per_ms,
                      "the receiver never promoted")
            step(rx, src)                         # one cruise superblock
            check(len(rx._pend_re) == 0, "pending samples at the save")
            fed_ms = rx.session.total_samples * DECIMATE // in_per_ms
            path = os.path.join(tmp, "smoke.ckpt.npz")
            save_checkpoint(rx, path)
            t_saved = time.perf_counter() - t0
            n_pull_in = read_launches()["epoch_correlate"]
            rx2, src2 = Receiver(cfg, device=device), source()
            try:
                load_checkpoint(rx2, path)
                check(rx2.session.promoted
                      and rx2.session.cfg is rx2.session.cruise_cfg,
                      "the resumed receiver is not in the cruise shape")
                check(rx2.session.state.carrier_freq.device.type == "cuda",
                      "the resumed state is not on the card")
                src2.read_ms(fed_ms)
                exact, worst_hz = True, 0.0
                for _ in range(5):
                    step(rx, src)
                    step(rx2, src2)
                    a, b = rx.last_outputs, rx2.last_outputs
                    for k in keys[:5]:
                        check(np.array_equal(a[k], b[k]),
                              f"resumed run differs in {k}")
                    worst_hz = max(worst_hz, float(np.abs(
                        a["carrier_freq"] - b["carrier_freq"]).max()))
                    exact &= all(np.array_equal(a[k], b[k]) for k in keys)
            finally:
                src2.close()
        finally:
            src.close()
        launches = read_launches()
        print(f"checkpoint: saved at {fed_ms} ms (promoted, "
              f"{os.path.getsize(path) / 1e3:.0f} kB, reached in "
              f"{t_saved:.1f} s); resumed receiver promoted on load; 5 "
              f"superblocks of {cruise.block_ms * cruise.superblock} ms "
              f"side by side: integer outputs equal, carrier within "
              f"{worst_hz:.6f} Hz (bound 1 Hz), bit-identical: {exact}; "
              f"launches {launches} on {card}", flush=True)
        check(worst_hz <= 1.0, f"resumed carrier differs by {worst_hz} Hz")
        check(rx2.last_outputs["active"].shape[0]
              == cruise.block_ms * cruise.superblock,
              "the resumed receiver did not run cruise superblocks")
        # Pull-in ran once, in the first receiver only: the second one's K1
        # launches are 5 superblocks of cruise blocks.
        check(launches["epoch_correlate"] - n_pull_in
              == 2 * 5 * cruise.superblock,
              f"K1 launches after the save: "
              f"{launches['epoch_correlate'] - n_pull_in}")
        check([(c.n_codes, c.bits_pushed, c.tow_ref) for c in rx.channels]
              == [(c.n_codes, c.bits_pushed, c.tow_ref)
                  for c in rx2.channels],
              "resumed bookkeeping differs")

        # The CLI: scan runtime, a checkpoint every 200 ms.
        argv = ["--demo", "--fs", "4e6", "--runtime", "scan", "--ms", "400",
                "--checkpoint-every", "200", "--device", "cuda",
                "--no-dashboard", "--no-report", "--out", tmp]
        print(f"cli: sydr_tpu_torch.main.main({argv})", flush=True)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        print(buf.getvalue().rstrip(), flush=True)
        check(rc == 0, f"the CLI returned {rc}")
        ckpt = os.path.join(tmp, "demo.ckpt.npz")
        check(os.path.exists(ckpt), "the CLI left no checkpoint")
        run_cfg, _ = cli._build_demo(argparse.Namespace(
            fs=4e6, decimate=1, runtime="scan", pallas=False, superblock=1,
            quantize=False, no_cruise=False, cruise_superblock=50, ms=400,
            out=tmp))
        rx3 = Receiver(run_cfg.receiver, device=device)
        load_checkpoint(rx3, ckpt)
        check(rx3.session.total_samples == 400 * 4000
              and rx3._epochs_done == 400
              and len(rx3.session.acq_results) == len(sats),
              "the CLI's checkpoint does not hold the run's state")
        print(f"cli checkpoint: {os.path.getsize(ckpt) / 1e3:.0f} kB, "
              f"loads at {rx3.session.total_samples} samples with "
              f"{len(rx3.session.acq_results)} acquisition results",
              flush=True)
    torch.cuda.synchronize()
    return {"launches": launches}


def kernels():
    """Every CUDA kernel of the port, by name."""
    from sydr_tpu_torch.ops import acq_kernel
    from sydr_tpu_torch.ops import correlator_kernel as ck

    return {"epoch_correlate": ck.KERNEL, "pcps_bins": acq_kernel.KERNEL,
            "pcps_bins_fourstep": acq_kernel.FOURSTEP_KERNEL,
            "block_cumsum_streams": ck.CUMSUM_KERNEL}


def reset_launches() -> None:
    for kern in kernels().values():
        kern.launches = 0


def read_launches() -> dict:
    return {name: kern.launches for name, kern in kernels().items()}


def cli_phase() -> dict:
    """The receiver through its CLI on the demo sky at the bench's input
    rate, in process; stdout is captured, echoed and checked."""
    from sydr_tpu_torch import main as cli

    buf = io.StringIO()
    with tempfile.TemporaryDirectory() as out:
        argv = ["--demo", "--fs", f"{FS_IN:g}", "--decimate", str(DECIMATE),
                "--quantize", "--ms", str(RX_MS), "--device", "cuda",
                "--no-dashboard", "--no-report", "--out", out]
        print(f"cli: sydr_tpu_torch.main.main({argv})", flush=True)
        reset_launches()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        launches = read_launches()
    text = buf.getvalue()
    print(text.rstrip(), flush=True)
    print(f"cli launches on the main path: {launches}", flush=True)
    check(rc == 0, f"the CLI returned {rc}")
    check("final fix:" in text, "the CLI printed no fix")
    found = re.search(r"error vs reference position: ([0-9.]+) m", text)
    check(found is not None, "the CLI printed no position error")
    err = float(found.group(1))
    check(err < FIX_BOUND_M, f"CLI fix error {err} m >= {FIX_BOUND_M} m")
    check(launches["epoch_correlate"] > 0 and launches["pcps_bins"] > 0,
          f"a kernel never launched on the CLI's path: {launches}")
    return {"launches": launches, "fix_error_m": err}


def demo_scenario():
    """The demo sky at the bench's input rate (sydr_tpu_torch/main.py)."""
    from sydr_tpu_torch.signal.scenario import (
        DEMO_RX_TRUTH, Scenario, demo_ephemerides)

    sats = demo_ephemerides(DEMO_T0, DEMO_WEEK)
    return Scenario(np.array(DEMO_RX_TRUTH), sats, DEMO_T0, FS_IN,
                    cn0_dbhz=47.0, seed=3)


def write_demo_sky(path: str) -> None:
    """Write RX_MS of the demo sky to ``path`` as int8 IQ (run in a child
    process while the CLI phase runs: it is host work only)."""
    sys.path.insert(0, REPO)
    t0 = time.perf_counter()
    demo_scenario().write_file(path, RX_MS)
    print(f"prefix receiver: wrote {RX_MS} ms of the demo sky at "
          f"{FS_IN / 1e6:g} Msps ({os.path.getsize(path) / 1e6:.0f} MB "
          f"int8 IQ) in {time.perf_counter() - t0:.1f} s", flush=True)


def prefix_receiver_phase(device, sky_path) -> dict:
    """The receiver at full width on the prefix form (K3 + K2), fed from the
    int8 IQ file of the demo sky (:func:`write_demo_sky`) through
    RFFileSource."""
    import torch

    from sydr_tpu_torch.channels.runtime import TrackingConfig
    from sydr_tpu_torch.channels.state import MODE_TRACKING
    from sydr_tpu_torch.receiver.receiver import Receiver, ReceiverConfig
    from sydr_tpu_torch.signal.rf import RFConfig, RFFileSource

    scn = demo_scenario()
    sats = [s.eph for s in scn.sats]
    rx_truth = scn.rx
    truth = {t["prn"]: t["doppler"] for t in scn.truth_state(DEMO_T0)}
    fs = FS_IN / DECIMATE
    pull_in = TrackingConfig(
        sampling_frequency=fs, input_decimate=DECIMATE,
        window_size=round(fs * 1e-3) + 256, runtime="batch",
        profile="kaplan", block_ms=5, superblock=4, quantize_spacing=True,
        use_pallas=True, boundary_mode="prefix")
    cruise = dataclasses.replace(pull_in, kaplan_narrow_only=True,
                                 block_ms=20, superblock=CRUISE_SUPERBLOCK)
    cfg = ReceiverConfig(
        prns=tuple(range(1, N_CHANNELS + 1)), tracking=pull_in,
        cruise_tracking=cruise,
        approx_position=tuple(rx_truth + np.array([3000.0, -2000.0, 1500.0])),
        assisted_ephemerides={e.prn: e for e in sats}, tropo_enabled=False)
    source = RFFileSource(RFConfig(filepath=sky_path,
                                   sampling_frequency=FS_IN, data_size=8,
                                   is_complex=True))
    rx = Receiver(cfg, device=device)
    first_acq, promoted_block, fed = None, None, 0
    reset_launches()
    t0 = time.perf_counter()
    while fed < RX_MS:
        re_, im_ = source.read_ms(500)
        rx.process_ms((re_, im_))
        fed += 500
        if first_acq is None and len(rx.session.acq_results) == N_CHANNELS:
            first_acq = {i: dict(r) for i, r in
                         rx.session.acq_results.items()}
        if promoted_block is None and rx.session.promoted:
            promoted_block = rx._block_index
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    source.close()

    ok_acq = first_acq is not None
    for e in sats:
        res = (first_acq or {}).get(e.prn - 1)
        if res is None:
            print(f"PRN {e.prn}: not acquired", flush=True)
            ok_acq = False
            continue
        good = (res["metric"] >= cfg.acquisition.threshold
                and abs(res["doppler"] - truth[e.prn])
                <= cfg.acquisition.doppler_step)
        ok_acq &= good
        print(f"PRN {e.prn}: acquired doppler {res['doppler']:+8.1f} Hz "
              f"(truth {truth[e.prn]:+8.1f}) metric {res['metric']:.2f}",
              flush=True)
    with_tow = [ch.prn for ch in rx.channels if ch.has_tow]
    errors = [float(np.linalg.norm(f.solution.position - rx_truth))
              for f in rx.fixes]
    visible = {e.prn for e in sats}
    absent_modes = {p: int(rx.session.mode_host[p - 1])
                    for p in cfg.prns if p not in visible}
    print(f"prefix receiver: promotion at block {promoted_block}; channels "
          f"with TOW {with_tow}; fix errors [m] "
          f"{[round(x, 3) for x in errors]}", flush=True)
    print(f"prefix receiver: absent PRNs' modes {absent_modes}", flush=True)
    print(f"prefix receiver: {fed} ms of signal in {wall:.1f} s; launches "
          f"{launches}", flush=True)
    check(ok_acq, "a visible satellite was not acquired within one "
                  "Doppler bin")
    check(promoted_block is not None, "the receiver never promoted")
    check(len(with_tow) >= 4, f"only {len(with_tow)} channels decoded TOW")
    check(len(errors) >= 1, "no position fix")
    check(errors[-1] < FIX_BOUND_M,
          f"last fix error {errors[-1]} m >= {FIX_BOUND_M} m")
    check(all(m != MODE_TRACKING for m in absent_modes.values()),
          "an absent PRN is tracking")
    check(launches["block_cumsum_streams"] > 0 and launches["pcps_bins"] > 0,
          f"K3 or K2 never launched on the prefix path: {launches}")
    check(launches["epoch_correlate"] == 0,
          f"K1 launched on the prefix path: {launches}")
    return {"launches": launches, "fix_errors_m": errors, "wall_s": wall}


def timed(name, fn, *args, **kwargs):
    t0 = time.perf_counter()
    res = fn(*args, **kwargs)
    print(f"phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    return res


# (kernel, its source, the TPU kernel body it replaces, the case of the
# kernel phase and the path whose launch count the JSON record reports)
RECORD = (
    ("epoch_correlate", "epoch_correlate.cu",
     "sydr_tpu/ops/correlator_kernel.py:449",
     "cruise 2.5 Msps 20 ms 6 streams", "cli"),
    ("pcps_bins", "pcps_bins.cu", "sydr_tpu/ops/acq_kernel.py:54",
     "session 32 ch n=2500", "cli"),
    ("pcps_bins_fourstep", "pcps_bins_fourstep.cu",
     "sydr_tpu/ops/acq_kernel.py:54", "8 ch n=4070", "session at n=4070"),
    ("block_cumsum_streams", "block_cumsum_streams.cu",
     "sydr_tpu/ops/correlator_kernel.py:282",
     "cruise 2.5 Msps 20 ms 6 streams", "prefix receiver"),
)


def main(argv=None) -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--kernels", action="store_true",
                        help="stop after the kernel checks (phase 3)")
    opts = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device: this smoke test runs only on a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from sydr_tpu_torch.ops import correlator_kernel, native

    card = card_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    print(f"card: {card}", flush=True)
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    built = [*kernels().values(), native.EMPTY_LAUNCH,
             correlator_kernel.STORE_CEILING]
    native.build_all(built)
    for kern in built:
        usage = [ln.strip() for ln in kern.build_log.splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"built {kern.source} in {kern.build_seconds or 0:.2f} s: "
              f"{'; '.join(usage) or 'cached'}", flush=True)
    print(f"phase build: {time.perf_counter() - t0:.1f} s", flush=True)

    cases = timed("kernel checks", kernel_phase, device)
    if opts.kernels:
        return 0

    timed("parity", parity_phase, device)
    paths = {}
    rng = np.random.default_rng(SEED)
    capture = make_scenario(rng, SIGNAL_MS, FS_IN, N_CHANNELS, N_VISIBLE)
    paths["session"] = timed(
        "session", slice_phase, device, capture,
        sync=torch.cuda.synchronize, card=card)
    # The prefix phase's IQ file is written by a child process while the
    # CLI phase runs.
    with tempfile.TemporaryDirectory() as tmp:
        sky = os.path.join(tmp, "demo_sky.int8")
        writer = multiprocessing.get_context("spawn").Process(
            target=write_demo_sky, args=(sky,), daemon=True)
        writer.start()
        try:
            paths["cli"] = timed("cli", cli_phase)
            t0 = time.perf_counter()
            writer.join()
            print(f"waited {time.perf_counter() - t0:.1f} s for the IQ "
                  f"file", flush=True)
            check(writer.exitcode == 0,
                  f"writing the IQ file failed ({writer.exitcode})")
            paths["prefix receiver"] = timed(
                "prefix receiver", prefix_receiver_phase, device, sky)
            paths["checkpoint"] = timed(
                "checkpoint", checkpoint_phase, device, sky, card)
        finally:
            if writer.is_alive():
                writer.terminate()
                writer.join()
    # n = 4092 = 2^2 * 3 * 11 * 31 takes the FFT entry's prime radices;
    # n = 4070 = 2 * 5 * 11 * 37 has no radix plan and takes the four-step
    # entry.
    for n, entry in ((4092, "pcps_bins"), (4070, "pcps_bins_fourstep")):
        paths[f"session at n={n}"] = timed(
            f"session at n={n}", slice_phase, device, signal_ms=300,
            fs_in=n * 1e3 * DECIMATE, n_channels=8, n_visible=4,
            acq_kernel_name=entry, settled=False, card=card)

    # The scan runtime at full width, on the first 2 s of the capture.
    res = timed("scan session", slice_phase, device, capture,
                signal_ms=SCAN_SIGNAL_MS, runtime="scan",
                sync=torch.cuda.synchronize, card=card)
    scan_block_profile(res["session"], card)
    paths["scan session"] = res
    from sydr_tpu_torch.receiver.session import AcquisitionConfig

    res = timed(
        "serial-search session", slice_phase, device, signal_ms=300,
        n_channels=8, n_visible=4, settled=False, card=card,
        acq_kernel_name=None, cn0_dbhz=SERIAL_CN0_DBHZ,
        code_index_tol=SERIAL_CODE_INDEX_TOL,
        acq_cfg=AcquisitionConfig(method="serial",
                                  doppler_step=SERIAL_DOPPLER_STEP,
                                  threshold=SERIAL_THRESHOLD))
    serial_search_times(res["session"], card)
    paths["serial-search session"] = res
    paths["direct map"] = timed("direct map", direct_map_phase, device,
                                capture, card)
    del capture

    for name, by_case in cases.items():
        for case, res in by_case.items():
            report("summary", f"{name} | {case}", (),
                   f"max_abs_err {res['max_abs_err']:.3e}", res)
    print("launches by path: " + json.dumps(
        {name: res["launches"] for name, res in paths.items()}), flush=True)
    record = {"kernels": [
        {"name": name, "route": "cuda",
         "source": f"sydr_tpu_torch/csrc/{source}", "replaces": replaces,
         "launches": paths[path]["launches"][name], **cases[name][case]}
        for name, source, replaces, case, path in RECORD]}
    for entry in record["kernels"]:
        check(entry["launches"] > 0,
              f"{entry['name']} never launched on its path")
    print(json.dumps(record), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
