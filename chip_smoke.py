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
   ``pcps_bins`` (the radix FFT, and the four-step entry at n = 4092), K3
   ``block_cumsum_streams``. Each case prints four times and a bound:
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
8. a session at 4.092 Msps (n = 4092 = 2^2 * 3 * 11 * 31, no radix plan):
   8 channels, 300 ms; acquisition must go through K2's four-step entry
   and find the visible satellites.

Each of phases 5-8 sets every kernel's launch count to 0 just before it
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
    out, cargs, _scratch = ck.block_cumsum_streams_launch_args(*k3)
    fn = ck.CUMSUM_KERNEL.function()
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
           f"{corr_bound:.3e})", res)
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
    k2f = {name: k2_case(name, fs, n_ch, "pcps_bins_fourstep", device, rng)
           for name, fs, n_ch in (("8 ch n=4092", 4.092e6, 8),)}
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

def make_scenario(rng, signal_ms, fs_in, n_channels, n_visible):
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
                          cn0_dbhz=CN0_DBHZ,
                          nav_bits=rng.integers(0, 2, 300))
    iq = gen.generate_ms(signal_ms)
    return sats, np.float32(iq.real), np.float32(iq.imag)


def session_configs(fs_in, superblock):
    from sydr_tpu_torch.channels.runtime import TrackingConfig

    fs = fs_in / DECIMATE
    pull_in = TrackingConfig(
        sampling_frequency=fs, input_decimate=DECIMATE,
        window_size=round(fs * 1e-3) + 256, runtime="batch",
        profile="kaplan", block_ms=5, quantize_spacing=True)
    cruise = dataclasses.replace(
        pull_in, kaplan_narrow_only=True, block_ms=20, superblock=superblock)
    return pull_in, cruise


def slice_phase(device, signal_ms=SIGNAL_MS, fs_in=FS_IN,
                n_channels=N_CHANNELS, n_visible=N_VISIBLE,
                superblock=CRUISE_SUPERBLOCK, sync=None, card="",
                acq_kernel_name="pcps_bins", settled=True) -> dict:
    """Drive the port's TrackingSession; check and return what it did.

    ``acq_kernel_name``: the K2 entry the acquisition must launch at this
    rate. ``settled``: the run is long enough for promotion, bit sync and
    the 5 Hz carrier bound to be required; a short run checks acquisition
    and finite outputs only."""
    from sydr_tpu_torch.channels.state import FLAG_BIT_SYNC, MODE_TRACKING
    from sydr_tpu_torch.receiver.session import TrackingSession

    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    sats, sig_re, sig_im = make_scenario(rng, signal_ms, fs_in, n_channels,
                                         n_visible)
    print(f"capture: {signal_ms} ms at {fs_in / 1e6:g} Msps, "
          f"{n_visible} satellites, made in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    pull_in, cruise = session_configs(fs_in, superblock)
    session = TrackingSession(pull_in, list(range(1, n_channels + 1)),
                              cruise=cruise, device=device)
    sync = sync or (lambda: None)
    in_per_ms = round(fs_in * 1e-3)

    reset_launches()
    outs, pos, calls, promoted_at = [], 0, 0, None
    cruise_signal_s, cruise_wall_s = 0.0, 0.0
    while pos + session.block_input_samples <= len(sig_re):
        n_in = session.block_input_samples
        in_cruise = session.promoted
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
        ok &= abs(acq["doppler"] - s["doppler"]) <= 100.0 and abs(d_ci) <= 2
        if settled:
            ok &= synced and err_hz < 5.0
    visible = {s["prn"] - 1 for s in sats}
    absent_modes = {i + 1: int(session.mode_host[i])
                    for i in range(n_channels) if i not in visible}
    print(f"absent PRNs' modes: {absent_modes}", flush=True)
    rtf = cruise_signal_s / cruise_wall_s if cruise_wall_s else float("nan")
    print(f"cruise real-time factor {rtf:.4f} ({cruise_signal_s:.2f} s of "
          f"signal in {cruise_wall_s:.3f} s) on {card}", flush=True)
    print(f"launches on the main path: {launches}", flush=True)

    check(ok, "a visible satellite failed acquisition, bit sync or the "
              "5 Hz carrier bound")
    check(promoted_at is not None or not settled,
          "the session never promoted to cruise")
    check(all(m != MODE_TRACKING for m in absent_modes.values()),
          "an absent PRN is tracking")
    other = ({"pcps_bins", "pcps_bins_fourstep"} - {acq_kernel_name}).pop()
    check(launches["epoch_correlate"] > 0 and launches[acq_kernel_name] > 0
          and launches[other] == 0,
          f"the session's path launched {launches}: expected K1 and "
          f"{acq_kernel_name}, and no {other}")
    check(all(np.isfinite(merged[k]).all() for k in
              ("i_prompt", "q_prompt", "carrier_freq")),
          "non-finite tracking output")
    return {"launches": launches, "rtf": rtf, "promoted_at": promoted_at}


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
     "sydr_tpu/ops/acq_kernel.py:54", "8 ch n=4092", "session at n=4092"),
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
    from sydr_tpu_torch.ops import native

    card = card_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    print(f"card: {card}", flush=True)
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    built = [*kernels().values(), native.EMPTY_LAUNCH]
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
    paths["session"] = timed(
        "session", slice_phase, device, sync=torch.cuda.synchronize,
        card=card)
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
        finally:
            if writer.is_alive():
                writer.terminate()
                writer.join()
    # n = 4092 has no radix plan: acquisition takes K2's four-step entry.
    paths["session at n=4092"] = timed(
        "session at n=4092", slice_phase, device, signal_ms=300,
        fs_in=4.092e6 * DECIMATE, n_channels=8, n_visible=4,
        acq_kernel_name="pcps_bins_fourstep", settled=False, card=card)

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
