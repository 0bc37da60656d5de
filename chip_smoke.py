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
   ``pcps_bins`` (the one-block radix FFT, at n = 4092 through its prime
   radices 31 and 11, and at n = 4070 = 2 * 5 * 11 * 37 through the
   generic pass of radix 37; the cluster entry at n = 16368 and 40920,
   and at n = 26500 = 2^2 * 5^3 * 53 through a generic pass, with its
   cluster size and ``cudaOccupancyMaxActiveClusters``; then a sweep over
   the front-end code periods that need a cluster, 12276 to 65536, on the
   entry and cluster that ``kernel_for`` gives, one over lengths with
   prime factors above 31, 1517 = 37 * 41 to 65498 = 2 * 32749, on the
   radix entry that holds the plan (its generic pass), and one over the
   lengths that take the Bluestein entry, 9722 = 2 * 4861 to 2^20 - 2,
   each with ``torch.fft.ifft`` beside it (and, on the Bluestein entry,
   the radix entry's time where one holds the plan); the Bluestein entry
   at 8 ch x 101 bins x 10 blocks at the 70 Msps session's n = 70000
   (its pairs in several chunks of the scratch cap) and at n = 9722; the
   refusal of a prime n
   and of n = 2^20 + 2 before any launch), K3
   ``block_cumsum_streams`` (with its two launches timed apart, the time
   of a kernel that only makes its stores, and a second run that must be
   bit-identical). Each case prints four times and a bound:
   ``ms``, the device time of the launch alone (:func:`device_ms`: the C
   entry point called in a tight loop from arguments prepared once, the
   launches queued behind a spinning kernel so that the CUDA events around
   them see the device's time, not the host's); ``call_ms``, the time
   through the Python wrapper as the receiver pays it; ``plain_ms``, the
   plain version; ``library_ms``, the part of the kernel that one PyTorch
   call computes over pre-made inputs (the port never calls it): for K2
   ``torch.fft.ifft`` over the spectrum product, for K1
   ``torch.segment_reduce`` over the correlation streams laid out
   channel-major (checked against the plain version), for K3
   ``torch.cumsum`` over the streams; and ``bound_ms``, the least time the
   card could take (:func:`roofline`). An empty kernel is timed the same way: the
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
9. the same at 4.070 Msps (n = 4070 = 2 * 5 * 11 * 37): acquisition must
   go through K2's one-block entry (plan 11, 37, 10: a generic pass of
   radix 37) and no other K2 entry;
10. a session at 16.368 Msps, full rate (no decimation: n = 16368 =
    2^4 * 3 * 11 * 31, above one block's shared memory): 8 channels, 4
    visible, 300 ms; acquisition must go through K2's cluster entry (and
    no other entry) and find the visible satellites, K1 must run; then
    the same at 70 Msps (n = 70000 = 2^4 * 5^4 * 7, above the clusters'
    65,536 points) through K2's Bluestein entry alone, K1 at 70000
    samples a ms, the entry's scratch printed;
11. the per-ms scan runtime at full width: phase 5's capture (its first
    2 s) through a 32-channel ``TrackingSession`` with ``runtime="scan"``,
    borre loops, 20 ms blocks: acquisition through K2, bit sync and the
    5 Hz carrier bound on the visible channels, no K1 or K3 launch; its
    real-time factor is printed, and ``torch.profiler`` over one more block
    counts its kernel launches per epoch and the device's busy share;
12. a serial-search session: 8 channels at 2.5 Msps, 4 visible at
    50 dB-Hz (one code period is all a serial search integrates),
    ``AcquisitionConfig(method="serial")`` on 250 Hz bins, 300 ms: the
    visible satellites within one Doppler bin and one chip, and no K2
    launch; one PRN's search is then timed apart (the host's shift-matrix
    build, its upload, the search on the card);
13. the direct PCPS map: phase 5's capture with ``doppler_step=130`` (77
    bins on 77 phases: no shift plan), where ``acquire`` must take
    ``pcps_map`` and launch no K2, the satellites within one bin; then
    ``pcps_map`` against ``pcps_shift_map`` (K2) on the same 50 ms at the
    production grid (step 100), within 1e-4 of the map's maximum;
14. checkpoint and resume (run right after phase 7, while its IQ file
    exists): a 6-channel ``Receiver`` on that file runs to a block
    boundary after promotion, saves, and continues; a
    fresh ``Receiver`` loads the checkpoint, is promoted without running
    pull-in, and continues on the same samples: integer outputs equal and
    the carrier within 1 Hz (the kernels sum in one fixed order, so the
    phase also prints whether the two runs were bit-identical). Then the
    CLI in process with ``--runtime scan --checkpoint-every``, which must
    leave a ``.ckpt.npz`` that a receiver of the demo's configuration
    loads;
15. the multi-device layer (``sydr_tpu_torch.parallel``): (a) a one-rank
    NCCL process group, ``TrackingSession(mesh=make_mesh(1, 1))`` on the
    first 2 s of phase 5's capture, every output of every call bit for bit
    phase 5's; (b) two gloo ranks sharing the card (spawned processes):
    the cruise superblock that follows (a) sharded 16 + 16 channels in
    both forms of pass B (K1, K3), bit for bit the 32-channel superblock;
    the full-rate block (10 Msps, 32 channels, 4 + 20 ms, 6 streams)
    sharded 12 + 12 ms in both forms, within :func:`sp_bound` of the
    unsharded block with the epoch geometry exact; ``sharded_pcps`` on a
    (1, 2) mesh over the production grid, Doppler and code index those of
    the unsharded ``pcps_map`` + ``peak_metric``; each rank's launch
    counts and step times, the unsharded times beside them, and K1 and K3
    on a time shard timed as in phase 3; (c) ``python -m
    sydr_tpu_torch.parallel.dryrun --world 2 --backend gloo``, which must
    print its OK line;
16. the measuring tools (``sydr_tpu_torch.tools``): (a) the soak, 60 s of
    the production receiver (10 Msps, decimate 4, kaplan pull-in, the
    narrow-only cruise at superblock 25, quantised taps, seed 3) within the
    soak's fix, prompt-ratio and C/N0 bounds (its Doppler drift is printed:
    the > 50 Hz bound needs 300 s); its scenario is made from the end of
    phase 3 on by a child process (``soak.scenario_chunks``, 3 workers)
    while phases 4-15 run; (b) beside the soak, in a child process, one
    kaplan ``track_benchmark`` trial at 45 dB-Hz (retained, BER 0) and one
    at 35 dB-Hz (printed); (c) ``acq_benchmark``: 32 trials at 30 and 33
    dB-Hz and 32 signal-absent, 4 Msps, 5 x 10 ms (Pd 1.00 at 33 dB-Hz,
    Pfa 0/32; the 30 dB-Hz row and the grid rate printed); (d)
    ``trace_profile``'s superblock (5 blocks) in both boundary forms with
    its pass A/B/C split; (e) ``scaling_bench``'s per-shard curve (10-block
    steps) at 32, 16, 8, 4 channels with eff(n); (f) ``acq_profile``'s two
    maps.

Each of phases 5-16 sets every kernel's launch count to 0 just before it
(phase 16: each of its parts) and reads the counts just after (phase 15's
ranks and phase 16's tracking trials count in their own processes, from
0). The last three lines are the kernels'
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
# The 70 Msps session's code index: the map's peak sits at the code phase
# of the 50 ms search's middle, which drifts from the capture's start by
# 4040 Hz / 1540 carrier cycles a chip x 25 ms = 0.066 chip = 4.5 samples
# at 68.4 samples a chip at the scenario's largest Doppler; so 2 samples
# plus 5. (At 2.5-16.368 Msps the sessions keep 2.)
SESSION_70_CODE_INDEX_TOL = 7

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
# K2: a float32 FFT (a direct sum in its generic passes) against cuFFT,
# both float32: 1e-4 of the map's maximum.
# K3: the same per-sample values as K1, scanned in another order than
# torch.cumsum: the raw prefix within 4 * sqrt(n_win) * 2^-24 of its largest
# magnitude (a random walk of float32 roundings, four sigma); the epoch
# correlators picked from it within K1's bound.
K1_ATOL, K1_RTOL = 1e-2, 1e-4
K2_RTOL = 1e-4
K3_PREFIX_SIGMAS = 4.0
CORR_KEYS = ("i_early", "q_early", "i_prompt", "q_prompt", "i_late",
             "q_late")


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

def random_config(fs, block_ms, profile, quantize):
    """The batch runtime's configuration of :func:`random_tracking`."""
    from sydr_tpu_torch.channels.runtime import TrackingConfig

    return TrackingConfig(
        sampling_frequency=fs, block_ms=block_ms, tail_ms=4,
        window_size=round(fs * 1e-3) + 256, runtime="batch",
        profile="kaplan", kaplan_narrow_only=profile == "narrow",
        quantize_spacing=quantize)


def random_tracking(fs, block_ms, profile, quantize, device, rng):
    """A random 32-channel tracking state and window: ``(cfg, state,
    window_re, window_im, code_bits)``."""
    import torch

    from sydr_tpu_torch.channels import batch_runtime as br
    from sydr_tpu_torch.channels.state import MODE_TRACKING, init_state

    cfg = random_config(fs, block_ms, profile, quantize)
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
    return cfg, st, wre, wim, bits


def random_block(fs, block_ms, profile, quantize, device, rng):
    """A random 32-channel tracking state and window: the K1 arguments."""
    from sydr_tpu_torch.channels import batch_runtime as br

    cfg, st, wre, wim, bits = random_tracking(fs, block_ms, profile,
                                              quantize, device, rng)
    spms = cfg.samples_per_ms
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
    lib_ms, lib_err = segment_reduce_library(args, ref)
    check(lib_err <= bound, f"K1 {name}: the library yardstick "
          f"(segment_reduce) is off by {lib_err}, above {bound}")
    out, cargs = ck.epoch_correlate_launch_args(*args)
    fn = ck.KERNEL.function()
    # The work this state needs: the samples inside the epochs' bounds.
    n_samples = int((bounds[-1] - bounds[0]).sum())
    wpe, epb = ck.launch_shape(bounds.shape[0] - 1, N_CHANNELS, spms)
    res = {"max_abs_err": err,
           "ms": device_ms(lambda: fn(*cargs), 200),
           "call_ms": cuda_ms(lambda: ck.epoch_correlate(*args), 50),
           "plain_ms": cuda_ms(lambda: ck.epoch_correlate_ref(*args), 5),
           "library_ms": lib_ms,
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


def segment_reduce_library(args, ref):
    """``torch.segment_reduce`` over K1's streams, pre-made and laid out
    channel-major (``[n_ch * n_win, n_streams]``, one segment per epoch and
    one before and after): the part of K1 that one PyTorch call computes.
    Returns (its ms, its largest difference from the plain version)."""
    import torch

    from sydr_tpu_torch.ops import correlator_kernel as ck

    bounds = args[8]
    streams = ck._dense_streams(*args[:8], *args[9:])
    n_ch, n_s, n_win = streams.shape
    data = streams.permute(0, 2, 1).reshape(n_ch * n_win, n_s).contiguous()
    b = bounds.to(torch.int64).t()
    lengths = torch.cat([b[:, :1], b[:, 1:] - b[:, :-1], n_win - b[:, -1:]],
                        dim=1).reshape(-1)

    def run():
        return torch.segment_reduce(data, "sum", lengths=lengths, axis=0)

    got = run().reshape(n_ch, -1, n_s)[:, 1:-1].permute(1, 0, 2)
    err = float((got - ref).abs().max())
    ms = cuda_ms(run, 20)
    print(f"   library yardstick: torch.segment_reduce over "
          f"{tuple(data.shape)} f32 ({tensor_bytes(data) / 1e6:.0f} MB, "
          f"{lengths.numel()} segments): {ms:.4f} ms, max_abs_err "
          f"{err:.3e}", flush=True)
    return ms, err


def cumsum_library_ms(k3) -> float:
    """``torch.cumsum`` over K3's streams, pre-made ``[n_ch, n_streams,
    n_win]`` f32: the part of K3 that one PyTorch call computes."""
    import torch

    from sydr_tpu_torch.ops import correlator_kernel as ck

    streams = ck._dense_streams(*k3)
    ms = cuda_ms(lambda: torch.cumsum(streams, dim=-1), 20)
    print(f"   library yardstick: torch.cumsum over {tuple(streams.shape)} "
          f"f32 ({tensor_bytes(streams) / 1e6:.0f} MB): {ms:.4f} ms",
          flush=True)
    return ms


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
           "library_ms": cumsum_library_ms(k3),
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


def ifft_library_ms(spectra, code_k, bin_shifts, quiet=False) -> float:
    """``torch.fft.ifft`` alone over the pre-made product ``[n_bins, n_ch,
    nc, n]`` complex64: the part of K2 that one PyTorch call computes
    (printed unless ``quiet``)."""
    import torch

    n_ph, n_ch, nc, n = spectra.shape
    prod = torch.empty((len(bin_shifts), n_ch, nc, n), dtype=torch.complex64,
                       device=spectra.device)
    for b, (k, p) in enumerate(bin_shifts):
        torch.mul(spectra[p], torch.roll(code_k, k, dims=-1)[:, None, :],
                  out=prod[b])
    ms = cuda_ms(lambda: torch.fft.ifft(prod, dim=-1), 5)
    if quiet:
        return ms
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
    if entry == "pcps_bins_bluestein":
        print(f"   {bluestein_shape(n, n_ch * len(bin_shifts), non_coherent)}",
              flush=True)
    elif entry == "pcps_bins_cluster":
        print(f"   plan {acq_kernel.radix_plan(n)}, cluster of "
              f"{acq_kernel.cluster_size(n)} blocks of {cargs[10]} threads, "
              f"cudaOccupancyMaxActiveClusters "
              f"{acq_kernel.cluster_occupancy(n)}", flush=True)
    else:
        print(f"   plan {acq_kernel.radix_plan(n)}, one block of "
              f"{cargs[10]} threads", flush=True)
    report("K2", f"[{entry}] {name}", got.shape,
           f"max_abs_err {err:.3e} (bound {bound:.3e}, "
           f"{err / float(ref.abs().max()):.2e} of the map's maximum)", res)
    check(bool(torch.isfinite(got).all()), f"K2 {name}: non-finite output")
    check(err <= bound, f"K2 {name}: error {err} above bound {bound}")
    return res


# Code periods of front ends whose transform takes a cluster (12.276 to
# 65.536 Msps), each at 1 channel x 11 bins x 2 blocks.
SWEEP_N = (12276, 16368, 20000, 20460, 25000, 26000, 30690, 40000, 40920,
           50000, 65536)
# Lengths with prime factors above 31 (generic passes), at the same shape,
# on the radix entry that holds the plan: no factor up to 31 (1517 =
# 37 * 41, 65231 = 37 * 41 * 43), one twice that, a large prime factor on
# a cluster of 2 (9722 = 2 * 4861, 16370 = 2 * 5 * 1637), a 53 Msps front
# end (53000 = 2^3 * 5^3 * 53) and the largest prime factor of any n up
# to 65536 (65498 = 2 * 32749).
GENERIC_SWEEP_N = (1517, 3034, 9722, 16370, 53000, 65231, 65498)
# Lengths that take the Bluestein entry, at the same shape: large prime
# factors (9722, 16370, 65498), the first n above the clusters (65538 =
# 2 * 3^2 * 11 * 331), front ends at 70 Msps (70000 = 2^4 * 5^4 * 7) and
# 122.88 Msps (122880 = 2^13 * 3 * 5), 131074 = 2 * 65537, 245.52 Msps
# (245520 = 2^4 * 3^2 * 5 * 11 * 31) and the largest even n, 2^20 - 2.
BLUESTEIN_SWEEP_N = (9722, 16370, 65498, 65538, 70000, 122880, 131074,
                     245520, 1048574)
# Code periods that no entry takes: a prime (as the JAX package refuses
# a prime above 64) and the first even n above the Bluestein entry's 2^20.
REFUSED_N = (4093, 1048578)


def entry_name(kernel) -> str:
    """The JSON record's name of a K2 entry."""
    return next(name for name, kern in kernels().items() if kern is kernel)


def bluestein_shape(n, pairs, nc) -> str:
    """The Bluestein entry's lengths and scratch at ``pairs`` (bin,
    channel) pairs of ``nc`` blocks, as text."""
    from sydr_tpu_torch.ops import acq_kernel

    m, m1, m2 = acq_kernel.bluestein_lengths(n)
    chunk = acq_kernel.bluestein_chunk_pairs(pairs, nc, m)
    return (f"Bluestein M = {m} = {m1} x {m2}, {pairs} pairs in chunks of "
            f"{chunk}, scratch {chunk * nc * m * 8 / 2 ** 20:.1f} MiB")


def k2_sweep(device, ns, entry=None) -> dict:
    """K2 at every n of ``ns``, 1 channel x 11 bins x 2 blocks: the
    wrapper must launch the entry ``kernel_for`` gives (and nothing else)
    on its cluster (``entry="radix"``: the radix entry that holds n's
    plan, launched from ``pcps_bins_launch_args``, whichever entry the
    wrapper would take), within 1e-4 of the map's maximum; its plan,
    device time, time through the wrapper (or the launch path), the plain
    version's, the bound and ``torch.fft.ifft``'s time over the same
    product printed, and, on the Bluestein entry, the radix entry's device
    time where one holds the plan. Returns the JSON record's numbers by
    case."""
    import torch

    from sydr_tpu_torch.ops import acq_kernel

    g = torch.Generator().manual_seed(SEED)
    bins = tuple((b - 5, b % 2) for b in range(11))
    cases = {}
    for n in ns:
        spec = torch.randn(2, 1, 2, n, dtype=torch.complex64,
                           generator=g).to(device)
        code = torch.randn(1, n, dtype=torch.complex64,
                           generator=g).to(device)

        def call():
            kernel, out, cargs = acq_kernel.pcps_bins_launch_args(
                spec, code, bins, entry=entry)
            kernel.launch(*cargs)
            return out

        kernel, shape = (acq_kernel.radix_kernel_for(n) if entry
                         else acq_kernel.kernel_for(n))
        name = entry_name(kernel)
        before = read_launches()
        got = call() if entry else acq_kernel.pcps_bins(spec, code, bins)
        launched = {k: v - before[k] for k, v in read_launches().items()
                    if v != before[k]}
        check(launched == {name: 1},
              f"K2 sweep n={n}: launched {launched}, expected {name}")
        ref = acq_kernel.pcps_bins_ref(spec, code, bins)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        rel = err / float(ref.abs().max())
        _, out, cargs = acq_kernel.pcps_bins_launch_args(spec, code, bins,
                                                         entry=entry)
        fn = kernel.function()
        # About 50 ms of launches: the large prime factors run for tens of
        # milliseconds a launch on the radix entries.
        once = cuda_ms(lambda: fn(*cargs), 1)
        reps = max(2, min(20, int(50 / once)))
        ms = device_ms(lambda: fn(*cargs), reps)
        call_ms = cuda_ms(
            call if entry else lambda: acq_kernel.pcps_bins(spec, code, bins),
            reps)
        plain = cuda_ms(lambda: acq_kernel.pcps_bins_ref(spec, code, bins), 5)
        lib = ifft_library_ms(spec, code, bins, quiet=True)
        bound = roofline(tensor_bytes(spec, code, out) + 8 * n + 8 * 11,
                         22 * (5.0 * n * np.log2(n) + 10.0 * n))
        if kernel is acq_kernel.BLUESTEIN_KERNEL:
            where = bluestein_shape(n, 11, 2)
            plan = (acq_kernel.radix_plan(n) if acq_kernel.has_radix_plan(n)
                    else None)
            if plan is not None and acq_kernel.fitting_cluster(n, plan):
                rk, _, rargs = acq_kernel.pcps_bins_launch_args(
                    spec, code, bins, entry="radix")
                rfn = rk.function()
                rms = device_ms(lambda: rfn(*rargs), max(
                    2, min(20, int(50 / cuda_ms(lambda: rfn(*rargs), 1)))))
                where += (f"; the radix entry (plan {plan}, {rk.source}) "
                          f"{rms:.4f} ms")
        else:
            cluster = 1 if kernel is acq_kernel.KERNEL else shape[3]
            check(cluster == 1 or cargs[11] == cluster,
                  f"K2 sweep n={n}: cluster argument {cargs[11]}, expected "
                  f"{cluster}")
            occupancy = ("" if cluster == 1 else f" (max active clusters "
                         f"{acq_kernel.cluster_occupancy(n)})")
            where = (f"plan {acq_kernel.radix_plan(n)}, {cluster} block(s) x "
                     f"{cargs[10]} threads{occupancy}")
        print(f"K2 sweep [{name}] n={n}: {where}, 1 ch x 11 bins x 2 "
              f"blocks: device {ms:.4f} ms, call {call_ms:.4f} ms, plain "
              f"{plain:.4f} ms, ifft {lib:.4f} ms ({ms / lib:.1f}x), bound "
              f"{bound['bound_ms']:.6f} ms ({bound['bound_by']}), "
              f"max_abs_err {err:.3e} ({rel:.2e} of the map's maximum)",
              flush=True)
        check(bool(torch.isfinite(got).all()), f"K2 sweep n={n}: non-finite")
        check(rel <= K2_RTOL, f"K2 sweep n={n}: error {rel:.2e} of the "
                              f"maximum, above {K2_RTOL}")
        cases[f"1 ch n={n}"] = {
            "max_abs_err": err, "ms": ms, "call_ms": call_ms,
            "plain_ms": plain, "library_ms": lib, **bound}
    return cases


def k2_refusal(device) -> None:
    """A prime n, and an n above 2^20, have no K2 kernel: ``kernel_for``
    and the wrapper must raise ValueError, and nothing may launch."""
    import torch

    from sydr_tpu_torch.ops import acq_kernel

    for n in REFUSED_N:
        spec = torch.zeros(1, 1, 1, n, dtype=torch.complex64, device=device)
        code = torch.zeros(1, n, dtype=torch.complex64, device=device)
        before = read_launches()
        msgs = []
        for call in (lambda: acq_kernel.kernel_for(n),
                     lambda: acq_kernel.pcps_bins(spec, code, ((0, 0),))):
            try:
                call()
            except ValueError as exc:
                msgs.append(str(exc))
        torch.cuda.synchronize()
        check(len(msgs) == 2, f"K2 refusal: n={n} did not raise ValueError")
        check(read_launches() == before,
              f"K2 refusal: n={n} launched a kernel")
        print(f"K2 refusal: n={n} raised ValueError from kernel_for and the "
              f"wrapper, no launch: {msgs[0]}", flush=True)


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
    from sydr_tpu_torch.ops import acq_kernel

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
               for name, fs, n_ch in (("8 ch n=4092", 4.092e6, 8),
                                      ("8 ch n=4070", 4.070e6, 8))})
    k2c = {name: k2_case(name, fs, n_ch, "pcps_bins_cluster", device, rng)
           for name, fs, n_ch in (("8 ch n=16368", 16.368e6, 8),
                                  ("8 ch n=40920", 40.92e6, 8),
                                  ("8 ch n=26500", 26.5e6, 8))}
    k2_sweep(device, SWEEP_N)
    k2_sweep(device, GENERIC_SWEEP_N, entry="radix")
    k2b = k2_sweep(device, BLUESTEIN_SWEEP_N)
    check(all(entry_name(acq_kernel.kernel_for(n)[0])
              == "pcps_bins_bluestein" for n in BLUESTEIN_SWEEP_N),
          "a length of the Bluestein sweep took another entry")
    # The 70 Msps session's K2 shape (8 ch x 101 bins x 10 blocks, M =
    # 2^18, the pairs in several chunks of the scratch cap) and a large
    # prime factor at the same shape.
    k2b.update({name: k2_case(name, fs, 8, "pcps_bins_bluestein", device,
                              rng)
                for name, fs in (("8 ch n=70000", 70e6),
                                 ("8 ch n=9722", 9.722e6))})
    k2_refusal(device)
    k3 = {name: k3_case(name, fs, bm, prof, device, rng)
          for name, fs, bm, prof in (
              ("cruise 2.5 Msps 20 ms 6 streams", 2.5e6, 20, "narrow"),
              ("pull-in 2.5 Msps 5 ms 10 streams", 2.5e6, 5, "kaplan"),
              ("full-rate 10 Msps 20 ms 6 streams", 10e6, 20, "narrow"))}
    return {"epoch_correlate": k1, "pcps_bins": k2,
            "pcps_bins_cluster": k2c, "pcps_bins_bluestein": k2b,
            "block_cumsum_streams": k3}


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


def session_configs(fs_in, superblock, runtime="batch", decimate=DECIMATE):
    """(pull-in, cruise) of the batch runtime, as the CLI builds them; or
    the CLI's scan-runtime configuration (borre, 20 ms blocks) and no
    cruise."""
    from sydr_tpu_torch.channels.runtime import TrackingConfig

    fs = fs_in / decimate
    if runtime == "scan":
        return TrackingConfig(
            sampling_frequency=fs, input_decimate=decimate,
            window_size=round(fs * 1e-3) + 256, runtime="scan",
            profile="borre", block_ms=20, quantize_spacing=True), None
    pull_in = TrackingConfig(
        sampling_frequency=fs, input_decimate=decimate,
        window_size=round(fs * 1e-3) + 256, runtime="batch",
        profile="kaplan", block_ms=5, quantize_spacing=True)
    cruise = dataclasses.replace(
        pull_in, kaplan_narrow_only=True, block_ms=20, superblock=superblock)
    return pull_in, cruise


def slice_phase(device, capture=None, signal_ms=SIGNAL_MS, fs_in=FS_IN,
                n_channels=N_CHANNELS, n_visible=N_VISIBLE,
                superblock=CRUISE_SUPERBLOCK, sync=None, card="",
                acq_kernel_name="pcps_bins", settled=True, runtime="batch",
                acq_cfg=None, cn0_dbhz=CN0_DBHZ, code_index_tol=2,
                decimate=DECIMATE) -> dict:
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
    pull_in, cruise = session_configs(fs_in, superblock, runtime, decimate)
    session = TrackingSession(pull_in, list(range(1, n_channels + 1)),
                              acq_cfg, cruise=cruise, device=device)
    sync = sync or (lambda: None)
    in_per_ms = round(fs_in * 1e-3)

    reset_launches()
    outs, pos, calls, promoted_at, call_walls = [], 0, 0, None, []
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
        call_walls.append(time.perf_counter() - t_call)
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

    fs = fs_in / decimate
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
        rows = len(merged["carrier_freq"])
        track = [round(float(merged["carrier_freq"][j, i]), 1)
                 for j in (99, 149, 199, 249, rows - 1) if j < rows]
        print(f"PRN {s['prn']:2d}: doppler {acq['doppler']:8.1f} Hz "
              f"(truth {s['doppler']:8.1f}) code_index {acq['code_index']:4d} "
              f"(truth {ci_truth:4d}) metric {acq['metric']:.2f} | "
              f"bit_sync {synced} carrier error (last 200 ms) "
              f"{err_hz:.3f} Hz", flush=True)
        if ms_fed <= 300:
            print(f"        carrier at 100/150/200/250 ms and the end: "
                  f"{track} Hz", flush=True)
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
            "session": session, "outputs": outs, "call_walls": call_walls}


def scan_block_profile(session, card) -> None:
    """``torch.profiler`` over one block of the scan runtime on the
    session's state: kernel launches per epoch and the device's busy
    share (the state is not advanced: ``run_block`` returns a new one)."""
    import torch

    from sydr_tpu_torch.channels import runtime
    from sydr_tpu_torch.tools import trace_profile

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
    device_us = sum(e.self_device_time_total
                    for e in trace_profile.kernel_rows(events))
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
            "pcps_bins_cluster": acq_kernel.CLUSTER_KERNEL,
            "pcps_bins_bluestein": acq_kernel.BLUESTEIN_KERNEL,
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


# ---------------------------------------------------------------------------
# Phase 14: the multi-device layer
# ---------------------------------------------------------------------------

MESH_SIGNAL_MS = 2000   # (a): the first 2 s of the session's capture
MESH_WORLD = 2          # (b): gloo ranks that share the card
SP_FS = 10e6            # (b): the full-rate case, 12 of 24 ms a shard
RANK_TIMEOUT_S = 300
WARM_CALLS = 5          # (b): the cheap steps' warm calls, after the first


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def pass_b_forms(cfg):
    """``cfg`` in each form of pass B: K1 row sums and the K3 prefix."""
    return (("rowsum", dataclasses.replace(cfg, use_pallas=False,
                                           boundary_mode="rowsum")),
            ("prefix", dataclasses.replace(cfg, use_pallas=True,
                                           boundary_mode="prefix")))


def timed_call(walls, name, fn, warm=0):
    """``fn()``'s result. Its wall in seconds, between device fences, goes
    to ``walls[name]``; with ``warm`` > 0, ``fn`` runs that many more
    times and their median goes to ``walls[name + " warm"]``."""
    import torch

    def once():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    out, walls[name] = once()
    if warm:
        walls[f"{name} warm"] = float(np.median(
            [once()[1] for _ in range(warm)]))
    return out


def mesh_session_phase(device, capture, reference, card) -> dict:
    """(a) ``TrackingSession(mesh=make_mesh(1, 1))`` in a one-rank NCCL
    process group over the first MESH_SIGNAL_MS of the session's capture,
    call by call against phase 5's unsharded session on the same samples:
    every output bit for bit."""
    import torch

    from sydr_tpu_torch.parallel import distributed, mesh as pmesh
    from sydr_tpu_torch.receiver.session import TrackingSession

    _, sig_re, sig_im = capture
    pull_in, cruise = session_configs(FS_IN, CRUISE_SUPERBLOCK)
    in_per_ms = round(FS_IN * 1e-3)
    distributed.initialize("nccl", rank=0, world_size=1,
                           init_method=f"tcp://127.0.0.1:{free_port()}")
    try:
        session = TrackingSession(
            pull_in, list(range(1, N_CHANNELS + 1)), cruise=cruise,
            device=device, mesh=pmesh.make_mesh(1, 1))
        outs, walls, pos = [], [], 0
        reset_launches()
        while pos + session.block_input_samples <= MESH_SIGNAL_MS * in_per_ms:
            n_in = session.block_input_samples
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs.append(session.process_block(sig_re[pos:pos + n_in],
                                              sig_im[pos:pos + n_in]))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            pos += n_in
        launches = read_launches()
    finally:
        distributed.shutdown()
    ref = reference["outputs"]
    check(len(ref) >= len(outs), "phase 5 made fewer calls than (a)")
    diff = [(i, k) for i, (got, want) in enumerate(zip(outs, ref))
            for k in set(got) | set(want)
            if k not in got or k not in want
            or not np.array_equal(got[k], want[k])]
    ref_walls = reference["call_walls"][:len(outs)]
    print(f"multi-device (a): nccl, world 1, mesh {{'ch': 1, 'dop': 1}}: "
          f"{len(outs)} calls, {pos // in_per_ms} ms of signal, promoted "
          f"{session.promoted}; {sum(walls):.3f} s against "
          f"{sum(ref_walls):.3f} s unsharded (phase 5, the same calls), "
          f"first call {walls[0]:.3f} s against {ref_walls[0]:.3f} s, "
          f"median call {1e3 * np.median(walls):.2f} ms against "
          f"{1e3 * np.median(ref_walls):.2f} ms, on {card}; every output "
          f"bit-identical: {not diff}; launches {launches}", flush=True)
    check(not diff, f"the mesh session differs from the unsharded one at "
                    f"(call, key) {diff[:5]}")
    check(session.promoted, "the mesh session never promoted")
    check(launches["epoch_correlate"] > 0 and launches["pcps_bins"] > 0,
          f"K1 or K2 never launched on the mesh session's path: {launches}")
    return {"launches": launches, "session": session, "pos": pos}


def mesh_inputs(device, capture, mesh_run) -> dict:
    """(b)'s inputs as numpy: the cruise superblock that follows (a) (its
    promoted state and the next second of the capture, decimated, after
    the session's tail), a random full-rate block (the kernel phase's
    state at 10 Msps, 20 ms, 6 streams) and the first 50 ms of the
    capture, decimated, for the acquisition."""
    from sydr_tpu_torch.channels.state import state_to_numpy

    session, pos = mesh_run["session"], mesh_run["pos"]
    _, sig_re, sig_im = capture
    n_in = session.block_input_samples
    check(session.cfg.superblock == CRUISE_SUPERBLOCK
          and pos + n_in <= len(sig_re),
          "(a) did not leave a cruise superblock of the capture")

    def decimated(x, lo, n):
        return np.float32(x[lo:lo + n]).reshape(-1, DECIMATE).sum(axis=1)

    data = {"ch_re": np.concatenate([session._tail_re,
                                     decimated(sig_re, pos, n_in)]),
            "ch_im": np.concatenate([session._tail_im,
                                     decimated(sig_im, pos, n_in)])}
    data.update({f"ch_st_{k}": v
                 for k, v in state_to_numpy(session.state).items()})
    _, st, wre, wim, _ = random_tracking(
        SP_FS, 20, "narrow", True, device, np.random.default_rng(SEED + 14))
    data.update({f"sp_st_{k}": v for k, v in state_to_numpy(st).items()})
    data["sp_re"], data["sp_im"] = wre.cpu().numpy(), wim.cpu().numpy()
    n_acq = 50 * round(FS_IN * 1e-3)
    data["acq_re"] = decimated(sig_re, 0, n_acq)
    data["acq_im"] = decimated(sig_im, 0, n_acq)
    return data


def mesh_tensors(data, device):
    """The code table, the acquisition's code spectra and bins, and a
    host-to-device copy helper, as every side of (b) builds them."""
    import torch

    from sydr_tpu_torch.channels import batch_runtime as br
    from sydr_tpu_torch.ops import acquisition as acq

    prns = list(range(1, N_CHANNELS + 1))
    fs = FS_IN / DECIMATE
    code_k = torch.tensor(np.stack([acq.code_fft_conj(p, fs) for p in prns]),
                          dtype=torch.complex64, device=device)
    bins = acq.doppler_bins(5000.0, 100.0)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    acq_re = t(data["acq_re"])[None, :].expand(N_CHANNELS, -1)
    acq_im = t(data["acq_im"])[None, :].expand(N_CHANNELS, -1)
    return (t(br.tiled_code_bits(prns)), code_k, bins, acq_re, acq_im, t)


def mesh_rank(rank, world, port, workdir) -> None:
    """One rank of (b): gloo, on ``cuda:0`` beside the other rank. Runs
    the channel-sharded cruise superblock (16 of 32 channels), the
    time-sharded full-rate block (12 of 24 ms) in both forms of pass B,
    and ``sharded_pcps`` on a (1, 2) mesh; writes its results, its step
    times and its kernels' launch counts to ``workdir``."""
    sys.path.insert(0, REPO)
    import torch

    from sydr_tpu_torch.channels.state import (
        FIELDS, state_from_numpy, state_to_numpy)
    from sydr_tpu_torch.parallel import distributed, mesh as pmesh
    from sydr_tpu_torch.parallel import timeshard

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    distributed.initialize("gloo", rank=rank, world_size=world,
                           init_method=f"tcp://127.0.0.1:{port}",
                           timeout_s=RANK_TIMEOUT_S)
    with np.load(os.path.join(workdir, "inputs.npz")) as f:
        data = dict(f)
    bits, code_k, bins, acq_re, acq_im, t = mesh_tensors(data, device)
    ch_mesh = pmesh.make_mesh(world, 1)
    sp_mesh = timeshard.make_sp_mesh(world)
    dop_mesh = pmesh.make_mesh(1, world)
    rows = pmesh.channel_slice(ch_mesh, N_CHANNELS)
    res, walls = {}, {}
    reset_launches()
    _, cruise = session_configs(FS_IN, CRUISE_SUPERBLOCK)
    for form, cfg in pass_b_forms(cruise):
        step = pmesh.make_sharded_batch_step(cfg, ch_mesh,
                                             k_blocks=cfg.superblock)
        st = state_from_numpy({n: data[f"ch_st_{n}"][rows] for n in FIELDS},
                              device)
        st, out = timed_call(walls, f"ch {form}", lambda: step(
            bits[rows], st, t(data["ch_re"]), t(data["ch_im"])))
        res.update({f"ch_{form}_out_{k}": v.cpu().numpy()
                    for k, v in out.items()})
        res.update({f"ch_{form}_st_{k}": v
                    for k, v in state_to_numpy(st).items()})
    for form, cfg in pass_b_forms(random_config(SP_FS, 20, "narrow", True)):
        st = state_from_numpy({n: data[f"sp_st_{n}"] for n in FIELDS},
                              device)
        _, out = timed_call(walls, f"sp {form}", lambda: (
            timeshard.run_block_batched_timesharded(
                cfg, sp_mesh, bits, st, t(data["sp_re"]),
                t(data["sp_im"]))), warm=WARM_CALLS)
        res.update({f"sp_{form}_out_{k}": v.cpu().numpy()
                    for k, v in out.items()})
    found = timed_call(walls, "sharded_pcps", lambda: pmesh.sharded_pcps(
        dop_mesh, acq_re, acq_im, code_k, bins,
        sampling_frequency=FS_IN / DECIMATE), warm=WARM_CALLS)
    for name, v in zip(("doppler", "code_index", "metric"), found):
        res[f"acq_{name}"] = v.cpu().numpy()
    launches = read_launches()
    np.savez(os.path.join(workdir, f"rank{rank}.npz"), **res)
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump({"launches": launches, "walls": walls}, f)
    distributed.shutdown()


def sp_bound(ref, form, n_win, max_prefix) -> float:
    """Time shards against the unsharded block on the card: K1's
    kernel-vs-plain bound (the same stream values, summed in another
    order); in the prefix form, plus two K3 prefix bounds (each epoch is a
    difference of two prefixes)."""
    bound = K1_ATOL + K1_RTOL * float(np.abs(ref).max())
    if form == "prefix":
        bound += 2 * K3_PREFIX_SIGMAS * n_win ** 0.5 * 2.0 ** -24 * max_prefix
    return bound


def mesh_ranks_phase(device, capture, mesh_run, card) -> dict:
    """(b) Two gloo ranks on the card, against the unsharded runs made
    here first (and timed alone)."""
    import torch

    from sydr_tpu_torch.channels import batch_runtime as br
    from sydr_tpu_torch.channels.state import FIELDS, state_from_numpy
    from sydr_tpu_torch.ops import acquisition as acq
    from sydr_tpu_torch.ops import correlator_kernel as ck

    data = mesh_inputs(device, capture, mesh_run)
    bits, code_k, bins, acq_re, acq_im, t = mesh_tensors(data, device)
    refs, ref_walls = {}, {}
    _, cruise = session_configs(FS_IN, CRUISE_SUPERBLOCK)
    for form, cfg in pass_b_forms(cruise):
        st = state_from_numpy({n: data[f"ch_st_{n}"] for n in FIELDS},
                              device)
        st, out = timed_call(ref_walls, f"ch {form}", lambda: (
            br.run_superblock(cfg, cfg.superblock, bits, st,
                              t(data["ch_re"]), t(data["ch_im"]))))
        refs[f"ch_{form}"] = ({k: v.cpu().numpy() for k, v in out.items()},
                              {n: getattr(st, n).cpu().numpy()
                               for n in FIELDS})
    sp_cfg = random_config(SP_FS, 20, "narrow", True)
    for form, cfg in pass_b_forms(sp_cfg):
        st = state_from_numpy({n: data[f"sp_st_{n}"] for n in FIELDS},
                              device)
        _, out = timed_call(ref_walls, f"sp {form}", lambda: (
            br.run_block_batched(cfg, bits, st, t(data["sp_re"]),
                                 t(data["sp_im"]))), warm=WARM_CALLS)
        refs[f"sp_{form}"] = {k: v.cpu().numpy() for k, v in out.items()}
    bins_t = torch.from_numpy(bins).to(device)
    refs["acq"] = [x.cpu().numpy() for x in timed_call(
        ref_walls, "sharded_pcps", lambda: acq.peak_metric(
            acq.pcps_map(acq_re, acq_im, code_k, bins_t,
                         sampling_frequency=FS_IN / DECIMATE),
            bins_t, samples_per_chip=round(FS_IN / DECIMATE / 1.023e6)),
        warm=WARM_CALLS)]

    with tempfile.TemporaryDirectory() as workdir:
        np.savez(os.path.join(workdir, "inputs.npz"), **data)
        ctx = multiprocessing.get_context("spawn")
        port = free_port()
        procs = [ctx.Process(target=mesh_rank,
                             args=(r, MESH_WORLD, port, workdir), daemon=True)
                 for r in range(MESH_WORLD)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(RANK_TIMEOUT_S)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join()
        ranks_wall = time.perf_counter() - t0
        check(all(p.exitcode == 0 for p in procs),
              f"a rank failed: exit codes {[p.exitcode for p in procs]}")
        ranks = []
        for r in range(MESH_WORLD):
            with np.load(os.path.join(workdir, f"rank{r}.npz")) as f:
                got = dict(f)
            with open(os.path.join(workdir, f"rank{r}.json")) as f:
                ranks.append((got, json.load(f)))

    # The channel shards: every output and state row bit for bit.
    per = N_CHANNELS // MESH_WORLD
    ch_diff = []
    for r, (got, _) in enumerate(ranks):
        rows = slice(r * per, (r + 1) * per)
        for form, _ in pass_b_forms(cruise):
            out, st = refs[f"ch_{form}"]
            ch_diff += [(r, form, k) for k, v in out.items()
                        if not np.array_equal(got[f"ch_{form}_out_{k}"],
                                              v[:, rows])]
            ch_diff += [(r, form, n) for n, v in st.items()
                        if not np.array_equal(got[f"ch_{form}_st_{n}"],
                                              v[rows])]
    # The time shards: correlators within the bound, geometry exact, both
    # ranks alike.
    sp_err = {}
    n_win = sp_cfg.window_samples
    for form, cfg in pass_b_forms(sp_cfg):
        ref = refs[f"sp_{form}"]
        st = state_from_numpy({n: data[f"sp_st_{n}"] for n in FIELDS},
                              device)
        inputs, _ = br.pass_b_inputs(cfg, bits, st, br._pass_a(cfg, st))
        prefix = ck.block_cumsum_streams(
            t(data["sp_re"]), t(data["sp_im"]), *inputs, br.taps_for(cfg),
            cfg.samples_per_ms)
        max_prefix = float(prefix.abs().max())
        del prefix
        corr_ref = np.stack([ref[k] for k in CORR_KEYS])
        bound = sp_bound(corr_ref, form, n_win, max_prefix)
        errs = []
        for got, _ in ranks:
            corr = np.stack([got[f"sp_{form}_out_{k}"] for k in CORR_KEYS])
            errs.append(float(np.abs(corr - corr_ref).max()))
            for k in ("active", "required", "unread"):
                check(np.array_equal(got[f"sp_{form}_out_{k}"], ref[k]),
                      f"sp {form}: {k} differs from the unsharded block")
            check(np.array_equal(corr, np.stack(
                [ranks[0][0][f"sp_{form}_out_{k}"] for k in CORR_KEYS])),
                f"sp {form}: the ranks' correlators differ")
        sp_err[form] = (max(errs), bound)
    doppler, code_idx, metric = refs["acq"]
    acq_ok = all(np.array_equal(got["acq_doppler"], doppler)
                 and np.array_equal(got["acq_code_index"], code_idx)
                 and np.allclose(got["acq_metric"], metric, rtol=1e-4)
                 for got, _ in ranks)

    for r, (_, info) in enumerate(ranks):
        print(f"multi-device (b): rank {r} launches {info['launches']}; "
              f"wall " + ", ".join(f"{k} {1e3 * v:.2f} ms"
                                   for k, v in info["walls"].items())
              + f" (warm: the median of {WARM_CALLS} calls after the first)",
              flush=True)
    print("multi-device (b): unsharded on one process, wall " + ", ".join(
        f"{k} {1e3 * v:.2f} ms" for k, v in ref_walls.items())
        + f"; the two ranks took {ranks_wall:.1f} s from spawn to exit, on "
        f"{card}", flush=True)
    print(f"multi-device (b): ch shards ({MESH_WORLD} x {per} of "
          f"{N_CHANNELS} channels, cruise superblock of {CRUISE_SUPERBLOCK} "
          f"blocks, both forms) bit-identical: {not ch_diff}; sp shards "
          f"({MESH_WORLD} x {n_win // sp_cfg.samples_per_ms // MESH_WORLD} "
          f"of {n_win // sp_cfg.samples_per_ms} ms, {SP_FS / 1e6:g} Msps, "
          f"{N_CHANNELS} ch, 6 streams) max_abs_err " + ", ".join(
              f"{form} {e:.3e} (bound {b:.3e})"
              for form, (e, b) in sp_err.items())
          + f"; sharded_pcps (1, 2) Doppler and code index exact, metric "
          f"within 1e-4: {acq_ok}", flush=True)
    check(not ch_diff, f"a channel shard differs from the unsharded "
                       f"superblock: {ch_diff[:5]}")
    check(all(e <= b for e, b in sp_err.values()),
          f"a time shard is outside its bound: {sp_err}")
    check(acq_ok, "sharded_pcps differs from the unsharded map's peak")
    for r, (_, info) in enumerate(ranks):
        n = info["launches"]
        check(n["epoch_correlate"] > 0 and n["block_cumsum_streams"] > 0
              and n["pcps_bins"] == 0 and n["pcps_bins_cluster"] == 0
              and n["pcps_bins_bluestein"] == 0,
              f"rank {r} launched {n}: expected K1 and K3, and no K2")
    launches = {name: sum(info["launches"][name] for _, info in ranks)
                for name in ranks[0][1]["launches"]}
    return {"launches": launches, "sp_cases": sp_shard_cases(data, device)}


def sp_shard_cases(data, device) -> dict:
    """K1 and K3 on shard 0 of the full-rate block's 2 time shards: the
    kernel against its plain version, device and call time, bound."""
    import torch

    from sydr_tpu_torch.channels import batch_runtime as br
    from sydr_tpu_torch.channels.state import FIELDS, state_from_numpy
    from sydr_tpu_torch.ops import correlator_kernel as ck
    from sydr_tpu_torch.parallel import timeshard

    bits = torch.tensor(br.tiled_code_bits(list(range(1, N_CHANNELS + 1))),
                        device=device)
    cfg = random_config(SP_FS, 20, "narrow", True)
    st = state_from_numpy({n: data[f"sp_st_{n}"] for n in FIELDS}, device)
    inputs, bounds = br.pass_b_inputs(cfg, bits, st, br._pass_a(cfg, st))
    code_bits, c_int, omega, code_step, fb_q, phic_q = inputs
    wre = torch.from_numpy(data["sp_re"]).to(device)
    wim = torch.from_numpy(data["sp_im"]).to(device)
    win_re, win_im, fb_l, ph_l, m0 = timeshard.shard_inputs(
        cfg, MESH_WORLD, 0, wre, wim, fb_q, phic_q)
    shard_len = (cfg.tail_ms + cfg.block_ms) // MESH_WORLD \
        * cfg.samples_per_ms
    local = torch.clamp(bounds - m0, 0, shard_len).to(torch.int32)
    taps, spms = br.taps_for(cfg), cfg.samples_per_ms
    k1 = (win_re, win_im, code_bits, c_int, omega, code_step, fb_l, ph_l,
          local.contiguous(), taps, spms)
    k3 = k1[:8] + k1[9:]
    name = (f"sp shard 0 of {MESH_WORLD} ({SP_FS / 1e6:g} Msps, "
            f"{shard_len // spms} of {cfg.tail_ms + cfg.block_ms} ms, "
            f"{N_CHANNELS} ch, {2 * len(taps)} streams)")
    cases = {}

    got, ref = ck.epoch_correlate(*k1), ck.epoch_correlate_ref(*k1)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    bound = K1_ATOL + K1_RTOL * float(ref.abs().max())
    lib_ms, lib_err = segment_reduce_library(k1, ref)
    check(lib_err <= bound, f"K1 {name}: the library yardstick "
          f"(segment_reduce) is off by {lib_err}, above {bound}")
    out, cargs = ck.epoch_correlate_launch_args(*k1)
    fn = ck.KERNEL.function()
    n_samples = int((local[-1] - local[0]).sum())
    cases["epoch_correlate"] = {
        "max_abs_err": err, "ms": device_ms(lambda: fn(*cargs), 200),
        "call_ms": cuda_ms(lambda: ck.epoch_correlate(*k1), 50),
        "plain_ms": cuda_ms(lambda: ck.epoch_correlate_ref(*k1), 5),
        "library_ms": lib_ms,
        **roofline(tensor_bytes(*k1[:9], out),
                   stream_flops(n_samples, len(taps)))}
    report("K1", name, got.shape, f"max_abs_err {err:.3e} (bound "
           f"{bound:.3e}), {n_samples} samples", cases["epoch_correlate"])
    check(err <= bound, f"K1 {name}: error {err} above bound {bound}")

    got, ref = ck.block_cumsum_streams(*k3), ck.block_cumsum_streams_ref(*k3)
    torch.cuda.synchronize()
    n_ch, n_streams, n_win = ref.shape
    err = float((got - ref).abs().max())
    bound = K3_PREFIX_SIGMAS * n_win ** 0.5 * 2.0 ** -24 \
        * float(ref.abs().max())
    out, cargs, _scratch = ck.block_cumsum_streams_launch_args(*k3)
    fn = ck.CUMSUM_KERNEL.function()
    cases["block_cumsum_streams"] = {
        "max_abs_err": err, "ms": device_ms(lambda: fn(*cargs), 100),
        "call_ms": cuda_ms(lambda: ck.block_cumsum_streams(*k3), 20),
        "plain_ms": cuda_ms(lambda: ck.block_cumsum_streams_ref(*k3), 3),
        "library_ms": cumsum_library_ms(k3),
        **roofline(tensor_bytes(*k3[:8], out),
                   stream_flops(n_ch * n_win, n_streams // 2)
                   + float(n_ch * n_streams * n_win))}
    report("K3", name, got.shape, f"prefix max_abs_err {err:.3e} (bound "
           f"{bound:.3e}), {n_win} samples", cases["block_cumsum_streams"])
    check(err <= bound, f"K3 {name}: prefix error {err} above {bound}")
    return cases


def dryrun_phase() -> None:
    """(c) ``python -m sydr_tpu_torch.parallel.dryrun --world 2 --backend
    gloo`` as a child process, on the card."""
    cmd = [sys.executable, "-m", "sydr_tpu_torch.parallel.dryrun",
           "--world", str(MESH_WORLD), "--backend", "gloo"]
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=RANK_TIMEOUT_S)
    text = proc.stdout + proc.stderr
    print("\n".join(ln for ln in text.splitlines()
                    if ln.startswith(("rank ", "dryrun_multichip",
                                      "Traceback"))), flush=True)
    check(proc.returncode == 0,
          f"the dry run exited {proc.returncode}:\n{text[-3000:]}")
    check("dryrun_multichip OK" in proc.stdout, "the dry run printed no OK")


def multi_device_phase(device, capture, session_run, card) -> dict:
    """Phase 14: (a) NCCL at world size 1, (b) two gloo ranks on the card,
    (c) the dry run."""
    mesh_run = timed("multi-device (a)", mesh_session_phase, device,
                     capture, session_run, card)
    res = timed("multi-device (b)", mesh_ranks_phase, device, capture,
                mesh_run, card)
    timed("multi-device (c)", dryrun_phase)
    launches = {name: mesh_run["launches"][name] + res["launches"][name]
                for name in res["launches"]}
    return {"launches": launches, "sp_cases": res["sp_cases"]}


# ---------------------------------------------------------------------------
# Phase 15: the measuring tools
# ---------------------------------------------------------------------------

SOAK_SECONDS = 60       # the soak's shape (tools/soak.py), cut from 300 s
SOAK_WORKERS = 3        # processes making the scenario's signal
SOAK_SUPERBLOCK = 25
ACQ_FS = 4e6            # docs/acq_benchmark.md's command: PRN 7, 5 x 10,
ACQ_TRIALS = 32         # +-5 kHz in 100 Hz bins, threshold 1.5, seed 0
ACQ_CN0 = (30.0, 33.0)
ACQ_PD_30_JAX = 0.41    # docs/acq_benchmark.md (the JAX package, a CPU)
TRACK_CN0 = (45.0, 35.0)  # one kaplan trial each, channel_sweep's seeds
# Depth cut for the timed tools: the profiler's post-processing of a 50
# block superblock's ~285,000 launches takes minutes a form; the per-block
# work is the same at any superblock length.
TRACE_SUPERBLOCK = 5
SCALING_SUPERBLOCK = 10
TOOLS_TIMEOUT_S = 900


def soak_producer(queue, seconds: int, fs: float, workers: int) -> None:
    """Put the soak's scenario at ``fs`` on ``queue`` as ``(re, im)``
    chunks of 1 s, made by ``workers`` processes
    (``soak.scenario_chunks``: the in-line stream's samples), then None. Runs in a child process from the kernel
    checks on, while the earlier phases run; SIGTERM ends it and its
    workers."""
    import signal

    signal.signal(signal.SIGTERM, lambda *_: sys.exit(0))
    sys.path.insert(0, REPO)
    from sydr_tpu_torch.tools.soak import scenario_chunks

    t0 = time.perf_counter()
    for chunk in scenario_chunks(seconds, fs, workers=workers):
        queue.put(chunk)
    queue.put(None)
    print(f"soak producer: {seconds} s of the scenario at {fs / 1e6:g} "
          f"Msps made in {time.perf_counter() - t0:.1f} s by {workers} "
          f"workers", flush=True)


def stop_process(proc) -> None:
    if proc.is_alive():
        proc.terminate()
        proc.join(30)
        if proc.is_alive():
            proc.kill()
            proc.join()


def queued_chunks(queue, producer):
    """The producer's chunks until its None; fails if it died first."""
    import queue as queue_mod

    while True:
        try:
            item = queue.get(timeout=60)
        except queue_mod.Empty:
            check(producer.is_alive(),
                  f"the soak producer exited ({producer.exitcode})")
            continue
        if item is None:
            return
        yield item


def track_trials(results, device_name: str) -> None:
    """The tracking benchmark's trials on the card, in a child process
    that runs beside the soak: one kaplan trial at each of TRACK_CN0, with
    this process's launch counts (from 0)."""
    sys.path.insert(0, REPO)
    import torch

    from sydr_tpu_torch.tools import track_benchmark as tb

    device = torch.device(device_name)
    t0 = time.perf_counter()
    rows = [tb.run_trial(cn0, "kaplan", tb.trial_seed(0, cn0, 0),
                         device=device) for cn0 in TRACK_CN0]
    results.put({"rows": rows, "launches": read_launches(),
                 "wall_s": time.perf_counter() - t0})


def soak_phase(device, soak_queue, producer) -> dict:
    """(a) the soak, 60 s of the production receiver, in this process."""
    from sydr_tpu_torch.tools import soak

    reset_launches()
    res = soak.run_soak(seconds=SOAK_SECONDS, fs=FS_IN, decimate=DECIMATE,
                        use_pallas=True, superblock=SOAK_SUPERBLOCK,
                        device=device,
                        chunks=queued_chunks(soak_queue, producer))
    launches = read_launches()
    print(f"soak: {json.dumps(res)}", flush=True)
    print(f"soak: Doppler drift {res['doppler_drift_hz']} Hz over "
          f"{SOAK_SECONDS} s (not checked: the > 50 Hz bound is for 300 s); "
          f"launches {launches}", flush=True)
    check(soak.within_bounds(res, SOAK_SECONDS),
          f"the soak is outside its bounds: {res}")
    check(launches["epoch_correlate"] > 0 and launches["pcps_bins"] > 0,
          f"the soak did not launch K1 and K2: {launches}")
    return {"launches": launches, "soak": res}


def track_phase(results, tracker) -> dict:
    """(b) the tracking trials' results from their child process."""
    import queue as queue_mod

    try:
        out = results.get(timeout=TOOLS_TIMEOUT_S)
    except queue_mod.Empty:
        fail(f"the tracking trials gave no result (exit {tracker.exitcode})")
    tracker.join(60)
    from sydr_tpu_torch.tools import track_benchmark as tb

    for r in out["rows"]:
        print(f"track_benchmark: {json.dumps(r)}", flush=True)
    print(f"track_benchmark: {len(out['rows'])} trials in "
          f"{out['wall_s']:.1f} s beside the soak, launches "
          f"{out['launches']}", flush=True)
    rows = [{"profile": r["profile"], "cn0_dbhz": r["cn0_dbhz"],
             "retention": float(r["retained"]),
             "pll_lock_mean": r.get("pll_lock_mean", 0.0),
             "cn0_est_mean": r.get("cn0_est_mean", 0.0),
             "slipped_frac": float(abs(r.get("slip_cycles", 0.0)) >= 0.5),
             "ber_mean": r.get("ber", 1.0)} for r in out["rows"]]
    print(tb.render_table(rows), flush=True)
    strong = out["rows"][0]
    check(strong["locked_at_drop"] and strong["retained"]
          and strong["ber"] == 0.0,
          f"kaplan at {TRACK_CN0[0]} dB-Hz not retained with BER 0: {strong}")
    n = out["launches"]
    check(n["epoch_correlate"] > 0 and n["pcps_bins"] > 0,
          f"the tracking trials did not launch K1 and K2: {n}")
    return {"launches": n}


def acq_phase(device) -> dict:
    """(c) the acquisition benchmark: 32 trials at ACQ_CN0 and 32
    signal-absent trials, the seeds of docs/acq_benchmark.md's command."""
    from sydr_tpu_torch.tools import acq_benchmark as ab

    kw = dict(prn=7, trials=ACQ_TRIALS, sampling_frequency=ACQ_FS,
              coherent=5, non_coherent=10, doppler_range=5000.0,
              doppler_step=100.0, threshold=1.5, device=device)
    reset_launches()
    ab.run_config(cn0_dbhz=None, seed=10_000_000, **kw)     # warm-up
    rows = [ab.run_config(cn0_dbhz=cn0, seed=int(round(cn0 * 10)), **kw)
            for cn0 in ACQ_CN0]
    rows.append(ab.run_config(cn0_dbhz=None, seed=1000, **kw))
    launches = read_launches()
    for r in rows:
        print(f"acq_benchmark: {json.dumps(r)}", flush=True)
    print(ab.render_table(rows, 1.5), flush=True)
    rates = ", ".join(f"{r['grid_pts_per_s']:.4g}" for r in rows)
    print(f"acq_benchmark: Pd at 30 dB-Hz {rows[0]['pd']:.2f} (the JAX "
          f"package's table: {ACQ_PD_30_JAX}); grid rate {rates} points/s "
          f"({ACQ_TRIALS} x 101 bins x n={round(ACQ_FS * 1e-3)}, forward "
          f"FFT + K2 + peak between fences); launches {launches}",
          flush=True)
    check(rows[1]["pd"] == 1.0, f"Pd at 33 dB-Hz {rows[1]['pd']} != 1.00")
    check(rows[2]["pfa"] == 0.0, f"Pfa {rows[2]['pfa']} != 0/32")
    check(launches["pcps_bins"] > 0, f"acquisition never ran K2: {launches}")
    return {"launches": launches,
            "grid_pts_per_s": [r["grid_pts_per_s"] for r in rows]}


def trace_phase(device) -> dict:
    """(d) the production superblock's device profile (cut to
    TRACE_SUPERBLOCK blocks) in both boundary forms."""
    from sydr_tpu_torch.tools import trace_profile

    launches = {}
    for mode in ("prefix", "rowsum"):
        reset_launches()
        rec = trace_profile.profile_form(mode, device,
                                         superblock=TRACE_SUPERBLOCK)
        n = read_launches()
        split = rec["pass_split"]
        check(all(split[p]["device_ms"] is not None
                  for p in trace_profile.PASSES)
              and split["pass C"]["device_ms"] > 0,
              f"trace_profile [{mode}]: no device time per pass: {split}")
        kernel = ("block_cumsum_streams" if mode == "prefix"
                  else "epoch_correlate")
        check(n[kernel] > 0, f"trace_profile [{mode}] never ran {kernel}")
        if mode == "prefix":
            check(n["epoch_correlate"] == 0,
                  f"trace_profile [prefix] launched K1: {n}")
        launches[mode] = n
    return {"launches": {k: sum(n[k] for n in launches.values())
                         for k in launches["rowsum"]}}


def scaling_phase(device) -> dict:
    """(e) the per-shard curve: the production step (cut to
    SCALING_SUPERBLOCK blocks) at 32, 16, 8 and 4 channels, 3 timed steps
    each."""
    from sydr_tpu_torch.tools import scaling_bench

    reset_launches()
    res = scaling_bench.chip_section(device, superblock=SCALING_SUPERBLOCK,
                                     n_blocks=3, warmup=1)
    launches = read_launches()
    eff = res["ch_mesh_strong_32ch"]
    check(all(n in eff for n in (2, 4, 8)),
          f"scaling_bench: eff(n) missing: {eff}")
    print(f"scaling_bench: {json.dumps(res)}", flush=True)
    check(launches["epoch_correlate"] > 0,
          f"scaling_bench never ran K1: {launches}")
    return {"launches": launches}


def acq_profile_phase(device) -> dict:
    """(f) both PCPS maps at the bench's acquisition shape."""
    from sydr_tpu_torch.tools import acq_profile

    reset_launches()
    res = acq_profile.profile_maps(device)
    launches = read_launches()
    print(f"acq_profile: {json.dumps(res)}", flush=True)
    check(res["max_rel_diff"] <= K2_RTOL,
          f"acq_profile: the maps differ by {res['max_rel_diff']}")
    check(launches["pcps_bins"] > 0, f"acq_profile never ran K2: {launches}")
    return {"launches": launches}


def tools_phase(device, soak_queue, producer) -> dict:
    """Phase 15: the measuring tools (``sydr_tpu_torch.tools``). The soak
    runs here while a child process runs the tracking trials; the timed
    tools run after both, alone."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    tracker = ctx.Process(target=track_trials, args=(results, str(device)),
                          daemon=True)
    tracker.start()
    paths = {}
    try:
        paths["tools: soak"] = timed("tools: soak", soak_phase, device,
                                     soak_queue, producer)
        paths["tools: track_benchmark"] = timed(
            "tools: track_benchmark (waited for)", track_phase, results,
            tracker)
    finally:
        stop_process(tracker)
    paths["tools: acq_benchmark"] = timed("tools: acq_benchmark", acq_phase,
                                          device)
    paths["tools: trace_profile"] = timed("tools: trace_profile",
                                          trace_phase, device)
    paths["tools: scaling_bench"] = timed("tools: scaling_bench",
                                          scaling_phase, device)
    paths["tools: acq_profile"] = timed("tools: acq_profile",
                                        acq_profile_phase, device)
    return paths


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
    ("pcps_bins_cluster", "pcps_bins_cluster.cu",
     "sydr_tpu/ops/acq_kernel.py:54", "8 ch n=16368",
     "session at 16.368 Msps"),
    ("pcps_bins_bluestein", "pcps_bins_bluestein.cu",
     "sydr_tpu/ops/acq_kernel.py:54", "8 ch n=70000", "session at 70 Msps"),
    ("block_cumsum_streams", "block_cumsum_streams.cu",
     "sydr_tpu/ops/correlator_kernel.py:282",
     "cruise 2.5 Msps 20 ms 6 streams", "prefix receiver"),
)


def path_phases(device, card, soak_queue, producer) -> dict:
    """Phases 4-16; per path, what it returns (its launch counts among
    them)."""
    import torch

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
    # n = 4070 = 2 * 5 * 11 * 37 its generic pass (radix 37).
    for n in (4092, 4070):
        paths[f"session at n={n}"] = timed(
            f"session at n={n}", slice_phase, device, signal_ms=300,
            fs_in=n * 1e3 * DECIMATE, n_channels=8, n_visible=4,
            acq_kernel_name="pcps_bins", settled=False, card=card)
    # A 16.368 Msps front end at full rate: n = 16368 = 2^4 * 3 * 11 * 31,
    # above one block's shared memory, takes K2's cluster entry; K1 runs
    # on every sample.
    res = timed(
        "session at 16.368 Msps", slice_phase, device, signal_ms=300,
        fs_in=16.368e6, decimate=1, n_channels=8, n_visible=4,
        acq_kernel_name="pcps_bins_cluster", settled=False, card=card)
    cfg = res["session"].cfg
    print(f"16.368 Msps: K1 at {cfg.samples_per_ms} samples a ms "
          f"(decimate {cfg.input_decimate})", flush=True)
    check(cfg.samples_per_ms == 16368 and cfg.input_decimate == 1,
          "the 16.368 Msps session did not track at full rate")
    paths["session at 16.368 Msps"] = res
    # A 70 Msps front end at full rate: n = 70000 = 2^4 * 5^4 * 7, above
    # the clusters' 65,536 points, takes K2's Bluestein entry; K1 runs on
    # every sample.
    res = timed(
        "session at 70 Msps", slice_phase, device, signal_ms=300,
        fs_in=70e6, decimate=1, n_channels=8, n_visible=4,
        acq_kernel_name="pcps_bins_bluestein", settled=False, card=card,
        code_index_tol=SESSION_70_CODE_INDEX_TOL)
    from sydr_tpu_torch.ops.acquisition import doppler_bins

    cfg, acq_cfg = res["session"].cfg, res["session"].acq_cfg
    n_bins = len(doppler_bins(acq_cfg.doppler_range, acq_cfg.doppler_step))
    print(f"70 Msps: K1 at {cfg.samples_per_ms} samples a ms (decimate "
          f"{cfg.input_decimate}); K2 at 8 ch x {n_bins} bins x "
          f"{acq_cfg.non_coherent} blocks: "
          f"{bluestein_shape(70000, 8 * n_bins, acq_cfg.non_coherent)}",
          flush=True)
    check(cfg.samples_per_ms == 70000 and cfg.input_decimate == 1,
          "the 70 Msps session did not track at full rate")
    paths["session at 70 Msps"] = res

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
    paths["multi-device"] = timed("multi-device", multi_device_phase,
                                  device, capture, paths["session"], card)
    del capture
    paths.update(timed("tools", tools_phase, device, soak_queue, producer))
    return paths


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

    # The soak's scenario is made in a child process from here on, while
    # the other phases run.
    ctx = multiprocessing.get_context("spawn")
    soak_queue = ctx.Queue()
    producer = ctx.Process(target=soak_producer,
                           args=(soak_queue, SOAK_SECONDS, FS_IN,
                                 SOAK_WORKERS))
    producer.start()
    try:
        paths = path_phases(device, card, soak_queue, producer)
    finally:
        stop_process(producer)

    for name, by_case in cases.items():
        for case, res in by_case.items():
            report("summary", f"{name} | {case}", (),
                   f"max_abs_err {res['max_abs_err']:.3e}", res)
    for name, res in paths["multi-device"]["sp_cases"].items():
        report("summary", f"{name} | sp shard", (),
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
