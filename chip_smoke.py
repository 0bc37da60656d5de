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
   with its cluster size and ``cudaOccupancyMaxActiveClusters``; then a
   sweep over
   the front-end code periods that need a cluster, 12276 to 65536, on the
   entry and cluster that ``kernel_for`` gives, one over lengths with
   prime factors above 31, 1517 = 37 * 41 to 65498 = 2 * 32749, on the
   radix entry that holds the plan (its generic pass), one over the
   lengths above the clusters that take the two-step entry, the
   31-smooth ones 66000 to 2^20 and those of the crossover sweep through
   the tile's generic pass (largest prime factor 37 to 257, 99375 = 3 *
   5^4 * 53 among them), with the Bluestein entry's time at the same
   inputs beside each (the two-step entry must be under it), and one
   over the lengths that take the Bluestein entry, 9722 = 2 * 4861 to
   2^20 - 2 (each with its convolution length M, its split and
   sub-plans), each with ``torch.fft.ifft`` beside it
   (and, on the Bluestein entry, the radix entry's time where one holds
   the plan); the two-step entry at 8 ch x 101 bins x 10 blocks at the
   70 and 99.375 Msps sessions' n = 70000 and 99375 (its pairs in chunks
   of the scratch cap) and at n = 26500 = 2^2 * 5^3 * 53 (where a radix
   plan would take a cluster of 4), the Bluestein entry's time beside
   each, and the Bluestein entry at the same shape at n = 9722; the
   refusal of a prime n
   and of n = 2^20 + 2 before any launch), K3
   ``block_cumsum_streams`` (with its two launches timed apart, the time
   of a kernel that only makes its stores, and a second run that must be
   bit-identical), the geometry kernel ``block_geometry``
   (``ops/geometry_kernel.py``: pass A and pass B's geometry, what XLA
   fuses ahead of the correlation in the JAX package's jitted
   ``run_block_batched``; it replaces no TPU kernel) at the cruise (20
   epochs) and pull-in (5) shapes, 32 channels, every output bit for bit
   the plain version's on 40 states each (``tests/_geometry_inputs.py``:
   chip-boundary ties, carrier phases at 0 and 2 pi, sample deficits
   among them), its device
   time beside its latency bound, and pass C's kernel ``pass_c``
   (``ops/loop_kernel.py``, the JAX package's fused ``lax.scan`` and the
   anchor slew after it; it replaces no TPU kernel) on a
   mid-track block of 32 channels (``tests/_pass_c_inputs.py``) at the
   cruise shape (narrow-only kaplan, 20 epochs) and the pull-in shape
   (kaplan, 5 epochs), every output and the new state bit for bit the
   plain version's, its device time beside the empty launch's and its
   latency bound, and at 1, 2, 4 and 8 warps (channels) a CTA in turns;
   then the same on the shapes where the kernel tiles epochs and spreads
   channels (2, 45 and 64 epochs; 1, 13, 33 and 64 channels; inactive
   stretches, one across two 32-epoch tiles; no epoch active; a
   declaration that moves the bit edge: ``tests/_pass_c_inputs.py``'s
   ``SHAPE_CASES``, each reaching the branches it claims); and the scan
   runtime's kernel ``scan_block`` (``ops/scan_kernel.py``, the JAX
   package's jitted ``lax.scan`` in ``run_block``; it replaces no TPU
   kernel) on a mid-track block of 32 channels x 20 epochs
   (``tests/_scan_inputs.py``: a declaration and a bit completion inside
   it, acquiring channels, a late first epoch) at the scan session's shape
   (2.5 Msps, window 2756, borre), at 10 Msps with kaplan's 5 taps and at
   the classic front end's 16.368 Msps (borre), each channel on a cluster
   of ``SCAN_CLUSTER`` CTAs (printed with the clusters the card runs at
   once), against its plain version under the scan runtime's bounds
   (integers equal, correlators by the tie rule, code phase within 1e-5
   chips, carrier within 0.05 Hz), a second launch bit-identical, the
   kernel's protocol-check build (``SCAN_CHECK_KERNEL``) bit-identical
   and without a fault in ``SCAN_CHECK_LAUNCHES`` launches, with its
   latency bound beside the bytes and operations bound. Each case
   prints four times and a bound:
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
   launch counts are checked. It runs twice, its device step eager
   (``graph=False``) and then as the session's default, one captured CUDA
   graph per configuration replayed on every later step
   (``ops/step_graph.py``): every output and the final state bit for
   bit, the same launch counts, the geometry kernel, K1 and pass C's
   kernel inside the replayed cruise graph (one launch of each a block),
   each graph's capture and instantiation seconds and node count (the
   cruise graph's nodes a block printed); then steady
   cruise superblocks in turns (eager, graphed, graphed, eager) with both
   real-time factors, and the step alone (the replay between CUDA events,
   the eager step between fences). Every later session, receiver and CLI
   run graphs by default, and their launch counts count replays;
6. the receiver through its CLI: ``sydr_tpu_torch.main.main`` on the
   demo sky at the bench's input rate (10 Msps, decimate 4, quantised
   taps, 16 s): a position fix within 10 m of truth (K1 + K2). It runs in
   a child process, a lane beside phases 7-15, and is checked in phase 16
   (see there);
7. the receiver at full width on the prefix form (K3 + K2): 16 s of the
   demo sky written to an int8 IQ file (by a child process, from before
   phase 2 on) and read back through ``RFFileSource``, 32 channels (6 visible),
   ``use_pallas=True, boundary_mode="prefix"`` in both loop shapes:
   acquisition against the scenario's truth, promotion, TOW, fixes within
   10 m, absent PRNs idle, no K1 launch, and K3 inside a replayed graph;
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
    65,536 points) through K2's two-step entry alone, K1 at 70000
    samples a ms, the entry's split and scratch printed; at 99.375 Msps
    (n = 99375 = 3 * 5^4 * 53) through the two-step entry alone and its
    tile's generic pass (radix 53); and at 9.722 Msps (n = 9722 = 2 *
    4861, a prime factor above the radix entries' 233) through K2's
    Bluestein entry alone;
11. the per-ms scan runtime at full width: phase 5's capture (its first
    2 s) through a 32-channel ``TrackingSession`` with ``runtime="scan"``,
    borre loops, 20 ms blocks: acquisition through K2, bit sync and the
    5 Hz carrier bound on the visible channels, one launch of the scan
    kernel a block and no K1, K3 or pass C launch; its real-time factor is
    printed, ``torch.profiler`` over one more block must see the one scan
    kernel on the device, and the step's graph prints its nodes and its
    replay's time a block;
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
    launch the scan kernel once a block and leave a ``.ckpt.npz`` that a
    receiver of the demo's configuration loads;
15. the multi-device layer (``sydr_tpu_torch.parallel``): (a) a one-rank
    NCCL process group, ``TrackingSession(mesh=make_mesh(1, 1))`` on the
    first 2 s of phase 5's capture, its step graphed (the default on NCCL:
    the channel shard's step and its two ``all_gather``s of state and
    outputs captured in one graph) and then eager (``graph=False``), every
    output of every call of each bit for bit phase 5's, with each form's
    graphs (nodes by kind, capture and instantiation seconds, the
    launches and collectives a replay makes), median call and launches;
    both forms over the same steady cruise superblocks in turns with
    their real-time factors, the cruise graph's replay between CUDA events
    beside phase 5's unsharded graph's nodes and replay; the same pair in
    the scan runtime on phase 11's 2 s, bit for bit phase 11's session, one
    scan launch a block; the time-sharded full-rate block (10 Msps, 32
    channels, 4 + 20 ms) and a superblock of 2 on a one-rank NCCL ``sp``
    mesh through ``TimeShardGraph``, captured and replayed, bit for bit the
    eager calls, in both forms of pass B; (b) two gloo ranks sharing the
    card (spawned processes):
    the cruise superblock that follows (a) sharded 16 + 16 channels in
    both forms of pass B (K1, K3), bit for bit the 32-channel superblock;
    the full-rate block (10 Msps, 32 channels, 4 + 20 ms, 6 streams)
    sharded 12 + 12 ms in both forms, within :func:`sp_bound` of the
    unsharded block with the epoch geometry exact; ``sharded_pcps`` on a
    (1, 2) mesh over the production grid, Doppler and code index those of
    the unsharded ``pcps_map`` + ``peak_metric``; each rank's launch
    counts and step times, the unsharded times beside them, and K1 and K3
    on a time shard timed as in phase 3; (c) ``python -m
    sydr_tpu_torch.parallel.dryrun --world 2 --backend gloo`` and
    ``--world 1 --backend nccl`` (its steps captured and held against
    their eager runs), each of which must print its OK line;
16. the measuring tools (``sydr_tpu_torch.tools``): (a) the soak, 60 s of
    the production receiver (10 Msps, decimate 4, kaplan pull-in, the
    narrow-only cruise at superblock 25, quantised taps, seed 3) within the
    soak's fix, prompt-ratio and C/N0 bounds (its Doppler drift is printed:
    the > 50 Hz bound needs 300 s), its scenario made from before phase 2
    on by a child process (``soak.scenario_chunks``, 3 workers); (b) one
    kaplan ``track_benchmark`` trial at 45 dB-Hz (retained, BER 0) and one
    at 35 dB-Hz (printed). The soak, and the CLI of phase 6 followed by
    (b), run in two lanes (child processes, :func:`lanes_of`) started
    after phase 5: host-bound paths that leave the card mostly idle and,
    one after the other, took most of the run's wall. So the walls that
    phases 7-15 print are taken beside them; this phase waits for the
    lanes, checks their results, and then runs (c)-(f) alone; (c)
    ``acq_benchmark``: 32 trials at 30 and 33
    dB-Hz and 32 signal-absent, 4 Msps, 5 x 10 ms (Pd 1.00 at 33 dB-Hz,
    Pfa 0/32; the 30 dB-Hz row and the grid rate printed); (d)
    ``trace_profile``'s superblock (5 blocks) in both boundary forms with
    its pass A/B/C split; (e) ``scaling_bench``'s per-shard curve (10-block
    steps) at 32, 16, 8, 4 channels with eff(n), the step captured as a
    CUDA graph and, beside it in turns, eager; (f) ``acq_profile``'s two
    maps.

Each of phases 5-16 sets every kernel's launch count to 0 just before it
(phase 16: each of its parts) and reads the counts just after (phase 15's
ranks and the lanes' CLI, soak and tracking trials count in their own
processes, from 0). The last three lines are the kernels'
JSON record, the ``nvidia-smi`` line and ``{"ok": true, "device":
{...}}``. Without a CUDA device the script exits non-zero before printing
any result. It imports no JAX.

``python3 chip_smoke.py --kernels`` stops after phase 3 (a developer's
quick check of the kernels; it prints no final result line).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
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
# The most nodes the cruise step's graph may hold: a block's three kernels
# (the geometry, K1, pass C) x CRUISE_SUPERBLOCK, and the step's own
# dequantising, ring and output ops (~64 nodes, torch 2.11 on an H100).
CRUISE_GRAPH_NODES = 300
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
# The same at 99.375 Msps: 0.066 chip = 6.4 samples at 97.1 samples a chip,
# so 2 samples plus 7.
SESSION_99_CODE_INDEX_TOL = 9

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
# Pass C's kernel: operations counted per channel and epoch for its bound
# (the loop update, rails, derotation, bit sync and accumulators, ~150
# arithmetic and compare operations, and two or three accurate atanf, sinf
# and cosf at ~40 each).
PASS_C_EPOCH_OPS = 300
# Its latency bound: the epochs' carried chain, one after the other, each
# PASS_C_CHAIN_OPS dependent operations (filter_step's longest path from
# one epoch's virtual phase to the next: rintf, the compensation, the loop
# filter, the NCO, both carrier clamps, the activity select and the phase
# step; 20 for narrow-only kaplan, 21 for kaplan with its pull-in select,
# PERF.md section 6) at PASS_C_OP_CYCLES cycles each (Hopper's FADD and
# FMUL latency) at the card's largest SM clock, plus the empty launch.
PASS_C_OP_CYCLES = 4
# Pass C's cases: (name, block_ms, TrackingConfig fields, chain ops).
PASS_C_CASES = (
    ("cruise 32 ch x 20 epochs, narrow-only kaplan", 20,
     dict(profile="kaplan", kaplan_narrow_only=True), 20),
    ("pull-in 32 ch x 5 epochs, kaplan", 5, dict(profile="kaplan"), 21))
PASS_C_WARP_SWEEP = (1, 2, 4, 8, 8, 4, 2, 1)
# The geometry kernel (pass A and pass B's geometry): operations counted
# for its bound, per channel and epoch (the epoch boundary's double
# multiply-add, division and ceil, its budget, the code and carrier phases
# with the remainder's ~10, the bounds: ~40) and per channel and anchor
# millisecond (two products, a sum, a difference and a remainder: ~15).
GEOMETRY_EPOCH_OPS = 40
GEOMETRY_ANCHOR_OPS = 15
# Its latency bound: the longest dependent chain from a channel's state to
# its last output, at PASS_C_OP_CYCLES cycles an operation, plus the empty
# launch: the carrier anchors' (omega, 2 products; its remainder over a
# millisecond, a product and ~10 for fmodf; the first epoch's carrier
# phase, 2 products, a sum, a difference, ~10 for its remainder, and the
# activity's select; phic0, a product and 2 sums; the anchor, a product, a
# difference and ~10 for its remainder): 48.
GEOMETRY_CHAIN_OPS = 48
# States a geometry case holds the kernel to its plain version on, ten of
# each of tests/_geometry_inputs.py's kinds (random, ties, carrier phase
# edges, deficits).
GEOMETRY_STATES = 40
# The geometry kernel's cases: (name, fs, block_ms, loops), the Session
# cell's cruise and pull-in shapes at 32 channels.
GEOMETRY_CASES = (
    ("cruise 32 ch x 20 epochs, 2.5 Msps", 2.5e6, 20, "narrow"),
    ("pull-in 32 ch x 5 epochs, 2.5 Msps", 2.5e6, 5, "kaplan"))
# The scan runtime's kernel: operations counted for its bound, per sample
# and channel of an epoch (the carrier phase's 2, accurate cosf and sinf at
# ~15 each, the mix's 6) and per spacing of a sample (the chip index in
# double: 2 and 2 conversions, ceil, clamp; the two products and sums), and
# per channel and epoch the loop update and bookkeeping (pass C's count).
SCAN_SAMPLE_OPS = 38
SCAN_SPACING_OPS = 10
# Its latency bound: each epoch's carried chain, one after the other, at
# PASS_C_OP_CYCLES cycles an operation: SCAN_CHAIN_OPS dependent
# operations from an epoch's start to the next (one sample's phase, cosf,
# mix and product, 25; the loop update from the correlators to the carrier
# and code rate, with the Costas atanf and NNEML's square roots and
# divisions, ~35; the next start's code rate, division and ceil, ~10),
# plus the least depth of any sum of the epoch's n_valid products, a tree
# of ceil(log2(n_valid)) levels of adds: the same work whatever
# implements it.
SCAN_CHAIN_OPS = 70
# The scan kernel's cases: (name, TrackingConfig fields), 32 channels x
# 20 epochs: the scan session's shape, a full-rate front end with kaplan's
# 5 taps, and the classic 16.368 Msps front end (the 16.368 Msps cell's
# rate) at full rate.
SCAN_CASES = (
    ("scan session 32 ch x 20 epochs, 2.5 Msps, borre",
     dict(sampling_frequency=2.5e6, profile="borre", quantize_spacing=True)),
    ("full rate 32 ch x 20 epochs, 10 Msps, kaplan 5 taps",
     dict(sampling_frequency=10e6, profile="kaplan")),
    ("classic front end 32 ch x 20 epochs, 16.368 Msps, borre",
     dict(sampling_frequency=16.368e6, profile="borre")))
# Launches of the scan kernel's protocol-check build a case.
SCAN_CHECK_LAUNCHES = 20
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
    """A random 32-channel tracking state and window: the K1 arguments,
    the geometry from the geometry kernel (``block_geometry_all``)."""
    from sydr_tpu_torch.channels import batch_runtime as br
    from sydr_tpu_torch.ops import geometry_kernel as gk

    cfg, st, wre, wim, bits = random_tracking(fs, block_ms, profile,
                                              quantize, device, rng)
    _, inputs, bounds = gk.block_geometry_all(cfg, st)
    return (wre, wim, bits, *inputs, bounds, br.taps_for(cfg),
            cfg.samples_per_ms)


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


def pass_c_module():
    """``tests/_pass_c_inputs.py``, the pass C blocks shared with the
    tests."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import _pass_c_inputs

    return _pass_c_inputs


def pass_c_inputs(block_ms, extra, device):
    """The mid-track block of ``tests/_pass_c_inputs.py`` at 32 channels
    (bit-sync declarations and bit completions inside it, inactive
    channels, every clamp acting): ``(cfg, state, geo, corr)``."""
    import torch

    from sydr_tpu_torch.channels.runtime import TrackingConfig
    from sydr_tpu_torch.channels.state import state_from_numpy
    from sydr_tpu_torch.ops import geometry_kernel as gk

    cfg = TrackingConfig(sampling_frequency=FS_IN / DECIMATE,
                         block_ms=block_ms, tail_ms=4,
                         window_size=round(FS_IN / DECIMATE * 1e-3) + 256,
                         runtime="batch", quantize_spacing=True, **extra)
    leaves, corr = pass_c_module().mid_track(cfg, N_CHANNELS, SEED % 1000)
    st = state_from_numpy(leaves, device)
    geo, _, _ = gk.block_geometry_all(cfg, st)
    return cfg, st, geo, torch.tensor(corr, device=device)


_SM_CLOCK_HZ: list[float] = []


def sm_clock_hz() -> float:
    """The card's largest SM clock (``nvidia-smi clocks.max.sm``)."""
    if not _SM_CLOCK_HZ:
        proc = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                               "--format=csv,noheader,nounits"],
                              capture_output=True, text=True)
        check(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr}")
        _SM_CLOCK_HZ.append(1e6 * float(proc.stdout.split()[0]))
    return _SM_CLOCK_HZ[0]


def pass_c_latency_ms(block_ms, chain_ops, empty_ms) -> float:
    """Pass C's latency bound: the carried chain of ``block_ms`` epochs
    of ``chain_ops`` dependent operations each (PASS_C_OP_CYCLES cycles an
    operation at the largest SM clock), plus the empty launch."""
    return (1e3 * block_ms * chain_ops * PASS_C_OP_CYCLES / sm_clock_hz()
            + empty_ms)


def pass_c_case(name, block_ms, extra, device, empty_ms, chain_ops=None,
                inputs=None, claims=()):
    """Kernel vs plain pass C (``loop_kernel.pass_c_plain``:
    ``batch_runtime._pass_c`` and the anchor slew) on the card: every
    output and the new state bit for bit. ``inputs``: ``(cfg,
    state, geo, corr)`` (default: :func:`pass_c_inputs`); ``chain_ops``:
    with it, the latency bound and the device time at every warps-a-CTA
    width of PASS_C_WARP_SWEEP in turns; ``claims``: the branches the
    kernel's run must reach (``_pass_c_inputs.CLAIMS``)."""
    import torch

    from sydr_tpu_torch.channels.state import FIELDS
    from sydr_tpu_torch.ops import loop_kernel as lk
    from sydr_tpu_torch.ops import native

    cfg, st, geo, corr = inputs or pass_c_inputs(block_ms, extra, device)
    n_ch = corr.shape[1]
    before = read_launches()
    got_st, got = lk.pass_c(cfg, st, geo, corr)
    launched = {k: v - before[k] for k, v in read_launches().items()
                if v != before[k]}
    check(launched == {"pass_c": 1},
          f"pass C {name}: the wrapper launched {launched}")
    ref_st, ref = lk.pass_c_plain(cfg, st, geo, corr)
    torch.cuda.synchronize()
    pairs = [(k, got[k], ref[k]) for k in ref] + [
        (f"state {f}", getattr(got_st, f), getattr(ref_st, f))
        for f in FIELDS]
    differ, err = {}, 0.0
    for key, a, b in pairs:
        if a.dtype == torch.float32:
            err = max(err, float((a - b).abs().max()))
            a, b = a.view(torch.int32), b.view(torch.int32)
        if not torch.equal(a, b):
            differ[key] = int((a.long() - b.long()).abs().max())
    bufs, cargs = lk.pass_c_launch_args(cfg, st, geo, corr)
    fn = lk.PASS_C_KERNEL.function()
    stream = native.stream_of(corr)
    inputs = [getattr(st, f) for f in FIELDS] + [corr] + [
        geo[k] for k in ("active", "required", "unread_after", "rem_code",
                         "rem_code_end", "rem_carrier_end", "delta",
                         "unread_end")]
    n_bytes = tensor_bytes(*inputs, *bufs.values())
    res = {"max_abs_err": err,
           "ms": device_ms(lambda: fn(*cargs, stream), 200),
           "call_ms": cuda_ms(lambda: lk.pass_c(cfg, st, geo, corr), 50),
           "plain_ms": cuda_ms(lambda: lk.pass_c_plain(cfg, st, geo, corr),
                               5),
           "library_ms": None,
           **roofline(n_bytes, float(block_ms * n_ch * PASS_C_EPOCH_OPS))}
    warps = lk.PASS_C_WARPS
    latency = ""
    if chain_ops is not None:
        res["latency_ms"] = pass_c_latency_ms(block_ms, chain_ops, empty_ms)
        latency = (f"; latency bound {res['latency_ms']:.5f} ms ({chain_ops}"
                   f" chain ops x {PASS_C_OP_CYCLES} cycles x {block_ms} "
                   f"epochs at {sm_clock_hz() / 1e9:.3f} GHz + the empty "
                   f"launch)")
    report("pass C", name, got["i_prompt"].shape,
           f"max_abs_err {err:.3e}, every output and the state "
           f"bit-identical: {not differ}"
           + (f" (differing, max ulp or count: {differ})" if differ else "")
           + f"; {int(got['bit_ready'].sum())} bit completions, "
           f"{int((got_st.flags & 2).ne(st.flags & 2).sum())} declarations; "
           f"{warps} warps a CTA, {lk.slab_bytes(warps, corr.shape[2])} "
           f"bytes of shared memory a CTA; bound {res['bound_ms']:.3e} ms "
           f"({n_bytes} bytes){latency}, the empty launch {empty_ms:.5f} ms",
           res)
    if chain_ops is not None:
        sweep = {}
        for w in PASS_C_WARP_SWEEP:
            _, wargs = lk.pass_c_launch_args(cfg, st, geo, corr, warps=w)
            sweep.setdefault(w, []).append(
                device_ms(lambda: fn(*wargs, stream), 200))
        print(f"pass C {name}: device ms by warps a CTA, in turns "
              f"{PASS_C_WARP_SWEEP}: " + ", ".join(
                  f"{w}: " + " / ".join(f"{ms:.5f}" for ms in v)
                  for w, v in sorted(sweep.items())), flush=True)
    check(all(bool(torch.isfinite(got[k]).all()) for k in got
              if got[k].dtype == torch.float32),
          f"pass C {name}: non-finite output")
    check(not differ, f"pass C {name}: the kernel differs from the plain "
                      f"version in {differ}")
    missed = set(claims) - pass_c_module().reached(st, got_st, got)
    check(not missed, f"pass C {name}: the block did not reach {missed}")
    return res


def geometry_module():
    """``tests/_geometry_inputs.py``, the geometry states shared with the
    tests."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import _geometry_inputs

    return _geometry_inputs


def geometry_case(name, fs, block_ms, profile, device, rng, empty_ms):
    """Kernel vs plain pass A and pass B's geometry
    (``geometry_kernel.geometry_plain``) on the card: every output of
    :data:`GEOMETRY_STATES` states of ``tests/_geometry_inputs.py`` bit
    for bit, the device time of a launch beside the latency bound, the
    call and the plain version."""
    import torch

    from sydr_tpu_torch.ops import geometry_kernel as gk
    from sydr_tpu_torch.ops import native

    cfg = random_config(fs, block_ms, profile, True)
    mod = geometry_module()
    states = [mod.geometry_state(cfg, N_CHANNELS, kind, rng, device)
              for kind in mod.KINDS * (GEOMETRY_STATES // len(mod.KINDS))]
    differ, err, active = {}, 0.0, 0
    for i, st in enumerate(states):
        before = read_launches()
        got = gk.block_geometry_all(cfg, st)
        launched = {k: v - before[k] for k, v in read_launches().items()
                    if v != before[k]}
        check(launched == {"block_geometry": 1},
              f"geometry {name}: the wrapper launched {launched}")
        ref = gk.geometry_plain(cfg, st)
        torch.cuda.synchronize()
        (geo, inputs, bounds), (rgeo, rinputs, rbounds) = got, ref
        pairs = [(k, geo[k], rgeo[k]) for k in rgeo] + [
            (f"input {j}", a, b) for j, (a, b) in enumerate(
                zip(inputs, rinputs))] + [("bounds", bounds, rbounds)]
        for key, a, b in pairs:
            if a.dtype == torch.float32:
                err = max(err, float((a - b).abs().max()))
                a, b = a.view(torch.int32), b.view(torch.int32)
            if not torch.equal(a, b):
                differ[(i, key)] = int((a.long() - b.long()).abs().max())
        active += int(geo["active"][0].sum())
    st = states[0]
    bufs, cargs = gk.geometry_launch_args(cfg, st)
    fn = gk.GEOMETRY_KERNEL.function()
    stream = native.stream_of(st.rem_code)
    fields = [getattr(st, n) for n in gk.STATE_F32 + gk.STATE_I32]
    n_bytes = tensor_bytes(*fields, *bufs.values())
    n_q = cfg.tail_ms + cfg.block_ms
    res = {"max_abs_err": err,
           "ms": device_ms(lambda: fn(*cargs, stream), 200),
           "call_ms": cuda_ms(lambda: gk.block_geometry_all(cfg, st), 50),
           "plain_ms": cuda_ms(lambda: gk.geometry_plain(cfg, st), 10),
           "library_ms": None,
           **roofline(n_bytes, float(N_CHANNELS * (
               block_ms * GEOMETRY_EPOCH_OPS + n_q * GEOMETRY_ANCHOR_OPS))),
           "latency_ms": pass_c_latency_ms(1, GEOMETRY_CHAIN_OPS, empty_ms)}
    report("geometry", name, bufs["seq_f"].shape,
           f"{len(states)} states ({active} of {len(states) * N_CHANNELS} "
           f"channels active), every output bit-identical: {not differ}"
           + (f" (differing, max ulp or count: "
              f"{dict(list(differ.items())[:8])})" if differ else "")
           + f"; {gk.GEO_WARPS} warps a CTA; bound {res['bound_ms']:.3e} ms "
           f"({n_bytes} bytes); latency bound {res['latency_ms']:.5f} ms "
           f"({GEOMETRY_CHAIN_OPS} chain ops x {PASS_C_OP_CYCLES} cycles at "
           f"{sm_clock_hz() / 1e9:.3f} GHz + the empty launch), the empty "
           f"launch {empty_ms:.5f} ms", res)
    check(not differ, f"geometry {name}: the kernel differs from the plain "
                      f"version in {dict(list(differ.items())[:8])}")
    check(0 < active < len(states) * N_CHANNELS,
          f"geometry {name}: {active} channels active: the states do not "
          f"reach both the running and the deferred block")
    return res


def scan_module():
    """``tests/_scan_inputs.py``, the scan blocks shared with the tests."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import _scan_inputs

    return _scan_inputs


def scan_inputs(extra, device):
    """The mid-track scan block of ``tests/_scan_inputs.py`` at 32 channels
    and 20 epochs (a bit-sync declaration and a bit completion inside it,
    acquiring channels, a late first epoch, the rails acting): ``(cfg,
    codes, state, window_re, window_im)``."""
    mod = scan_module()
    cfg = mod.scan_config(**extra)
    return (cfg, *mod.scan_block_tensors(cfg, N_CHANNELS, SEED % 1000,
                                         device))


def scan_latency_ms(cfg, n_valid, empty_ms) -> float:
    """The scan kernel's latency bound: each epoch's carried chain of
    SCAN_CHAIN_OPS operations plus the depth of a tree over its samples'
    products (ceil(log2(n)) levels of adds), at PASS_C_OP_CYCLES cycles an
    operation at the largest SM clock, plus the empty launch. ``n_valid``:
    the samples each epoch sums, the most over the channels
    ``[block_ms]``. No launch shape enters it."""
    depth = sum(SCAN_CHAIN_OPS + max(int(n) - 1, 0).bit_length()
                for n in n_valid)
    return 1e3 * depth * PASS_C_OP_CYCLES / sm_clock_hz() + empty_ms


def scan_case(name, extra, device, empty_ms):
    """Kernel vs plain scan block (``runtime._run_block_plain``) on the
    card under the scan runtime's bounds; a second launch bit-identical to
    the first; the branches of ``tests/_scan_inputs.py`` reached."""
    import torch

    from sydr_tpu_torch.channels import runtime as rt
    from sydr_tpu_torch.channels.state import FIELDS
    from sydr_tpu_torch.ops import native
    from sydr_tpu_torch.ops import profiles as prof
    from sydr_tpu_torch.ops import scan_kernel as sk

    cfg, codes, st, wre, wim = scan_inputs(extra, device)
    n_ch = codes.shape[0]
    before = read_launches()
    got_st, got = rt.run_block(cfg, codes, st, wre, wim)
    launched = {k: v - before[k] for k, v in read_launches().items()
                if v != before[k]}
    check(launched == {"scan_block": 1},
          f"scan {name}: run_block launched {launched}")
    again_st, again = sk.scan_block(cfg, codes, st, wre, wim)
    ref_st, ref = rt._run_block_plain(cfg, codes, st, wre, wim)
    torch.cuda.synchronize()

    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    def same(a_st, a, b_st, b):
        return all(torch.equal(bits(a[k]), bits(b[k])) for k in a) and all(
            torch.equal(bits(getattr(a_st, f)), bits(getattr(b_st, f)))
            for f in FIELDS)

    repeat = same(got_st, got, again_st, again)
    check_faults = dict.fromkeys(sk.PROTOCOL_FAULTS, 0)
    checked_same = 0
    for _ in range(SCAN_CHECK_LAUNCHES):
        (chk_st, chk), faults = sk.check_protocol(cfg, codes, st, wre, wim)
        checked_same += same(chk_st, chk, got_st, got)
        for kind, n in faults.items():
            check_faults[kind] += n
    peak = max(float(wre.abs().max()), float(wim.abs().max()))
    faults, errors = scan_module().bound_faults((got_st, got),
                                                (ref_st, ref), peak)
    missed = {"declare", "bit", "idle", "late"} - scan_module().reached(
        st, got_st, got)

    bufs, cargs = sk.scan_launch_args(cfg, codes, st, wre, wim)
    fn = sk.SCAN_KERNEL.function()
    stream = native.stream_of(wre)
    cluster = sk.SCAN_CLUSTER
    active = sk.max_active_clusters(cfg)
    n_valid = got["required"].clamp(0, cfg.window_size)
    n_bytes = tensor_bytes(*[getattr(st, f) for f in FIELDS], codes, wre,
                           wim, *bufs.values())
    n_sp = len(prof.spacings_for(cfg))
    flops = float(n_valid.sum()) * (SCAN_SAMPLE_OPS
                                    + SCAN_SPACING_OPS * n_sp) \
        + cfg.block_ms * n_ch * PASS_C_EPOCH_OPS
    res = {"max_abs_err": errors.get("correlators", float("nan")),
           "ms": device_ms(lambda: fn(*cargs, stream), 20),
           "call_ms": cuda_ms(lambda: sk.scan_block(cfg, codes, st, wre, wim),
                              20),
           "plain_ms": cuda_ms(
               lambda: rt._run_block_plain(cfg, codes, st, wre, wim), 3),
           "library_ms": None, **roofline(n_bytes, flops),
           "latency_ms": scan_latency_ms(
               cfg, n_valid.max(dim=1).values.tolist(), empty_ms)}
    report("scan", name, got["i_prompt"].shape,
           f"within the scan runtime's bounds: {not faults}; max abs err "
           f"{ {k: float(f'{v:.2e}') for k, v in errors.items()} }; second "
           f"launch bit-identical: {repeat}; protocol check: "
           f"{sum(check_faults.values())} faults, {checked_same} of "
           f"{SCAN_CHECK_LAUNCHES} launches bit-identical; "
           f"{int(got['bit_ready'].sum())} bit completions, "
           f"{int((got_st.flags & 2).ne(st.flags & 2).sum())} declarations; "
           f"C = {cluster} CTAs a channel ({sk.SCAN_THREADS} correlating "
           f"threads and 2 warps each), {active} clusters of {cluster} at "
           f"once on the card (cudaOccupancyMaxActiveClusters; "
           f"{n_ch} channels in {-(-n_ch // active)} wave(s)); bound "
           f"{res['bound_ms']:.3e} ms ({n_bytes} bytes, {flops:.3e} ops); "
           f"latency bound {res['latency_ms']:.5f} ms ({SCAN_CHAIN_OPS} "
           f"chain ops + ceil(log2 n_valid) adds an epoch x {cfg.block_ms} "
           f"epochs x {PASS_C_OP_CYCLES} cycles at "
           f"{sm_clock_hz() / 1e9:.3f} GHz + the empty launch), the empty "
           f"launch {empty_ms:.5f} ms", res)
    check(not faults, f"scan {name}: the kernel differs from the plain "
                      f"version beyond its bounds: {faults}")
    check(repeat, f"scan {name}: a second launch differs from the first")
    check(not any(check_faults.values())
          and checked_same == SCAN_CHECK_LAUNCHES,
          f"scan {name}: the protocol check found {check_faults}, "
          f"{SCAN_CHECK_LAUNCHES - checked_same} launches differ")
    check(not missed, f"scan {name}: the block did not reach {missed}")
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
    if entry == "pcps_bins_twostep":
        bms = entry_ms(spectra, code_k, bin_shifts, "bluestein")
        print(f"   {twostep_shape(n, n_ch * len(bin_shifts), non_coherent)}; "
              f"the Bluestein entry at the same inputs {bms:.4f} ms "
              f"({bms / res['ms']:.2f}x this)", flush=True)
    elif entry == "pcps_bins_bluestein":
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
# Front ends above the clusters' 65,536 points whose code period is
# 31-smooth, at the same shape, on the two-step entry (each took the
# Bluestein entry before it; 80 and 100 Msps stay on a cluster): 66,
# 70 (70000 = 2^4 * 5^4 * 7), 120, 122.88, 131.072, 163.68 (radices 31 and
# 11), 200, 245.52 (245520 = 2^4 * 3^2 * 5 * 11 * 31), 400 and 1000 Msps,
# and 2^20; then the n of the crossover sweep (the tile's generic pass,
# largest prime factor 37, 41, 53, 71, 97, 131, 157, 193, 233 and 257 at
# n ~ 10^5, 99375 = 3 * 5^4 * 53 at 99.375 Msps among them, and 65792 =
# 2^8 * 257 with its prime in the rows), which took the Bluestein entry
# before.
TWOSTEP_SWEEP_N = (66000, 70000, 120000, 122880, 131072, 163680, 200000,
                   245520, 400000, 1000000, 1048576, 99900, 99630, 99375,
                   102240, 99328, 100608, 100480, 98816, 100656, 98688,
                   65792)
# Lengths that take the Bluestein entry, at the same shape: large prime
# factors (9722, 16370, 65498), the first n above the clusters (65538 =
# 2 * 3^2 * 11 * 331), 99300 = 2^2 * 3 * 5^2 * 331 beside 99.375 Msps
# (331 is above TWOSTEP_MAX_PRIME), 131074 = 2 * 65537 and the largest
# even n, 2^20 - 2.
BLUESTEIN_SWEEP_N = (9722, 16370, 65498, 65538, 99300, 131074, 1048574)
# Code periods that no entry takes: a prime (as the JAX package refuses
# a prime above 64) and the first even n above the Bluestein entry's 2^20.
REFUSED_N = (4093, 1048578)


def entry_name(kernel) -> str:
    """The JSON record's name of a K2 entry."""
    return next(name for name, kern in kernels().items() if kern is kernel)


def bluestein_shape(n, pairs, nc) -> str:
    """The Bluestein entry's convolution length, its split and sub-plans,
    and the scratch at ``pairs`` (bin, channel) pairs of ``nc`` blocks, as
    text."""
    from sydr_tpu_torch.ops import acq_kernel

    m, m1, m2 = acq_kernel.bluestein_kernel_for(n)[1]
    chunk = acq_kernel.scratch_chunk_pairs(pairs, nc, m)
    return (f"Bluestein M = {m} = {m1} x {m2} ({m / (2 * n - 1):.4f} x "
            f"(2n - 1)), plans {acq_kernel.sub_plan(m1)} "
            f"{acq_kernel.sub_plan(m2)}, {pairs} pairs in chunks of {chunk}, "
            f"scratch {chunk * nc * m * 8 / 2 ** 20:.1f} MiB")


def twostep_shape(n, pairs, nc) -> str:
    """The two-step entry's split, sub-plans and scratch at ``pairs``
    (bin, channel) pairs of ``nc`` blocks, as text."""
    from sydr_tpu_torch.ops import acq_kernel

    n1, n2, plan1, plan2 = acq_kernel.twostep_kernel_for(n)[1]
    chunk = acq_kernel.scratch_chunk_pairs(pairs, nc, n)
    return (f"two-step n = {n1} x {n2}, plans {plan1} {plan2}, {pairs} pairs "
            f"in chunks of {chunk}, scratch "
            f"{chunk * nc * n * 8 / 2 ** 20:.1f} MiB")


def entry_ms(spec, code, bins, entry) -> float:
    """Device time of the K2 entry ``entry`` (``pcps_bins_launch_args``'
    name) at these inputs: launches of about 50 ms in all."""
    from sydr_tpu_torch.ops import acq_kernel

    kern, _, args = acq_kernel.pcps_bins_launch_args(spec, code, bins,
                                                     entry=entry)
    fn = kern.function()
    return device_ms(lambda: fn(*args),
                     max(2, min(20, int(50 / cuda_ms(lambda: fn(*args), 1)))))


def k2_sweep(device, ns, entry=None) -> dict:
    """K2 at every n of ``ns``, 1 channel x 11 bins x 2 blocks: the
    wrapper must launch the entry ``kernel_for`` gives (and nothing else)
    on its cluster (``entry="radix"``: the radix entry that holds n's
    plan, launched from ``pcps_bins_launch_args``, whichever entry the
    wrapper would take), within 1e-4 of the map's maximum; its plan,
    device time, time through the wrapper (or the launch path), the plain
    version's, the bound and ``torch.fft.ifft``'s time over the same
    product printed, and the device time of another entry at the same
    inputs: on the two-step entry the Bluestein entry's, on the Bluestein
    entry the radix entry's where one holds the plan. Returns the JSON
    record's numbers by case."""
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
        if kernel is acq_kernel.TWOSTEP_KERNEL:
            bms = entry_ms(spec, code, bins, "bluestein")
            where = (f"{twostep_shape(n, 11, 2)}; the Bluestein entry "
                     f"{bms:.4f} ms ({bms / ms:.1f}x this)")
            check(ms < bms, f"K2 sweep n={n}: the two-step entry "
                            f"({ms:.4f} ms) not under the Bluestein entry "
                            f"({bms:.4f} ms)")
        elif kernel is acq_kernel.BLUESTEIN_KERNEL:
            where = bluestein_shape(n, 11, 2)
            plan = (acq_kernel.radix_plan(n) if acq_kernel.has_radix_plan(n)
                    else None)
            if plan is not None and acq_kernel.fitting_cluster(n, plan):
                rms = entry_ms(spec, code, bins, "radix")
                where += (f"; the radix entry (plan {plan}) {rms:.4f} ms")
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
    empty_ms = empty_launch_ms()
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
                                  ("8 ch n=40920", 40.92e6, 8))}
    k2_sweep(device, SWEEP_N)
    k2_sweep(device, GENERIC_SWEEP_N, entry="radix")
    for ns, name in ((TWOSTEP_SWEEP_N, "pcps_bins_twostep"),
                     (BLUESTEIN_SWEEP_N, "pcps_bins_bluestein")):
        check(all(entry_name(acq_kernel.kernel_for(n)[0]) == name
                  for n in ns), f"a length of the {name} sweep took "
                                f"another entry")
    k2t = k2_sweep(device, TWOSTEP_SWEEP_N)
    k2b = k2_sweep(device, BLUESTEIN_SWEEP_N)
    # The 70 Msps session's K2 shape (8 ch x 101 bins x 10 blocks, the
    # pairs in chunks of the scratch cap), and a large prime factor at the
    # same shape on the Bluestein entry.
    k2t["8 ch n=70000"] = k2_case("8 ch n=70000", 70e6, 8,
                                  "pcps_bins_twostep", device, rng)
    # The 99.375 Msps session's shape: the tile's generic pass (radix 53);
    # and 26500 = 2^2 * 5^3 * 53, whose radix plan would take a cluster of
    # 4 (its generic pass), on the same pass.
    k2t["8 ch n=99375"] = k2_case("8 ch n=99375", 99.375e6, 8,
                                  "pcps_bins_twostep", device, rng)
    k2t["8 ch n=26500"] = k2_case("8 ch n=26500", 26.5e6, 8,
                                  "pcps_bins_twostep", device, rng)
    k2b["8 ch n=9722"] = k2_case("8 ch n=9722", 9.722e6, 8,
                                 "pcps_bins_bluestein", device, rng)
    k2_refusal(device)
    k3 = {name: k3_case(name, fs, bm, prof, device, rng)
          for name, fs, bm, prof in (
              ("cruise 2.5 Msps 20 ms 6 streams", 2.5e6, 20, "narrow"),
              ("pull-in 2.5 Msps 5 ms 10 streams", 2.5e6, 5, "kaplan"),
              ("full-rate 10 Msps 20 ms 6 streams", 10e6, 20, "narrow"))}
    geometry = {name: geometry_case(name, fs, bm, prof, device, rng,
                                    empty_ms)
                for name, fs, bm, prof in GEOMETRY_CASES}
    pc = {name: pass_c_case(name, bm, extra, device, empty_ms, chain)
          for name, bm, extra, chain in PASS_C_CASES}
    mod = pass_c_module()
    for name, bm, n_ch, kind, extra, claims in mod.SHAPE_CASES:
        inputs = mod.shaped_block(bm, n_ch, kind, extra, device,
                                  fs=FS_IN / DECIMATE)
        pass_c_case(f"{name} ({n_ch} ch x {bm} epochs, {kind})", bm, extra,
                    device, empty_ms, inputs=inputs, claims=claims)
    scan = {name: scan_case(name, extra, device, empty_ms)
            for name, extra in SCAN_CASES}
    return {"epoch_correlate": k1, "pcps_bins": k2,
            "pcps_bins_cluster": k2c, "pcps_bins_twostep": k2t,
            "pcps_bins_bluestein": k2b, "block_cumsum_streams": k3,
            "block_geometry": geometry, "pass_c": pc, "scan_block": scan}


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
                decimate=DECIMATE, graph=None) -> dict:
    """Drive the port's TrackingSession; check and return what it did.

    ``capture``: ``(sats, re, im)`` of :func:`make_scenario`, made here
    when None. ``acq_kernel_name``: the K2 entry the acquisition must
    launch at this rate, or None when it must launch neither (serial
    search, direct map). ``settled``: the run is long enough for bit
    sync and the 5 Hz carrier bound to be required (and promotion, in the
    batch runtime); a short run checks acquisition and finite outputs
    only. ``runtime``: ``"batch"`` (kaplan pull-in, promotion to cruise;
    K1 must launch) or ``"scan"`` (borre at 20 ms blocks; no K1).
    ``graph``: the session's ``graph=`` (None: its default, a captured CUDA
    graph of the step on the card)."""
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
                              acq_cfg, cruise=cruise, device=device,
                              graph=graph)
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
          f"signal in {cruise_wall_s:.3f} s; step "
          f"{'graphed' if session.graph is not None else 'eager'}) on "
          f"{card}", flush=True)
    print(f"launches on the main path: {launches}", flush=True)

    check(ok, "a visible satellite failed acquisition, bit sync or the "
              "5 Hz carrier bound")
    check(promoted_at is not None or not settled or cruise is None,
          "the session never promoted to cruise")
    check(all(m != MODE_TRACKING for m in absent_modes.values()),
          "an absent PRN is tracking")
    # K1, the geometry and pass C in the batch runtime, the scan kernel in
    # the scan runtime, the named K2 entry, and nothing else.
    expected = {name: name == acq_kernel_name
                or (name in ("epoch_correlate", "block_geometry", "pass_c")
                    and runtime == "batch")
                or (name == "scan_block" and runtime == "scan")
                for name in launches}
    check(all((launches[name] > 0) == hit for name, hit in expected.items()),
          f"the session's path launched {launches}: expected exactly "
          f"{[name for name, hit in expected.items() if hit]}")
    check(runtime != "scan" or launches["scan_block"] == calls,
          f"the scan runtime launched its kernel {launches['scan_block']} "
          f"times in {calls} blocks, not once a block")
    check(launches["block_geometry"] == launches["pass_c"]
          == launches["epoch_correlate"],
          f"the geometry, K1 and pass C did not launch once a block each: "
          f"{launches}")
    check(all(np.isfinite(merged[k]).all() for k in
              ("i_prompt", "q_prompt", "carrier_freq")),
          "non-finite tracking output")
    return {"launches": launches, "rtf": rtf, "promoted_at": promoted_at,
            "session": session, "outputs": outs, "call_walls": call_walls}


# Calls of the steady-state comparison after the paired sessions: eager,
# graphed, graphed, eager, ... on the same cruise superblock of input.
STEADY_TURNS = 2


def graph_stats(session) -> list:
    """One line per captured graph of ``session``: its shape, what its
    capture cost, its nodes and the kernel launches a replay makes."""
    lines = []
    for (cfg, n_in, dtype), entry in session.graph.graphs.items():
        kern = {k.source.removesuffix(".cu"): n
                for k, n in entry.launches.items()}
        lines.append(
            f"{cfg.block_ms} ms x {cfg.superblock} ({n_in} {dtype} inputs): "
            f"capture {entry.capture_s:.3f} s, instantiate "
            f"{entry.instantiate_s:.3f} s, nodes "
            f"{entry.nodes if entry.nodes is not None else 'not measured'}, "
            f"kernel launches a replay {kern}, replays {entry.replays}")
    return lines


def steady_turns(sessions, block_re, block_im):
    """The same input to each of the two ``sessions`` (``{name: session}``,
    both in cruise) in turns, ``2 * STEADY_TURNS`` calls each (a, b, b, a,
    ...): each form's call walls, its real-time factor over their median,
    and whether every call's outputs were bit-identical across forms."""
    import torch

    names = list(sessions)
    walls = {name: [] for name in names}
    same = True
    for turn in range(2 * STEADY_TURNS):
        got = {}
        for name in names if turn % 2 == 0 else names[::-1]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got[name] = sessions[name].process_block(block_re, block_im)
            torch.cuda.synchronize()
            walls[name].append(time.perf_counter() - t0)
        a, b = (got[name] for name in names)
        same &= all(np.array_equal(a[k], b[k]) for k in a)
    signal_s = len(block_re) / FS_IN
    rtf = {name: signal_s / float(np.median(w)) for name, w in walls.items()}
    return walls, rtf, same


def step_alone(session, entry) -> tuple:
    """The graph ``entry`` of ``session``'s cruise step replayed on its
    static inputs three times (ms each, CUDA events), and the eager step
    on the same inputs (ms, fenced wall)."""
    import torch

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    replay_ms = []
    for _ in range(3):
        start.record()
        entry.replay()
        end.record()
        torch.cuda.synchronize()
        replay_ms.append(start.elapsed_time(end))
    inner, _ = session._packed_runs[session.cruise_cfg]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    inner(*entry.inputs)
    torch.cuda.synchronize()
    return replay_ms, 1e3 * (time.perf_counter() - t0)


def session_pair_phase(device, capture, card) -> dict:
    """Phase 5: the Session cell twice, its step eager (``graph=False``)
    and then captured (the default): every output of every call and the
    final state bit for bit, the graphs' capture, instantiation and node
    counts, K1 inside the cruise graph; then steady cruise superblocks in
    turns (eager, graphed, graphed, eager, ...) on the same input, their
    walls and real-time factors, and the step alone (the graph's replay
    between CUDA events; the eager step between fences). Returns the
    graphed run's :func:`slice_phase` result."""
    import torch

    from sydr_tpu_torch.channels.state import pack_state
    from sydr_tpu_torch.ops import correlator_kernel as ck
    from sydr_tpu_torch.ops import geometry_kernel as gk
    from sydr_tpu_torch.ops import loop_kernel as lk

    sync = torch.cuda.synchronize
    eager = slice_phase(device, capture, sync=sync, card=card, graph=False)
    graphed = slice_phase(device, capture, sync=sync, card=card)
    es, gs = eager["session"], graphed["session"]
    check(gs.graph is not None and es.graph is None,
          "the default session did not graph its step, or graph=False did")
    diff = [(i, k) for i, (a, b) in enumerate(zip(eager["outputs"],
                                                   graphed["outputs"]))
            for k in a if not np.array_equal(a[k], b[k])]
    same_state = all(torch.equal(a, b) for a, b in zip(
        pack_state(es.state), pack_state(gs.state))) and torch.equal(
            es._ring_re, gs._ring_re)
    print(f"session pair: {len(graphed['outputs'])} calls; every output "
          f"bit-identical: {not diff}; final state and ring "
          f"bit-identical: {same_state}; launches eager "
          f"{eager['launches']} graphed {graphed['launches']}", flush=True)
    for line in graph_stats(gs):
        print(f"session graph: {line} on {card}", flush=True)
    check(len(eager["outputs"]) == len(graphed["outputs"]) and not diff,
          f"the graphed session differs from the eager one at (call, key) "
          f"{diff[:5]}")
    check(same_state, "the graphed session's final state differs")
    check(eager["launches"] == graphed["launches"],
          "the graphed session's launch counts differ from the eager one's")
    cruise_key = next(k for k in gs.graph.graphs if k[0] is gs.cruise_cfg)
    entry = gs.graph.graphs[cruise_key]
    check(entry.launches.get(ck.KERNEL, 0) == CRUISE_SUPERBLOCK
          and entry.replays > 0,
          f"K1 did not launch inside the replayed cruise graph: "
          f"{graph_stats(gs)}")
    check(entry.launches.get(lk.PASS_C_KERNEL, 0) == CRUISE_SUPERBLOCK,
          f"pass C's kernel did not launch once a block inside the "
          f"replayed cruise graph: {graph_stats(gs)}")
    check(entry.launches.get(gk.GEOMETRY_KERNEL, 0) == CRUISE_SUPERBLOCK,
          f"the geometry kernel did not launch once a block inside the "
          f"replayed cruise graph: {graph_stats(gs)}")
    check(entry.nodes is not None and entry.nodes <= CRUISE_GRAPH_NODES,
          f"the cruise graph holds {entry.nodes} nodes, above "
          f"{CRUISE_GRAPH_NODES}: a block is more than its three kernels")
    print(f"session pair: the cruise graph holds {entry.nodes} nodes "
          f"({entry.node_kinds}) for {CRUISE_SUPERBLOCK} blocks, "
          f"{entry.nodes / CRUISE_SUPERBLOCK:.2f} a block", flush=True)

    # Steady state: both sessions are in cruise; the same superblock of
    # input to each, in turns.
    n_in = gs.block_input_samples
    check(gs.promoted and es.promoted and es.block_input_samples == n_in,
          "the paired sessions are not both in cruise")
    _, sig_re, sig_im = capture
    walls, rtf, same = steady_turns({"eager": es, "graphed": gs},
                                    sig_re[:n_in], sig_im[:n_in])
    replay_ms, eager_step_ms = step_alone(gs, entry)
    signal_s = n_in / FS_IN
    print(f"session pair, steady cruise ({STEADY_TURNS * 2} superblocks "
          f"a form, {signal_s:g} s each, in turns): eager calls "
          f"{[round(w, 4) for w in walls['eager']]} s, RTF "
          f"{rtf['eager']:.4f}; graphed calls "
          f"{[round(w, 4) for w in walls['graphed']]} s, RTF "
          f"{rtf['graphed']:.4f}; graphed / eager "
          f"{rtf['graphed'] / rtf['eager']:.2f}x; outputs bit-identical: "
          f"{same}; the step alone: replay "
          f"{[round(x, 3) for x in replay_ms]} ms (CUDA events) of "
          f"{entry.nodes} nodes, eager "
          f"{eager_step_ms:.1f} ms (fenced wall); on {card}", flush=True)
    check(same, "the steady graphed superblocks differ from the eager ones")
    host_split(gs, sig_re[:n_in], sig_im[:n_in], card)
    graphed.update(steady_rtf=rtf, replay_ms=replay_ms,
                   eager_step_ms=eager_step_ms)
    return graphed


def host_split(session, block_re, block_im, card) -> None:
    """One more graphed cruise call under ``cProfile``: where its host time
    goes. The replay is asynchronous, so the host waits for it in the
    output copy (``Tensor.to``); the rest is the host's own work."""
    import cProfile
    import pstats

    import torch

    torch.cuda.synchronize()
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.runcall(session.process_block, block_re, block_im)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = pstats.Stats(prof)
    rows = sorted(((v[3], f"{k[2]} ({os.path.basename(k[0])}:{k[1]})")
                   for k, v in stats.stats.items()), reverse=True)
    top = "; ".join(f"{name} {1e3 * cum:.1f}" for cum, name in rows[1:13])
    print(f"host split of one graphed cruise call ({1e3 * wall:.1f} ms "
          f"under cProfile), cumulative ms: {top}; on {card}", flush=True)


def scan_block_profile(session, card) -> None:
    """``torch.profiler`` over one block of the scan runtime on the
    session's state: exactly one kernel, the scan kernel, launched and run
    on the card, and its device time (the state is not advanced:
    ``run_block`` returns a new one); then the session's graph of the
    step: its nodes, the launches a replay makes and the replay's time a
    block between CUDA events."""
    import torch

    from sydr_tpu_torch.channels import runtime
    from sydr_tpu_torch.ops import scan_kernel as sk
    from sydr_tpu_torch.tools import trace_profile

    cfg = session.cfg
    window = torch.randn(cfg.window_samples, device=session.device)

    def run():
        runtime.run_block(cfg, session.codes, session.state, window, window)

    run()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    before = sk.SCAN_KERNEL.launches
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        run()
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    launched = sk.SCAN_KERNEL.launches - before
    events = prof.key_averages()
    rows = trace_profile.kernel_rows(events)
    on_device = {e.key: e.count for e in rows}
    n_scan = sum(n for key, n in on_device.items()
                 if "scan_block_kernel" in key)
    device_us = sum(e.self_device_time_total for e in rows)
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    print(f"scan runtime, one {cfg.block_ms} ms block of "
          f"{session.n_channels} channels: {launched} launch of the scan "
          f"kernel; on the device {on_device}; {plain_ms:.3f} ms wall "
          f"({wall_ms:.2f} ms under the profiler), device time "
          f"{device_us / 1e3:.4f} ms "
          f"({100.0 * device_us / 1e3 / plain_ms:.1f}% of the unprofiled "
          f"wall) on {card}", flush=True)
    check(launched == 1 and n_scan == 1,
          f"a scan block ran {on_device} on the device ({launched} "
          f"launches of the scan kernel), not one scan kernel")

    check(session.graph is not None and len(session.graph.graphs) == 1,
          "the scan session did not graph its step")
    entry = next(iter(session.graph.graphs.values()))
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    replay_ms = []
    for _ in range(5):
        start.record()
        entry.replay()
        end.record()
        torch.cuda.synchronize()
        replay_ms.append(start.elapsed_time(end))
    held = {k.source.removesuffix(".cu"): n
            for k, n in entry.launches.items()}
    print(f"scan graph: {entry.nodes} nodes, kernel launches a replay "
          f"{held}, capture {entry.capture_s:.3f} s + instantiation "
          f"{entry.instantiate_s:.3f} s, replay "
          f"{[round(x, 4) for x in replay_ms]} ms a {cfg.block_ms} ms block "
          f"(CUDA events) on {card}", flush=True)
    check(entry.launches == {sk.SCAN_KERNEL: 1},
          f"the scan graph holds {held}, not one scan kernel a block")


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
        scan_before = read_launches()["scan_block"]
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        scan_launches = read_launches()["scan_block"] - scan_before
        print(buf.getvalue().rstrip(), flush=True)
        print(f"cli --runtime scan: {scan_launches} launches of the scan "
              f"kernel in 400 ms of 20 ms blocks", flush=True)
        check(rc == 0, f"the CLI returned {rc}")
        check(scan_launches == 400 // 20,
              f"the CLI's scan runtime launched its kernel {scan_launches} "
              f"times in 20 blocks")
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
    from sydr_tpu_torch.ops import geometry_kernel, loop_kernel, scan_kernel

    return {"epoch_correlate": ck.KERNEL, "pcps_bins": acq_kernel.KERNEL,
            "pcps_bins_cluster": acq_kernel.CLUSTER_KERNEL,
            "pcps_bins_twostep": acq_kernel.TWOSTEP_KERNEL,
            "pcps_bins_bluestein": acq_kernel.BLUESTEIN_KERNEL,
            "block_cumsum_streams": ck.CUMSUM_KERNEL,
            "block_geometry": geometry_kernel.GEOMETRY_KERNEL,
            "pass_c": loop_kernel.PASS_C_KERNEL,
            "scan_block": scan_kernel.SCAN_KERNEL}


def reset_launches() -> None:
    for kern in kernels().values():
        kern.launches = 0


def read_launches() -> dict:
    return {name: kern.launches for name, kern in kernels().items()}


def cli_run() -> dict:
    """The receiver through its CLI on the demo sky at the bench's input
    rate, its stdout captured, and the launches it made (run in a child
    process beside the soak: :func:`background_lane`)."""
    from sydr_tpu_torch import main as cli

    buf = io.StringIO()
    with tempfile.TemporaryDirectory() as out:
        argv = ["--demo", "--fs", f"{FS_IN:g}", "--decimate", str(DECIMATE),
                "--quantize", "--ms", str(RX_MS), "--device", "cuda",
                "--no-dashboard", "--no-report", "--out", out]
        reset_launches()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        launches = read_launches()
    return {"argv": argv, "rc": rc, "text": buf.getvalue(),
            "launches": launches}


def cli_phase(out: dict) -> dict:
    """Phase 6's checks on :func:`cli_run`'s result: stdout echoed, a fix
    within FIX_BOUND_M, K1 and K2 launched."""
    text = out["text"]
    print(f"cli: sydr_tpu_torch.main.main({out['argv']}) in "
          f"{out['wall_s']:.1f} s beside the soak", flush=True)
    print(text.rstrip(), flush=True)
    launches = out["launches"]
    print(f"cli launches on the main path: {launches}", flush=True)
    check(out["rc"] == 0, f"the CLI returned {out['rc']}")
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
    process from before the build on: it is host work only)."""
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
    check(launches["block_cumsum_streams"] > 0 and launches["pcps_bins"] > 0
          and launches["block_geometry"] == launches["pass_c"] > 0,
          f"K3, K2, the geometry or pass C never launched on the prefix "
          f"path, or not once a block: {launches}")
    check(launches["epoch_correlate"] == 0,
          f"K1 launched on the prefix path: {launches}")
    from sydr_tpu_torch.ops import correlator_kernel as ck

    for line in graph_stats(rx.session):
        print(f"prefix receiver graph: {line}", flush=True)
    check(any(entry.launches.get(ck.CUMSUM_KERNEL, 0) > 0
              and entry.replays > 0
              for entry in rx.session.graph.graphs.values()),
          "K3 did not launch inside a replayed graph of the prefix path")
    return {"launches": launches, "fix_errors_m": errors, "wall_s": wall}


# ---------------------------------------------------------------------------
# Phase 15: the multi-device layer
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


def mesh_session_run(device, capture, mesh, runtime, graph, signal_ms):
    """``TrackingSession(mesh=mesh)`` over the first ``signal_ms`` of the
    capture, its step graphed (``graph=None``, the default) or eager:
    every call's outputs and wall, the kernels' and the collectives'
    launches, the session and the samples fed."""
    import torch

    from sydr_tpu_torch.parallel import distributed
    from sydr_tpu_torch.receiver.session import TrackingSession

    _, sig_re, sig_im = capture
    pull_in, cruise = session_configs(FS_IN, CRUISE_SUPERBLOCK, runtime)
    session = TrackingSession(
        pull_in, list(range(1, N_CHANNELS + 1)), cruise=cruise,
        device=device, mesh=mesh, graph=graph)
    outs, walls, pos = [], [], 0
    reset_launches()
    for counter in distributed.COLLECTIVES.values():
        counter.launches = 0
    while pos + session.block_input_samples <= signal_ms * round(
            FS_IN * 1e-3):
        n_in = session.block_input_samples
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(session.process_block(sig_re[pos:pos + n_in],
                                          sig_im[pos:pos + n_in]))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        pos += n_in
    return {"outs": outs, "walls": walls, "launches": read_launches(),
            "collectives": {name: c.launches for name, c
                            in distributed.COLLECTIVES.items()},
            "session": session, "pos": pos}


def outputs_diff(outs, ref) -> list:
    """The (call, key) pairs where ``outs`` and ``ref`` differ."""
    return [(i, k) for i, (got, want) in enumerate(zip(outs, ref))
            for k in set(got) | set(want)
            if k not in got or k not in want
            or not np.array_equal(got[k], want[k])]


def mesh_form_line(name, run, card) -> str:
    """One form's figures: calls, the median call, its graphs (nodes by
    kind, capture and instantiation seconds, launches a replay) and its
    launches."""
    session, walls = run["session"], run["walls"]
    graphs = "eager" if session.graph is None else "; ".join(
        f"{line} (nodes by kind {entry.node_kinds})" for line, entry in zip(
            graph_stats(session), session.graph.graphs.values()))
    return (f"{name}: {len(walls)} calls, first {walls[0]:.3f} s, median "
            f"call {1e3 * np.median(walls):.2f} ms; graphs: {graphs}; "
            f"launches {run['launches']}, collectives "
            f"{run['collectives']}; on {card}")


def replays_in_turns(entries, turns=3) -> dict:
    """Each graph of ``entries`` (``{name: Captured}``) replayed on its
    static inputs in turns (a, b, b, a, ...), ``2 * turns`` times each:
    the ms of every replay (CUDA events), by name."""
    import torch

    names = list(entries)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    ms = {name: [] for name in names}
    for turn in range(2 * turns):
        for name in names if turn % 2 == 0 else names[::-1]:
            start.record()
            entries[name].replay()
            end.record()
            torch.cuda.synchronize()
            ms[name].append(start.elapsed_time(end))
    return ms


def replay_trace(entries, replays=3) -> dict:
    """Each graph of ``entries`` (``{name: Captured}``) replayed
    ``replays`` times, each replay alone under ``torch.profiler`` (CUPTI's
    records of the kernels and copies that a graph launch runs). Per
    graph, the mean over its replays of: the device's events (kernels and
    copies), their busy time (the union of their intervals), the span
    from the first start to the last end and the idle time in it, the
    five longest idle gaps with the events on each side, and the device
    time by event name. Empty where the trace holds no device event."""
    import torch

    from sydr_tpu_torch.tools import trace_profile

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    out = {}
    for name, entry in entries.items():
        runs = []
        for _ in range(replays):
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=acts) as prof:
                entry.replay()
                torch.cuda.synchronize()
            evts = sorted(((e.time_range.start, e.time_range.end, e.key)
                           for e in trace_profile.kernel_rows(prof.events())),
                          key=lambda r: r[0])
            if not evts:
                return {}
            busy, gaps, reach, last = 0.0, [], evts[0][0], evts[0][2]
            for lo, hi, key in evts:
                if lo > reach:
                    gaps.append((lo - reach, last, key))
                busy += max(0.0, hi - max(lo, reach))
                if hi > reach:
                    reach, last = hi, key
            by_name: dict = {}
            for lo, hi, key in evts:
                by_name[key] = by_name.get(key, 0.0) + (hi - lo) / 1e3
            span = (reach - evts[0][0]) / 1e3
            runs.append({"events": len(evts), "copies": sum(
                "memcpy" in k.lower() or "memset" in k.lower()
                for *_, k in evts), "busy_ms": busy / 1e3, "span_ms": span,
                "idle_ms": span - busy / 1e3, "gaps": sorted(gaps)[::-1][:5],
                "by_name": by_name})
        keys = ("events", "copies", "busy_ms", "span_ms", "idle_ms")
        out[name] = {k: float(np.mean([r[k] for r in runs])) for k in keys}
        out[name]["gaps"] = [(round(g / 1e3, 4), a[:40], b[:40])
                             for g, a, b in runs[-1]["gaps"]]
        names = set().union(*(r["by_name"] for r in runs))
        out[name]["by_name"] = {k: float(np.mean([r["by_name"].get(k, 0.0)
                                                  for r in runs]))
                                for k in names}
    return out


def replay_trace_line(trace, base, other) -> str:
    """:func:`replay_trace`'s figures of ``other`` against ``base``, and
    the event names whose device time differs most between the two."""
    if not trace:
        return "the trace holds no device event (not measured)"
    a, b = trace[base], trace[other]
    diff = sorted(((b["by_name"].get(k, 0.0) - a["by_name"].get(k, 0.0), k)
                   for k in set(a["by_name"]) | set(b["by_name"])),
                  key=lambda r: -abs(r[0]))[:8]
    figs = "; ".join(
        f"{name}: {t['events']:.0f} events ({t['copies']:.0f} copies), busy "
        f"{t['busy_ms']:.4f} ms, span {t['span_ms']:.4f} ms, idle "
        f"{t['idle_ms']:.4f} ms, longest gaps (ms, after, before) "
        f"{t['gaps']}" for name, t in ((base, a), (other, b)))
    return (f"{figs}; {other} - {base} by event name, ms: "
            + ", ".join(f"{k[:60]} {d:+.4f}" for d, k in diff))


def mesh_session_phase(device, capture, reference, scan_reference,
                       card) -> dict:
    """(a) ``TrackingSession(mesh=make_mesh(1, 1))`` in a one-rank NCCL
    process group, its step graphed (the default on NCCL: the channel
    shard's step and its two ``all_gather``s captured in one graph) and
    then eager (``graph=False``), over the first MESH_SIGNAL_MS of the
    session's capture: every output of every call bit for bit phase 5's
    unsharded session; then both forms over the same steady cruise
    superblocks in turns, their real-time factors, and the cruise step
    alone (the replay between CUDA events beside phase 5's unsharded
    graph's nodes, then the two graphs replayed in turns); the same pair
    in the scan runtime against phase 11's
    session; then the time-sharded full-rate block and superblock on a
    one-rank NCCL ``sp`` mesh, captured and eager, in both forms of pass
    B (:func:`timeshard_graph_phase`)."""
    from sydr_tpu_torch.channels.state import state_to_numpy
    from sydr_tpu_torch.parallel import distributed, mesh as pmesh
    from sydr_tpu_torch.parallel import timeshard

    distributed.initialize("nccl", rank=0, world_size=1,
                           init_method=f"tcp://127.0.0.1:{free_port()}")
    try:
        mesh = pmesh.make_mesh(1, 1)
        check(mesh.backend == "nccl" and mesh.captures,
              f"the NCCL mesh reads backend {mesh.backend}")
        runs = {name: mesh_session_run(device, capture, mesh, "batch",
                                       graph, MESH_SIGNAL_MS)
                for name, graph in (("graphed", None), ("eager", False))}
        gs, es = runs["graphed"]["session"], runs["eager"]["session"]
        check(gs.graph is not None and es.graph is None,
              "the NCCL mesh session did not graph its step by default, "
              "or graph=False did")
        # (b) reads the superblock that follows, from here.
        pos = runs["eager"]["pos"]
        handoff = {"state": state_to_numpy(es.state),
                   "tail": (es._tail_re.copy(), es._tail_im.copy()),
                   "n_in": es.block_input_samples,
                   "superblock": es.cfg.superblock, "pos": pos}
        ref = reference["outputs"]
        ref_walls = reference["call_walls"][:len(runs["eager"]["outs"])]
        for name, run in runs.items():
            diff = outputs_diff(run["outs"], ref)
            print(f"multi-device (a): nccl, world 1, mesh {mesh.shape}, "
                  + mesh_form_line(name, run, card)
                  + f"; every output bit-identical to phase 5's: "
                  f"{not diff}", flush=True)
            check(len(ref) >= len(run["outs"]) and not diff,
                  f"the {name} mesh session differs from the unsharded one "
                  f"at (call, key) {diff[:5]}")
        print(f"multi-device (a): {len(ref_walls)} calls unsharded (phase "
              f"5, graphed, the same calls): first {ref_walls[0]:.3f} s, "
              f"median call {1e3 * np.median(ref_walls):.2f} ms", flush=True)
        check(not outputs_diff(runs["graphed"]["outs"], runs["eager"]["outs"]),
              "the graphed mesh session differs from the eager one")
        check(gs.promoted and es.promoted, "the mesh session never promoted")
        launches = runs["eager"]["launches"]
        check(launches["epoch_correlate"] > 0 and launches["pcps_bins"] > 0,
              f"K1 or K2 never launched on the mesh session's path: "
              f"{launches}")
        check(runs["graphed"]["launches"] == launches,
              "the graphed mesh session's launch counts differ from the "
              "eager one's")
        gather = distributed.COLLECTIVES["all_gather"]
        calls = len(runs["graphed"]["outs"])
        check(runs["graphed"]["collectives"]["all_gather"] == 2 * calls
              == runs["eager"]["collectives"]["all_gather"],
              f"not two all_gathers a call: {runs['graphed']['collectives']}"
              f" graphed, {runs['eager']['collectives']} eager")
        entry = next(e for k, e in gs.graph.graphs.items()
                     if k[0] is gs.cruise_cfg)
        check(entry.launches.get(gather) == 2,
              f"the cruise graph does not hold the two all_gathers: "
              f"{graph_stats(gs)}")

        # Steady state, both in cruise: the same superblock, in turns.
        _, sig_re, sig_im = capture
        n_in = gs.block_input_samples
        walls, rtf, same = steady_turns({"eager": es, "graphed": gs},
                                        sig_re[:n_in], sig_im[:n_in])
        replay_ms, eager_step_ms = step_alone(gs, entry)
        plain = reference["session"]
        plain_entry = next(e for k, e in plain.graph.graphs.items()
                           if k[0] is plain.cruise_cfg)
        plain_nodes = plain_entry.node_kinds
        turns = replays_in_turns({"unsharded": plain_entry, "mesh": entry})
        trace = replay_trace({"unsharded": plain_entry, "mesh": entry})
        print(f"multi-device (a), steady cruise ({STEADY_TURNS * 2} "
              f"superblocks a form, {n_in / FS_IN:g} s each, in turns): "
              f"eager calls {[round(w, 4) for w in walls['eager']]} s, RTF "
              f"{rtf['eager']:.4f}; graphed calls "
              f"{[round(w, 4) for w in walls['graphed']]} s, RTF "
              f"{rtf['graphed']:.4f}; graphed / eager "
              f"{rtf['graphed'] / rtf['eager']:.2f}x; outputs "
              f"bit-identical: {same}; the step alone: replay "
              f"{[round(x, 3) for x in replay_ms]} ms (CUDA events) of "
              f"{entry.nodes} nodes {entry.node_kinds} (phase 5's unsharded "
              f"cruise graph: {sum(plain_nodes.values())} nodes "
              f"{plain_nodes}; its replay {reference['replay_ms']} ms), "
              f"eager {eager_step_ms:.1f} ms (fenced wall); the two graphs "
              f"replayed in turns, ms: " + ", ".join(
                  f"{name} {[round(x, 3) for x in ms]}"
                  for name, ms in turns.items()) + f"; on {card}",
              flush=True)
        print(f"multi-device (a), one replay of each cruise graph under "
              f"torch.profiler (mean of 3): "
              + replay_trace_line(trace, "unsharded", "mesh")
              + f"; on {card}", flush=True)
        check(same and entry.replays > 0, "the steady graphed mesh "
                                          "superblocks differ from the eager "
                                          "ones, or did not replay")

        # The scan runtime's mesh step, against phase 11's session.
        scan = {name: mesh_session_run(device, capture, mesh, "scan", graph,
                                       SCAN_SIGNAL_MS)
                for name, graph in (("graphed", None), ("eager", False))}
        for name, run in scan.items():
            diff = outputs_diff(run["outs"], scan_reference["outputs"])
            print(f"multi-device (a), scan runtime: "
                  + mesh_form_line(name, run, card)
                  + f"; every output bit-identical to phase 11's: "
                  f"{not diff}", flush=True)
            check(len(run["outs"]) == len(scan_reference["outputs"])
                  and not diff, f"the {name} scan mesh session differs "
                  f"from the unsharded one at (call, key) {diff[:5]}")
            check(run["launches"]["scan_block"] == len(run["outs"]),
                  f"the {name} scan mesh session did not launch the scan "
                  f"kernel once a block: {run['launches']}")
        ts_launches = timeshard_graph_phase(
            device, timeshard.make_sp_mesh(), card)
    finally:
        distributed.shutdown()
    launches = {name: sum(run["launches"][name]
                          for run in (*runs.values(), *scan.values()))
                + ts_launches[name] for name in launches}
    return {"launches": launches, "handoff": handoff}


def timeshard_graph_phase(device, sp_mesh, card) -> dict:
    """The full-rate block (10 Msps, 32 channels, 4 + 20 ms) and a
    superblock of 2 such blocks on the ``sp`` mesh through
    ``TimeShardGraph`` (graphed on NCCL) and eagerly, in both forms of
    pass B: the capture's call and two replays, each on the state the
    eager call before it left, bit for bit the eager call; the graphs'
    nodes, the replay between CUDA events and the eager call's fenced
    wall. Returns the kernels' launches."""
    import torch

    from sydr_tpu_torch.parallel import timeshard

    reset_launches()
    _, st0, wre, wim, bits = random_tracking(
        SP_FS, 20, "narrow", True, device, np.random.default_rng(SEED + 15))
    for form, cfg in pass_b_forms(random_config(SP_FS, 20, "narrow", True)):
        spms = cfg.samples_per_ms
        sre = torch.cat([wre, wre[cfg.tail_ms * spms:]])
        sim = torch.cat([wim, wim[cfg.tail_ms * spms:]])
        runner = timeshard.TimeShardGraph(sp_mesh, device)
        check(runner.graph is not None,
              "the time shards on NCCL did not graph by default")
        calls = {
            "block": (lambda s: runner.block(cfg, bits, s, wre, wim),
                      lambda s: timeshard.run_block_batched_timesharded(
                          cfg, sp_mesh, bits, s, wre, wim)),
            "superblock of 2": (
                lambda s: runner.superblock(cfg, 2, bits, s, sre, sim),
                lambda s: timeshard.run_superblock_timesharded(
                    cfg, sp_mesh, 2, bits, s, sre, sim))}
        for name, (graphed, eager) in calls.items():
            state, same, eager_ms = st0, True, []
            for _ in range(3):
                got = graphed(state)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                want = eager(state)
                torch.cuda.synchronize()
                eager_ms.append(1e3 * (time.perf_counter() - t0))
                same &= all(torch.equal(got[1][k], want[1][k])
                            for k in want[1]) and all(
                    torch.equal(getattr(got[0], f.name),
                                getattr(want[0], f.name))
                    for f in dataclasses.fields(want[0]))
                state = want[0]
            entry = list(runner.graph.graphs.values())[-1]
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            entry.replay()
            end.record()
            torch.cuda.synchronize()
            kern = {k.source.removesuffix(".cu"): n
                    for k, n in entry.launches.items()}
            print(f"multi-device (a), time shards on nccl world 1: {form} "
                  f"{name} ({SP_FS / 1e6:g} Msps, {N_CHANNELS} ch): "
                  f"captured and two replays bit-identical to eager: {same}; "
                  f"graph {entry.nodes} nodes {entry.node_kinds}, capture "
                  f"{entry.capture_s:.3f} s, instantiate "
                  f"{entry.instantiate_s:.3f} s, launches a replay {kern}; "
                  f"replay {start.elapsed_time(end):.3f} ms (CUDA events), "
                  f"eager calls {[round(x, 3) for x in eager_ms]} ms (fenced "
                  f"wall); on {card}", flush=True)
            check(same, f"the captured time-sharded {form} {name} differs "
                        f"from the eager one")
    return read_launches()


def mesh_inputs(device, capture, mesh_run) -> dict:
    """(b)'s inputs as numpy: the cruise superblock that follows (a) (its
    promoted state and the next second of the capture, decimated, after
    the session's tail), a random full-rate block (the kernel phase's
    state at 10 Msps, 20 ms, 6 streams) and the first 50 ms of the
    capture, decimated, for the acquisition."""
    from sydr_tpu_torch.channels.state import state_to_numpy

    handoff = mesh_run["handoff"]
    pos, n_in, (tail_re, tail_im) = (handoff[k] for k in ("pos", "n_in",
                                                          "tail"))
    _, sig_re, sig_im = capture
    check(handoff["superblock"] == CRUISE_SUPERBLOCK
          and pos + n_in <= len(sig_re),
          "(a) did not leave a cruise superblock of the capture")

    def decimated(x, lo, n):
        return np.float32(x[lo:lo + n]).reshape(-1, DECIMATE).sum(axis=1)

    data = {"ch_re": np.concatenate([tail_re, decimated(sig_re, pos, n_in)]),
            "ch_im": np.concatenate([tail_im, decimated(sig_im, pos, n_in)])}
    data.update({f"ch_st_{k}": v for k, v in handoff["state"].items()})
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
    from sydr_tpu_torch.ops import geometry_kernel as gk

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
        _, inputs, _ = gk.block_geometry_all(cfg, st)
        prefix = ck.block_cumsum_streams(
            t(data["sp_re"]), t(data["sp_im"]), bits, *inputs,
            br.taps_for(cfg), cfg.samples_per_ms)
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
              and n["pass_c"] > 0 and n["block_geometry"] == n["pass_c"]
              and n["pcps_bins"] == 0 and n["pcps_bins_cluster"] == 0
              and n["pcps_bins_twostep"] == 0
              and n["pcps_bins_bluestein"] == 0,
              f"rank {r} launched {n}: expected K1, K3, the geometry and "
              f"pass C (once a block), and no K2")
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
    from sydr_tpu_torch.ops import geometry_kernel as gk
    from sydr_tpu_torch.parallel import timeshard

    bits = torch.tensor(br.tiled_code_bits(list(range(1, N_CHANNELS + 1))),
                        device=device)
    cfg = random_config(SP_FS, 20, "narrow", True)
    st = state_from_numpy({n: data[f"sp_st_{n}"] for n in FIELDS}, device)
    _, inputs, bounds = gk.block_geometry_all(cfg, st)
    c_int, omega, code_step, fb_q, phic_q = inputs
    code_bits = bits
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
    """(c) ``python -m sydr_tpu_torch.parallel.dryrun`` as a child process
    on the card, twice: ``--world 2 --backend gloo`` (two ranks share the
    card; no graph) and ``--world 1 --backend nccl`` (the steps and their
    collectives captured, held against their eager runs)."""
    for world, backend, graphs in ((MESH_WORLD, "gloo", "none"),
                                   (1, "nccl", "captured")):
        cmd = [sys.executable, "-m", "sydr_tpu_torch.parallel.dryrun",
               "--world", str(world), "--backend", backend]
        proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                              timeout=RANK_TIMEOUT_S)
        text = proc.stdout + proc.stderr
        print("\n".join(ln for ln in text.splitlines()
                        if ln.startswith(("rank ", "dryrun_multichip",
                                          "Traceback"))), flush=True)
        check(proc.returncode == 0, f"the {backend} dry run exited "
                                    f"{proc.returncode}:\n{text[-3000:]}")
        check("dryrun_multichip OK" in proc.stdout
              and f"graphs={graphs}" in proc.stdout,
              f"the {backend} dry run printed no OK with graphs={graphs}")


def multi_device_phase(device, capture, session_run, scan_run,
                       card) -> dict:
    """Phase 15: (a) NCCL at world size 1, its steps graphed and eager,
    (b) two gloo ranks on the card, (c) the dry run."""
    mesh_run = timed("multi-device (a)", mesh_session_phase, device,
                     capture, session_run, scan_run, card)
    res = timed("multi-device (b)", mesh_ranks_phase, device, capture,
                mesh_run, card)
    timed("multi-device (c)", dryrun_phase)
    launches = {name: mesh_run["launches"][name] + res["launches"][name]
                for name in res["launches"]}
    return {"launches": launches, "sp_cases": res["sp_cases"]}


# ---------------------------------------------------------------------------
# Phase 16: the measuring tools
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
    (``soak.scenario_chunks``: the in-line stream's samples), then None;
    a fault puts its traceback. Runs in a child process from before the
    build on, so that the soak reads made chunks; SIGTERM ends it and its
    workers."""
    import signal
    import traceback

    signal.signal(signal.SIGTERM, lambda *_: sys.exit(0))
    sys.path.insert(0, REPO)
    t0 = time.perf_counter()
    try:
        from sydr_tpu_torch.tools.soak import scenario_chunks

        for chunk in scenario_chunks(seconds, fs, workers=workers):
            queue.put(chunk)
    except Exception:
        queue.put(traceback.format_exc())
        return
    queue.put(None)
    print(f"soak producer: {seconds} s of the scenario at {fs / 1e6:g} "
          f"Msps made in {time.perf_counter() - t0:.1f} s by {workers} "
          f"workers", flush=True)


def queued_chunks(queue):
    """The producer's chunks until its None; raises at its fault, or when
    no chunk comes for 300 s."""
    while True:
        item = queue.get(timeout=300)
        if item is None:
            return
        if isinstance(item, str):
            raise RuntimeError(f"the soak producer failed:\n{item}")
        yield item


def soak_run(soak_queue) -> dict:
    """(a) the soak, SOAK_SECONDS of the production receiver on the
    producer's chunks (:func:`soak_producer`)."""
    from sydr_tpu_torch.tools import soak

    reset_launches()
    res = soak.run_soak(
        seconds=SOAK_SECONDS, fs=FS_IN, decimate=DECIMATE, use_pallas=True,
        superblock=SOAK_SUPERBLOCK, device="cuda",
        chunks=queued_chunks(soak_queue))
    return {"soak": res, "launches": read_launches()}


def track_run() -> dict:
    """(b) the tracking benchmark: one kaplan trial at each of TRACK_CN0."""
    from sydr_tpu_torch.tools import track_benchmark as tb

    reset_launches()
    rows = [tb.run_trial(cn0, "kaplan", tb.trial_seed(0, cn0, 0),
                         device="cuda") for cn0 in TRACK_CN0]
    return {"rows": rows, "launches": read_launches()}


def lanes_of(soak_queue) -> tuple:
    """The paths that run in child processes beside phases 7-15, one lane a
    process, its jobs in order: each is host-bound and leaves the card
    mostly idle, and one after the other they took most of the run."""
    return ((functools.partial(soak_run, soak_queue),), (cli_run, track_run))


def job_name(job) -> str:
    return getattr(job, "func", job).__name__


def background_lane(results, jobs) -> None:
    """Run ``jobs`` in order, in a child process, putting ``(name,
    result)`` on ``results`` after each, the result with its wall
    ``wall_s``; a fault puts ``(name, {"error": traceback})`` and ends the
    lane. The launch counts are this process's, from 0. SIGTERM ends the
    lane."""
    import signal
    import traceback

    signal.signal(signal.SIGTERM, lambda *_: sys.exit(0))
    sys.path.insert(0, REPO)
    for job in jobs:
        t0 = time.perf_counter()
        try:
            out = job()
        except (Exception, SystemExit):
            results.put((job_name(job), {"error": traceback.format_exc()}))
            return
        out["wall_s"] = time.perf_counter() - t0
        results.put((job_name(job), out))


def start_lanes(soak_queue):
    """Start the lanes of :func:`lanes_of`; their results queue, their
    processes and the names of their jobs."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    lanes = lanes_of(soak_queue)
    procs = [ctx.Process(target=background_lane, args=(results, jobs),
                         daemon=True) for jobs in lanes]
    for proc in procs:
        proc.start()
    return results, procs, {job_name(job) for jobs in lanes for job in jobs}


def lane_results(results, procs, want) -> dict:
    """Every lane job's result by name; fails at a job's fault, or when the
    lanes end or TOOLS_TIMEOUT_S pass without all of them."""
    import queue as queue_mod

    got = {}
    deadline = time.perf_counter() + TOOLS_TIMEOUT_S
    while len(got) < len(want):
        missing = sorted(want - set(got))
        try:
            name, out = results.get(timeout=30)
        except queue_mod.Empty:
            check(time.perf_counter() < deadline,
                  f"no result from {missing} in {TOOLS_TIMEOUT_S} s")
            check(any(proc.is_alive() for proc in procs),
                  f"the lanes ended without {missing} (exit codes "
                  f"{[proc.exitcode for proc in procs]})")
            continue
        check("error" not in out, f"{name} failed:\n{out.get('error')}")
        got[name] = out
    for proc in procs:
        proc.join(60)
    return got


def stop_process(proc) -> None:
    if proc.is_alive():
        proc.terminate()
        proc.join(30)
        if proc.is_alive():
            proc.kill()
            proc.join()


def soak_phase(out: dict) -> dict:
    """(a)'s checks on :func:`soak_run`'s result."""
    from sydr_tpu_torch.tools import soak

    res, launches = out["soak"], out["launches"]
    print(f"soak: {json.dumps(res)}", flush=True)
    print(f"soak: Doppler drift {res['doppler_drift_hz']} Hz over "
          f"{SOAK_SECONDS} s (not checked: the > 50 Hz bound is for 300 s); "
          f"{out['wall_s']:.1f} s beside phases 7-15; launches {launches}",
          flush=True)
    check(soak.within_bounds(res, SOAK_SECONDS),
          f"the soak is outside its bounds: {res}")
    check(launches["epoch_correlate"] > 0 and launches["pcps_bins"] > 0,
          f"the soak did not launch K1 and K2: {launches}")
    return {"launches": launches, "soak": res}


def track_phase(out: dict) -> dict:
    """(b)'s checks on :func:`track_run`'s result."""
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
    each, captured as a CUDA graph (the primary curve) and eager beside
    it, in turns."""
    from sydr_tpu_torch.tools import scaling_bench

    reset_launches()
    res = scaling_bench.chip_section(device, superblock=SCALING_SUPERBLOCK,
                                     n_blocks=3, warmup=1)
    launches = read_launches()
    for suffix in ("", "_eager"):
        eff = res[f"ch_mesh_strong_32ch{suffix}"]
        check(all(n in eff for n in (2, 4, 8)),
              f"scaling_bench: eff{suffix}(n) missing: {eff}")
    check(res["graph"] == "captured", "scaling_bench did not graph its step")
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


def tools_phase(device, lanes) -> dict:
    """Phase 16: the measuring tools (``sydr_tpu_torch.tools``). The soak
    and the tracking trials ran in the lanes beside phases 7-15 (with the
    CLI of phase 6); their results are waited for and checked here, and
    the timed tools run after them, alone."""
    got = timed("lanes (waited for)", lane_results, *lanes)
    paths = {"cli": cli_phase(got["cli_run"]),
             "tools: soak": soak_phase(got["soak_run"]),
             "tools: track_benchmark": track_phase(got["track_run"])}
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
    ("pcps_bins_twostep", "pcps_bins_twostep.cu",
     "sydr_tpu/ops/acq_kernel.py:54", "8 ch n=70000", "session at 70 Msps"),
    ("pcps_bins_bluestein", "pcps_bins_bluestein.cu",
     "sydr_tpu/ops/acq_kernel.py:54", "8 ch n=9722",
     "session at 9.722 Msps"),
    ("block_cumsum_streams", "block_cumsum_streams.cu",
     "sydr_tpu/ops/correlator_kernel.py:282",
     "cruise 2.5 Msps 20 ms 6 streams", "prefix receiver"),
    # No TPU kernel: what XLA fuses ahead of the correlation in the JAX
    # run_block_batched (its pass A's closed form, intercept and anchors).
    ("block_geometry", "block_geometry.cu",
     "sydr_tpu/channels/batch_runtime.py:197", GEOMETRY_CASES[0][0], "cli"),
    # No TPU kernel: the XLA-fused lax.scan of the JAX pass C.
    ("pass_c", "pass_c.cu", "sydr_tpu/channels/batch_runtime.py:1205",
     PASS_C_CASES[0][0], "cli"),
    # No TPU kernel: the jitted lax.scan of the JAX run_block.
    ("scan_block", "scan_block.cu", "sydr_tpu/channels/runtime.py:468",
     SCAN_CASES[0][0], "scan session"),
)


def path_phases(device, card, sky, writer, soak_queue) -> dict:
    """Phases 4-16; per path, what it returns (its launch counts among
    them). ``writer`` is the child process writing the demo sky's IQ file
    ``sky``; the soak reads its scenario from ``soak_queue``."""
    import torch

    timed("parity", parity_phase, device)
    paths = {}
    rng = np.random.default_rng(SEED)
    capture = make_scenario(rng, SIGNAL_MS, FS_IN, N_CHANNELS, N_VISIBLE)
    paths["session"] = timed(
        "session", session_pair_phase, device, capture, card)
    lanes = start_lanes(soak_queue)
    try:
        paths.update(more_phases(device, card, sky, writer, capture, lanes,
                                 paths["session"]))
    finally:
        for proc in lanes[1]:
            stop_process(proc)
    return paths


def more_phases(device, card, sky, writer, capture, lanes,
                session_run) -> dict:
    """Phases 7-16, the lanes running beside phases 7-15."""
    import torch

    paths = {}
    t0 = time.perf_counter()
    writer.join()
    print(f"waited {time.perf_counter() - t0:.1f} s for the IQ file",
          flush=True)
    check(writer.exitcode == 0,
          f"writing the IQ file failed ({writer.exitcode})")
    paths["prefix receiver"] = timed(
        "prefix receiver", prefix_receiver_phase, device, sky)
    paths["checkpoint"] = timed("checkpoint", checkpoint_phase, device, sky,
                                card)
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
    # the clusters' 65,536 points, takes K2's two-step entry; K1 runs on
    # every sample.
    res = timed(
        "session at 70 Msps", slice_phase, device, signal_ms=300,
        fs_in=70e6, decimate=1, n_channels=8, n_visible=4,
        acq_kernel_name="pcps_bins_twostep", settled=False, card=card,
        code_index_tol=SESSION_70_CODE_INDEX_TOL)
    from sydr_tpu_torch.ops.acquisition import doppler_bins

    cfg, acq_cfg = res["session"].cfg, res["session"].acq_cfg
    n_bins = len(doppler_bins(acq_cfg.doppler_range, acq_cfg.doppler_step))
    print(f"70 Msps: K1 at {cfg.samples_per_ms} samples a ms (decimate "
          f"{cfg.input_decimate}); K2 at 8 ch x {n_bins} bins x "
          f"{acq_cfg.non_coherent} blocks: "
          f"{twostep_shape(70000, 8 * n_bins, acq_cfg.non_coherent)}",
          flush=True)
    check(cfg.samples_per_ms == 70000 and cfg.input_decimate == 1,
          "the 70 Msps session did not track at full rate")
    paths["session at 70 Msps"] = res
    # A 99.375 Msps front end at full rate: n = 99375 = 3 * 5^4 * 53 takes
    # K2's two-step entry through its tile's generic pass (radix 53).
    res = timed(
        "session at 99.375 Msps", slice_phase, device, signal_ms=300,
        fs_in=99.375e6, decimate=1, n_channels=8, n_visible=4,
        acq_kernel_name="pcps_bins_twostep", settled=False, card=card,
        code_index_tol=SESSION_99_CODE_INDEX_TOL)
    acq_cfg = res["session"].acq_cfg
    print(f"99.375 Msps: K2 at 8 ch x {n_bins} bins x "
          f"{acq_cfg.non_coherent} blocks: "
          f"{twostep_shape(99375, 8 * n_bins, acq_cfg.non_coherent)}",
          flush=True)
    check(res["session"].cfg.samples_per_ms == 99375,
          "the 99.375 Msps session did not track at full rate")
    paths["session at 99.375 Msps"] = res
    # n = 9722 = 2 * 4861: a prime factor above GENERIC_MAX_PRIME takes
    # K2's Bluestein entry.
    res = timed(
        "session at 9.722 Msps", slice_phase, device, signal_ms=300,
        fs_in=9.722e6, decimate=1, n_channels=8, n_visible=4,
        acq_kernel_name="pcps_bins_bluestein", settled=False, card=card)
    check(res["session"].cfg.samples_per_ms == 9722,
          "the 9.722 Msps session did not track at full rate")
    paths["session at 9.722 Msps"] = res

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
                                  device, capture, session_run,
                                  paths["scan session"], card)
    paths.update(timed("tools", tools_phase, device, lanes))
    return paths


def build_and_run(device, card, opts, sky, writer, soak_queue):
    """Phases 2-16: the kernel phase's cases and the paths' results, or
    None after phase 3 with ``--kernels``."""
    from sydr_tpu_torch.ops import correlator_kernel, native

    t0 = time.perf_counter()
    from sydr_tpu_torch.ops import scan_kernel

    built = [*kernels().values(), native.EMPTY_LAUNCH,
             correlator_kernel.STORE_CEILING, scan_kernel.SCAN_CHECK_KERNEL]
    native.build_all(built)
    for kern in built:
        usage = [ln.strip() for ln in kern.build_log.splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"built {kern.source} in {kern.build_seconds or 0:.2f} s: "
              f"{'; '.join(usage) or 'cached'}", flush=True)
    print(f"phase build: {time.perf_counter() - t0:.1f} s", flush=True)

    cases = timed("kernel checks", kernel_phase, device)
    if opts.kernels:
        return None
    return cases, path_phases(device, card, sky, writer, soak_queue)


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
    # Fails here, before any child starts, without the package beside it.
    import sydr_tpu_torch.ops.native  # noqa: F401

    card = card_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    print(f"card: {card}", flush=True)
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # The prefix phase's IQ file and the soak's scenario are made by child
    # processes from here on, while the kernels build and the earlier
    # phases run.
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        sky = os.path.join(tmp, "demo_sky.int8")
        soak_queue = ctx.Queue()
        writer = ctx.Process(target=write_demo_sky, args=(sky,), daemon=True)
        producer = ctx.Process(target=soak_producer,
                               args=(soak_queue, SOAK_SECONDS, FS_IN,
                                     SOAK_WORKERS))
        writer.start()
        producer.start()
        try:
            found = build_and_run(device, card, opts, sky, writer,
                                  soak_queue)
        finally:
            stop_process(producer)
            stop_process(writer)
    if found is None:
        return 0
    cases, paths = found
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
