#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``sydr_tpu_torch``) on one GPU.

Usage, from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, each failing the run (non-zero exit) at its first fault:

1. versions, the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``sydr_tpu_torch/csrc`` with ``nvcc``;
3. each kernel against its plain PyTorch version on the card, at the shapes
   the receiver gives it, with its error bound and CUDA-event times;
4. the production parity gate: 4 closed-loop blocks against the committed
   CPU truth ``tools/parity_truth.npz`` (read with numpy);
5. the receiver's device path end to end: a 32-channel ``TrackingSession``
   on 5 s of a synthetic 10 Msps capture (12 visible satellites at
   45 dB-Hz, 20 absent PRNs), decimate 4, kaplan pull-in at 5 ms blocks,
   promotion to the narrow-only cruise at 20 ms blocks x 50-block
   superblocks, quantised taps; acquisition, promotion, bit sync, carrier
   error and the kernels' launch counts are checked.

The last three lines are the kernels' JSON record, the ``nvidia-smi`` line
and ``{"ok": true, "device": {...}}``. Without a CUDA device the script
exits non-zero before printing any result. It imports no JAX.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
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
SIGNAL_MS = 5000
CRUISE_SUPERBLOCK = 50

# Kernel-vs-plain bounds. K1: identical chips (same rounding of the index
# arithmetic), sums in another order: 1e-2 + 1e-4 of the largest correlator.
# K2: a direct-summation four-step DFT against cuFFT, both float32:
# 1e-4 of the map's maximum.
K1_ATOL, K1_RTOL = 1e-2, 1e-4
K2_RTOL = 1e-4


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
    two warm-up calls."""
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


# ---------------------------------------------------------------------------
# Kernel checks
# ---------------------------------------------------------------------------

def k1_case(name, fs, block_ms, profile, quantize, device, rng):
    """Kernel vs plain ``epoch_correlate`` on a random tracking state."""
    import torch

    from sydr_tpu_torch.channels import batch_runtime as br
    from sydr_tpu_torch.channels.runtime import TrackingConfig
    from sydr_tpu_torch.channels.state import MODE_TRACKING, init_state
    from sydr_tpu_torch.ops import correlator_kernel as ck

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
    args = (wre, wim, bits, bg["c_int"], geo["omega"], geo["code_step"],
            bg["fb_q"].contiguous(), bg["phic_q"].contiguous(),
            br.epoch_bounds(cfg, geo, bg["base"]), br.taps_for(cfg), spms)
    got = ck.epoch_correlate(*args)
    ref = ck.epoch_correlate_ref(*args)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    bound = K1_ATOL + K1_RTOL * float(ref.abs().max())
    ms = cuda_ms(lambda: ck.epoch_correlate(*args), 50)
    plain_ms = cuda_ms(lambda: ck.epoch_correlate_ref(*args), 5)
    print(f"K1 {name}: out {tuple(got.shape)} max_abs_err {err:.3e} "
          f"(bound {bound:.3e}) kernel {ms:.4f} ms plain {plain_ms:.4f} ms",
          flush=True)
    check(bool(torch.isfinite(got).all()), f"K1 {name}: non-finite output")
    check(err <= bound, f"K1 {name}: error {err} above bound {bound}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def k2_case(name, fs, n_ch, device, rng):
    """Kernel vs plain ``pcps_bins`` on the acquisition's spectra of a
    noise capture, with the receiver's 101-bin shift plan."""
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
    got = acq_kernel.pcps_bins(spectra, code_k, bin_shifts)
    ref = acq_kernel.pcps_bins_ref(spectra, code_k, bin_shifts)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    bound = K2_RTOL * float(ref.abs().max())
    ms = cuda_ms(lambda: acq_kernel.pcps_bins(spectra, code_k, bin_shifts), 5)
    plain_ms = cuda_ms(
        lambda: acq_kernel.pcps_bins_ref(spectra, code_k, bin_shifts), 5)
    print(f"K2 {name}: out {tuple(got.shape)} max_abs_err {err:.3e} "
          f"(bound {bound:.3e}) kernel {ms:.4f} ms plain {plain_ms:.4f} ms",
          flush=True)
    check(bool(torch.isfinite(got).all()), f"K2 {name}: non-finite output")
    check(err <= bound, f"K2 {name}: error {err} above bound {bound}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


# ---------------------------------------------------------------------------
# Parity gate
# ---------------------------------------------------------------------------

def parity_phase(device) -> None:
    from sydr_tpu_torch import parity

    truth = np.load(os.path.join(REPO, "tools", "parity_truth.npz"),
                    allow_pickle=False)["superblock"]
    res = parity.production_parity(truth, device)
    b = parity.PARITY_BOUNDS
    print(f"parity_metric {res['parity_metric']:.4f} (<= "
          f"{b['parity_metric']}) parity_scaled {res['parity_scaled']:.4f} "
          f"(<= {b['parity_scaled']}) prompt_ratio {res['prompt_ratio']:.4f} "
          f"(in {list(b['prompt_ratio'])})", flush=True)
    check(res["parity_ok"], f"parity gate failed: {res}")


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
                superblock=CRUISE_SUPERBLOCK, sync=None, card="") -> dict:
    """Drive the port's TrackingSession; check and return what it did."""
    from sydr_tpu_torch.channels.state import FLAG_BIT_SYNC, MODE_TRACKING
    from sydr_tpu_torch.ops import acq_kernel
    from sydr_tpu_torch.ops import correlator_kernel as ck
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

    ck.KERNEL.launches = 0
    acq_kernel.KERNEL.launches = 0
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
    launches = {"epoch_correlate": ck.KERNEL.launches,
                "pcps_bins": acq_kernel.KERNEL.launches}
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
        ok &= (abs(acq["doppler"] - s["doppler"]) <= 100.0
               and abs(d_ci) <= 2 and synced and err_hz < 5.0)
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
    check(promoted_at is not None, "the session never promoted to cruise")
    check(all(m != MODE_TRACKING for m in absent_modes.values()),
          "an absent PRN is tracking")
    check(all(v > 0 for v in launches.values()),
          f"a kernel never launched on the main path: {launches}")
    check(all(np.isfinite(merged[k]).all() for k in
              ("i_prompt", "q_prompt", "carrier_freq")),
          "non-finite tracking output")
    return {"launches": launches, "rtf": rtf, "promoted_at": promoted_at}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device: this smoke test runs only on a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from sydr_tpu_torch.ops import acq_kernel
    from sydr_tpu_torch.ops import correlator_kernel as ck

    card = card_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    print(f"card: {card}", flush=True)
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    for kern in (ck.KERNEL, acq_kernel.KERNEL):
        t0 = time.perf_counter()
        kern.function()
        usage = [ln.strip() for ln in kern.build_log.splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"built {kern.source} in {time.perf_counter() - t0:.2f} s: "
              f"{'; '.join(usage) or 'cached'}", flush=True)

    rng = np.random.default_rng(SEED)
    k1 = {name: k1_case(name, fs, bm, prof, quant, device, rng)
          for name, fs, bm, prof, quant in (
              ("cruise 2.5 Msps 20 ms 6 streams", 2.5e6, 20, "narrow", True),
              ("pull-in 2.5 Msps 5 ms 10 streams", 2.5e6, 5, "kaplan", True),
              ("full-rate 10 Msps 20 ms 6 streams", 10e6, 20, "narrow",
               True),
              ("full-rate 10 Msps 20 ms 10 streams, plain taps", 10e6, 20,
               "kaplan", False))}
    k2 = {name: k2_case(name, fs, n_ch, device, rng)
          for name, fs, n_ch in (
              ("session 32 ch n=2500", 2.5e6, 32),
              ("bench 12 ch n=10000", 10e6, 12))}

    parity_phase(device)
    res = slice_phase(device, sync=torch.cuda.synchronize, card=card)

    k1_main = k1["cruise 2.5 Msps 20 ms 6 streams"]
    k2_main = k2["session 32 ch n=2500"]
    record = {"kernels": [
        {"name": "epoch_correlate", "route": "cuda",
         "source": "sydr_tpu_torch/csrc/epoch_correlate.cu",
         "replaces": "sydr_tpu/ops/correlator_kernel.py:449",
         "launches": res["launches"]["epoch_correlate"], **k1_main},
        {"name": "pcps_bins", "route": "cuda",
         "source": "sydr_tpu_torch/csrc/pcps_bins.cu",
         "replaces": "sydr_tpu/ops/acq_kernel.py:54",
         "launches": res["launches"]["pcps_bins"], **k2_main},
    ]}
    print(json.dumps(record), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
