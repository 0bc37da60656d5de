"""Inputs of the scan runtime's block in mid-track, made with numpy from a
seed, and the bounds two runs of it are held to, shared by
``tests/test_torch_scan_kernel.py`` (the port against the JAX package on
the CPU), ``tests/test_torch_cuda.py`` (the kernel against its plain
version on the card) and ``chip_smoke.py``; this module imports no JAX.

:func:`scan_block_inputs` gives a state's leaves, the channels' code rows
and one block's window: a synthetic capture (``signal.synthetic``) of one
satellite for each tracking channel, its nav bits alternating so that the
prompt flips at every bit edge, and each channel's state set on its
satellite (carrier, carrier and code phase at its read pointer, a bit edge
inside the block). Roles by channel index ``i`` (:data:`ROLES`):

- ``i % 8 == 3``: acquiring, not in the capture (every epoch inactive,
  correlated all the same);
- ``i % 8 == 6``: its first epoch inactive (too few samples unread);
- ``i % 8 == 7``: not converged (code counter 0 or 1);
- even ``i``: bit-synced at the true edge, a bit completing at it;
- odd ``i``: one flip short of a unanimous histogram at the true edge (a
  declaration inside the block), but ``i % 8 == 5``, whose histogram is
  spread over bins (no declaration);
- channel 0's anchor past the carrier rail, channel 1's code rate at its
  rail.

:func:`scan_config` and :func:`scan_block_tensors` give the configuration
and the tensors; :func:`bound_faults` holds a run to another under the
scan runtime's bounds; :func:`reached` names the branches a run reached.
"""

from __future__ import annotations

import numpy as np

from sydr_tpu_torch.channels.runtime import TrackingConfig
from sydr_tpu_torch.channels.state import (
    FIELDS,
    FLAG_BIT_SYNC,
    FLAG_CODE_LOCK,
    I32_FIELDS,
    MODE_ACQUIRING,
    MODE_TRACKING,
    code_table,
    init_state,
    state_from_numpy,
    state_to_numpy,
)
from sydr_tpu_torch.constants import (
    GPS_L1CA_CARRIER_FREQ,
    GPS_L1CA_CODE_FREQ,
)
from sydr_tpu_torch.signal.synthetic import IQGenerator

ROLES = {"acquiring": 3, "late start": 6, "unconverged": 7, "spread": 5}
CN0_DBHZ = 48.0
CORR_KEYS = ("i_early", "q_early", "i_prompt", "q_prompt", "i_late",
             "q_late")
# The scan runtime's bounds between two runs of a block whose correlators
# are summed in other orders (tests/test_torch_scan_runtime.py's): code
# phase [chips], carrier [Hz], and every other float relative to its
# key's largest magnitude (last-ulp differences of the sums carried
# through the loop filters over a block; ~1e-6 in a host emulation of the
# kernel).
CODE_TOL, CARRIER_TOL, FLOAT_RTOL = 1e-5, 0.05, 1e-3


def scan_config(**extra) -> TrackingConfig:
    """The scan runtime's configuration of a block: 20 epochs at 2.5 Msps
    unless ``extra`` says otherwise, a window of a millisecond and 256
    samples."""
    fields = dict(sampling_frequency=2.5e6, block_ms=20, tail_ms=4,
                  runtime="scan")
    fields.update(extra)
    fields.setdefault(
        "window_size", round(fields["sampling_frequency"] * 1e-3) + 256)
    return TrackingConfig(**fields)


def scan_block_tensors(cfg, n_ch: int, seed: int, device):
    """:func:`scan_block_inputs` as ``(codes, state, window_re,
    window_im)`` tensors on ``device``."""
    import torch

    leaves, codes, wre, wim = scan_block_inputs(cfg, n_ch, seed)
    return (torch.tensor(codes, device=device),
            state_from_numpy(leaves, device),
            torch.tensor(wre, device=device), torch.tensor(wim, device=device))


def scan_block_inputs(cfg, n_ch: int, seed: int):
    """``(leaves, codes, window_re, window_im)``: the state's ``{field:
    numpy array}``, ``[n_ch, 1025]`` float32 code rows (PRN ``i + 1``) and
    the block's ``[window_samples]`` float32 window planes for ``cfg``'s
    scan runtime."""
    import torch

    rng = np.random.default_rng(seed)
    spms, tail = cfg.samples_per_ms, cfg.tail_ms
    leaves = state_to_numpy(init_state(n_ch, torch.device("cpu")))
    gen = IQGenerator(cfg.sampling_frequency, noise=True, seed=seed)

    def f32(x):
        return np.asarray(x, dtype=np.float32)

    idx = np.arange(n_ch)
    role = idx % 8
    tracking = role != ROLES["acquiring"]
    doppler = rng.uniform(-4000.0, 4000.0, n_ch)
    carrier = doppler + rng.uniform(-3.0, 3.0, n_ch)
    anchor = carrier + rng.uniform(-60.0, 60.0, n_ch)
    anchor[0] = carrier[0] - 405.0            # past the carrier rail
    code_off = rng.uniform(-2.0, 2.0, n_ch)
    if n_ch > 1:
        code_off[1] = 5.99                    # at the code rail
    rem_code = rng.uniform(0.0, 1.0, n_ch)
    unread = spms + rng.integers(spms // 20, spms // 2, n_ch)
    unread[role == ROLES["late start"]] = -(spms // 100)
    # The epoch (of the block's active ones) that starts a new nav bit.
    edge_epoch = rng.integers(1, cfg.block_ms, n_ch) if cfg.block_ms > 1 \
        else np.zeros(n_ch, dtype=np.int64)
    ms0 = rng.integers(0, 20, n_ch)
    edge_bin = (ms0 + edge_epoch + 1) % 20
    synced = idx % 2 == 0
    step_true = GPS_L1CA_CODE_FREQ * (1.0 + doppler / GPS_L1CA_CARRIER_FREQ) \
        / cfg.sampling_frequency
    bits = np.array([1.0, -1.0])
    prompt_prev = np.zeros(n_ch)
    rem_carrier = np.zeros(n_ch)
    for i in np.flatnonzero(tracking):
        # The first active epoch reads code period m0 from sample a0,
        # where the satellite's code phase is rem_code; period
        # m0 + edge_epoch starts a bit.
        a0 = tail * spms - unread[i]
        m0 = 20 * 4 - edge_epoch[i]
        gen.add_satellite(
            i + 1, doppler_hz=doppler[i],
            code_phase_chips=m0 * 1023 + rem_code[i] - a0 * step_true[i],
            cn0_dbhz=CN0_DBHZ, nav_bits=bits)
        rem_carrier[i] = (-2 * np.pi * doppler[i] * a0
                          / cfg.sampling_frequency) % (2 * np.pi)
        prompt_prev[i] = bits[((m0 - 1) // 20) % 2] * spms * 0.1
    iq = gen.generate_ms(cfg.tail_ms + cfg.block_ms)

    leaves["mode"][:] = np.where(tracking, MODE_TRACKING, MODE_ACQUIRING)
    code_counter = rng.integers(150, 5000, n_ch)
    code_counter[role == ROLES["unconverged"]] = idx[
        role == ROLES["unconverged"]] // 8 % 2
    leaves.update(
        carrier_freq=f32(carrier), freq_anchor=f32(anchor),
        code_freq_offset=f32(code_off), rem_code=f32(rem_code),
        rem_carrier=f32(rem_carrier),
        dll_memory=f32(rng.uniform(-0.05, 0.05, n_ch)),
        pll_memory=f32(rng.uniform(-0.02, 0.02, n_ch)),
        fll_memory=f32(rng.uniform(-2.0, 2.0, n_ch)),
        fll_vel=f32(rng.uniform(-5.0, 5.0, n_ch)),
        fll_acc=f32(rng.uniform(-1.0, 1.0, n_ch)),
        i_prompt_prev=f32(prompt_prev),
        q_prompt_prev=f32(prompt_prev * rng.uniform(-0.1, 0.1, n_ch)),
        cn0=f32(rng.uniform(35.0, 48.0, n_ch)),
        pll_lock=f32(rng.uniform(0.55, 1.0, n_ch)),
        fll_lock=f32(rng.uniform(0.3, 1.0, n_ch)))
    leaves["unread"][:] = unread
    leaves["code_counter"][:] = code_counter
    leaves["ms_counter"][:] = ms0
    leaves["lock_state"][:] = rng.integers(0, 3, n_ch)
    # Synced channels: at the true edge, edge_epoch epochs short of a
    # whole bit. The others: one flip at the true edge short of a
    # unanimous histogram, or a spread one.
    n_acc = np.where(synced, 20 - edge_epoch, 0)
    leaves["flags"][:] = FLAG_CODE_LOCK | np.where(synced, FLAG_BIT_SYNC, 0)
    leaves["bit_edge"][:] = np.where(synced, edge_bin,
                                     rng.integers(0, 20, n_ch))
    leaves["accum_count"][:] = n_acc
    amp = np.abs(prompt_prev)
    leaves.update(
        ip_sum=f32(n_acc * prompt_prev), qp_sum=f32(n_acc * amp * 0.01),
        ip_sq_sum=f32(n_acc * amp ** 2 * 1.01),
        qp_sq_sum=f32(n_acc * (0.01 * amp) ** 2 + n_acc * 100.0),
        cn0_ratio_sum=f32(n_acc * rng.uniform(0.001, 0.05, n_ch)))
    hist = leaves["edge_hist"]
    for i in np.flatnonzero(~synced):
        if role[i] == ROLES["spread"]:
            hist[i] = rng.integers(0, 2, 20)
        else:
            hist[i, edge_bin[i]] = cfg.bit_sync_unanimous - 1
    codes = code_table([i + 1 for i in range(n_ch)])
    return (leaves, codes, np.ascontiguousarray(iq.real, dtype=np.float32),
            np.ascontiguousarray(iq.imag, dtype=np.float32))


def reached(state, new_state, out) -> set:
    """Which of the block's branches a run reached: ``"declare"`` (a
    channel declared bit sync), ``"bit"`` (a bit completed), ``"idle"``
    (a channel with no active epoch), ``"late"`` (an inactive epoch before
    an active one on a channel)."""
    active = out["active"]
    got = set()
    if ((new_state.flags & FLAG_BIT_SYNC) != (state.flags & FLAG_BIT_SYNC)
            ).any():
        got.add("declare")
    if out["bit_ready"].any():
        got.add("bit")
    if (~active.any(0)).any():
        got.add("idle")
    if (~active[0] & active[1:].any(0)).any():
        got.add("late")
    return got


def bound_faults(got, ref, peak: float):
    """``(faults, errors)`` of a block's ``got = (state, outputs)`` against
    ``ref``, summed in another order, under the scan runtime's bounds:
    every integer output and state field equal; the correlators by the
    tie rule (rtol 2e-3, atol 1 on 95% of them, every one within two
    chip-boundary ties, a tie moving a correlator by twice a sample's
    magnitude, ``peak``); code phase within :data:`CODE_TOL`, carrier and
    the rail's anchor within :data:`CARRIER_TOL`, every other float
    within :data:`FLOAT_RTOL` of its key's largest magnitude; no float
    output non-finite. ``faults`` names what is outside; ``errors`` is
    each float output's largest absolute error, ``"correlators"`` for
    the six correlators."""
    import torch

    (got_st, got_out), (ref_st, ref_out) = got, ref
    faults = [] if list(got_out) == list(ref_out) else ["keys"]
    for key in ref_out:
        a, b = got_out[key], ref_out[key]
        if a.dtype != b.dtype or a.shape != b.shape:
            faults.append(f"{key} dtype or shape")
        elif a.dtype != torch.float32:
            if not torch.equal(a, b):
                faults.append(key)
        elif not bool(torch.isfinite(a).all()):
            faults.append(f"{key} not finite")
    faults += [f"state {name}" for name in FIELDS if name in I32_FIELDS
               and not torch.equal(getattr(got_st, name),
                                   getattr(ref_st, name))]
    if faults:
        return faults, {}
    corr, corr_ref = (torch.stack([out[k] for k in CORR_KEYS]).cpu().numpy()
                      for out in (got_out, ref_out))
    err = np.abs(corr - corr_ref)
    errors = {"correlators": float(err.max())}
    outside = float((err > 1.0 + 2e-3 * np.abs(corr_ref)).mean())
    if outside > 0.05 or err.max() > 1.0 + 2 * (2.0 * peak):
        faults.append(f"correlators ({outside:.3f} outside rtol 2e-3 "
                      f"atol 1, max {err.max():.3f})")
    for key in ref_out:
        if ref_out[key].dtype != torch.float32 or key in CORR_KEYS:
            continue
        errors[key] = float((got_out[key] - ref_out[key]).abs().max())
        tol = {"rem_code": CODE_TOL, "carrier_freq": CARRIER_TOL}.get(
            key, FLOAT_RTOL * float(ref_out[key].abs().max()))
        if not errors[key] <= tol:
            faults.append(f"{key} {errors[key]:.3e} > {tol:.3e}")
    for name, tol in (("rem_code", CODE_TOL), ("carrier_freq", CARRIER_TOL),
                      ("freq_anchor", CARRIER_TOL)):
        e = float((getattr(got_st, name) - getattr(ref_st, name))
                  .abs().max())
        if not e <= tol:
            faults.append(f"state {name} {e:.3e} > {tol:.3e}")
    return faults, errors
