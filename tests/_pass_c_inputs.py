"""Inputs of pass C in mid-track, made with numpy from a seed, shared by
``tests/test_torch_pass_c.py`` (the port against the JAX package on the
CPU) and ``tests/test_torch_cuda.py`` (the kernel against its plain version
on the card); this module imports no JAX.

:func:`mid_track` gives a state's leaves and the block's correlators:
channels whose nav bits flip at their bit edge, so that a bit completes
inside the block on the synced channels and the unsynced ones declare bit
sync (one flip short of a unanimous histogram); two channels not tracking
(pass A makes every epoch of theirs inactive); a carrier anchor at the
rail and the loops pushing into it, a carrier velocity past the block's
step bound and code-rate offsets at the code rail, so that each clamp
acts; lock states across the kaplan state machine; and two channels that
have not converged (code counter 0 and 1).

:func:`shaped_block` puts that block on the shapes pass C's kernel tiles
and spreads over CTAs (:data:`SHAPE_CASES`: 1 to 64 channels, 2 to 64
epochs) and on other activity than pass A gives: stretches of inactive
epochs between active ones (one across the boundary of two 32-epoch
tiles), or none active at all. Each case names the branches it is built to
reach (:data:`CLAIMS`); the CPU tests hold the plain version to them.
"""

from __future__ import annotations

import numpy as np

from sydr_tpu_torch.channels.state import (
    FLAG_BIT_SYNC,
    FLAG_CODE_LOCK,
    MODE_ACQUIRING,
    MODE_TRACKING,
    init_state,
    state_to_numpy,
)


def n_streams(cfg) -> int:
    """The correlator streams of ``cfg``'s loop shape."""
    full_kaplan = cfg.profile == "kaplan" and not cfg.kaplan_narrow_only
    return 10 if full_kaplan else 6


def mid_track(cfg, n_ch: int, seed: int):
    """``(leaves, corr)``: the state's ``{field: numpy array}`` and the
    block's correlators ``[block_ms, n_ch, n_streams(cfg)]`` float32."""
    import torch

    rng = np.random.default_rng(seed)
    leaves = state_to_numpy(init_state(n_ch, torch.device("cpu")))
    spms = cfg.samples_per_ms

    def f32(x):
        return np.asarray(x, dtype=np.float32)

    leaves["mode"][:] = MODE_TRACKING
    leaves["mode"][[3, n_ch - 2]] = MODE_ACQUIRING
    carrier = rng.uniform(-4000.0, 4000.0, n_ch)
    anchor = carrier + rng.uniform(-60.0, 60.0, n_ch)
    anchor[0] = carrier[0] - 405.0          # past the carrier rail
    vel = rng.uniform(-20.0, 20.0, n_ch)
    vel[0] = 10.0                           # pushing into the rail
    vel[1] = 300.0                          # past the step bound at once
    code_off = rng.uniform(-3.0, 3.0, n_ch)
    code_off[[4, 5]] = (-5.99, 5.99)        # at the code rail
    leaves.update(
        carrier_freq=f32(carrier), freq_anchor=f32(anchor),
        code_freq_offset=f32(code_off),
        rem_code=f32(rng.uniform(0.0, 1.0, n_ch)),
        rem_carrier=f32(rng.uniform(0.0, 2 * np.pi, n_ch)),
        dll_memory=f32(rng.uniform(-0.05, 0.05, n_ch)),
        pll_memory=f32(np.where(np.arange(n_ch) == 0, -0.2,
                                rng.uniform(-0.05, 0.05, n_ch))),
        fll_memory=f32(rng.uniform(-5.0, 5.0, n_ch)),
        fll_vel=f32(vel), fll_acc=f32(rng.uniform(-1.0, 1.0, n_ch)),
        cn0=f32(rng.uniform(35.0, 48.0, n_ch)),
        pll_lock=f32(rng.uniform(0.55, 1.0, n_ch)),
        fll_lock=f32(rng.uniform(0.3, 1.0, n_ch)))
    leaves["unread"][:] = spms + rng.integers(spms // 20, spms // 2, n_ch)
    code_counter = rng.integers(150, 5000, n_ch)
    code_counter[[6, 7]] = (0, 1)           # not converged
    ms0 = rng.integers(0, 20, n_ch)
    edge = rng.integers(0, 20, n_ch)
    leaves["code_counter"][:] = code_counter
    leaves["ms_counter"][:] = ms0
    leaves["bit_edge"][:] = edge
    leaves["lock_state"][:] = rng.integers(0, 3, n_ch)

    # The prompt: amplitude, phase and a small frequency error; the nav
    # bit before the block is the sign of the previous prompt.
    amp = rng.uniform(300.0, 3000.0, n_ch)
    phase0 = rng.uniform(-0.3, 0.3, n_ch)
    f_err = rng.uniform(-15.0, 15.0, n_ch)
    bit = np.where(rng.random(n_ch) < 0.5, -1.0, 1.0)
    leaves["i_prompt_prev"] = f32(bit * amp * np.cos(phase0))
    leaves["q_prompt_prev"] = f32(bit * amp * np.sin(phase0))

    # Half the channels are bit-synced, their accumulators as far into the
    # bit as their counters say; the others are one flip at their edge bin
    # short of a unanimous declaration, but two whose histograms are spread
    # over bins (no declaration).
    synced = rng.random(n_ch) < 0.5
    synced[[8, 9]] = (True, False)
    n_acc = np.where(synced, (ms0 - edge) % 20 + 1, 0)
    leaves["flags"][:] = FLAG_CODE_LOCK | np.where(synced, FLAG_BIT_SYNC, 0)
    leaves["accum_count"][:] = n_acc
    i_bit, q_bit = amp * np.cos(phase0), amp * np.sin(phase0)
    leaves.update(
        ip_sum=f32(n_acc * bit * i_bit), qp_sum=f32(n_acc * bit * q_bit),
        ip_sq_sum=f32(n_acc * i_bit ** 2 * 1.01),
        qp_sq_sum=f32(n_acc * q_bit ** 2 + n_acc * 100.0),
        cn0_ratio_sum=f32(n_acc * rng.uniform(0.001, 0.05, n_ch)))
    hist = leaves["edge_hist"]
    for c in np.flatnonzero(~synced):
        if c in (10, 11):
            hist[c] = rng.integers(0, 2, 20)
        else:
            hist[c, edge[c]] = cfg.bit_sync_unanimous - 1

    # The block: the bit flips at the first edge of an unsynced channel
    # (its declaring flip) and at random edges after.
    n_ep, n_s = cfg.block_ms, n_streams(cfg)
    corr = np.zeros((n_ep, n_ch, n_s), dtype=np.float32)
    first = np.ones(n_ch, dtype=bool)
    dl = rng.uniform(-0.1, 0.1, n_ch)
    dl[[4, 5]] = (0.15, -0.15)              # push the code rail
    for e in range(n_ep):
        at_edge = (ms0 + e + 1) % 20 == edge
        flip = at_edge & (rng.random(n_ch) < 0.6)
        flip |= at_edge & first & ~synced
        first &= ~at_edge
        bit = np.where(flip, -bit, bit)
        phi = phase0 + 2 * np.pi * f_err * (e + 1) * 1e-3
        noise = rng.normal(0.0, 1.0, (n_ch, n_s)) * (0.05 * amp)[:, None]
        noise[[4, 5]] = 0.0                 # the code rail holds each epoch
        p_i, p_q = bit * amp * np.cos(phi), bit * amp * np.sin(phi)
        if n_s == 6:
            gains = (0.8 + dl, 1.0, 0.8 - dl)
        else:
            gains = (0.5 + dl, 0.8 + dl, 1.0, 0.8 - dl, 0.5 - dl)
        for t, g in enumerate(gains):
            corr[e, :, 2 * t] = g * p_i + noise[:, 2 * t]
            corr[e, :, 2 * t + 1] = g * p_q + noise[:, 2 * t + 1]
    return leaves, corr


NARROW = dict(profile="kaplan", kaplan_narrow_only=True)
KAPLAN = dict(profile="kaplan")
# What a shaped case is built to reach: a bit-sync declaration inside the
# block; a bit completion; a channel inactive between active epochs; a
# block of more than 32 epochs with a bit completion after epoch 32 and an
# inactive stretch across epochs 31 and 32; no epoch active; a declaration
# of another bit edge than the state's.
CLAIMS = ("declare", "bit", "gap", "tiles", "idle", "moved-edge")
# (id, block_ms, n_ch, activity, TrackingConfig fields, claims): activity
# "pass-a" (pass A's own), "gaps" or "idle" (:func:`activity`), or
# "moved-edge" (pass A's, and the unsynced channels' bit edge in the state
# 7 ms from the one their histograms point at).
SHAPE_CASES = [
    ("block-2", 2, 32, "pass-a", NARROW, ("declare", "bit")),
    ("block-45", 45, 32, "gaps", NARROW, ("declare", "bit", "gap", "tiles")),
    ("block-64", 64, 32, "gaps", KAPLAN, ("declare", "bit", "gap", "tiles")),
    ("channels-1", 20, 1, "pass-a", NARROW, ("bit",)),
    ("channels-13", 20, 13, "pass-a", NARROW, ("declare", "bit")),
    ("channels-33", 5, 33, "pass-a", KAPLAN, ("declare", "bit")),
    ("channels-64", 20, 64, "pass-a", NARROW, ("declare", "bit")),
    ("gaps", 20, 32, "gaps", NARROW, ("declare", "bit", "gap")),
    ("idle", 20, 32, "idle", NARROW, ("idle",)),
    ("moved-edge", 20, 32, "moved-edge", NARROW,
     ("declare", "bit", "moved-edge")),
]


def activity(kind: str, active):
    """``[block_ms, n_ch]`` bool, contiguous: pass A's ``active`` for
    ``"pass-a"``; for ``"gaps"`` the same with stretches cut out of every
    third channel (from channel 1: epochs 4 + c % 5 to 9 + c % 7, and past
    32 epochs also 30 to 33 on channels 2 and 5); all False for
    ``"idle"``."""
    out = np.array(np.asarray(active), dtype=bool, order="C")   # a copy
    n_ep, n_ch = out.shape
    if kind == "moved-edge":
        kind = "pass-a"
    if kind == "idle":
        out[:] = False
    elif kind == "gaps":
        for c in range(1, n_ch, 3):
            out[4 + c % 5:9 + c % 7, c] = False
        if n_ep > 33:
            out[30:34, [2, 5]] = False
    elif kind != "pass-a":
        raise ValueError(f"activity {kind!r}")
    return out


def shaped_block(block_ms, n_ch, kind, extra, device, seed=3,
                 fs=2.5e6):
    """``(cfg, state, geo, corr)`` on ``device``: :func:`mid_track`'s block
    at ``block_ms`` epochs and ``n_ch`` channels (below 12 channels, the
    first ``n_ch`` of 32), ``geo`` from the port's pass A with ``active``
    from :func:`activity`."""
    import torch

    from sydr_tpu_torch.channels.batch_runtime import _pass_a
    from sydr_tpu_torch.channels.runtime import TrackingConfig
    from sydr_tpu_torch.channels.state import state_from_numpy

    cfg = TrackingConfig(sampling_frequency=fs, block_ms=block_ms,
                         tail_ms=4, window_size=round(fs * 1e-3) + 256,
                         runtime="batch", quantize_spacing=True, **extra)
    leaves, corr = mid_track(cfg, max(n_ch, 12), seed)
    leaves = {k: v[:n_ch] for k, v in leaves.items()}
    if kind == "moved-edge":
        unsynced = (leaves["flags"] & FLAG_BIT_SYNC) == 0
        leaves["bit_edge"][unsynced] = (leaves["bit_edge"][unsynced] + 7) % 20
    st = state_from_numpy(leaves, device)
    geo = dict(_pass_a(cfg, st))
    geo["active"] = torch.tensor(activity(kind, geo["active"].cpu()),
                                 device=device)
    return cfg, st, geo, torch.tensor(corr[:, :n_ch].copy(), device=device)


def reached(state, new_state, out) -> set:
    """The :data:`CLAIMS` that a pass C run (its state before and after,
    its outputs, on any device) reached."""
    active = out["active"].cpu().numpy()
    bits = out["bit_ready"].cpu().numpy()
    flags = out["flags"].cpu().numpy()
    sync0 = (state.flags.cpu().numpy() & FLAG_BIT_SYNC) != 0
    got = set()
    if ((flags & FLAG_BIT_SYNC) != 0)[:, ~sync0].any():
        got.add("declare")
    if bits.any():
        got.add("bit")
    seen = np.maximum.accumulate(active, axis=0)
    later = np.maximum.accumulate(active[::-1], axis=0)[::-1]
    if (seen & later & ~active).any():
        got.add("gap")
    if (len(active) > 33 and bits[32:].any()
            and (active[29] & ~active[31] & ~active[32]
                 & active[34]).any()):
        got.add("tiles")
    if not active.any():
        got.add("idle")
    edge0, edge1 = state.bit_edge.cpu().numpy(), new_state.bit_edge.cpu().numpy()
    if ((edge0 != edge1) & ~sync0).any():
        got.add("moved-edge")
    return got
