"""Tracking-loop profiles: per-epoch discriminator/filter/lock updates.

Port of ``sydr_tpu.ops.profiles``: one vectorised update over ``[n_ch]``
tensors for the three loop shapes the receiver runs:

* ``borre``  — NNEML DLL + Costas PLL through the Borre PI filter.
  3 correlators.
* ``kaplan`` — FLL-assisted PLL (Kaplan 2006 DLF) with a
  PULL_IN -> WIDE_TRACK -> NARROW_TRACK lock-state machine and wide/narrow
  correlator pairs. 5 correlators (wide E, narrow E, P, narrow L, wide L).
* ``kaplan`` with ``kaplan_narrow_only`` — the cruise shape: 3 correlators
  and the state machine pinned to NARROW_TRACK.
"""

from __future__ import annotations

import torch

from sydr_tpu_torch.constants import (
    DLF_A2,
    DLF_A3,
    DLF_B3,
    DLF_W0_SCALE_1ST,
    DLF_W0_SCALE_2ND,
    DLF_W0_SCALE_3RD,
    GPS_L1CA_CODE_FREQ,
)
from sydr_tpu_torch.ops import tracking as trk

LOCK_PULL_IN = 0
LOCK_WIDE = 1
LOCK_NARROW = 2


def spacings_for(cfg) -> tuple:
    """Correlator spacings [chips], optionally sample-quantised.

    With ``cfg.quantize_spacing`` each spacing becomes ``k * step0`` for
    integer ``k`` (``step0`` = chips per sample), with a nonzero spacing
    clamped to at least one sample so E/L never collapse onto the prompt.
    """
    if cfg.profile == "kaplan":
        w, n = cfg.spacing_wide, cfg.spacing_narrow
        if cfg.kaplan_narrow_only:
            sp = (-n, 0.0, n)      # cruise shape: 3 taps, 6 streams
        else:
            sp = (-w, -n, 0.0, n, w)
    else:
        sp = tuple(cfg.spacings)
    if cfg.quantize_spacing:
        step0 = GPS_L1CA_CODE_FREQ / cfg.sampling_frequency
        sp = tuple(
            0.0 if s == 0.0 else
            max(1, abs(round(s / step0))) * (1 if s > 0 else -1) * step0
            for s in sp)
    return sp


def spacing_shifts(cfg):
    """(base_spacing, per-spacing integer sample shifts) or ``None``.

    Only defined under ``quantize_spacing``: every spacing is
    ``base + shift * step0`` with ``shift >= 0`` integer, so all correlator
    chip streams are forward sample-shifts of the single base stream.
    """
    if not cfg.quantize_spacing:
        return None
    step0 = GPS_L1CA_CODE_FREQ / cfg.sampling_frequency
    sp = spacings_for(cfg)
    base = sp[0]
    shifts = tuple(int(round((s - base) / step0)) for s in sp)
    return base, shifts


def _select(conds, values, default, like):
    """``jnp.select`` over scalar ``values``: the first true condition wins."""
    out = torch.full_like(like, default)
    for cond, value in reversed(list(zip(conds, values))):
        out = torch.where(cond, value, out)
    return out


def loop_update(cfg, corr, st, active, comp=None):
    """One per-epoch loop update across channels.

    Args:
        cfg: TrackingConfig.
        corr: ``[n_ch, 2 * n_spacings]`` correlators (i, q per spacing).
        st: object with fields dll_memory, pll_memory, fll_vel, fll_acc,
            i_prompt_prev, q_prompt_prev, pll_lock, fll_lock, lock_state,
            code_counter (read-only here).
        active: ``[n_ch]`` bool.
        comp: optional virtual-NCO compensation dict with keys ``freq``
            [Hz], ``phase`` [cycles], ``code`` [chips], subtracted from the
            raw discriminators (the batched runtime's NCOs are frozen
            within a block).

    Returns dict with: i_early..q_late (selected pair), code_err, phase_err,
    freq_err, nco_code, nco_carrier, fll_vel, fll_acc, pll_lock, fll_lock,
    lock_state.
    """
    narrow_only = cfg.profile == "kaplan" and cfg.kaplan_narrow_only
    if narrow_only or cfg.profile != "kaplan":
        i_e, q_e = corr[:, 0], corr[:, 1]
        i_p, q_p = corr[:, 2], corr[:, 3]
        i_l, q_l = corr[:, 4], corr[:, 5]
    else:
        narrow = st.lock_state == LOCK_NARROW
        i_e = torch.where(narrow, corr[:, 2], corr[:, 0])
        q_e = torch.where(narrow, corr[:, 3], corr[:, 1])
        i_p, q_p = corr[:, 4], corr[:, 5]
        i_l = torch.where(narrow, corr[:, 6], corr[:, 8])
        q_l = torch.where(narrow, corr[:, 7], corr[:, 9])

    # --- DLL (shared): NNEML + Borre PI filter -----------------------------
    dll_t1, dll_t2 = trk.loop_filter_taus(
        cfg.dll_bandwidth, cfg.dll_damping, cfg.dll_gain)
    code_err = trk.dll_nneml(i_e, q_e, i_l, q_l)
    if comp is not None:
        code_err = code_err - comp["code"]
    nco_code = trk.borre_loop_filter(
        code_err, st.dll_memory, dll_t1, dll_t2, cfg.dll_pdi)

    if cfg.profile == "kaplan":
        if narrow_only:
            pull_in = torch.zeros_like(st.lock_state, dtype=torch.bool)
        else:
            pull_in = st.lock_state == LOCK_PULL_IN
        fll_disc = (trk.fll_atan2 if cfg.fll_discriminator == "atan2"
                    else trk.fll_atan)
        converged = st.code_counter > 1
        freq_err = torch.where(
            converged,
            fll_disc(i_p, q_p, st.i_prompt_prev, st.q_prompt_prev, 1e-3),
            0.0)
        phase_err = torch.where(pull_in, 0.0, trk.pll_costas(i_p, q_p))
        if comp is not None:
            freq_err = torch.where(converged, freq_err - comp["freq"], 0.0)
            phase_err = torch.where(pull_in, 0.0, phase_err - comp["phase"])

        # Delayed-feedback gain scheduling: loop_bandwidth * block_length
        # must stay below ~0.12 when corrections apply once per block.
        if cfg.runtime == "batch":
            cap = 0.12 / (cfg.block_ms * 1e-3)
        else:
            cap = float("inf")
        if narrow_only:
            fll_bw = torch.full_like(
                st.fll_vel, min(cfg.fll_bandwidth_narrow, cap))
            pll_bw = torch.full_like(
                st.fll_vel, min(cfg.pll_bandwidth_narrow, cap))
        else:
            states = [st.lock_state == LOCK_NARROW,
                      st.lock_state == LOCK_WIDE]
            fll_bw = _select(
                states,
                [min(cfg.fll_bandwidth_narrow, cap),
                 min(cfg.fll_bandwidth_wide, cap)],
                min(cfg.fll_bandwidth_pullin, cap), st.fll_vel)
            pll_bw = _select(
                states,
                [min(cfg.pll_bandwidth_narrow, cap),
                 min(cfg.pll_bandwidth_wide, cap)],
                0.0, st.fll_vel)
        if cfg.dlf_order == 3:
            nco_carrier, fll_vel, fll_acc = trk.fll_assisted_pll_3rd(
                phase_err, freq_err,
                fll_bw / DLF_W0_SCALE_2ND, pll_bw / DLF_W0_SCALE_3RD,
                DLF_A2, DLF_A3, DLF_B3, 1e-3, st.fll_vel, st.fll_acc,
            )
            fll_acc = torch.where(active, fll_acc, st.fll_acc)
        else:
            nco_carrier, fll_vel = trk.fll_assisted_pll_2nd(
                phase_err, freq_err,
                fll_bw / DLF_W0_SCALE_1ST, pll_bw / DLF_W0_SCALE_2ND,
                DLF_A2, 1e-3, st.fll_vel,
            )
            fll_acc = st.fll_acc
        fll_vel = torch.where(active, fll_vel, st.fll_vel)

        alpha = cfg.lock_indicator_alpha
        fll_lock = torch.where(
            active,
            trk.fll_lock_indicator(i_p, q_p, st.i_prompt_prev,
                                   st.q_prompt_prev, st.fll_lock,
                                   alpha=alpha),
            st.fll_lock)
        pll_lock = torch.where(
            active & ~pull_in,
            trk.pll_lock_indicator(i_p, q_p, st.pll_lock, alpha=alpha),
            st.pll_lock)

        if narrow_only:
            lock_state = torch.where(
                active, LOCK_NARROW, st.lock_state).to(torch.int32)
        else:
            # State machine (reference trackingStateUpdate :538-619).
            to_narrow = (
                (st.lock_state != LOCK_NARROW)
                & (fll_lock >= cfg.fll_threshold_narrow)
                & (pll_lock >= cfg.pll_threshold_narrow)
            )
            to_wide = (
                ~to_narrow
                & (st.lock_state != LOCK_WIDE)
                & (fll_lock >= cfg.fll_threshold_wide)
                & (fll_lock < cfg.fll_threshold_narrow)
            )
            to_pullin = (
                ~to_narrow & ~to_wide
                & (st.lock_state != LOCK_PULL_IN)
                & (fll_lock <= cfg.fll_threshold_wide)
            )
            nxt = torch.where(
                to_narrow, LOCK_NARROW,
                torch.where(to_wide, LOCK_WIDE,
                            torch.where(to_pullin, LOCK_PULL_IN,
                                        st.lock_state)))
            lock_state = torch.where(
                active, nxt, st.lock_state).to(torch.int32)
    else:
        # Under 20 ms delayed block feedback the borre Costas loop can hold
        # ~k*25 Hz alias locks; the production cruise profile is therefore
        # kaplan (see the JAX module's note).
        pll_t1, pll_t2 = trk.loop_filter_taus(
            cfg.pll_bandwidth, cfg.pll_damping, cfg.pll_gain)
        phase_err = trk.pll_costas(i_p, q_p)
        if comp is not None:
            phase_err = phase_err - comp["phase"]
        freq_err = torch.zeros_like(phase_err)
        nco_carrier = trk.borre_loop_filter(
            phase_err, st.pll_memory, pll_t1, pll_t2, cfg.pll_pdi)
        fll_vel = st.fll_vel
        fll_acc = st.fll_acc
        pll_lock = torch.where(
            active, trk.pll_lock_indicator(i_p, q_p, st.pll_lock),
            st.pll_lock)
        fll_lock = torch.where(
            active,
            trk.fll_lock_indicator(i_p, q_p, st.i_prompt_prev,
                                   st.q_prompt_prev, st.fll_lock),
            st.fll_lock)
        lock_state = torch.where(
            active, LOCK_NARROW, st.lock_state).to(torch.int32)

    return {
        "i_early": i_e, "q_early": q_e,
        "i_prompt": i_p, "q_prompt": q_p,
        "i_late": i_l, "q_late": q_l,
        "code_err": code_err, "phase_err": phase_err, "freq_err": freq_err,
        "nco_code": nco_code, "nco_carrier": nco_carrier,
        "fll_vel": fll_vel, "fll_acc": fll_acc,
        "pll_lock": pll_lock, "fll_lock": fll_lock,
        "lock_state": lock_state,
    }
