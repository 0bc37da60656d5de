"""Two-pass batched tracking runtime: frozen-rate epoch geometry, per-epoch
correlation, scalar loop replay.

Port of ``sydr_tpu.channels.batch_runtime``. With NCO rates frozen for one
block, code and carrier phase are linear in the consumed sample index, so
a block splits into:

  Pass A ([n_ch] wide): epoch boundaries, per-epoch phases and active
      gating under frozen rates, in closed form (:func:`_pass_a_closed`,
      the default) or by the per-epoch recurrence (:func:`_pass_a_scan`,
      the oracle form; ``TrackingConfig.pass_a``).
  Pass B: every epoch's E/P/L correlators from the per-millisecond
      anchors of :func:`block_geometry`: by default in one launch of CUDA
      kernel K1 (``ops.correlator_kernel.epoch_correlate``); in the prefix
      boundary form (:func:`prefix_form`) from the per-sample prefix of
      CUDA kernel K3 (``ops.correlator_kernel.block_cumsum_streams``).
  Pass C: discriminators, loop filters with virtual-NCO compensation,
      bit-edge histogram sync, C/N0 and lock indicators, epoch by epoch;
      corrections take effect at the next block; then the anchor slew. On
      the card one launch of a CUDA kernel a block
      (``ops.loop_kernel.pass_c``, the JAX package's fused ``lax.scan``);
      :func:`_pass_c` is its plain version (``[n_ch]``-wide ops, one Python
      iteration per epoch), which runs on CPU tensors.

Pass A and pass B's geometry (:func:`_pass_a` and :func:`pass_b_inputs`,
the plain versions here) run on the card as one launch of a CUDA kernel a
block (``ops.geometry_kernel.block_geometry_all``), so that a block is
three launches: the geometry, K1 (or K3) and pass C.

The JAX package's packed-word machinery (``_build_words``,
``_kernel_word_table``, ``make_wordpack``, ``_rowsum_boundary_prefix``)
exists only because Mosaic has no gather; the CUDA kernel reads chips
straight from the code table, so none of it is ported. Every float is
float32 and every integer int32, with Python scalars entering float32
arithmetic as the JAX package's weak-typed scalars do. The JAX reference
is compiled, and its compiler rewrites a division by a constant into a
multiplication by the float32 reciprocal and fuses ``a * b + c`` into one
rounding; where such an expression feeds a ``ceil``/``floor`` (epoch
boundaries, the code intercept, the chip index) a different rounding moves
samples across epoch or chip boundaries, so the port writes the same
forms: ``x * (1.0 / c)`` (which is also what PyTorch's CUDA division by a
Python scalar computes) and ``correlator_kernel.fma32``.
"""

from __future__ import annotations

import math
import types

import numpy as np
import torch

from sydr_tpu_torch.channels import runtime as runtime_mod
from sydr_tpu_torch.channels.runtime import TrackingConfig
from sydr_tpu_torch.channels.state import (
    FLAG_BIT_SYNC,
    FLAG_CODE_LOCK,
    MODE_TRACKING,
    ChannelState,
)
from sydr_tpu_torch.constants import (
    GPS_L1CA_CARRIER_FREQ,
    GPS_L1CA_CODE_FREQ,
    GPS_L1CA_CODE_LENGTH,
)
from sydr_tpu_torch.ops import correlator_kernel as ck
from sydr_tpu_torch.ops import geometry_kernel
from sydr_tpu_torch.ops import loop_kernel
from sydr_tpu_torch.ops.correlator_kernel import fma32
from sydr_tpu_torch.ops import profiles as prof
from sydr_tpu_torch.ops import tracking as trk
from sydr_tpu_torch.signal import cacode

TWO_PI = 2.0 * math.pi
F32 = torch.float32
I32 = torch.int32


def tiled_code_bits(prns: list[int]) -> np.ndarray:
    """Per-channel 0/1 code bits tiled 4x with slack, ``[n_ch, 4160]``.

    ``tiled[ch, 1023 + u]`` is chip ``u mod 1023`` for u in [-1023, 3069),
    so a chip index ``c_int + idx`` reads column ``1023 + c_int + idx``
    without a modulo. PRN 0 (unassigned channel) gets all-zero bits.
    """
    rows = []
    for prn in prns:
        if prn <= 0:
            rows.append(np.zeros(1023, dtype=np.float32))
        else:
            rows.append(cacode.ca_code_bits(prn).astype(np.float32))
    bits = np.stack(rows)
    tiled = np.concatenate([bits] * 4, axis=1)
    pad = np.zeros((len(prns), 4160 - 4 * 1023), dtype=np.float32)
    return np.concatenate([tiled, pad], axis=1).astype(np.float32)


def taps_for(cfg: TrackingConfig) -> tuple:
    """Correlator taps ``((spacing, sample_shift), ...)`` in stream order.

    Quantised taps are sample shifts of the one base chip stream; plain
    taps are one chip stream per spacing.
    """
    shifts = prof.spacing_shifts(cfg)
    if shifts is not None:
        base, ks = shifts
        return tuple((base, k) for k in ks)
    return tuple((sp, 0) for sp in prof.spacings_for(cfg))


def _rates(cfg: TrackingConfig, st: ChannelState):
    """Frozen-block (delta, code_step, omega): code-rate offset [Hz],
    chips per sample and carrier radians per sample."""
    fs = cfg.sampling_frequency
    if cfg.carrier_aiding:
        doppler = st.carrier_freq - cfg.intermediate_frequency
        delta = st.code_freq_offset \
            + doppler * (GPS_L1CA_CODE_FREQ / GPS_L1CA_CARRIER_FREQ)
    else:
        delta = st.code_freq_offset + 0.0
    code_step = (GPS_L1CA_CODE_FREQ + delta) * (1.0 / fs)
    omega = TWO_PI * st.carrier_freq * (1.0 / fs)
    return delta, code_step, omega


# ---------------------------------------------------------------------------
# Pass A: frozen-rate epoch geometry
# ---------------------------------------------------------------------------

def _pass_a(cfg: TrackingConfig, st: ChannelState):
    """Epoch boundaries and phases for the block under frozen rates.

    Returns a dict of ``[block_ms, n_ch]`` tensors (required, active,
    consumed-sample offsets ``b_start``, rem_code and rem_carrier per
    epoch, unread after each epoch) plus end-of-block ``[n_ch]`` values
    and the frozen rates. Two equivalent forms (``cfg.pass_a``): the
    closed-form vectorised evaluation and the per-epoch recurrence.
    """
    if cfg.pass_a == "closed":
        return _pass_a_closed(cfg, st)
    if cfg.pass_a == "scan":
        return _pass_a_scan(cfg, st)
    raise ValueError(
        f"TrackingConfig.pass_a must be 'closed' or 'scan', "
        f"got {cfg.pass_a!r}")


def _pass_a_scan(cfg: TrackingConfig, st: ChannelState):
    """Reference-structured pass A: one step per epoch, with the scan
    runtime's phase arithmetic (``runtime.scan_phase_advance``). Unlike
    the closed form, a channel short of samples skips single epochs, not
    the whole block."""
    spms = cfg.samples_per_ms
    delta, code_step, omega = _rates(cfg, st)
    tracking = st.mode == MODE_TRACKING
    rem_code, rem_carrier, unread = st.rem_code, st.rem_carrier, st.unread
    consumed = torch.zeros_like(st.unread)
    rows = []
    for e in range(cfg.block_ms):
        unread = torch.clamp(unread + spms, max=(cfg.tail_ms + e + 1) * spms)
        required = torch.ceil(
            (GPS_L1CA_CODE_LENGTH - rem_code) / code_step).to(I32)
        active = tracking & (unread >= required)
        req_eff = torch.where(active, required, 0)
        unread = unread - req_eff
        rows.append({
            "required": required, "active": active, "b_start": consumed,
            "rem_code": rem_code, "rem_carrier": rem_carrier,
            "unread_after": unread})
        new_code, new_carrier = runtime_mod.scan_phase_advance(
            cfg, rem_code, rem_carrier, required, delta, omega)
        rem_code = torch.where(active, new_code, rem_code)
        rem_carrier = torch.where(active, new_carrier, rem_carrier)
        consumed = consumed + req_eff
    seq = {k: torch.stack([r[k] for r in rows]) for k in rows[0]}
    seq.update(rem_code_end=rem_code, rem_carrier_end=rem_carrier,
               unread_end=unread, consumed_end=consumed,
               code_step=code_step, omega=omega, delta=delta)
    return seq


def _pass_a_closed(cfg: TrackingConfig, st: ChannelState):
    """All epoch boundaries of the block in one vectorised shot.

    ``C(e) = (e+1)*spms + ceil(-(rem0 + (e+1)*eps) / code_step)`` samples
    are consumed after epoch ``e`` (``eps = spms * delta / fs``), evaluated
    cancellation-free on small operands. A channel that cannot run every
    epoch of the block runs none of them (``active`` is all-or-nothing).
    Returns a dict of ``[block_ms, n_ch]`` tensors plus end-of-block
    ``[n_ch]`` values, as the JAX function does.
    """
    spms = cfg.samples_per_ms
    fs = cfg.sampling_frequency
    n_epochs = cfg.block_ms
    dev = st.rem_code.device

    delta, code_step, omega = _rates(cfg, st)
    e_i = torch.arange(n_epochs, dtype=I32, device=dev)[:, None]   # [E, 1]
    e_f = e_i.to(F32)
    eps = delta * (float(spms) / fs)                               # [n_ch]

    g = -fma32(e_f + 1.0, eps[None, :], st.rem_code[None, :]) \
        / code_step[None, :]
    dd = torch.ceil(g).to(I32)                                     # [E, n_ch]
    c_full = (e_i + 1) * spms + dd                                 # C(e)
    c_prev = torch.cat([torch.zeros_like(dd[:1]), c_full[:-1]], dim=0)
    required = c_full - c_prev

    # Feasibility incl. the availability clamp: the block runs iff
    # min(unread0 + (e+1)*spms, (tail+e+1)*spms) >= C(e) for every e.
    w = torch.minimum(st.unread[None, :] + (e_i + 1) * spms,
                      (cfg.tail_ms + e_i + 1) * spms)
    tracking = st.mode == MODE_TRACKING
    all_ok = tracking[None, :] & torch.all(w >= c_full, dim=0, keepdim=True)
    active = all_ok.expand_as(required)

    d_prev = c_prev - e_i * spms                                   # O(10)
    rem_code_seq = st.rem_code[None, :] + e_f * eps[None, :] \
        + d_prev.to(F32) * code_step[None, :]
    om_ms = torch.remainder(omega * float(spms), TWO_PI)
    rem_carrier_seq = torch.remainder(
        st.rem_carrier[None, :]
        - (om_ms[None, :] * e_f + omega[None, :] * d_prev.to(F32)),
        TWO_PI)
    c_eff = torch.where(active, c_full, 0)
    c_prev_eff = torch.where(active, c_prev, 0)

    seq = {
        "required": required,
        "active": active,
        "b_start": c_prev_eff,
        "rem_code": torch.where(active, rem_code_seq, st.rem_code[None, :]),
        "rem_carrier": torch.where(active, rem_carrier_seq,
                                   st.rem_carrier[None, :]),
        "unread_after": w - c_eff,
    }
    last = n_epochs - 1
    e_end = float(n_epochs)
    d_end = (c_full[last] - n_epochs * spms).to(F32)
    rem_code_end = st.rem_code + e_end * eps + d_end * code_step
    rem_carrier_end = torch.remainder(
        st.rem_carrier - (om_ms * e_end + omega * d_end), TWO_PI)
    act1 = all_ok[0]
    seq["rem_code_end"] = torch.where(act1, rem_code_end, st.rem_code)
    seq["rem_carrier_end"] = torch.where(act1, rem_carrier_end,
                                         st.rem_carrier)
    seq["unread_end"] = w[last] - torch.where(act1, c_full[last], 0)
    seq["consumed_end"] = torch.where(act1, c_full[last], 0)
    seq["code_step"] = code_step
    seq["omega"] = omega
    seq["delta"] = delta
    return seq


# ---------------------------------------------------------------------------
# Pass B: per-epoch correlation
# ---------------------------------------------------------------------------

def _intercept(cfg: TrackingConfig, st: ChannelState):
    """Window position ``base`` of the block's first consumed sample and
    its code phase split into whole chips ``c_int`` and fraction ``fb``.

    Returns (base, a_ms, b_rem, c_int, fb) as in the JAX function.
    """
    spms = cfg.samples_per_ms
    fs = cfg.sampling_frequency
    delta, _, _ = _rates(cfg, st)
    avail0 = (cfg.tail_ms + 1) * spms
    unread0 = torch.clamp(st.unread + spms, max=avail0)
    base = avail0 - unread0                              # [n_ch] int32
    a_ms = torch.div(base, spms, rounding_mode="floor")
    b_rem = base - a_ms * spms
    b1023 = (b_rem * GPS_L1CA_CODE_LENGTH).to(F32)       # exact in int32
    phase = st.rem_code - base.to(F32) * (delta * (1.0 / fs)) \
        - b1023 * (1.0 / spms)
    phase = torch.remainder(phase, float(GPS_L1CA_CODE_LENGTH))
    c_int = torch.floor(phase).to(I32)                   # [0, 1022]
    fb = phase - c_int.to(F32)                           # [0, 1)
    return base, a_ms, b_rem, c_int, fb


def block_geometry(cfg: TrackingConfig, st: ChannelState, geo):
    """Per-millisecond anchors of the block: ``fb_q`` (fractional code
    phase) and ``phic_q`` (carrier phase) at the start of each window
    millisecond, plus the intercept ``base`` and ``c_int``."""
    spms = cfg.samples_per_ms
    fs = cfg.sampling_frequency
    n_q = cfg.tail_ms + cfg.block_ms
    delta = geo["delta"]
    omega = geo["omega"]
    base, a_ms, b_rem, c_int, fb = _intercept(cfg, st)

    qs = torch.arange(n_q, dtype=F32, device=fb.device)
    fb_q = fb[:, None] + qs[None, :] * (spms * delta * (1.0 / fs))[:, None]
    w_ms = torch.remainder(omega * spms, TWO_PI)
    phic0 = (geo["rem_carrier"][0] + a_ms.to(F32) * w_ms
             + omega * b_rem.to(F32))
    phic_q = torch.remainder(phic0[:, None] - qs[None, :] * w_ms[:, None],
                             TWO_PI)
    return {"base": base, "c_int": c_int, "fb_q": fb_q, "phic_q": phic_q}


def epoch_bounds(cfg: TrackingConfig, geo, base):
    """``[block_ms + 1, n_ch]`` int32 epoch bounds in window samples.

    Epochs are contiguous (inactive epochs consume nothing), so epoch ``e``
    sums ``[bounds[e], bounds[e+1])``; as in the JAX ``_pass_b``.
    """
    n_win = cfg.window_samples
    req_eff = torch.where(geo["active"], geo["required"], 0)
    b_start = torch.clamp(geo["b_start"] + base[None, :], 0, n_win)
    last_end = torch.clamp(b_start[-1:] + req_eff[-1:], 0, n_win)
    return torch.cat([b_start, last_end], dim=0).to(I32).contiguous()


def prefix_form(cfg: TrackingConfig) -> bool:
    """Whether pass B takes the prefix boundary form (K3), under the JAX
    package's condition: ``use_pallas``, a ``boundary_mode`` other than
    ``"rowsum"``, and at least 1024 samples per millisecond (the JAX
    kernel's smallest sub-chunk). Otherwise K1 runs; it stands in for both
    the JAX dense path and its row-sum kernel."""
    return (cfg.use_pallas and cfg.boundary_mode != "rowsum"
            and cfg.samples_per_ms >= 1024)


def prefix_at(prefix, ends):
    """The inclusive prefix ``[n_ch, n_streams, n_win]`` at positions
    ``ends`` ``[n_ch, k]`` (int64, within the window): ``[n_ch, n_streams,
    k]``."""
    n_ch, n_streams, _ = prefix.shape
    return torch.gather(
        prefix, 2, ends[:, None, :].expand(n_ch, n_streams, ends.shape[1]))


def boundary_differences(picked):
    """Per-epoch sums ``[block_ms, n_ch, n_streams]`` from the prefix at
    every epoch bound, ``picked`` ``[n_ch, n_streams, block_ms + 1]``."""
    corr = picked[:, :, 1:] - picked[:, :, :-1]
    return corr.permute(2, 0, 1).contiguous()


def prefix_epoch_sums(prefix, bounds):
    """Per-epoch sums ``[block_ms, n_ch, n_streams]`` from the inclusive
    prefix ``[n_ch, n_streams, n_win]`` and the epoch bounds ``[block_ms +
    1, n_ch]``: ``sum[b0, b1) = P[b1 - 1] - P[b0 - 1]`` with ``P[-1] =
    0``, as the JAX prefix path picks them."""
    n_win = prefix.shape[2]
    valid = (bounds > 0).t()                                   # [n_ch, E+1]
    idx = torch.clamp(bounds.to(torch.int64) - 1, 0, n_win - 1).t()
    picked = prefix_at(prefix, idx) * valid[:, None, :].to(F32)
    return boundary_differences(picked)


def pass_b_inputs(cfg: TrackingConfig, st: ChannelState, geo):
    """The kernels' arguments after the window planes and the code bits,
    ``(c_int, omega, code_step, fb_q, phic_q)``, and the epoch bounds:
    the plain version of their part of
    ``ops.geometry_kernel.block_geometry_all``."""
    bg = block_geometry(cfg, st, geo)
    bounds = epoch_bounds(cfg, geo, bg["base"])
    return (bg["c_int"], geo["omega"], geo["code_step"],
            bg["fb_q"].contiguous(), bg["phic_q"].contiguous()), bounds


def _pass_b(cfg: TrackingConfig, bits3x, inputs, bounds, window_re,
            window_im, grid_ch=None):
    """Correlators ``[block_ms, n_ch, 2 * n_taps]`` for the whole block,
    from the geometry's ``inputs`` and ``bounds``
    (``ops.geometry_kernel.block_geometry_all``)."""
    args = (window_re, window_im, bits3x, *inputs)
    if prefix_form(cfg):
        prefix = ck.block_cumsum_streams(*args, taps_for(cfg),
                                         cfg.samples_per_ms, grid_ch=grid_ch)
        return prefix_epoch_sums(prefix, bounds)
    return ck.epoch_correlate(*args, bounds, taps_for(cfg),
                              cfg.samples_per_ms, grid_ch=grid_ch)


# ---------------------------------------------------------------------------
# Pass C: scalar replay (loop filters, bit sync, indicators)
# ---------------------------------------------------------------------------

def _pass_c(cfg: TrackingConfig, st: ChannelState, geo, corr):
    """Replay the block's epochs through the loops; one Python iteration
    per epoch (the JAX ``lax.scan``), ``[n_ch]``-wide tensor ops inside.
    The plain version of ``ops.loop_kernel.pass_c``'s CUDA kernel.

    Returns (new_state, outputs) with outputs a dict of ``[block_ms, n_ch]``
    tensors.
    """
    frozen_carrier = st.carrier_freq
    frozen_code_off = st.code_freq_offset
    rem_code_next = torch.cat(
        [geo["rem_code"][1:], geo["rem_code_end"][None]], dim=0)
    hist_bins = torch.arange(20, dtype=I32, device=corr.device)[None, :]

    carrier_freq, code_off = st.carrier_freq, st.code_freq_offset
    dll_mem, pll_mem, fll_mem = st.dll_memory, st.pll_memory, st.fll_memory
    fll_vel, fll_acc, lock_state = st.fll_vel, st.fll_acc, st.lock_state
    ip_prev, qp_prev = st.i_prompt_prev, st.q_prompt_prev
    flags, code_counter, ms_counter = st.flags, st.code_counter, st.ms_counter
    edge_hist, bit_edge, accum_count = st.edge_hist, st.bit_edge, \
        st.accum_count
    ip_sum, qp_sum = st.ip_sum, st.qp_sum
    ip_sq, qp_sq, ratio_sum = st.ip_sq_sum, st.qp_sq_sum, st.cn0_ratio_sum
    cn0, pll_lock, fll_lock = st.cn0, st.pll_lock, st.fll_lock
    phi_virt = torch.zeros_like(st.carrier_freq)
    chip_virt = torch.zeros_like(st.carrier_freq)
    ipc_prev, qpc_prev = st.i_prompt_prev, st.q_prompt_prev

    outs = []
    for e in range(cfg.block_ms):
        c, active = corr[e], geo["active"][e]

        def upd(new, old):
            return torch.where(active, new, old)

        stv = types.SimpleNamespace(
            dll_memory=dll_mem, pll_memory=pll_mem, fll_vel=fll_vel,
            fll_acc=fll_acc, i_prompt_prev=ip_prev, q_prompt_prev=qp_prev,
            pll_lock=pll_lock, fll_lock=fll_lock, lock_state=lock_state,
            code_counter=code_counter)
        # Virtual-NCO compensation: the within-block NCO is frozen, so the
        # raw discriminators measure the full error; subtract what the
        # already-applied corrections would have removed.
        comp = {
            "freq": carrier_freq - frozen_carrier,
            "phase": phi_virt - torch.round(phi_virt),
            "code": chip_virt,
        }
        lu = prof.loop_update(cfg, c, stv, active, comp=comp)
        i_prompt, q_prompt = lu["i_prompt"], lu["q_prompt"]
        code_err, phase_err = lu["code_err"], lu["phase_err"]
        nco_code, nco_carrier = lu["nco_code"], lu["nco_carrier"]

        new_carrier = carrier_freq + nco_carrier
        if cfg.freq_rail_hz > 0:
            new_carrier = torch.clamp(
                new_carrier, st.freq_anchor - cfg.freq_rail_hz,
                st.freq_anchor + cfg.freq_rail_hz)
        if cfg.max_block_freq_step > 0:
            new_carrier = torch.clamp(
                new_carrier, frozen_carrier - cfg.max_block_freq_step,
                frozen_carrier + cfg.max_block_freq_step)
        new_code_off = code_off - nco_code
        if cfg.code_rail_hz > 0:
            new_code_off = torch.clamp(
                new_code_off, -cfg.code_rail_hz, cfg.code_rail_hz)

        # Prompts derotated by the virtual phase, so every epoch of a bit
        # sums in one frame (see the JAX module).
        theta = TWO_PI * comp["phase"]
        cth, sth = torch.cos(theta), torch.sin(theta)
        ip_c = i_prompt * cth + q_prompt * sth
        qp_c = q_prompt * cth - i_prompt * sth

        # Bit-edge histogram sync.
        had_sync = (flags & FLAG_BIT_SYNC) != 0
        new_ms_counter = torch.where(
            active, torch.remainder(ms_counter + 1, 20), ms_counter)
        sign_flip = torch.sign(ipc_prev) != torch.sign(ip_c)
        counting = (active & ~had_sync
                    & (code_counter > cfg.min_convergence_ms)
                    & (pll_lock > 0.5))
        flip_now = counting & sign_flip
        onehot = (hist_bins == new_ms_counter[:, None]).to(I32)
        new_hist = edge_hist + onehot * flip_now[:, None].to(I32)
        declare = ~had_sync & runtime_mod._bit_sync_declare(cfg, new_hist)
        new_edge = torch.where(
            declare, torch.argmax(new_hist, dim=-1).to(I32), bit_edge)
        bit_sync = had_sync | declare
        phase_in_bit = torch.remainder(new_ms_counter - new_edge, 20)
        at_edge = active & bit_sync & (phase_in_bit == 0)
        bit_complete = at_edge & (accum_count >= 20)
        bit_ip_sum = ip_sum
        accum_reset = at_edge | declare
        acc = active & bit_sync
        new_accum = torch.where(accum_reset, 0, accum_count) + acc.to(I32)

        n_ip = torch.where(accum_reset, 0.0, ip_sum) \
            + torch.where(acc, ip_c, 0.0)
        n_qp = torch.where(accum_reset, 0.0, qp_sum) \
            + torch.where(acc, qp_c, 0.0)
        n_ip2 = torch.where(accum_reset, 0.0, ip_sq) \
            + torch.where(acc, i_prompt**2, 0.0)
        n_qp2 = torch.where(accum_reset, 0.0, qp_sq) \
            + torch.where(acc, q_prompt**2, 0.0)
        n_ratio = torch.where(accum_reset, 0.0, ratio_sum) + torch.where(
            acc, trk.beaulieu_ratio_term(i_prompt, q_prompt, ip_prev,
                                         qp_prev), 0.0)
        new_cn0 = trk.cn0_update(cfg, bit_complete, ip_sum, qp_sum,
                                 ip_sq, qp_sq, ratio_sum, cn0)

        new_flags = torch.where(
            active,
            flags | FLAG_CODE_LOCK | torch.where(bit_sync, FLAG_BIT_SYNC, 0),
            flags).to(I32)
        carrier_out = upd(new_carrier, carrier_freq)
        code_off_out = upd(new_code_off, code_off)

        outs.append({
            "active": active,
            "i_early": lu["i_early"], "q_early": lu["q_early"],
            "i_prompt": i_prompt, "q_prompt": q_prompt,
            "i_late": lu["i_late"], "q_late": lu["q_late"],
            "dll_error": code_err, "pll_error": phase_err,
            "fll_error": lu["freq_err"], "lock_state": lu["lock_state"],
            "nco_code": nco_code, "nco_carrier": nco_carrier,
            "carrier_freq": carrier_out,
            "code_freq": GPS_L1CA_CODE_FREQ + geo["delta"],
            "cn0": new_cn0, "pll_lock": lu["pll_lock"],
            "fll_lock": lu["fll_lock"],
            "flags": new_flags,
            "unread": geo["unread_after"][e],
            "required": geo["required"][e],
            "rem_code": rem_code_next[e],
            "bit_ready": bit_complete,
            "bit_ip_sum": bit_ip_sum,
        })

        phi_virt = torch.where(
            active, phi_virt + (carrier_out - frozen_carrier) * 1e-3,
            phi_virt)
        chip_virt = torch.where(
            active, chip_virt + (code_off_out - frozen_code_off) * 1e-3,
            chip_virt)
        carrier_freq, code_off = carrier_out, code_off_out
        dll_mem = upd(code_err, dll_mem)
        pll_mem = upd(phase_err, pll_mem)
        fll_mem = upd(lu["freq_err"], fll_mem)
        fll_vel, fll_acc = lu["fll_vel"], lu["fll_acc"]
        lock_state = lu["lock_state"]
        ip_prev, qp_prev = upd(i_prompt, ip_prev), upd(q_prompt, qp_prev)
        flags = new_flags
        code_counter = upd(code_counter + 1, code_counter)
        ms_counter, edge_hist, bit_edge = new_ms_counter, new_hist, new_edge
        accum_count = new_accum
        ip_sum, qp_sum, ip_sq, qp_sq, ratio_sum = \
            n_ip, n_qp, n_ip2, n_qp2, n_ratio
        cn0, pll_lock, fll_lock = new_cn0, lu["pll_lock"], lu["fll_lock"]
        ipc_prev, qpc_prev = upd(ip_c, ipc_prev), upd(qp_c, qpc_prev)

    outputs = {k: torch.stack([o[k] for o in outs]) for k in outs[0]}

    # End-of-block phase catch-up: realise the virtual-NCO phase the
    # within-block corrections assumed.
    rem_carrier_end = torch.remainder(
        geo["rem_carrier_end"] - TWO_PI * phi_virt, TWO_PI)
    rem_code_end = geo["rem_code_end"] + chip_virt
    new_state = ChannelState(
        mode=st.mode, flags=flags,
        carrier_freq=carrier_freq, freq_anchor=st.freq_anchor,
        code_freq_offset=code_off,
        rem_carrier=rem_carrier_end, rem_code=rem_code_end,
        dll_memory=dll_mem, pll_memory=pll_mem,
        fll_memory=fll_mem, fll_vel=fll_vel, fll_acc=fll_acc,
        i_prompt_prev=ip_prev, q_prompt_prev=qp_prev,
        unread=geo["unread_end"].to(I32), code_counter=code_counter,
        ms_counter=ms_counter, edge_hist=edge_hist, bit_edge=bit_edge,
        accum_count=accum_count,
        ip_sum=ip_sum, qp_sum=qp_sum, cn0_ratio_sum=ratio_sum,
        ip_sq_sum=ip_sq, qp_sq_sum=qp_sq,
        cn0=cn0, pll_lock=pll_lock, fll_lock=fll_lock,
        lock_state=lock_state,
    )
    return new_state, outputs


def run_block_batched(cfg: TrackingConfig, bits3x, state: ChannelState,
                      window_re, window_im, *, grid_ch=None):
    """One block: pass A and pass B's geometry
    (``ops.geometry_kernel.block_geometry_all``), pass B (K1, or K3 in the
    prefix form), pass C and the anchor slew (``ops.loop_kernel.pass_c``).

    ``bits3x`` is the ``tiled_code_bits`` table (``[n_ch, 4160]`` f32 on
    the state's device); ``window_re/im`` hold ``tail_ms + block_ms``
    milliseconds. ``grid_ch``: the kernels' launch shape for this many
    channels (a channel shard passes the full count; see
    ``correlator_kernel.epoch_correlate``). Returns (state, outputs
    ``[block_ms, n_ch]``).
    """
    geo, inputs, bounds = geometry_kernel.block_geometry_all(cfg, state)
    corr = _pass_b(cfg, bits3x, inputs, bounds, window_re, window_im,
                   grid_ch)
    return loop_kernel.pass_c(cfg, state, geo, corr)


def run_superblock(cfg: TrackingConfig, k_blocks: int, bits3x,
                   state: ChannelState, samples_re, samples_im, *,
                   grid_ch=None):
    """Process ``k_blocks`` consecutive blocks of :func:`run_block_batched`
    (``runtime.superblock_loop``)."""
    return runtime_mod.superblock_loop(
        cfg, k_blocks, state, samples_re, samples_im,
        lambda st, wre, wim: run_block_batched(cfg, bits3x, st, wre, wim,
                                               grid_ch=grid_ch))
