"""Tracking configuration and the lockstep per-ms ("scan") runtime.

Port of ``sydr_tpu.channels.runtime``::

    state, outputs = run_block(cfg, codes, state, window_re, window_im)

advances every channel in lockstep through ``block_ms`` one-millisecond
epochs over a block of samples resident on the device: each epoch reads
every channel's window at its own offset, correlates E/P/L
(``ops.tracking.epl_correlate``), and updates the loops at once, so the
NCO feedback has the reference's per-ms cadence (the batched runtime,
``channels.batch_runtime``, applies it once per block). On CUDA tensors
the JAX ``lax.scan`` over epochs is one launch of a hand-written kernel
(``ops.scan_kernel``, ``csrc/scan_block.cu``); its plain version,
:func:`_run_block_plain`, which CPU tensors take, is a Python loop over
epochs with the channel ``vmap`` the leading axis of ``[n_ch, ...]``
tensors. The sliding window is ``tail_ms + block_ms`` milliseconds of IQ;
the tail carries the previous block's last ``tail_ms`` ms for channels
whose read cursor lags the write head. :func:`run_superblock` runs
``k`` consecutive blocks over one contiguous stretch of samples
(:func:`superblock_loop`, the layout the batched runtime's superblock
shares), one dispatch for ``k * block_ms`` milliseconds.

:class:`TrackingConfig` keeps every
field and default of the JAX configuration so existing configs load
unchanged. ``use_pallas`` with ``boundary_mode`` other than ``"rowsum"``
picks the prefix boundary form of pass B (CUDA kernel K3,
``ops.correlator_kernel.block_cumsum_streams``) as it picks the JAX
prefix kernel; every other setting runs K1
(``ops.correlator_kernel.epoch_correlate``), which stands in for both the
JAX dense path and its row-sum kernel
(``channels.batch_runtime.prefix_form``). Fields that only steer a TPU
implementation (``pallas_interpret``, ``epl_method``,
``ablate_word_row``) are accepted and ignored.
"""

from __future__ import annotations

import dataclasses
import math

import torch

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
from sydr_tpu_torch.ops import profiles as prof
from sydr_tpu_torch.ops import scan_kernel
from sydr_tpu_torch.ops import tracking as trk
from sydr_tpu_torch.ops.correlator_kernel import fma32
from sydr_tpu_torch.utils.metrics import count, span

TWO_PI = 2.0 * math.pi
F32 = torch.float32
I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class TrackingConfig:
    """Static tracking configuration (see the JAX class for each field)."""

    sampling_frequency: float = 10e6
    intermediate_frequency: float = 0.0
    block_ms: int = 20
    tail_ms: int = 4
    window_size: int = 10240       # >= samples_per_ms * (1 + margin)
    spacings: tuple = (-0.5, 0.0, 0.5)
    # Borre loop filters (reference channel_GPS_L1CA_borre.ini).
    dll_bandwidth: float = 1.0
    dll_damping: float = 0.7
    dll_gain: float = 1.0
    dll_pdi: float = 1e-3
    pll_bandwidth: float = 8.0
    pll_damping: float = 0.7
    pll_gain: float = 0.25
    pll_pdi: float = 1e-3
    # Carrier-aided code NCO: scale the code rate by the carrier Doppler.
    carrier_aiding: bool = True
    min_convergence_ms: int = 100  # bit-sync arming delay
    bit_sync_flips: int = 10       # sign flips needed to declare bit sync
    bit_sync_unanimous: int = 5    # unanimous-histogram early declaration
    bit_sync_dominance: float = 0.6
    # "borre" (DLL + Costas PLL, 3 taps) or "kaplan" (FLL-assisted PLL +
    # lock-state machine, 5 taps; 3 with kaplan_narrow_only).
    profile: str = "borre"
    kaplan_narrow_only: bool = False
    spacing_wide: float = 0.5
    spacing_narrow: float = 0.2
    fll_bandwidth_pullin: float = 100.0
    fll_bandwidth_wide: float = 50.0
    fll_bandwidth_narrow: float = 15.0
    pll_bandwidth_wide: float = 25.0
    pll_bandwidth_narrow: float = 15.0
    fll_threshold_wide: float = 0.5
    fll_threshold_narrow: float = 0.8
    pll_threshold_narrow: float = 0.8
    lock_indicator_alpha: float = 0.005
    dlf_order: int = 2
    fll_discriminator: str = "atan"
    cn0_estimator: str = "nwpr"
    # Carrier NCO rail around the acquisition anchor [Hz]; 0 disables.
    freq_rail_hz: float = 400.0
    # Anchor slew rate once bit-synced [Hz/s]; 0 disables.
    anchor_slew_hz_per_s: float = 5.0
    # Batch runtime: bound on the carrier correction within one block.
    max_block_freq_step: float = 125.0
    # Code-rate-offset rail [Hz of the 1.023 MHz code clock]; 0 disables.
    code_rail_hz: float = 6.0
    runtime: str = "scan"
    use_pallas: bool = False        # with boundary_mode: K1 or K3
    pallas_interpret: bool = False  # TPU kernel selector: ignored here
    superblock: int = 1
    upload_int8: bool = True
    input_decimate: int = 1
    quantize_spacing: bool = False
    epl_method: str = "bitpack"     # TPU chip-lookup form: ignored here
    boundary_mode: str = "rowsum"   # "prefix" + use_pallas: K3
    pass_a: str = "closed"
    ablate_word_row: int = 0        # TPU fault injection: ignored here

    @property
    def samples_per_ms(self) -> int:
        return round(self.sampling_frequency * 1e-3)

    @property
    def window_samples(self) -> int:
        return (self.tail_ms + self.block_ms) * self.samples_per_ms


def _bit_sync_declare(cfg: TrackingConfig, edge_hist):
    """Bit-edge declaration rule from a mod-20 flip histogram ``[ch, 20]``.

    (a) unanimous: every observed flip in one bin and at least
    ``bit_sync_unanimous`` of them; (b) volume: at least
    ``bit_sync_flips`` flips with the mode bin holding
    ``bit_sync_dominance`` of them.
    """
    total = edge_hist.sum(dim=-1)
    mode = edge_hist.amax(dim=-1)
    if cfg.bit_sync_unanimous > 0:
        unanimous = (mode == total) & (total >= cfg.bit_sync_unanimous)
    else:
        unanimous = torch.zeros_like(total, dtype=torch.bool)
    dominant = (total >= cfg.bit_sync_flips) & (
        mode.to(torch.float32)
        >= cfg.bit_sync_dominance * total.to(torch.float32))
    return unanimous | dominant


def scan_phase_advance(cfg: TrackingConfig, rem_code, rem_carrier, required,
                       delta, omega):
    """Code and carrier phase remainders after an epoch of ``required``
    samples at code-rate offset ``delta`` [Hz] and ``omega`` carrier radians
    per sample, shared by :func:`_epoch` and
    ``batch_runtime._pass_a_scan``.

    Exact-rational code phase: ``fc/fs == 1023/spms``, so ``required*step -
    1023 == 1023*(required - spms)/spms + required*delta/fs`` with every
    term well inside float32. ``required`` of the next epoch is a ``ceil``
    of the result, so the roundings of the compiled JAX reference are
    written out: it folds ``1023 * x / spms`` into ``x * c`` with ``c`` the
    float32 product of 1023 and the float32 reciprocal of ``spms``, divides
    by ``fs`` through its float32 reciprocal, and rounds each
    multiply-and-add once.
    """
    spms = cfg.samples_per_ms
    req_f = required.to(F32)
    # c as a Python float holding the float32 product exactly.
    ratio = (torch.tensor(float(GPS_L1CA_CODE_LENGTH), dtype=F32)
             * torch.tensor(1.0 / spms, dtype=F32)).item()
    whole = ((required - spms).to(F32).double() * ratio
             + rem_code.double()).float()
    rem_code = fma32(req_f, delta * (1.0 / cfg.sampling_frequency), whole)
    rem_carrier = torch.remainder(rem_carrier - omega * req_f, TWO_PI)
    return rem_code, rem_carrier


def _epoch(cfg: TrackingConfig, codes, window_re, window_im,
           st: ChannelState, epoch_idx: int):
    """One 1-ms lockstep epoch across all channels.

    ``window_re/im`` are the block's window padded by
    :func:`_run_block_plain`;
    returns (new_state, outputs ``[n_ch]`` per key).
    """
    spms = cfg.samples_per_ms
    fs = cfg.sampling_frequency
    dev = window_re.device

    # One millisecond of samples "arrives" for every channel.
    avail = (cfg.tail_ms + epoch_idx + 1) * spms
    unread = torch.clamp(st.unread + spms, max=avail)

    # delta: code-rate offset from nominal [Hz], kept apart from the
    # absolute rate so sub-mHz corrections survive float32.
    if cfg.carrier_aiding:
        doppler = st.carrier_freq - cfg.intermediate_frequency
        delta = st.code_freq_offset \
            + doppler * (GPS_L1CA_CODE_FREQ / GPS_L1CA_CARRIER_FREQ)
    else:
        delta = st.code_freq_offset + 0.0
    code_freq = GPS_L1CA_CODE_FREQ + delta
    code_step = code_freq * (1.0 / fs)
    required = torch.ceil(
        (GPS_L1CA_CODE_LENGTH - st.rem_code) / code_step).to(I32)

    active = (st.mode == MODE_TRACKING) & (unread >= required)

    # Per-channel fixed-size window reads at their own offsets, one gather.
    # The window is padded (_run_block_plain) so no read overruns: clamping the
    # start instead would misalign the last epoch of every block for
    # channels whose leftover unread is below window_size - samples_per_ms.
    read_ptr = torch.clamp(avail - unread, min=0)
    idx = read_ptr.to(torch.int64)[:, None] \
        + torch.arange(cfg.window_size, device=dev)[None, :]
    corr = trk.epl_correlate(
        window_re[idx], window_im[idx], codes, required, st.carrier_freq,
        st.rem_carrier, st.rem_code, code_step,
        spacings=prof.spacings_for(cfg), sampling_frequency=fs,
    )  # [n_ch, 2 * n_spacings]

    # --- Discriminators + loop filters (profile-dependent) -----------------
    lu = prof.loop_update(cfg, corr, st, active)
    i_prompt, q_prompt = lu["i_prompt"], lu["q_prompt"]
    code_err, phase_err = lu["code_err"], lu["phase_err"]
    nco_code, nco_carrier = lu["nco_code"], lu["nco_carrier"]

    # --- NCO / phase bookkeeping -------------------------------------------
    rem_code, rem_carrier = scan_phase_advance(
        cfg, st.rem_code, st.rem_carrier, required, delta,
        TWO_PI * st.carrier_freq * (1.0 / fs))
    carrier_freq = st.carrier_freq + nco_carrier
    if cfg.freq_rail_hz > 0:
        carrier_freq = torch.clamp(
            carrier_freq, st.freq_anchor - cfg.freq_rail_hz,
            st.freq_anchor + cfg.freq_rail_hz)
    code_freq_offset = st.code_freq_offset - nco_code
    if cfg.code_rail_hz > 0:
        code_freq_offset = torch.clamp(
            code_freq_offset, -cfg.code_rail_hz, cfg.code_rail_hz)

    # --- Bit-edge synchronisation (histogram method) -----------------------
    # Sign-flip positions are histogrammed modulo 20 epochs and the bit edge
    # is declared at the histogram mode once enough flips are observed.
    had_bit_sync = (st.flags & FLAG_BIT_SYNC) != 0
    ms_counter = torch.where(
        active, torch.remainder(st.ms_counter + 1, 20), st.ms_counter)
    # torch.sign(0) is 0, a sign of its own, as in the JAX runtime.
    sign_flip = torch.sign(st.i_prompt_prev) != torch.sign(i_prompt)
    counting = (active & ~had_bit_sync
                & (st.code_counter > cfg.min_convergence_ms)
                & (st.pll_lock > 0.5))
    flip_now = counting & sign_flip
    onehot = (torch.arange(20, dtype=I32, device=dev)[None, :]
              == ms_counter[:, None]).to(I32)
    edge_hist = st.edge_hist + onehot * flip_now[:, None].to(I32)
    declare = ~had_bit_sync & _bit_sync_declare(cfg, edge_hist)
    bit_edge = torch.where(
        declare, torch.argmax(edge_hist, dim=-1).to(I32), st.bit_edge)
    bit_sync = had_bit_sync | declare
    phase_in_bit = torch.remainder(ms_counter - bit_edge, 20)
    at_edge = active & bit_sync & (phase_in_bit == 0)
    bit_complete = at_edge & (st.accum_count >= 20)
    accum_reset = at_edge | declare
    acc = active & bit_sync
    accum_count = torch.where(accum_reset, 0, st.accum_count) + acc.to(I32)

    # --- C/N0 + lock indicators over bit-aligned 20-ms intervals -----------
    def accumulate(old, term):
        return torch.where(accum_reset, 0.0, old) \
            + torch.where(acc, term, 0.0)

    ip_sum = accumulate(st.ip_sum, i_prompt)
    qp_sum = accumulate(st.qp_sum, q_prompt)
    ip_sq_sum = accumulate(st.ip_sq_sum, i_prompt**2)
    qp_sq_sum = accumulate(st.qp_sq_sum, q_prompt**2)
    ratio_sum = accumulate(st.cn0_ratio_sum, trk.beaulieu_ratio_term(
        i_prompt, q_prompt, st.i_prompt_prev, st.q_prompt_prev))
    cn0 = trk.cn0_update(cfg, bit_complete, st.ip_sum, st.qp_sum,
                         st.ip_sq_sum, st.qp_sq_sum, st.cn0_ratio_sum,
                         st.cn0)

    flags = torch.where(
        active,
        st.flags | FLAG_CODE_LOCK | torch.where(bit_sync, FLAG_BIT_SYNC, 0),
        st.flags).to(I32)

    def upd(new, old):
        return torch.where(active, new, old)

    new_state = ChannelState(
        mode=st.mode,
        flags=flags,
        carrier_freq=upd(carrier_freq, st.carrier_freq),
        freq_anchor=st.freq_anchor,
        code_freq_offset=upd(code_freq_offset, st.code_freq_offset),
        rem_carrier=upd(rem_carrier, st.rem_carrier),
        rem_code=upd(rem_code, st.rem_code),
        dll_memory=upd(code_err, st.dll_memory),
        pll_memory=upd(phase_err, st.pll_memory),
        fll_memory=upd(lu["freq_err"], st.fll_memory),
        fll_vel=lu["fll_vel"],
        fll_acc=lu["fll_acc"],
        i_prompt_prev=upd(i_prompt, st.i_prompt_prev),
        q_prompt_prev=upd(q_prompt, st.q_prompt_prev),
        unread=torch.where(active, unread - required, unread),
        code_counter=upd(st.code_counter + 1, st.code_counter),
        ms_counter=ms_counter,
        edge_hist=edge_hist,
        bit_edge=bit_edge,
        accum_count=accum_count,
        ip_sum=ip_sum,
        qp_sum=qp_sum,
        cn0_ratio_sum=ratio_sum,
        ip_sq_sum=ip_sq_sum,
        qp_sq_sum=qp_sq_sum,
        cn0=cn0,
        pll_lock=lu["pll_lock"],
        fll_lock=lu["fll_lock"],
        lock_state=lu["lock_state"],
    )

    outputs = {
        "active": active,
        "i_early": lu["i_early"], "q_early": lu["q_early"],
        "i_prompt": i_prompt, "q_prompt": q_prompt,
        "i_late": lu["i_late"], "q_late": lu["q_late"],
        "dll_error": code_err, "pll_error": phase_err,
        "fll_error": lu["freq_err"], "lock_state": lu["lock_state"],
        "nco_code": nco_code, "nco_carrier": nco_carrier,
        "carrier_freq": carrier_freq,
        "code_freq": code_freq,
        "cn0": cn0, "pll_lock": lu["pll_lock"], "fll_lock": lu["fll_lock"],
        "flags": flags,
        "unread": new_state.unread,
        "required": required,
        "rem_code": new_state.rem_code,
        "bit_ready": bit_complete,
        # 20-ms prompt sum of the finished bit (valid where bit_ready).
        "bit_ip_sum": st.ip_sum,
    }
    return new_state, outputs


def run_block(cfg: TrackingConfig, codes, state: ChannelState,
              window_re, window_im):
    """Process one block of IQ through all channels, epoch by epoch:
    :func:`_run_block_plain` on CPU tensors, one launch of
    ``csrc/scan_block.cu`` on CUDA tensors (``ops.scan_kernel.scan_block``;
    the same arguments and results).
    """
    return scan_kernel.scan_block(cfg, codes, state, window_re, window_im)


def superblock_loop(cfg: TrackingConfig, k_blocks: int, state: ChannelState,
                    samples_re, samples_im, run_block):
    """``k_blocks`` consecutive blocks through ``run_block(state,
    window_re, window_im) -> (state, outputs)``, the window layout of both
    runtimes' superblocks (:func:`run_superblock` and
    ``batch_runtime.run_superblock``).

    ``samples_re/im`` hold ``tail_ms + k_blocks * block_ms`` milliseconds
    laid out contiguously; block k's window is the slice starting at
    ``k * block_ms`` milliseconds (its tail is the previous block's last
    ``tail_ms``). Returns (state, outputs ``[k_blocks*block_ms, n_ch]``);
    one block's outputs come back as ``run_block`` gave them.
    """
    sb = cfg.block_ms * cfg.samples_per_ms
    win_len = cfg.window_samples
    outs = []
    for k in range(k_blocks):
        start = k * sb
        state, out = run_block(state, samples_re[start:start + win_len],
                               samples_im[start:start + win_len])
        outs.append(out)
    if k_blocks == 1:
        return state, outs[0]
    merged = {key: torch.cat([o[key] for o in outs]) for key in outs[0]}
    return state, merged


def run_superblock(cfg: TrackingConfig, k_blocks: int, codes,
                   state: ChannelState, samples_re, samples_im):
    """``k_blocks`` consecutive blocks of :func:`run_block` over
    ``samples_re/im`` (``tail_ms + k_blocks * block_ms`` milliseconds,
    :func:`superblock_loop`'s layout): ``k_blocks`` launches of
    ``csrc/scan_block.cu`` on CUDA tensors, ``k_blocks`` calls of
    :func:`_run_block_plain` on CPU tensors, each block ending in its own
    anchor slew. Returns (state, outputs ``[k_blocks * block_ms, n_ch]``).

    Span ``sydr.scan.superblock`` (``blocks``, ``channels``; ``tracking``,
    the tracking channels, where the state is on the host: on the card
    counting them would wait on the device) and counter
    ``sydr.scan.blocks``, the blocks enqueued. Under a captured graph both
    record at the capture, not at a replay.
    """
    n_ch = codes.shape[0]
    attrs = {"blocks": k_blocks, "channels": n_ch}
    if state.mode.device.type == "cpu":
        attrs["tracking"] = int((state.mode == MODE_TRACKING).sum())
    with span("sydr.scan.superblock", **attrs):
        count("sydr.scan.blocks", k_blocks)
        return superblock_loop(
            cfg, k_blocks, state, samples_re, samples_im,
            lambda st, wre, wim: run_block(cfg, codes, st, wre, wim))


def _run_block_plain(cfg: TrackingConfig, codes, state: ChannelState,
                     window_re, window_im):
    """:func:`run_block` in plain PyTorch ops, a Python loop over epochs.

    Args:
        cfg: TrackingConfig.
        codes: ``[n_ch, 1025]`` float32 padded code tables
            (``channels.state.code_table``) on the state's device.
        state: ChannelState (``[n_ch]`` tensors).
        window_re, window_im: ``[(tail_ms + block_ms) * samples_per_ms]``
            float32 sample planes; the first ``tail_ms`` ms are the tail of
            the previous block.

    Returns:
        (new_state, outputs) with outputs a dict of ``[block_ms, n_ch]``.
    """
    # Trailing zero pad so every window_size read fits without clamping its
    # start (read_ptr <= window_samples - samples_per_ms; padded samples lie
    # beyond ``required`` and are masked by the correlator).
    pad = max(cfg.window_size - cfg.samples_per_ms, 0)
    if pad:
        window_re = torch.nn.functional.pad(window_re, (0, pad))
        window_im = torch.nn.functional.pad(window_im, (0, pad))
    outs = []
    for e in range(cfg.block_ms):
        state, out = _epoch(cfg, codes, window_re, window_im, state, e)
        outs.append(out)
    outputs = {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
    return _slew_anchor(cfg, state), outputs


def _slew_anchor(cfg: TrackingConfig, st: ChannelState) -> ChannelState:
    """Per-block rail re-anchoring (see ``anchor_slew_hz_per_s``)."""
    if cfg.anchor_slew_hz_per_s <= 0 or cfg.freq_rail_hz <= 0:
        return st
    max_step = cfg.anchor_slew_hz_per_s * cfg.block_ms * 1e-3
    synced = (st.flags & FLAG_BIT_SYNC) != 0
    anchor = st.freq_anchor + torch.clamp(
        st.carrier_freq - st.freq_anchor, -max_step, max_step)
    return dataclasses.replace(
        st, freq_anchor=torch.where(synced, anchor, st.freq_anchor))
