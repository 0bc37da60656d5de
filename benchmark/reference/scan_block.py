"""A scan-runtime block in plain PyTorch: the yardstick of the scan cell.

A frozen copy of the receiver's plain per-millisecond tracking path
(``sydr_tpu_torch/channels/runtime.py``: ``_run_block_plain``, ``_epoch``,
``scan_phase_advance``, ``_bit_sync_declare``, ``_slew_anchor``;
``ops/tracking.py``: ``epl_correlate`` with its direct chip gather,
``dll_nneml``, ``pll_costas``, ``loop_filter_taus``, ``borre_loop_filter``,
the lock indicators, the NWPR C/N0 and the Beaulieu ratio term;
``ops/profiles.py``: ``loop_update``'s borre branch;
``ops/correlator_kernel.py``: ``fma32``), the same operations in the same
order, restricted to what the configuration runs: the borre loops (NNEML
DLL and Costas PLL, each through Borre's PI filter) on exact taps
(``quantize_spacing`` false), carrier-aided code rate, NWPR C/N0. Nothing
here imports the receiver.

SyDR's borre channel (``channel_l1ca_borre.py``, ``runTracking``) runs
the same per-epoch shape: every code period re-reads its window at the
channel's own sample, ``required = ceil((1023 - rem_code) / code_step)``,
E/P/L by a chip gather, the two discriminators through Borre's filter.
Where the receiver departs from SyDR's equations, this copy departs with
it: the code rate is carrier-aided; the carrier frequency is held within
``freq_rail_hz`` of an anchor that slews ``anchor_slew_hz_per_s`` once
bit-synced, and the code-rate offset within ``code_rail_hz``; the code
phase advances in the exact-rational form of ``scan_phase_advance``; bit
sync is declared from a mod-20 histogram of prompt sign flips (SyDR
declares at a flip); C/N0 (NWPR) and the Beaulieu term are taken over
bit-aligned 20 ms; the PLL and FLL lock indicators low-pass with alpha
0.01.

The state is a dict of ``[n_ch]`` tensors (``edge_hist`` ``[n_ch, 20]``)
under the receiver's field names; everything runs on the samples' device.
``precision="bfloat16"`` is the control: the window's samples, the
carrier-mixed samples and each chip product rounded to bfloat16 before
the float32 sums. There is no matrix product, so TF32 does not arise.

``follow=`` (the receiver's outputs over the same samples) runs the
reference step by step along the receiver's own path: each epoch starts
from the receiver's state after its previous epoch (code phase, carrier
frequency, unread samples, the loops' memories, the prompt before, the
lock indicators, flags, C/N0) and correlates at the receiver's code rate,
so both read the same samples at the same chips and part only by that
epoch's arithmetic. The reference's own loops, phase advance, bit sync and
accumulators still compute each epoch's answer.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.cacode import CARRIER_FREQ, CODE_FREQ, CODE_LENGTH, code

TWO_PI = 2.0 * math.pi
F32 = torch.float32
I32 = torch.int32
MODE_TRACKING = 2
FLAG_CODE_LOCK = 1
FLAG_BIT_SYNC = 2
LOCK_NARROW = 2
N_PADDED = 1025
LOCK_ALPHA = 0.01

FIELDS = (
    "mode", "flags", "carrier_freq", "freq_anchor", "code_freq_offset",
    "rem_carrier", "rem_code", "dll_memory", "pll_memory", "fll_memory",
    "fll_vel", "fll_acc", "i_prompt_prev", "q_prompt_prev", "unread",
    "code_counter", "ms_counter", "edge_hist", "bit_edge", "accum_count",
    "ip_sum", "qp_sum", "cn0_ratio_sum", "ip_sq_sum", "qp_sq_sum", "cn0",
    "pll_lock", "fll_lock", "lock_state")


class Params:
    """The scan configuration's numbers (the config file's ``tracking``
    with its ``cruise`` overrides, and the sampling rate)."""

    def __init__(self, config: dict):
        p = dict(config["tracking"], **config["cruise"])
        for k, v in p.items():
            setattr(self, k, v)
        self.fs = float(config["sampling_frequency"])
        self.f_if = float(config["intermediate_frequency"])
        self.spms = round(self.fs * 1e-3)
        self.window_samples = (self.tail_ms + self.block_ms) * self.spms
        self.window_size = self.spms + self.window_extra_samples
        self.spacings = tuple(float(s) for s in self.spacings)
        if not (self.runtime == "scan" and self.profile == "borre"
                and not self.quantize_spacing and self.carrier_aiding
                and self.cn0_estimator == "nwpr"):
            raise ValueError("the plain scan block covers the borre scan "
                             "runtime on exact taps only")


def code_table(prns) -> np.ndarray:
    """``[n_ch, 1025]`` +/-1 chips with one wraparound chip each side
    (index 0 is chip 1022, index 1024 chip 0); zeros for PRN 0."""
    rows = []
    for p in prns:
        if p <= 0:
            rows.append(np.zeros(N_PADDED, np.float32))
        else:
            c = code(p).astype(np.float32)
            rows.append(np.concatenate([c[-1:], c, c[:1]]))
    return np.stack(rows)


def fma32(a, b, c):
    """``a * b + c`` rounded once to float32."""
    return (a.double() * b.double() + c.double()).float()


def _bf16(x, precision):
    return x.to(torch.bfloat16).to(F32) if precision == "bfloat16" else x


def epl_correlate(window_re, window_im, codes, required, carrier_freq,
                  rem_carrier, rem_code, code_step, spacings, fs,
                  precision="float32"):
    """``[n_ch, 2 * n_spacings]``: each channel's window (``[n_ch, W]``,
    from its code period's start) mixed off its carrier, its first
    ``required`` samples correlated with the chips at each spacing."""
    n = torch.arange(window_re.shape[-1], dtype=F32,
                     device=window_re.device)
    rate = TWO_PI * carrier_freq * (1.0 / fs)
    phase = rem_carrier[..., None] - rate[..., None] * n
    cos, sin = torch.cos(phase), torch.sin(phase)
    mixed_re = _bf16(cos * window_re - sin * window_im, precision)
    mixed_im = _bf16(cos * window_im + sin * window_re, precision)
    w = mixed_re.shape[-1]
    n_i = torch.arange(w, device=mixed_re.device)
    n = n_i.to(F32)
    valid = (n_i < required[..., None]).to(F32)
    mre, mim = mixed_re * valid, mixed_im * valid
    outs = []
    for sp in spacings:
        idx = torch.ceil(fma32(n, code_step[..., None],
                               (rem_code + sp)[..., None]))
        chips = torch.gather(codes, -1,
                             idx.to(torch.int64).clamp(0, N_PADDED - 1))
        outs.append(_bf16(chips * mre, precision).sum(dim=-1))
        outs.append(_bf16(chips * mim, precision).sum(dim=-1))
    return torch.stack(outs, dim=-1)


# --- discriminators, filters, indicators --------------------------------

def _taus(bandwidth, damping, gain):
    wn = bandwidth * 8.0 * damping / (4.0 * damping**2 + 1.0)
    return gain / wn**2, 2.0 * damping / wn


def _borre_filter(value, memory, tau1, tau2, pdi):
    return (tau2 / tau1) * (value - memory) + (pdi / tau1) * value


def _dll_nneml(ie, qe, il, ql):
    e = torch.sqrt(ie**2 + qe**2)
    l = torch.sqrt(il**2 + ql**2)
    return torch.where(e + l > 0.0, (e - l) / (e + l), 0.0)


def _pll_costas(ip, qp):
    nz = ip != 0.0
    ratio = torch.where(nz, qp / torch.where(nz, ip, 1.0), 0.0)
    return torch.atan(ratio) / TWO_PI


def _low_pass(new, old, alpha):
    return (1.0 - alpha) * old + alpha * new


def _pll_lock(ip, qp, prev):
    nbd = ip**2 - qp**2
    nbp = ip**2 + qp**2
    return _low_pass(torch.where(nbp > 0.0, nbd / nbp, 0.0), prev,
                     LOCK_ALPHA)


def _fll_lock(ip, qp, ipp, qpp, prev):
    dot = ip * ipp - qp * qpp
    cross_sign = torch.sign(ip * ipp + qp * qpp)
    power = ip**2 + qp**2
    value = torch.where(power > 0.0, torch.abs(dot * cross_sign / power),
                        0.0)
    return _low_pass(value, prev, LOCK_ALPHA)


def _cn0_nwpr(i_sum, q_sum, i_sq, q_sq, n_accum=20, t_int=1e-3):
    nbp = i_sum**2 + q_sum**2
    wbp = i_sq + q_sq
    ratio = torch.where(wbp > 0.0, nbp / wbp, 1.0)
    arg = (ratio - 1.0) / (n_accum - ratio) / t_int
    return 10.0 * torch.log10(torch.clamp(arg, min=1e-12))


def _beaulieu_term(ip, qp, ipp, qpp):
    m1, m0 = ip**2 + qp**2, ipp**2 + qpp**2
    pn = (torch.sqrt(m1) - torch.sqrt(m0)) ** 2
    pd = m1 + m0
    return torch.where(pd > 0.0, pn / pd, 0.0)


def _bit_sync_declare(p: Params, hist):
    total = hist.sum(dim=-1)
    mode = hist.amax(dim=-1)
    if p.bit_sync_unanimous > 0:
        unanimous = (mode == total) & (total >= p.bit_sync_unanimous)
    else:
        unanimous = torch.zeros_like(total, dtype=torch.bool)
    dominant = (total >= p.bit_sync_flips) & (
        mode.to(F32) >= p.bit_sync_dominance * total.to(F32))
    return unanimous | dominant


def _loops(p: Params, corr, s, active):
    """One epoch of the borre loops (``s``: the state)."""
    ie, qe = corr[:, 0], corr[:, 1]
    ip, qp = corr[:, 2], corr[:, 3]
    il, ql = corr[:, 4], corr[:, 5]
    t1, t2 = _taus(p.dll_bandwidth, p.dll_damping, p.dll_gain)
    code_err = _dll_nneml(ie, qe, il, ql)
    nco_code = _borre_filter(code_err, s["dll_memory"], t1, t2, p.dll_pdi)
    t1, t2 = _taus(p.pll_bandwidth, p.pll_damping, p.pll_gain)
    phase_err = _pll_costas(ip, qp)
    nco_carrier = _borre_filter(phase_err, s["pll_memory"], t1, t2,
                                p.pll_pdi)
    pll_lock = torch.where(active, _pll_lock(ip, qp, s["pll_lock"]),
                           s["pll_lock"])
    fll_lock = torch.where(
        active, _fll_lock(ip, qp, s["i_prompt_prev"], s["q_prompt_prev"],
                          s["fll_lock"]), s["fll_lock"])
    lock_state = torch.where(active, LOCK_NARROW, s["lock_state"]).to(I32)
    return {"i_early": ie, "q_early": qe, "i_prompt": ip, "q_prompt": qp,
            "i_late": il, "q_late": ql, "code_err": code_err,
            "phase_err": phase_err, "freq_err": torch.zeros_like(phase_err),
            "nco_code": nco_code, "nco_carrier": nco_carrier,
            "pll_lock": pll_lock, "fll_lock": fll_lock,
            "lock_state": lock_state}


def _phase_advance(p: Params, rem_code, rem_carrier, required, delta,
                   omega):
    req_f = required.to(F32)
    ratio = (torch.tensor(float(CODE_LENGTH), dtype=F32)
             * torch.tensor(1.0 / p.spms, dtype=F32)).item()
    whole = ((required - p.spms).to(F32).double() * ratio
             + rem_code.double()).float()
    rem_code = fma32(req_f, delta * (1.0 / p.fs), whole)
    rem_carrier = torch.remainder(rem_carrier - omega * req_f, TWO_PI)
    return rem_code, rem_carrier


def _follow(s, prev):
    """State ``s`` with the fields that the receiver's outputs of its
    previous epoch (``prev``, ``[n_ch]``) carry set to the receiver's."""
    act = prev["active"].to(torch.bool)

    def keep(new, old):
        return torch.where(act, new.to(old.dtype), old)

    return dict(
        s, rem_code=prev["rem_code"], unread=prev["unread"].to(I32),
        carrier_freq=keep(prev["carrier_freq"], s["carrier_freq"]),
        dll_memory=keep(prev["dll_error"], s["dll_memory"]),
        pll_memory=keep(prev["pll_error"], s["pll_memory"]),
        i_prompt_prev=keep(prev["i_prompt"], s["i_prompt_prev"]),
        q_prompt_prev=keep(prev["q_prompt"], s["q_prompt_prev"]),
        pll_lock=prev["pll_lock"], fll_lock=prev["fll_lock"],
        flags=prev["flags"].to(I32), lock_state=prev["lock_state"].to(I32),
        cn0=prev["cn0"])


def epoch(p: Params, codes, window_re, window_im, s, e: int,
          precision="float32", code_freq=None):
    """Epoch ``e`` of the block over every channel (``window_re/im``
    padded by :func:`run_block`); ``code_freq``, where given, the code rate
    to correlate at in place of the state's. Returns (state, outputs
    ``[n_ch]``)."""
    spms, fs = p.spms, p.fs
    dev = window_re.device
    avail = (p.tail_ms + e + 1) * spms
    unread = torch.clamp(s["unread"] + spms, max=avail)
    doppler = s["carrier_freq"] - p.f_if
    delta = s["code_freq_offset"] + doppler * (CODE_FREQ / CARRIER_FREQ)
    if code_freq is None:
        code_freq = CODE_FREQ + delta
    code_step = code_freq * (1.0 / fs)
    required = torch.ceil(
        (CODE_LENGTH - s["rem_code"]) / code_step).to(I32)
    active = (s["mode"] == MODE_TRACKING) & (unread >= required)
    read_ptr = torch.clamp(avail - unread, min=0)
    idx = read_ptr.to(torch.int64)[:, None] \
        + torch.arange(p.window_size, device=dev)[None, :]
    corr = epl_correlate(
        window_re[idx], window_im[idx], codes, required, s["carrier_freq"],
        s["rem_carrier"], s["rem_code"], code_step, p.spacings, fs,
        precision)
    lu = _loops(p, corr, s, active)
    i_prompt, q_prompt = lu["i_prompt"], lu["q_prompt"]
    code_err, phase_err = lu["code_err"], lu["phase_err"]
    nco_code, nco_carrier = lu["nco_code"], lu["nco_carrier"]

    rem_code, rem_carrier = _phase_advance(
        p, s["rem_code"], s["rem_carrier"], required, delta,
        TWO_PI * s["carrier_freq"] * (1.0 / fs))
    carrier_freq = s["carrier_freq"] + nco_carrier
    if p.freq_rail_hz > 0:
        carrier_freq = torch.clamp(
            carrier_freq, s["freq_anchor"] - p.freq_rail_hz,
            s["freq_anchor"] + p.freq_rail_hz)
    code_freq_offset = s["code_freq_offset"] - nco_code
    if p.code_rail_hz > 0:
        code_freq_offset = torch.clamp(
            code_freq_offset, -p.code_rail_hz, p.code_rail_hz)

    had_bit_sync = (s["flags"] & FLAG_BIT_SYNC) != 0
    ms_counter = torch.where(
        active, torch.remainder(s["ms_counter"] + 1, 20), s["ms_counter"])
    sign_flip = torch.sign(s["i_prompt_prev"]) != torch.sign(i_prompt)
    counting = (active & ~had_bit_sync
                & (s["code_counter"] > p.min_convergence_ms)
                & (s["pll_lock"] > 0.5))
    flip_now = counting & sign_flip
    onehot = (torch.arange(20, dtype=I32, device=dev)[None, :]
              == ms_counter[:, None]).to(I32)
    edge_hist = s["edge_hist"] + onehot * flip_now[:, None].to(I32)
    declare = ~had_bit_sync & _bit_sync_declare(p, edge_hist)
    bit_edge = torch.where(
        declare, torch.argmax(edge_hist, dim=-1).to(I32), s["bit_edge"])
    bit_sync = had_bit_sync | declare
    phase_in_bit = torch.remainder(ms_counter - bit_edge, 20)
    at_edge = active & bit_sync & (phase_in_bit == 0)
    bit_complete = at_edge & (s["accum_count"] >= 20)
    accum_reset = at_edge | declare
    acc = active & bit_sync
    accum_count = torch.where(accum_reset, 0, s["accum_count"]) \
        + acc.to(I32)

    def accumulate(old, term):
        return torch.where(accum_reset, 0.0, old) \
            + torch.where(acc, term, 0.0)

    ip_sum = accumulate(s["ip_sum"], i_prompt)
    qp_sum = accumulate(s["qp_sum"], q_prompt)
    ip_sq_sum = accumulate(s["ip_sq_sum"], i_prompt**2)
    qp_sq_sum = accumulate(s["qp_sq_sum"], q_prompt**2)
    ratio_sum = accumulate(s["cn0_ratio_sum"], _beaulieu_term(
        i_prompt, q_prompt, s["i_prompt_prev"], s["q_prompt_prev"]))
    cn0 = torch.where(bit_complete, _cn0_nwpr(
        s["ip_sum"], s["qp_sum"], s["ip_sq_sum"], s["qp_sq_sum"]), s["cn0"])
    flags = torch.where(
        active,
        s["flags"] | FLAG_CODE_LOCK | torch.where(bit_sync, FLAG_BIT_SYNC, 0),
        s["flags"]).to(I32)

    def upd(new, old):
        return torch.where(active, new, old)

    new = dict(
        s, flags=flags,
        carrier_freq=upd(carrier_freq, s["carrier_freq"]),
        code_freq_offset=upd(code_freq_offset, s["code_freq_offset"]),
        rem_carrier=upd(rem_carrier, s["rem_carrier"]),
        rem_code=upd(rem_code, s["rem_code"]),
        dll_memory=upd(code_err, s["dll_memory"]),
        pll_memory=upd(phase_err, s["pll_memory"]),
        fll_memory=upd(lu["freq_err"], s["fll_memory"]),
        i_prompt_prev=upd(i_prompt, s["i_prompt_prev"]),
        q_prompt_prev=upd(q_prompt, s["q_prompt_prev"]),
        unread=torch.where(active, unread - required, unread),
        code_counter=upd(s["code_counter"] + 1, s["code_counter"]),
        ms_counter=ms_counter, edge_hist=edge_hist, bit_edge=bit_edge,
        accum_count=accum_count, ip_sum=ip_sum, qp_sum=qp_sum,
        cn0_ratio_sum=ratio_sum, ip_sq_sum=ip_sq_sum, qp_sq_sum=qp_sq_sum,
        cn0=cn0, pll_lock=lu["pll_lock"], fll_lock=lu["fll_lock"],
        lock_state=lu["lock_state"])
    outputs = {
        "active": active,
        "i_early": lu["i_early"], "q_early": lu["q_early"],
        "i_prompt": i_prompt, "q_prompt": q_prompt,
        "i_late": lu["i_late"], "q_late": lu["q_late"],
        "dll_error": code_err, "pll_error": phase_err,
        "fll_error": lu["freq_err"], "lock_state": lu["lock_state"],
        "nco_code": nco_code, "nco_carrier": nco_carrier,
        "carrier_freq": carrier_freq, "code_freq": code_freq,
        "cn0": cn0, "pll_lock": lu["pll_lock"], "fll_lock": lu["fll_lock"],
        "flags": flags, "unread": new["unread"], "required": required,
        "rem_code": new["rem_code"], "bit_ready": bit_complete,
        "bit_ip_sum": s["ip_sum"],
    }
    return new, outputs


def run_block(p: Params, codes, state, window_re, window_im,
              precision="float32", follow=None, before=None):
    """One block of ``p.block_ms`` epochs over ``window_re/im`` (``tail_ms
    + block_ms`` milliseconds), then the anchor slew. ``follow``: the
    receiver's outputs ``[block_ms, n_ch]`` of this block to run along
    (the module's docstring), ``before`` its outputs of the epoch before
    the block (None at the superblock's start, whose state is the
    receiver's). Returns (state, outputs ``[block_ms, n_ch]``)."""
    window_re = _bf16(window_re, precision)
    window_im = _bf16(window_im, precision)
    pad = max(p.window_size - p.spms, 0)
    if pad:
        window_re = torch.nn.functional.pad(window_re, (0, pad))
        window_im = torch.nn.functional.pad(window_im, (0, pad))
    outs = []
    s = dict(state)
    for e in range(p.block_ms):
        code_freq = None
        if follow is not None:
            prev = before if e == 0 else {k: v[e - 1]
                                           for k, v in follow.items()}
            if prev is not None:
                s = _follow(s, prev)
            code_freq = follow["code_freq"][e]
        s, out = epoch(p, codes, window_re, window_im, s, e, precision,
                       code_freq)
        outs.append(out)
    outputs = {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
    if p.anchor_slew_hz_per_s > 0 and p.freq_rail_hz > 0:
        max_step = p.anchor_slew_hz_per_s * p.block_ms * 1e-3
        synced = (s["flags"] & FLAG_BIT_SYNC) != 0
        anchor = s["freq_anchor"] + torch.clamp(
            s["carrier_freq"] - s["freq_anchor"], -max_step, max_step)
        s["freq_anchor"] = torch.where(synced, anchor, s["freq_anchor"])
    return s, outputs


def run_superblock(p: Params, codes, state, samples_re, samples_im,
                   precision="float32", follow=None):
    """``p.superblock`` consecutive blocks from ``state`` over
    ``samples_re/im`` (``tail_ms + superblock * block_ms`` ms; block k's
    window starts at ``k * block_ms`` ms). ``codes``: :func:`code_table` on
    the samples' device, as ``state``. ``follow``: the receiver's outputs
    ``[superblock * block_ms, n_ch]`` from ``state`` over the same samples,
    on the samples' device, to run along step by step (the module's
    docstring). Returns (state, outputs ``[superblock * block_ms,
    n_ch]``)."""
    sb = p.block_ms * p.spms
    bm = p.block_ms
    outs = []
    for k in range(p.superblock):
        part = before = None
        if follow is not None:
            part = {key: v[k * bm:(k + 1) * bm] for key, v in follow.items()}
            if k:
                before = {key: v[k * bm - 1] for key, v in follow.items()}
        state, out = run_block(
            p, codes, state,
            samples_re[k * sb:k * sb + p.window_samples],
            samples_im[k * sb:k * sb + p.window_samples], precision,
            part, before)
        outs.append(out)
    return state, {k: torch.cat([o[k] for o in outs]) for k in outs[0]}
