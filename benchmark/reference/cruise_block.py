"""A cruise block in plain PyTorch: the yardstick of the tracking cells.

A frozen copy of the receiver's plain tracking path for the cruise shape
(``sydr_tpu_torch/channels/batch_runtime.py``: ``_rates``,
``_pass_a_closed``, ``_intercept``, ``block_geometry``, ``epoch_bounds``,
``_pass_c``; ``ops/correlator_kernel.py``: ``_dense_streams``,
``epoch_correlate_ref``; ``ops/profiles.py``: ``loop_update``, kaplan
narrow-only, second-order loop filter, arctangent FLL; ``ops/tracking.py``:
discriminators, filters, indicators, the NWPR C/N0;
``channels/runtime.py``: ``_bit_sync_declare``, ``_slew_anchor``), the
same operations in the same order, restricted to what the cruise
configuration runs: kaplan with ``kaplan_narrow_only``, sample-quantised
taps, closed pass A, epoch sums of the dense streams (the row-sum form of
pass B). Nothing here imports the receiver.

The state is a dict of ``[n_ch]`` tensors (``edge_hist`` ``[n_ch, 20]``)
under the receiver's field names. ``run_superblock`` runs ``superblock``
blocks: the epoch geometry and the loops on ``state``'s device, the
correlation streams on ``streams_device`` (the card: the dense streams
are ``[n_ch, 6, n_win]``). ``precision="bfloat16"`` is the control: the
window's samples, the carrier-mixed samples and each chip product rounded
to bfloat16 before the float32 epoch sums.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.cacode import CARRIER_FREQ, CODE_FREQ, CODE_LENGTH, code_bits

TWO_PI = 2.0 * math.pi
F32 = torch.float32
I32 = torch.int32
MODE_TRACKING = 2
FLAG_CODE_LOCK = 1
FLAG_BIT_SYNC = 2
LOCK_NARROW = 2
DLF_W0_SCALE_1ST = 0.25
DLF_W0_SCALE_2ND = 0.53
DLF_A2 = 1.414
CODE_WIDTH = 4160
CODE_ORIGIN = 1023

FIELDS = (
    "mode", "flags", "carrier_freq", "freq_anchor", "code_freq_offset",
    "rem_carrier", "rem_code", "dll_memory", "pll_memory", "fll_memory",
    "fll_vel", "fll_acc", "i_prompt_prev", "q_prompt_prev", "unread",
    "code_counter", "ms_counter", "edge_hist", "bit_edge", "accum_count",
    "ip_sum", "qp_sum", "cn0_ratio_sum", "ip_sq_sum", "qp_sq_sum", "cn0",
    "pll_lock", "fll_lock", "lock_state")
INT_FIELDS = frozenset({
    "mode", "flags", "unread", "code_counter", "ms_counter", "edge_hist",
    "bit_edge", "accum_count", "lock_state"})


class Params:
    """The cruise configuration's numbers (the config file's ``tracking``
    with its ``cruise`` overrides, and the sampling rate)."""

    def __init__(self, config: dict):
        p = dict(config["tracking"], **config["cruise"])
        for k, v in p.items():
            setattr(self, k, v)
        self.fs = float(config["sampling_frequency"])
        self.f_if = float(config["intermediate_frequency"])
        self.spms = round(self.fs * 1e-3)
        self.window_samples = (self.tail_ms + self.block_ms) * self.spms
        if not (self.profile == "kaplan" and self.kaplan_narrow_only
                and self.quantize_spacing and self.pass_a == "closed"
                and self.dlf_order == 2 and self.fll_discriminator == "atan"
                and self.cn0_estimator == "nwpr" and self.carrier_aiding):
            raise ValueError("the plain cruise block covers the narrow-only "
                             "kaplan cruise shape only")

    def taps(self) -> tuple:
        """((base spacing, sample shift), ...) of the quantised taps."""
        step0 = CODE_FREQ / self.fs
        n = self.spacing_narrow
        sp = tuple(0.0 if s == 0.0 else
                   max(1, abs(round(s / step0))) * (1 if s > 0 else -1)
                   * step0 for s in (-n, 0.0, n))
        return tuple((sp[0], int(round((s - sp[0]) / step0))) for s in sp)


def tiled_code_bits(prns) -> np.ndarray:
    """``[n_ch, 4160]`` 0/1 chips tiled 4x with slack (zeros for PRN 0)."""
    rows = [np.zeros(CODE_LENGTH, np.float32) if p <= 0 else
            code_bits(p).astype(np.float32) for p in prns]
    tiled = np.concatenate([np.stack(rows)] * 4, axis=1)
    pad = np.zeros((len(prns), CODE_WIDTH - 4 * CODE_LENGTH), np.float32)
    return np.concatenate([tiled, pad], axis=1)


def fma32(a, b, c):
    """``a * b + c`` rounded once to float32."""
    return (a.double() * b.double() + c.double()).float()


def _rates(p: Params, st):
    doppler = st["carrier_freq"] - p.f_if
    delta = st["code_freq_offset"] + doppler * (CODE_FREQ / CARRIER_FREQ)
    code_step = (CODE_FREQ + delta) * (1.0 / p.fs)
    omega = TWO_PI * st["carrier_freq"] * (1.0 / p.fs)
    return delta, code_step, omega


def pass_a(p: Params, st):
    """Every epoch boundary and phase of the block under frozen rates."""
    spms, fs, n_epochs = p.spms, p.fs, p.block_ms
    dev = st["rem_code"].device
    delta, code_step, omega = _rates(p, st)
    e_i = torch.arange(n_epochs, dtype=I32, device=dev)[:, None]
    e_f = e_i.to(F32)
    eps = delta * (float(spms) / fs)
    g = -fma32(e_f + 1.0, eps[None, :], st["rem_code"][None, :]) \
        / code_step[None, :]
    dd = torch.ceil(g).to(I32)
    c_full = (e_i + 1) * spms + dd
    c_prev = torch.cat([torch.zeros_like(dd[:1]), c_full[:-1]], dim=0)
    required = c_full - c_prev
    w = torch.minimum(st["unread"][None, :] + (e_i + 1) * spms,
                      (p.tail_ms + e_i + 1) * spms)
    tracking = st["mode"] == MODE_TRACKING
    all_ok = tracking[None, :] & torch.all(w >= c_full, dim=0, keepdim=True)
    active = all_ok.expand_as(required)
    d_prev = c_prev - e_i * spms
    rem_code_seq = st["rem_code"][None, :] + e_f * eps[None, :] \
        + d_prev.to(F32) * code_step[None, :]
    om_ms = torch.remainder(omega * float(spms), TWO_PI)
    rem_carrier_seq = torch.remainder(
        st["rem_carrier"][None, :]
        - (om_ms[None, :] * e_f + omega[None, :] * d_prev.to(F32)), TWO_PI)
    c_eff = torch.where(active, c_full, 0)
    c_prev_eff = torch.where(active, c_prev, 0)
    geo = {
        "required": required, "active": active, "b_start": c_prev_eff,
        "rem_code": torch.where(active, rem_code_seq,
                                st["rem_code"][None, :]),
        "rem_carrier": torch.where(active, rem_carrier_seq,
                                   st["rem_carrier"][None, :]),
        "unread_after": w - c_eff,
    }
    last = n_epochs - 1
    e_end = float(n_epochs)
    d_end = (c_full[last] - n_epochs * spms).to(F32)
    rem_code_end = st["rem_code"] + e_end * eps + d_end * code_step
    rem_carrier_end = torch.remainder(
        st["rem_carrier"] - (om_ms * e_end + omega * d_end), TWO_PI)
    act1 = all_ok[0]
    geo["rem_code_end"] = torch.where(act1, rem_code_end, st["rem_code"])
    geo["rem_carrier_end"] = torch.where(act1, rem_carrier_end,
                                         st["rem_carrier"])
    geo["unread_end"] = w[last] - torch.where(act1, c_full[last], 0)
    geo.update(code_step=code_step, omega=omega, delta=delta)
    return geo


def pass_b_inputs(p: Params, st, geo):
    """The correlation's per-channel inputs and the epoch bounds."""
    spms, fs = p.spms, p.fs
    delta, omega = geo["delta"], geo["omega"]
    avail0 = (p.tail_ms + 1) * spms
    unread0 = torch.clamp(st["unread"] + spms, max=avail0)
    base = avail0 - unread0
    a_ms = torch.div(base, spms, rounding_mode="floor")
    b_rem = base - a_ms * spms
    b1023 = (b_rem * CODE_LENGTH).to(F32)
    phase = st["rem_code"] - base.to(F32) * (delta * (1.0 / fs)) \
        - b1023 * (1.0 / spms)
    phase = torch.remainder(phase, float(CODE_LENGTH))
    c_int = torch.floor(phase).to(I32)
    fb = phase - c_int.to(F32)
    n_q = p.tail_ms + p.block_ms
    qs = torch.arange(n_q, dtype=F32, device=fb.device)
    fb_q = fb[:, None] + qs[None, :] * (spms * delta * (1.0 / fs))[:, None]
    w_ms = torch.remainder(omega * spms, TWO_PI)
    phic0 = (geo["rem_carrier"][0] + a_ms.to(F32) * w_ms
             + omega * b_rem.to(F32))
    phic_q = torch.remainder(phic0[:, None] - qs[None, :] * w_ms[:, None],
                             TWO_PI)
    n_win = p.window_samples
    req_eff = torch.where(geo["active"], geo["required"], 0)
    b_start = torch.clamp(geo["b_start"] + base[None, :], 0, n_win)
    last_end = torch.clamp(b_start[-1:] + req_eff[-1:], 0, n_win)
    bounds = torch.cat([b_start, last_end], dim=0).to(I32)
    return (c_int, omega, geo["code_step"], fb_q, phic_q), bounds


def _bf16(x, precision):
    return x.to(torch.bfloat16).to(F32) if precision == "bfloat16" else x


def epoch_correlate(window_re, window_im, code, c_int, omega, code_step,
                    fb_q, phic_q, bounds, taps, spms, precision="float32"):
    """Per-epoch correlators ``[n_epochs, n_ch, 2 * n_taps]``: every
    stream built densely over the window, each epoch's samples summed."""
    dev = window_re.device
    n_ch, n_q = fb_q.shape
    n_win = window_re.shape[0]
    n_epochs = bounds.shape[0] - 1
    window_re = _bf16(window_re, precision)
    window_im = _bf16(window_im, precision)
    m = torch.arange(n_win, device=dev, dtype=torch.int64)
    q = m // spms
    lm = (m - q * spms).to(F32)
    phase = fma32(-omega[:, None], lm[None, :], phic_q[:, q])
    cosv, sinv = torch.cos(phase), torch.sin(phase)
    mre = _bf16(cosv * window_re[None, :] - sinv * window_im[None, :],
                precision)
    mim = _bf16(cosv * window_im[None, :] + sinv * window_re[None, :],
                precision)
    origin = (CODE_ORIGIN + c_int.to(torch.int64))[:, None]
    streams = []
    for sp, k in taps:
        mk = m + k
        qk = torch.clamp(mk // spms, max=n_q - 1)
        lk = (mk - qk * spms).to(F32)
        r = fb_q[:, qk] + sp
        idx = torch.ceil(fma32(lk[None, :], code_step[:, None], r)).to(
            torch.int64)
        pos = torch.clamp(origin + idx, 0, CODE_WIDTH - 1)
        chips = 2.0 * torch.gather(code, 1, pos) - 1.0
        streams += [_bf16(chips * mre, precision),
                    _bf16(chips * mim, precision)]
    dense = torch.stack(streams, dim=1)
    edges = bounds.to(torch.int64).t().contiguous()
    seg = torch.searchsorted(
        edges, m.expand(n_ch, n_win).contiguous(), right=True) - 1
    seg = torch.where((seg < 0) | (seg >= n_epochs), n_epochs, seg)
    n_s = dense.shape[1]
    sums = torch.zeros(n_ch, n_s, n_epochs + 1, dtype=F32, device=dev)
    sums.scatter_add_(2, seg[:, None, :].expand(n_ch, n_s, n_win), dense)
    return sums[:, :, :n_epochs].permute(2, 0, 1).contiguous()


# --- discriminators, filters, indicators --------------------------------

def _taus(bandwidth, damping, gain):
    wn = bandwidth * 8.0 * damping / (4.0 * damping**2 + 1.0)
    return gain / wn**2, 2.0 * damping / wn


def _dll_nneml(ie, qe, il, ql):
    e = torch.sqrt(ie**2 + qe**2)
    l = torch.sqrt(il**2 + ql**2)
    return torch.where(e + l > 0.0, (e - l) / (e + l), 0.0)


def _pll_costas(ip, qp):
    nz = ip != 0.0
    ratio = torch.where(nz, qp / torch.where(nz, ip, 1.0), 0.0)
    return torch.atan(ratio) / TWO_PI


def _fll_atan(ip, qp, ipp, qpp, dt):
    nz, nzp = ip != 0.0, ipp != 0.0
    a = torch.where(nz, qp / torch.where(nz, ip, 1.0), 0.0)
    b = torch.where(nzp, qpp / torch.where(nzp, ipp, 1.0), 0.0)
    diff = torch.atan(a) - torch.atan(b)
    diff = torch.where(torch.isnan(diff), 0.0, diff)
    diff = torch.where(diff >= math.pi / 2.0, diff - math.pi, diff)
    diff = torch.where(diff <= -math.pi / 2.0, diff + math.pi, diff)
    return diff / dt / TWO_PI


def _low_pass(new, old, alpha):
    return (1.0 - alpha) * old + alpha * new


def _pll_lock(ip, qp, prev, alpha):
    nbd = ip**2 - qp**2
    nbp = ip**2 + qp**2
    return _low_pass(torch.where(nbp > 0.0, nbd / nbp, 0.0), prev, alpha)


def _fll_lock(ip, qp, ipp, qpp, prev, alpha):
    dot = ip * ipp - qp * qpp
    cross_sign = torch.sign(ip * ipp + qp * qpp)
    power = ip**2 + qp**2
    value = torch.where(power > 0.0, torch.abs(dot * cross_sign / power),
                        0.0)
    return _low_pass(value, prev, alpha)


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


def _loop_update(p: Params, corr, s, active, comp):
    """One epoch of the narrow-only kaplan loops (``s``: the loop state)."""
    ie, qe = corr[:, 0], corr[:, 1]
    ip, qp = corr[:, 2], corr[:, 3]
    il, ql = corr[:, 4], corr[:, 5]
    t1, t2 = _taus(p.dll_bandwidth, p.dll_damping, p.dll_gain)
    code_err = _dll_nneml(ie, qe, il, ql) - comp["code"]
    nco_code = (t2 / t1) * (code_err - s["dll_memory"]) \
        + (p.dll_pdi / t1) * code_err
    pull_in = torch.zeros_like(s["lock_state"], dtype=torch.bool)
    converged = s["code_counter"] > 1
    freq_err = torch.where(
        converged, _fll_atan(ip, qp, s["i_prompt_prev"], s["q_prompt_prev"],
                             1e-3), 0.0)
    phase_err = torch.where(pull_in, 0.0, _pll_costas(ip, qp))
    freq_err = torch.where(converged, freq_err - comp["freq"], 0.0)
    phase_err = torch.where(pull_in, 0.0, phase_err - comp["phase"])
    cap = 0.12 / (p.block_ms * 1e-3)
    fll_bw = torch.full_like(s["fll_vel"], min(p.fll_bandwidth_narrow, cap))
    pll_bw = torch.full_like(s["fll_vel"], min(p.pll_bandwidth_narrow, cap))
    w0f, w0p = fll_bw / DLF_W0_SCALE_1ST, pll_bw / DLF_W0_SCALE_2ND
    update = (phase_err * w0p**2 + freq_err * w0f) * 1e-3
    nco_carrier = update + s["fll_vel"] + phase_err * DLF_A2 * w0p
    fll_vel = torch.where(active, update, s["fll_vel"])
    alpha = p.lock_indicator_alpha
    fll_lock = torch.where(
        active, _fll_lock(ip, qp, s["i_prompt_prev"], s["q_prompt_prev"],
                          s["fll_lock"], alpha), s["fll_lock"])
    pll_lock = torch.where(active & ~pull_in,
                           _pll_lock(ip, qp, s["pll_lock"], alpha),
                           s["pll_lock"])
    lock_state = torch.where(active, LOCK_NARROW, s["lock_state"]).to(I32)
    return {"i_early": ie, "q_early": qe, "i_prompt": ip, "q_prompt": qp,
            "i_late": il, "q_late": ql, "code_err": code_err,
            "phase_err": phase_err, "freq_err": freq_err,
            "nco_code": nco_code, "nco_carrier": nco_carrier,
            "fll_vel": fll_vel, "pll_lock": pll_lock, "fll_lock": fll_lock,
            "lock_state": lock_state}


def pass_c(p: Params, st, geo, corr):
    """The block's epochs through the loops, then the anchor slew.
    Returns (new state, outputs ``{name: [block_ms, n_ch]}``)."""
    frozen_carrier = st["carrier_freq"]
    frozen_code_off = st["code_freq_offset"]
    rem_code_next = torch.cat(
        [geo["rem_code"][1:], geo["rem_code_end"][None]], dim=0)
    hist_bins = torch.arange(20, dtype=I32, device=corr.device)[None, :]
    s = dict(st)
    phi_virt = torch.zeros_like(st["carrier_freq"])
    chip_virt = torch.zeros_like(st["carrier_freq"])
    ipc_prev, qpc_prev = st["i_prompt_prev"], st["q_prompt_prev"]
    outs = []
    for e in range(p.block_ms):
        c, active = corr[e], geo["active"][e]

        def upd(new, old):
            return torch.where(active, new, old)

        comp = {"freq": s["carrier_freq"] - frozen_carrier,
                "phase": phi_virt - torch.round(phi_virt),
                "code": chip_virt}
        lu = _loop_update(p, c, s, active, comp)
        i_prompt, q_prompt = lu["i_prompt"], lu["q_prompt"]
        new_carrier = s["carrier_freq"] + lu["nco_carrier"]
        if p.freq_rail_hz > 0:
            new_carrier = torch.clamp(
                new_carrier, st["freq_anchor"] - p.freq_rail_hz,
                st["freq_anchor"] + p.freq_rail_hz)
        if p.max_block_freq_step > 0:
            new_carrier = torch.clamp(
                new_carrier, frozen_carrier - p.max_block_freq_step,
                frozen_carrier + p.max_block_freq_step)
        new_code_off = s["code_freq_offset"] - lu["nco_code"]
        if p.code_rail_hz > 0:
            new_code_off = torch.clamp(new_code_off, -p.code_rail_hz,
                                       p.code_rail_hz)
        theta = TWO_PI * comp["phase"]
        cth, sth = torch.cos(theta), torch.sin(theta)
        ip_c = i_prompt * cth + q_prompt * sth
        qp_c = q_prompt * cth - i_prompt * sth

        flags = s["flags"]
        had_sync = (flags & FLAG_BIT_SYNC) != 0
        new_ms = torch.where(active, torch.remainder(s["ms_counter"] + 1, 20),
                             s["ms_counter"])
        sign_flip = torch.sign(ipc_prev) != torch.sign(ip_c)
        counting = (active & ~had_sync
                    & (s["code_counter"] > p.min_convergence_ms)
                    & (s["pll_lock"] > 0.5))
        flip_now = counting & sign_flip
        onehot = (hist_bins == new_ms[:, None]).to(I32)
        new_hist = s["edge_hist"] + onehot * flip_now[:, None].to(I32)
        declare = ~had_sync & _bit_sync_declare(p, new_hist)
        new_edge = torch.where(
            declare, torch.argmax(new_hist, dim=-1).to(I32), s["bit_edge"])
        bit_sync = had_sync | declare
        phase_in_bit = torch.remainder(new_ms - new_edge, 20)
        at_edge = active & bit_sync & (phase_in_bit == 0)
        bit_complete = at_edge & (s["accum_count"] >= 20)
        bit_ip_sum = s["ip_sum"]
        reset = at_edge | declare
        acc = active & bit_sync
        new_accum = torch.where(reset, 0, s["accum_count"]) + acc.to(I32)
        n_ip = torch.where(reset, 0.0, s["ip_sum"]) \
            + torch.where(acc, ip_c, 0.0)
        n_qp = torch.where(reset, 0.0, s["qp_sum"]) \
            + torch.where(acc, qp_c, 0.0)
        n_ip2 = torch.where(reset, 0.0, s["ip_sq_sum"]) \
            + torch.where(acc, i_prompt**2, 0.0)
        n_qp2 = torch.where(reset, 0.0, s["qp_sq_sum"]) \
            + torch.where(acc, q_prompt**2, 0.0)
        n_ratio = torch.where(reset, 0.0, s["cn0_ratio_sum"]) + torch.where(
            acc, _beaulieu_term(i_prompt, q_prompt, s["i_prompt_prev"],
                                s["q_prompt_prev"]), 0.0)
        new_cn0 = torch.where(
            bit_complete, _cn0_nwpr(s["ip_sum"], s["qp_sum"], s["ip_sq_sum"],
                                    s["qp_sq_sum"]), s["cn0"])
        new_flags = torch.where(
            active,
            flags | FLAG_CODE_LOCK | torch.where(bit_sync, FLAG_BIT_SYNC, 0),
            flags).to(I32)
        carrier_out = upd(new_carrier, s["carrier_freq"])
        code_off_out = upd(new_code_off, s["code_freq_offset"])
        outs.append({
            "active": active,
            "i_early": lu["i_early"], "q_early": lu["q_early"],
            "i_prompt": i_prompt, "q_prompt": q_prompt,
            "i_late": lu["i_late"], "q_late": lu["q_late"],
            "dll_error": lu["code_err"], "pll_error": lu["phase_err"],
            "fll_error": lu["freq_err"], "lock_state": lu["lock_state"],
            "nco_code": lu["nco_code"], "nco_carrier": lu["nco_carrier"],
            "carrier_freq": carrier_out,
            "code_freq": CODE_FREQ + geo["delta"],
            "cn0": new_cn0, "pll_lock": lu["pll_lock"],
            "fll_lock": lu["fll_lock"], "flags": new_flags,
            "unread": geo["unread_after"][e],
            "required": geo["required"][e],
            "rem_code": rem_code_next[e],
            "bit_ready": bit_complete, "bit_ip_sum": bit_ip_sum,
        })
        phi_virt = torch.where(
            active, phi_virt + (carrier_out - frozen_carrier) * 1e-3,
            phi_virt)
        chip_virt = torch.where(
            active, chip_virt + (code_off_out - frozen_code_off) * 1e-3,
            chip_virt)
        s.update(
            carrier_freq=carrier_out, code_freq_offset=code_off_out,
            dll_memory=upd(lu["code_err"], s["dll_memory"]),
            pll_memory=upd(lu["phase_err"], s["pll_memory"]),
            fll_memory=upd(lu["freq_err"], s["fll_memory"]),
            fll_vel=lu["fll_vel"], lock_state=lu["lock_state"],
            i_prompt_prev=upd(i_prompt, s["i_prompt_prev"]),
            q_prompt_prev=upd(q_prompt, s["q_prompt_prev"]),
            flags=new_flags,
            code_counter=upd(s["code_counter"] + 1, s["code_counter"]),
            ms_counter=new_ms, edge_hist=new_hist, bit_edge=new_edge,
            accum_count=new_accum, ip_sum=n_ip, qp_sum=n_qp,
            ip_sq_sum=n_ip2, qp_sq_sum=n_qp2, cn0_ratio_sum=n_ratio,
            cn0=new_cn0, pll_lock=lu["pll_lock"], fll_lock=lu["fll_lock"])
        ipc_prev = upd(ip_c, ipc_prev)
        qpc_prev = upd(qp_c, qpc_prev)
    outputs = {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
    rem_carrier_end = torch.remainder(
        geo["rem_carrier_end"] - TWO_PI * phi_virt, TWO_PI)
    s.update(rem_carrier=rem_carrier_end,
             rem_code=geo["rem_code_end"] + chip_virt,
             unread=geo["unread_end"].to(I32))
    # The anchor slew.
    if p.anchor_slew_hz_per_s > 0 and p.freq_rail_hz > 0:
        max_step = p.anchor_slew_hz_per_s * p.block_ms * 1e-3
        synced = (s["flags"] & FLAG_BIT_SYNC) != 0
        anchor = s["freq_anchor"] + torch.clamp(
            s["carrier_freq"] - s["freq_anchor"], -max_step, max_step)
        s["freq_anchor"] = torch.where(synced, anchor, s["freq_anchor"])
    return s, outputs


def run_superblock(p: Params, code, state, samples_re, samples_im, *,
                   streams_device=None, precision="float32"):
    """``p.superblock`` consecutive blocks from ``state`` over
    ``samples_re/im`` (``tail_ms + superblock * block_ms`` ms). ``code``:
    :func:`tiled_code_bits` on ``streams_device``, as are the samples.
    Returns (state, outputs ``[superblock * block_ms, n_ch]``)."""
    streams_device = streams_device or samples_re.device
    loop_device = state["rem_code"].device
    sb = p.block_ms * p.spms
    taps = p.taps()
    outs = []
    for k in range(p.superblock):
        wre = samples_re[k * sb:k * sb + p.window_samples]
        wim = samples_im[k * sb:k * sb + p.window_samples]
        geo = pass_a(p, state)
        inputs, bounds = pass_b_inputs(p, state, geo)
        corr = epoch_correlate(
            wre, wim, code, *(x.to(streams_device) for x in inputs),
            bounds.to(streams_device), taps, p.spms, precision)
        state, out = pass_c(p, state, geo, corr.to(loop_device))
        outs.append(out)
    return state, {k: torch.cat([o[k] for o in outs]) for k in outs[0]}
