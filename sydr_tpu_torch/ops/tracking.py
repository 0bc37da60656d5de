"""Tracking-loop DSP: discriminators, loop filters, lock indicators, C/N0.

Port of ``sydr_tpu.ops.tracking`` (its per-epoch scalar half,
``:303-468``): every function works elementwise on ``[n_ch]`` float32
tensors. The EPL correlator forms of that module serve the per-ms scan
runtime, which is not ported yet; the batched runtime correlates in
``ops.correlator_kernel``.
"""

from __future__ import annotations

import math

import torch

TWO_PI = 2.0 * math.pi


# ---------------------------------------------------------------------------
# Discriminators (reference dsp/tracking.py:120-176)
# ---------------------------------------------------------------------------

def dll_nneml(i_early, q_early, i_late, q_late):
    """Normalised non-coherent early-minus-late power discriminator [chips]."""
    e = torch.sqrt(i_early**2 + q_early**2)
    l = torch.sqrt(i_late**2 + q_late**2)
    return torch.where(e + l > 0.0, (e - l) / (e + l), 0.0)


def pll_costas(i_prompt, q_prompt):
    """Costas-loop phase discriminator [cycles]."""
    nz = i_prompt != 0.0
    ratio = torch.where(nz, q_prompt / torch.where(nz, i_prompt, 1.0), 0.0)
    return torch.atan(ratio) / TWO_PI


def _half_cycle_unwrap(x):
    x = torch.where(x >= math.pi / 2.0, x - math.pi, x)
    return torch.where(x <= -math.pi / 2.0, x + math.pi, x)


def fll_atan(i_prompt, q_prompt, i_prompt_prev, q_prompt_prev, delta_t):
    """Single-arctangent frequency discriminator [Hz]."""
    nz = i_prompt != 0.0
    nz_prev = i_prompt_prev != 0.0
    a = torch.where(nz, q_prompt / torch.where(nz, i_prompt, 1.0), 0.0)
    b = torch.where(
        nz_prev, q_prompt_prev / torch.where(nz_prev, i_prompt_prev, 1.0), 0.0)
    diff = torch.atan(a) - torch.atan(b)
    diff = torch.where(torch.isnan(diff), 0.0, diff)
    return _half_cycle_unwrap(diff) / delta_t / TWO_PI


def fll_atan2(i_prompt, q_prompt, i_prompt_prev, q_prompt_prev, delta_t):
    """Four-quadrant cross/dot frequency discriminator [Hz].

    Decision-directed ``atan2(cross * sign(dot), |dot|)``: folds the
    180-degree nav-bit rotations into the half-cycle range (see the JAX
    module for why this deliberately deviates from the reference).
    """
    cross = i_prompt_prev * q_prompt - q_prompt_prev * i_prompt
    dot = i_prompt_prev * i_prompt + q_prompt_prev * q_prompt
    return torch.atan2(cross * torch.sign(dot), torch.abs(dot)) \
        / delta_t / TWO_PI


# ---------------------------------------------------------------------------
# Loop filters
# ---------------------------------------------------------------------------

def loop_filter_taus(noise_bandwidth: float, damping: float, gain: float):
    """Borre-style 2nd-order loop filter time constants (tau1, tau2)."""
    wn = noise_bandwidth * 8.0 * damping / (4.0 * damping**2 + 1.0)
    return gain / wn**2, 2.0 * damping / wn


def borre_loop_filter(value, memory, tau1, tau2, pdi):
    """PI loop filter used by the Borre channel profile."""
    return (tau2 / tau1) * (value - memory) + (pdi / tau1) * value


def fll_assisted_pll_2nd(phase_err, freq_err, w0f, w0p, a2, t_int, vel_memory):
    """2nd-order PLL assisted by a 1st-order FLL (Kaplan 2006 DLF).

    Returns (output, new_vel_memory).
    """
    update = (phase_err * w0p**2 + freq_err * w0f) * t_int
    out = update + vel_memory + phase_err * a2 * w0p
    return out, update


def fll_assisted_pll_3rd(
    phase_err, freq_err, w0f, w0p, a2, a3, b3, t_int, vel_memory, acc_memory
):
    """3rd-order PLL assisted by a 2nd-order FLL (Kaplan 2006 DLF).

    Returns (output, new_vel_memory, new_acc_memory).
    """
    acc_update = (phase_err * w0p**3 + freq_err * w0f**2) * t_int
    first = acc_update + acc_memory
    vel_update = (first + phase_err * a3 * w0p**2 + freq_err * a2 * w0f) * t_int
    out = vel_update + vel_memory + phase_err * b3 * w0p
    return out, vel_update, acc_update


# ---------------------------------------------------------------------------
# Lock indicators and C/N0 estimators (reference dsp/lockindicator.py)
# ---------------------------------------------------------------------------

def low_pass(new, old, alpha):
    return (1.0 - alpha) * old + alpha * new


def pll_lock_indicator(i_prompt, q_prompt, previous, alpha=0.01):
    """Narrow-band-difference over narrow-band-power, low-pass filtered."""
    nbd = i_prompt**2 - q_prompt**2
    nbp = i_prompt**2 + q_prompt**2
    value = torch.where(nbp > 0.0, nbd / nbp, 0.0)
    return low_pass(value, previous, alpha)


def fll_lock_indicator(
    i_prompt, q_prompt, i_prompt_prev, q_prompt_prev, previous, alpha=0.01
):
    dot = i_prompt * i_prompt_prev - q_prompt * q_prompt_prev
    cross_sign = torch.sign(
        i_prompt * i_prompt_prev + q_prompt * q_prompt_prev)
    power = i_prompt**2 + q_prompt**2
    value = torch.where(power > 0.0, torch.abs(dot * cross_sign / power), 0.0)
    return low_pass(value, previous, alpha)


def cn0_nwpr(i_sum, q_sum, i_sq_sum, q_sq_sum, n_accum=20, t_int=1e-3):
    """Narrow-band / wide-band power-ratio C/N0 estimate [dB-Hz]."""
    nbp = i_sum**2 + q_sum**2
    wbp = i_sq_sum + q_sq_sum
    np_ratio = torch.where(wbp > 0.0, nbp / wbp, 1.0)
    arg = (np_ratio - 1.0) / (n_accum - np_ratio) / t_int
    return 10.0 * torch.log10(torch.clamp(arg, min=1e-12))


def cn0_beaulieu(ratio, n, t_int, previous, alpha=0.1):
    """Beaulieu-method C/N0 estimate, low-pass filtered [linear Hz]."""
    value = torch.where(ratio > 0.0, n / ratio, 0.0) / t_int
    return low_pass(value, previous, alpha)


def beaulieu_ratio_term(i_prompt, q_prompt, i_prompt_prev, q_prompt_prev):
    """Per-epoch Beaulieu Pn/Pd ratio term accumulated over one data bit
    (Falletti 2011 form; see the JAX module for the reference deviation)."""
    m1_sq = i_prompt**2 + q_prompt**2
    m0_sq = i_prompt_prev**2 + q_prompt_prev**2
    pn = (torch.sqrt(m1_sq) - torch.sqrt(m0_sq)) ** 2
    pd = m1_sq + m0_sq
    return torch.where(pd > 0.0, pn / pd, 0.0)


def cn0_update(cfg, bit_complete, ip_sum, qp_sum, ip_sq_sum, qp_sq_sum,
               ratio_sum, prev_cn0, n_accum=20):
    """Estimator-selected C/N0 [dB-Hz] refresh at bit completion.

    ``cfg.cn0_estimator``: "nwpr" (default) or "beaulieu". The Beaulieu
    low-pass runs in the linear domain (previous dB-Hz converted back), so
    one state field serves both estimators.
    """
    if cfg.cn0_estimator == "beaulieu":
        prev_lin = torch.pow(10.0, prev_cn0 / 10.0)
        lin = cn0_beaulieu(ratio_sum, float(n_accum), 1e-3, prev_lin)
        new = 10.0 * torch.log10(torch.clamp(lin, min=1e-12))
    else:
        new = cn0_nwpr(ip_sum, qp_sum, ip_sq_sum, qp_sq_sum)
    return torch.where(bit_complete, new, prev_cn0)
