"""PCPS (Parallel Code Phase Search) acquisition on PyTorch.

Port of the shift-theorem path of ``sydr_tpu.ops.acquisition``: when the
Doppler step divides the DFT bin spacing ``fs / n``, every Doppler bin is
an integer DFT-bin shift ``k`` of one of a few fractional phase offsets, so
carrier mixing and the forward transform run once per phase
(``torch.fft.fft`` in complex64) and each bin costs one spectrum product
with a rolled code spectrum plus one inverse transform — the per-bin chain
of kernel K2 (``ops.acq_kernel.pcps_bins``).

The JAX package's matmul DFT (``ops/fft.py``) existed only because its TPU
backend had no complex dtype; it is not ported. Sign conventions are
direct: bin ``d`` wipes a carrier at ``f_if + d`` and the returned Doppler
is the bin value itself.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from sydr_tpu_torch.constants import GPS_L1CA_CODE_FREQ
from sydr_tpu_torch.ops import acq_kernel
from sydr_tpu_torch.signal import cacode


def doppler_bins(doppler_range: float, doppler_step: float) -> np.ndarray:
    """Doppler search bins: -range .. +range inclusive."""
    return np.arange(-doppler_range, doppler_range + 1, doppler_step).astype(
        np.float32
    )


def code_fft_conj(prn: int, sampling_frequency: float) -> np.ndarray:
    """conj(FFT(upsampled C/A code)) as a complex128 host array."""
    code = cacode.upsample_code(cacode.ca_code(prn), sampling_frequency)
    return np.conj(np.fft.fft(code.astype(np.float64)))


def split_reim(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Split a host complex array into float32 (re, im) planes."""
    x = np.asarray(x)
    return (
        np.ascontiguousarray(x.real, dtype=np.float32),
        np.ascontiguousarray(x.imag, dtype=np.float32),
    )


def shift_plan(bins: np.ndarray, sampling_frequency: float, n: int):
    """(phases, bin_shifts) for :func:`pcps_shift_map`, or None.

    ``bin_shifts`` holds per bin ``(k, phase_index)`` with
    ``bin_hz = k * fs/n + phases[phase_index]``; None when the bins do not
    decompose onto integer DFT-bin shifts. (The JAX package also declines
    a plan with little phase reuse, in favour of its direct map; the port
    has only the shift-theorem map.)
    """
    f_bin = sampling_frequency / n
    phases: list[float] = []
    shifts: list[tuple[int, int]] = []
    for d in np.asarray(bins, dtype=np.float64):
        k = int(np.floor(d / f_bin + 1e-9))
        rem = float(d - k * f_bin)
        if rem < 0 or rem >= f_bin - 1e-6:
            return None
        match = None
        for i, p in enumerate(phases):
            if abs(p - rem) < 1e-6:
                match = i
                break
        if match is None:
            phases.append(rem)
            match = len(phases) - 1
        shifts.append((k, match))
    return tuple(phases), tuple(shifts)


def phase_spectra(iq_re, iq_im, *, n, sampling_frequency,
                  intermediate_frequency=0.0, coherent=5, non_coherent=10,
                  phases=(0.0,)):
    """Per-phase block spectra ``[n_ph, n_ch, non_coherent, n]`` complex64.

    Each phase mixes the samples down by ``f_if + phase`` (carrier phase
    restarting at every non-coherent block, the reference semantics),
    transforms each ``n``-sample code period and sums the ``coherent``
    periods of a block (the sum commutes with the linear inverse DFT).
    """
    n_ch = iq_re.shape[0]
    dev = iq_re.device
    blocks_re = iq_re.reshape(n_ch, non_coherent, coherent, n)
    blocks_im = iq_im.reshape(n_ch, non_coherent, coherent, n)
    t = (torch.arange(coherent * n, dtype=torch.float32, device=dev)
         / sampling_frequency).reshape(coherent, n)
    spectra = []
    for f_p in phases:
        ph = -2.0 * math.pi * (intermediate_frequency + f_p) * t
        cos, sin = torch.cos(ph), torch.sin(ph)
        mre = blocks_re * cos - blocks_im * sin
        mim = blocks_re * sin + blocks_im * cos
        spec = torch.fft.fft(torch.complex(mre, mim), dim=-1)
        spectra.append(spec.sum(dim=2))               # [n_ch, nc, n]
    return torch.stack(spectra).contiguous()


def pcps_shift_map(iq_re, iq_im, code_k, *, sampling_frequency,
                   intermediate_frequency=0.0, coherent=5, non_coherent=10,
                   phases=(0.0,), bin_shifts=((0, 0),)):
    """PCPS correlation map ``[n_ch, n_bins, n]`` f32 via the shift theorem.

    Args:
        iq_re, iq_im: ``[n_ch, non_coherent * coherent * n]`` f32 samples.
        code_k: ``[n_ch, n]`` complex64 conj(DFT(code replica)).
        phases, bin_shifts: the :func:`shift_plan` of the Doppler bins.
    """
    n = code_k.shape[-1]
    spectra = phase_spectra(
        iq_re, iq_im, n=n, sampling_frequency=sampling_frequency,
        intermediate_frequency=intermediate_frequency, coherent=coherent,
        non_coherent=non_coherent, phases=phases)
    return acq_kernel.pcps_bins(spectra, code_k.contiguous(), bin_shifts)


def peak_metric(corr_map, bins, *, samples_per_chip: int):
    """Two-peak comparison metric per channel.

    Highest peak over the (Doppler x code) map; second peak on the same
    Doppler row with +/-1 chip of code phases around the main peak
    excluded (non-circular, as the reference's
    ``TwoCorrelationPeakComparison``).

    Returns (doppler_hz [n_ch], code_index [n_ch] int32, metric [n_ch]).
    """
    n_ch, n_dop, n = corr_map.shape
    flat = corr_map.reshape(n_ch, -1)
    flat_idx = torch.argmax(flat, dim=-1)
    peak1 = flat.gather(1, flat_idx[:, None])[:, 0]
    fi = flat_idx // n
    ci = flat_idx % n
    rows = corr_map[torch.arange(n_ch, device=corr_map.device), fi]
    idx = torch.arange(n, device=corr_map.device)[None, :]
    excluded = (idx > ci[:, None] - samples_per_chip) & (
        idx < ci[:, None] + samples_per_chip)
    peak2 = torch.where(excluded, -math.inf, rows).amax(dim=-1)
    doppler = bins[fi]
    return doppler, ci.to(torch.int32), peak1 / peak2


def acquire(iq, code_ffts, bins, *, sampling_frequency: float,
            intermediate_frequency: float = 0.0, coherent: int = 5,
            non_coherent: int = 10):
    """Full PCPS acquisition: map + peak metric, on ``iq``'s device.

    Args:
        iq: ``(re, im)`` f32 tensors ``[n_ch, non_coherent*coherent*n]``.
        code_ffts: ``[n_ch, n]`` conj code DFTs, a complex tensor or a host
            complex array (moved to ``iq``'s device as complex64).
        bins: Doppler bins [Hz] (host array); they must decompose onto
            the shift plan (:func:`shift_plan`), as the receiver's
            100 Hz-step grid does at every supported rate.

    Returns (doppler [n_ch], code_index [n_ch], metric [n_ch],
    map [n_ch, n_dop, n]) as tensors on ``iq``'s device.
    """
    iq_re, iq_im = iq
    dev = iq_re.device
    code_k = torch.as_tensor(code_ffts).to(device=dev, dtype=torch.complex64)
    n = code_k.shape[-1]
    bins = np.asarray(bins, dtype=np.float32)
    plan = shift_plan(bins, sampling_frequency, n)
    if plan is None:
        raise ValueError(
            f"Doppler bins do not decompose onto shifts of fs/n = "
            f"{sampling_frequency / n} Hz; only the shift-theorem map is "
            f"ported")
    phases, bin_shifts = plan
    corr = pcps_shift_map(
        iq_re, iq_im, code_k, sampling_frequency=sampling_frequency,
        intermediate_frequency=intermediate_frequency, coherent=coherent,
        non_coherent=non_coherent, phases=phases, bin_shifts=bin_shifts)
    samples_per_chip = round(sampling_frequency / GPS_L1CA_CODE_FREQ)
    doppler, code_idx, metric = peak_metric(
        corr, torch.from_numpy(bins).to(dev),
        samples_per_chip=samples_per_chip)
    return doppler, code_idx, metric, corr
