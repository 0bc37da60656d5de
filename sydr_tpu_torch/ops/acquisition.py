"""Acquisition on PyTorch: PCPS (Parallel Code Phase Search) and the
time-domain serial search.

Port of ``sydr_tpu.ops.acquisition``. PCPS has two maps with one contract.
The shift-theorem map (:func:`pcps_shift_map`): when the Doppler step
divides the DFT bin spacing ``fs / n``, every Doppler bin is an integer
DFT-bin shift ``k`` of one of a few fractional phase offsets, so carrier
mixing and the forward transform run once per phase (``torch.fft.fft`` in
complex64) and each bin costs one spectrum product with a rolled code
spectrum plus one inverse transform — the per-bin chain of kernel K2
(``ops.acq_kernel.pcps_bins``). Where every row is one snapshot (the
session and a snapshot server search every PRN on the same samples, an
``expand`` with row stride 0), the snapshot is mixed for all phases in one
batch and transformed once, not once a row (:func:`phase_spectra`). The
direct map (:func:`pcps_map`) mixes and transforms once per bin, a few
bins at a time, and serves bin grids that do not decompose or reuse too
few phases (:func:`shift_plan`). The serial
search (:func:`serial_search`) wipes the carrier per Doppler bin and
correlates one code period against all 1023 chip shifts in one matrix
product.

The JAX package's matmul DFT (``ops/fft.py``) existed only because its TPU
backend had no complex dtype; ``torch.fft`` stands in its place. Sign
conventions are direct: bin ``d`` wipes a carrier at ``f_if + d`` and the returned Doppler
is the bin value itself.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from sydr_tpu_torch.constants import GPS_L1CA_CODE_FREQ, GPS_L1CA_CODE_LENGTH
from sydr_tpu_torch.ops import acq_kernel
from sydr_tpu_torch.signal import cacode
from sydr_tpu_torch.utils.metrics import count, span


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


def pcps_map(iq_re, iq_im, code_k, bins, *, sampling_frequency,
             intermediate_frequency=0.0, coherent=5, non_coherent=10,
             doppler_chunk=4):
    """PCPS correlation map ``[n_ch, n_dop, n]`` f32, one mix and forward
    transform per Doppler bin (the direct map).

    Args:
        iq_re, iq_im: ``[n_ch, non_coherent * coherent * n]`` f32 samples.
        code_k: ``[n_ch, n]`` complex64 conj(DFT(code replica)).
        bins: ``[n_dop]`` f32 Doppler bins [Hz] on the samples' device.
        doppler_chunk: bins evaluated at once; bounds the working set at
            ``doppler_chunk * n_ch * non_coherent * coherent * n`` complex
            samples whatever the number of bins.
    """
    n_ch, n = code_k.shape
    blocks_re = iq_re.reshape(n_ch, non_coherent, coherent, n)
    blocks_im = iq_im.reshape(n_ch, non_coherent, coherent, n)
    t = (torch.arange(coherent * n, dtype=torch.float32, device=iq_re.device)
         / sampling_frequency).reshape(coherent, n)
    maps = []
    for b0 in range(0, bins.shape[0], doppler_chunk):
        # Carrier phase restarts at each non-coherent block (reference
        # semantics: one carrier vector of length coherent*n per block).
        freqs = intermediate_frequency + bins[b0:b0 + doppler_chunk]
        phase = -2.0 * math.pi * freqs[:, None, None] * t   # [dc, coh, n]
        cos = torch.cos(phase)[:, None, None]
        sin = torch.sin(phase)[:, None, None]
        mixed = torch.complex(blocks_re * cos - blocks_im * sin,
                              blocks_re * sin + blocks_im * cos)
        # The coherent sum commutes with the linear inverse DFT.
        spec = torch.fft.fft(mixed, dim=-1).sum(dim=3)      # [dc, ch, nc, n]
        corr = torch.fft.ifft(spec * code_k[None, :, None, :], dim=-1)
        maps.append(corr.abs().sum(dim=2))                  # [dc, ch, n]
    return torch.cat(maps).permute(1, 0, 2).contiguous()


# "auto" takes the shift-theorem map at every decomposable grid with
# enough phase reuse and the direct map otherwise.
ACQ_MODE_DEFAULT = "auto"


def shift_plan(bins: np.ndarray, sampling_frequency: float, n: int,
               mode: str = ACQ_MODE_DEFAULT):
    """(phases, bin_shifts) for :func:`pcps_shift_map`, or None.

    ``bin_shifts`` holds per bin ``(k, phase_index)`` with
    ``bin_hz = k * fs/n + phases[phase_index]``; None when the bins do not
    decompose onto integer DFT-bin shifts, and then :func:`acquire` takes
    the direct map. ``mode``: ``"direct"`` never plans; ``"auto"`` also
    declines a plan that reuses each phase fewer than about three times
    (it would hold one forward spectrum set per bin at once, where the
    direct map holds ``doppler_chunk``); ``"shift"`` plans whenever the
    bins decompose.
    """
    if mode == "direct":
        return None
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
    if mode != "shift" and len(phases) > max(4, len(shifts) // 3):
        return None  # not enough reuse to be worth it
    return tuple(phases), tuple(shifts)


def phase_spectra(iq_re, iq_im, *, n, sampling_frequency,
                  intermediate_frequency=0.0, coherent=5, non_coherent=10,
                  phases=(0.0,)):
    """Per-phase block spectra ``[n_ph, n_ch, non_coherent, n]`` complex64.

    Each phase mixes the samples down by ``f_if + phase`` (carrier phase
    restarting at every non-coherent block, the reference semantics),
    transforms each ``n``-sample code period and sums the ``coherent``
    periods of a block (the sum commutes with the linear inverse DFT).

    Rows that are one snapshot (:func:`one_snapshot`) are mixed for every
    phase in one batch, transformed and summed once, and the spectra
    copied to each row: the same float32 operations on the same samples
    as a row of the per-row loop, so the same numbers wherever the FFT
    gives a row the same result whatever the batch.
    """
    n_ch = iq_re.shape[0]
    dev = iq_re.device
    blocks_re = iq_re.reshape(n_ch, non_coherent, coherent, n)
    blocks_im = iq_im.reshape(n_ch, non_coherent, coherent, n)
    t = (torch.arange(coherent * n, dtype=torch.float32, device=dev)
         / sampling_frequency).reshape(coherent, n)
    if one_snapshot(iq_re, iq_im):
        # Each phase's coefficient rounded to float32 once, as the loop's
        # Python scalar is; its copy to the device does not wait for it.
        coef = torch.tensor(
            [-2.0 * math.pi * (intermediate_frequency + f_p)
             for f_p in phases], dtype=torch.float32).to(dev,
                                                         non_blocking=True)
        ph = coef[:, None, None, None] * t            # [n_ph, 1, coh, n]
        cos, sin = torch.cos(ph), torch.sin(ph)
        b_re, b_im = blocks_re[:1], blocks_im[:1]     # [1, nc, coh, n]
        mre = b_re * cos - b_im * sin
        mim = b_re * sin + b_im * cos
        spec = torch.fft.fft(torch.complex(mre, mim), dim=-1).sum(dim=2)
        return spec[:, None].expand(-1, n_ch, -1, -1).contiguous()
    spectra = []
    for f_p in phases:
        ph = -2.0 * math.pi * (intermediate_frequency + f_p) * t
        cos, sin = torch.cos(ph), torch.sin(ph)
        mre = blocks_re * cos - blocks_im * sin
        mim = blocks_re * sin + blocks_im * cos
        spec = torch.fft.fft(torch.complex(mre, mim), dim=-1)
        spectra.append(spec.sum(dim=2))               # [n_ch, nc, n]
    return torch.stack(spectra).contiguous()


def one_snapshot(iq_re, iq_im) -> bool:
    """Whether every row of the samples is the same snapshot: one row, or
    both planes with row stride 0 (an ``expand`` of one row)."""
    return iq_re.shape[0] == 1 or (iq_re.stride(0) == 0
                                   and iq_im.stride(0) == 0)


def pcps_shift_map(iq_re, iq_im, code_k, *, sampling_frequency,
                   intermediate_frequency=0.0, coherent=5, non_coherent=10,
                   phases=(0.0,), bin_shifts=((0, 0),)):
    """PCPS correlation map ``[n_ch, n_bins, n]`` f32 via the shift theorem.

    Args:
        iq_re, iq_im: ``[n_ch, non_coherent * coherent * n]`` f32 samples.
        code_k: ``[n_ch, n]`` complex64 conj(DFT(code replica)).
        phases, bin_shifts: the :func:`shift_plan` of the Doppler bins.

    Spans (``utils.metrics``): ``sydr.acq.spectra`` (the forward spectra;
    device time too; ``rows``: the rows mixed and transformed, 1 where
    every row is one snapshot) and ``sydr.acq.k2`` (K2's launch:
    arguments, plan tables, output). Counter ``sydr.acq.spectra.shared``:
    the calls whose rows were one snapshot.
    """
    n = code_k.shape[-1]
    shared = one_snapshot(iq_re, iq_im)
    with span("sydr.acq.spectra", device=iq_re.device,
              rows=1 if shared else iq_re.shape[0]):
        if shared:
            count("sydr.acq.spectra.shared")
        spectra = phase_spectra(
            iq_re, iq_im, n=n, sampling_frequency=sampling_frequency,
            intermediate_frequency=intermediate_frequency, coherent=coherent,
            non_coherent=non_coherent, phases=phases)
    with span("sydr.acq.k2"):
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
            non_coherent: int = 10, doppler_chunk: int = 4):
    """Full PCPS acquisition: map + peak metric, on ``iq``'s device.

    Args:
        iq: ``(re, im)`` f32 tensors ``[n_ch, non_coherent*coherent*n]``.
        code_ffts: ``[n_ch, n]`` conj code DFTs, a complex tensor or a host
            complex array (moved to ``iq``'s device as complex64).
        bins: Doppler bins [Hz] (host array), any length. Where they have
            a shift plan (:func:`shift_plan`), as the receiver's 100 Hz-step
            grid has at every supported rate, the map is
            :func:`pcps_shift_map` (kernel K2); otherwise :func:`pcps_map`,
            ``doppler_chunk`` bins at a time.

    Returns (doppler [n_ch], code_index [n_ch], metric [n_ch],
    map [n_ch, n_dop, n]) as tensors on ``iq``'s device.

    Spans (``utils.metrics``): ``sydr.acq`` a call (``searches``, the
    rows), and under it ``.prepare`` (the code spectra and the bins to the
    device, the plan), :func:`pcps_shift_map`'s ``.spectra`` and ``.k2``
    (without a plan ``.spectra`` holds the direct map, ``rows`` every
    row), and ``.peak`` (the peak metric; device time too).
    """
    iq_re, iq_im = iq
    dev = iq_re.device
    with span("sydr.acq", searches=iq_re.shape[0]):
        with span("sydr.acq.prepare"):
            code_k = torch.as_tensor(code_ffts).to(device=dev,
                                                   dtype=torch.complex64)
            n = code_k.shape[-1]
            bins = np.asarray(bins, dtype=np.float32)
            plan = shift_plan(bins, sampling_frequency, n)
            bins_dev = torch.from_numpy(bins).to(dev)
        common = dict(sampling_frequency=sampling_frequency,
                      intermediate_frequency=intermediate_frequency,
                      coherent=coherent, non_coherent=non_coherent)
        if plan is not None:
            phases, bin_shifts = plan
            corr = pcps_shift_map(iq_re, iq_im, code_k, phases=phases,
                                  bin_shifts=bin_shifts, **common)
        else:
            with span("sydr.acq.spectra", device=dev, rows=iq_re.shape[0]):
                corr = pcps_map(iq_re, iq_im, code_k, bins_dev,
                                doppler_chunk=doppler_chunk, **common)
        samples_per_chip = round(sampling_frequency / GPS_L1CA_CODE_FREQ)
        with span("sydr.acq.peak", device=dev):
            doppler, code_idx, metric = peak_metric(
                corr, bins_dev, samples_per_chip=samples_per_chip)
    return doppler, code_idx, metric, corr


# ---------------------------------------------------------------------------
# Serial search (time-domain) acquisition
# ---------------------------------------------------------------------------

def code_shift_matrix(prn: int, sampling_frequency: float) -> np.ndarray:
    """``[samples_per_code, 1023]`` float32: column k = code shifted k chips.

    Host-precomputed operand of the matrix-product serial search (one per
    PRN; ~40 MB at 10 Msps).
    """
    code = cacode.ca_code(prn)
    cols = [
        cacode.upsample_code(np.roll(code, k), sampling_frequency)
        for k in range(GPS_L1CA_CODE_LENGTH)
    ]
    return np.stack(cols, axis=1).astype(np.float32)


def serial_search(iq_re, iq_im, shift_matrix, bins, *, sampling_frequency,
                  intermediate_frequency=0.0, doppler_chunk=8):
    """Time-domain acquisition: carrier wipe-off then code-shift product.

    The code-shift axis is one matrix product per Doppler chunk::

        map[f, k] = |mixed_f . C[:, k]|^2

    The products are float32 ``torch.matmul``; on a CUDA device they must
    stay out of TF32 (``torch.backends.cuda.matmul.allow_tf32`` at its
    default, False): the metric is a ratio of squared sums over a whole
    code period, and 10 mantissa bits would put the rounding of 2500 to
    10000 terms at the level of the noise peaks it is compared with.

    Args:
        iq_re/iq_im: ``[n]`` float32 (one code period).
        shift_matrix: ``[n, 1023]`` from :func:`code_shift_matrix`.
        bins: ``[n_dop]`` float32 Doppler bins [Hz], any length.

    Returns ``[n_dop, 1023]`` float32 correlation map.
    """
    n = iq_re.shape[-1]
    t = torch.arange(n, dtype=torch.float32, device=iq_re.device) \
        / sampling_frequency
    maps = []
    for b0 in range(0, bins.shape[0], doppler_chunk):
        phase = -2.0 * math.pi * (
            intermediate_frequency + bins[b0:b0 + doppler_chunk, None]) * t
        cos, sin = torch.cos(phase), torch.sin(phase)
        mre = iq_re * cos - iq_im * sin
        mim = iq_re * sin + iq_im * cos
        i_corr = torch.matmul(mre, shift_matrix)
        q_corr = torch.matmul(mim, shift_matrix)
        maps.append(i_corr**2 + q_corr**2)
    return torch.cat(maps)


def peak_metric_ss(corr_map):
    """Two-peak metric with a 3x3 exclusion box (the reference's
    ``TwoCorrelationPeakComparison_SS``).

    Returns ((freq_idx, code_idx), metric) as 0-dim tensors.
    """
    n_dop, n_code = corr_map.shape
    flat = torch.argmax(corr_map)
    fi, ci = flat // n_code, flat % n_code
    peak1 = corr_map[fi, ci]
    fgrid = torch.arange(n_dop, device=corr_map.device)[:, None]
    cgrid = torch.arange(n_code, device=corr_map.device)[None, :]
    excl = ((fgrid - fi).abs() <= 1) & ((cgrid - ci).abs() <= 1)
    peak2 = torch.where(excl, -math.inf, corr_map).amax()
    return (fi, ci), peak1 / peak2
