"""Plain PCPS acquisition: the map mixed and transformed per Doppler bin.

The semantics of the receiver's acquisition (SyDR's PCPS with
``coherent`` code periods summed coherently and ``non_coherent`` blocks
summed in magnitude, the carrier restarting at every block), written
directly: for each bin ``d`` the snapshot is mixed down by ``f_if + d``,
each code period transformed, the coherent periods' spectra summed,
multiplied by the conjugate code spectrum and transformed back; the map is
the sum over blocks of the magnitudes. The code replicas come from
``benchmark.cacode``. Nothing here imports the receiver.

``precision="float64"`` is the reference. ``"bfloat16"`` is the control: the
same steps with the mixed samples, the spectra, their products and the
magnitudes rounded to bfloat16, transforms in float32 between them.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.cacode import CODE_FREQ, upsampled


def doppler_bins(doppler_range: float, doppler_step: float) -> np.ndarray:
    return np.arange(-doppler_range, doppler_range + 1, doppler_step,
                     dtype=np.float64)


def _round(z, precision):
    if precision != "bfloat16":
        return z
    if z.is_complex():
        return torch.complex(_round(z.real, precision),
                             _round(z.imag, precision))
    return z.to(torch.bfloat16).to(torch.float32)


def pcps_map(snap_re, snap_im, prns, *, fs, f_if, bins, coherent,
             non_coherent, precision="float64"):
    """The map ``[len(prns), len(bins), n]`` of one snapshot (``[coherent *
    non_coherent * n]`` float32 planes) for every PRN, as float64 (the
    control's values are bfloat16 numbers)."""
    dev = snap_re.device
    real = torch.float64 if precision == "float64" else torch.float32
    cplx = torch.complex128 if precision == "float64" else torch.complex64
    n = round(fs * 1e-3)
    codes = torch.from_numpy(np.stack([upsampled(p, fs) for p in prns])).to(
        device=dev, dtype=real)
    code_k = _round(torch.conj(torch.fft.fft(codes.to(cplx), dim=-1)),
                    precision)
    x = torch.complex(snap_re.to(real), snap_im.to(real)).reshape(
        non_coherent, coherent, n)
    t = (torch.arange(coherent * n, dtype=torch.float64, device=dev)
         / fs).reshape(coherent, n)
    out = torch.empty((len(prns), len(bins), n), dtype=torch.float64,
                      device=dev)
    for b, d in enumerate(np.asarray(bins, np.float64)):
        turns = (f_if + d) * t
        ph = (-2.0 * math.pi * (turns - torch.floor(turns))).to(real)
        mixed = _round(x * torch.polar(torch.ones_like(ph), ph), precision)
        spec = _round(torch.fft.fft(mixed, dim=-1), precision).sum(dim=1)
        prod = _round(spec[None] * code_k[:, None, :], precision)
        corr = torch.fft.ifft(prod, dim=-1)          # [rows, nc, n]
        out[:, b] = _round(corr.abs(), precision).sum(dim=1).to(
            torch.float64)
    return out


def peak_metric(cmap, fs):
    """Per row: (bin index, code index, metric) of the two-peak comparison
    (SyDR's ``TwoCorrelationPeakComparison``): the highest cell of the map
    over the second highest of its Doppler row, the code phases within one
    chip of the peak excluded (non-circular)."""
    rows, n_bins, n = cmap.shape
    flat = cmap.reshape(rows, -1)
    idx = torch.argmax(flat, dim=-1)
    fi, ci = idx // n, idx % n
    return fi, ci, metric_at(cmap, fi, ci, fs)


def metric_at(cmap, fi, ci, fs):
    """The two-peak metric of each row's cell ``(fi, ci)``: its value over
    the highest of its Doppler row outside one chip of ``ci``."""
    rows, _, n = cmap.shape
    spc = round(fs / CODE_FREQ)
    r = torch.arange(rows, device=cmap.device)
    row = cmap[r, fi]
    idx = torch.arange(n, device=cmap.device)[None, :]
    excluded = (idx > ci[:, None] - spc) & (idx < ci[:, None] + spc)
    peak2 = torch.where(excluded, -math.inf, row).amax(dim=-1)
    return row[r, ci] / peak2
