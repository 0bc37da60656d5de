"""K2 ``pcps_bins``: the per-bin PCPS chain (spectrum product -> inverse
DFT -> magnitude -> non-coherent sum) for every (Doppler bin, channel).

Replaces ``sydr_tpu.ops.acq_kernel.pcps_fused_bins`` (Pallas ``_kernel``).
The CUDA kernel (``csrc/pcps_bins.cu``) runs the four-step inverse DFT of
length ``n = n1 * n2`` in shared memory; :func:`pcps_bins_ref` is the plain
PyTorch version (``torch.fft.ifft`` of the product, ``abs``, sum).
:func:`pcps_bins` runs the kernel on CUDA tensors and the plain version on
CPU tensors; there is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import math

import torch

from sydr_tpu_torch.ops import native

_VP = ctypes.c_void_p
_INT = ctypes.c_int
KERNEL = native.CudaKernel(
    "pcps_bins.cu", "pcps_bins_launch", [_VP] * 5 + [_INT] * 6 + [_VP, _VP])

# Bins per batch of the plain version: bounds its [bins, ch, nc, n]
# complex64 intermediates (8 x 32 x 10 x 2500 x 8 B = 51 MB each at the
# session shape).
REF_BIN_CHUNK = 8


def balanced_factors(n: int) -> tuple[int, int]:
    """Factor n = n1 * n2 with n1 <= n2 as close to sqrt(n) as possible."""
    f = math.isqrt(n)
    while f >= 1:
        if n % f == 0:
            best = (f, n // f)
            break
        f -= 1
    if best[0] == 1 and n > 64:
        raise ValueError(f"N={n} has no useful factorisation (prime?)")
    return best


def _plan_tensors(bin_shifts, device):
    shift = torch.tensor([k for k, _ in bin_shifts], dtype=torch.int32,
                         device=device)
    phase = torch.tensor([p for _, p in bin_shifts], dtype=torch.int32,
                         device=device)
    return shift, phase


def pcps_bins_ref(spectra, code_k, bin_shifts):
    """Plain PyTorch version of :func:`pcps_bins` (same arguments)."""
    n_ph, n_ch, nc, n = spectra.shape
    shift, phase = _plan_tensors(bin_shifts, spectra.device)
    idx = torch.remainder(
        torch.arange(n, device=spectra.device)[None, :]
        - shift.to(torch.int64)[:, None], n)              # [n_bins, n]
    maps = []
    for b0 in range(0, len(bin_shifts), REF_BIN_CHUNK):
        sl = slice(b0, b0 + REF_BIN_CHUNK)
        rolled = code_k[:, idx[sl]].permute(1, 0, 2)      # [nb, n_ch, n]
        prod = spectra[phase[sl].to(torch.int64)] * rolled[:, :, None, :]
        corr = torch.fft.ifft(prod, dim=-1)
        maps.append(corr.abs().sum(dim=2))                # [nb, n_ch, n]
    return torch.cat(maps).permute(1, 0, 2).contiguous()


def pcps_bins(spectra, code_k, bin_shifts):
    """Non-coherent correlation map ``[n_ch, n_bins, n]`` f32.

    Args:
        spectra: ``[n_ph, n_ch, nc, n]`` complex64 per-phase spectra of the
            nc non-coherent blocks (coherent blocks already summed).
        code_k: ``[n_ch, n]`` complex64 conjugate code spectra.
        bin_shifts: per output bin ``(k, phase_index)`` (``shift_plan``):
            bin b correlates ``spectra[phase_index]`` against
            ``roll(code_k, k)``.
    """
    if spectra.device.type == "cpu":
        return pcps_bins_ref(spectra, code_k, bin_shifts)
    dev = spectra.device
    if dev.type != "cuda":
        raise ValueError(f"pcps_bins: unsupported device {dev}")
    n_ph, n_ch, nc, n = spectra.shape
    n1, n2 = balanced_factors(n)
    c64 = torch.complex64
    native.check(spectra, "spectra", c64, (n_ph, n_ch, nc, n), dev)
    native.check(code_k, "code_k", c64, (n_ch, n), dev)
    if any(not 0 <= p < n_ph for _, p in bin_shifts):
        raise ValueError("pcps_bins: phase index out of range")
    shift, phase = _plan_tensors(bin_shifts, dev)
    t = torch.arange(n, dtype=torch.float64, device=dev) * (2.0 * math.pi / n)
    tw = torch.polar(torch.ones_like(t), t).to(c64)   # e^{+2 pi i t / n}
    out = torch.empty((n_ch, len(bin_shifts), n), dtype=torch.float32,
                      device=dev)
    KERNEL.launch(
        native.ptr(spectra), native.ptr(code_k), native.ptr(tw),
        native.ptr(shift), native.ptr(phase), n_ch, nc, n, n1, n2,
        len(bin_shifts), native.ptr(out), native.stream_of(out))
    return out
