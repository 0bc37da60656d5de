"""K2 ``pcps_bins``: the per-bin PCPS chain (spectrum product -> inverse
DFT -> magnitude -> non-coherent sum) for every (Doppler bin, channel).

Replaces ``sydr_tpu.ops.acq_kernel.pcps_fused_bins`` (Pallas ``_kernel``).
On CUDA tensors :func:`pcps_bins` launches one of two hand-written
kernels, chosen from the code period ``n`` alone:

* ``csrc/pcps_bins.cu`` (:data:`KERNEL`), a mixed-radix Stockham FFT in
  shared memory (radices 10, 5, 4, 3, 2), for every ``n`` whose prime
  factors lie in {2, 3, 5} (:func:`radix_plan`): 2500, 4000, 5000, 10000,
  2048, ...;
* ``csrc/pcps_bins_fourstep.cu`` (:data:`FOURSTEP_KERNEL`), the direct
  four-step DFT of length ``n = n1 * n2`` (:func:`balanced_factors`), for
  every other ``n`` (4.092 Msps gives 4092 = 2^2 * 3 * 11 * 31).

:func:`pcps_bins_ref` is the plain PyTorch version (``torch.fft.ifft`` of
the product, ``abs``, sum), used on CPU tensors; there is no fallback from
a kernel to it or from one kernel to the other.
:func:`stockham_ifft_ref` walks the FFT kernel's passes, strides and
integer twiddle indices in PyTorch, for the tests of that arithmetic.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from sydr_tpu_torch.ops import native

_VP = ctypes.c_void_p
_INT = ctypes.c_int
KERNEL = native.CudaKernel(
    "pcps_bins.cu", "pcps_bins_launch",
    [_VP] * 5 + [_INT] * 3 + [ctypes.POINTER(_INT)] + [_INT] * 3 + [_VP, _VP])
FOURSTEP_KERNEL = native.CudaKernel(
    "pcps_bins_fourstep.cu", "pcps_bins_fourstep_launch",
    [_VP] * 5 + [_INT] * 6 + [_VP, _VP])

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


def radix_plan(n: int) -> tuple[int, ...]:
    """Radices of the FFT kernel's passes, in order: factors from
    {10, 4, 2, 3, 5} whose product is ``n``. Every pair (2, 5) becomes one
    radix-10 pass (a 2 x 5 butterfly in registers: a pass less to
    synchronise and to move through shared memory); tens first, then
    fours, a two, threes, and fives last (the order that measured fastest
    on the card). Raises ``ValueError`` for an ``n`` with a prime factor
    above 5, or with fewer than two passes."""
    rest, count = n, {}
    for p in (2, 3, 5):
        count[p] = 0
        while rest % p == 0:
            count[p] += 1
            rest //= p
    if rest != 1 or n < 2:
        raise ValueError(f"n={n} has a prime factor above 5: no radix plan")
    tens = min(count[2], count[5])
    twos = count[2] - tens
    plan = ([10] * tens + [4] * (twos // 2) + [2] * (twos % 2)
            + [3] * count[3] + [5] * (count[5] - tens))
    if len(plan) < 2:
        raise ValueError(f"n={n}: the FFT kernel needs two passes or more")
    return tuple(plan)


def fft_threads(n: int) -> int:
    """Threads of an FFT-kernel block: one per radix-10 butterfly of a pass
    (n / 10, in whole warps), between 128 and 1024. The block's two
    buffers take 16 n bytes of the SM's shared memory, so small n runs
    several blocks an SM (4 of 256 threads at n = 2500) and large n one
    full block (1024 threads at n = 10000); a thread holds at most 20
    output points."""
    return min(1024, max(128, 32 * -(-n // 320)))


def has_radix_plan(n: int) -> bool:
    """Whether ``n`` goes to the FFT kernel (else to the four-step one)."""
    try:
        radix_plan(n)
    except ValueError:
        return False
    return True


@functools.lru_cache(maxsize=8)
def twiddle_table(n: int, device) -> torch.Tensor:
    """``tw[t] = e^{+2 pi i t / n}`` complex64, from float64 angles; built
    once per ``(n, device)``."""
    t = torch.arange(n, dtype=torch.float64, device=device) \
        * (2.0 * math.pi / n)
    return torch.polar(torch.ones_like(t), t).to(torch.complex64)


@functools.lru_cache(maxsize=8)
def _plan_tensors(bin_shifts, device):
    shift = torch.tensor([k for k, _ in bin_shifts], dtype=torch.int32,
                         device=device)
    phase = torch.tensor([p for _, p in bin_shifts], dtype=torch.int32,
                         device=device)
    return shift, phase


def stockham_ifft_ref(x, plan, tw):
    """Unnormalised inverse DFT of ``x [..., n]`` complex64 by the FFT
    kernel's own passes (``csrc/pcps_bins.cu``), in PyTorch.

    With ``ns`` the product of the radices done so far, the pass of radix
    ``r`` reads ``v[q] = in[j + q * n/r]`` for ``j < n/r``, multiplies by
    ``tw[q * (j mod ns) * n/(ns*r)]`` (an exact integer index below n),
    takes the r-point inverse DFT and writes it to
    ``out[(j // ns) * ns*r + (j mod ns) + q * ns]``.
    """
    n = x.shape[-1]
    if math.prod(plan) != n:
        raise ValueError(f"plan {plan} does not multiply to n={n}")
    ns = 1
    for r in plan:
        m = n // r
        j = torch.arange(m, device=x.device)
        k = j % ns
        q = torch.arange(r, device=x.device)
        v = x[..., (j[None, :] + q[:, None] * m)]             # [..., r, m]
        idx = q[:, None] * (k * (m // ns))[None, :]           # [r, m] < n
        v = v * tw[idx]
        root = tw[(q[:, None] * q[None, :] * (n // r)) % n]   # [r, r]
        y = torch.einsum("pq,...qm->...pm", root, v)
        dest = ((j - k) * r + k)[None, :] + q[:, None] * ns   # [r, m]
        out = torch.empty_like(x)
        out[..., dest.reshape(-1)] = y.reshape(*y.shape[:-2], -1)
        x = out
        ns *= r
    return x


def pcps_bins_ref(spectra, code_k, bin_shifts):
    """Plain PyTorch version of :func:`pcps_bins` (same arguments)."""
    n_ph, n_ch, nc, n = spectra.shape
    bin_shifts = tuple(map(tuple, bin_shifts))
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


def pcps_bins_launch_args(spectra, code_k, bin_shifts):
    """Check the arguments of :func:`pcps_bins` (CUDA tensors), allocate
    its output and return ``(kernel, out, args)``: the kernel that ``n``
    selects and the C arguments of its entry point."""
    dev = spectra.device
    if dev.type != "cuda":
        raise ValueError(f"pcps_bins: unsupported device {dev}")
    n_ph, n_ch, nc, n = spectra.shape
    c64 = torch.complex64
    native.check(spectra, "spectra", c64, (n_ph, n_ch, nc, n), dev)
    native.check(code_k, "code_k", c64, (n_ch, n), dev)
    bin_shifts = tuple(map(tuple, bin_shifts))
    if any(not 0 <= p < n_ph for _, p in bin_shifts):
        raise ValueError("pcps_bins: phase index out of range")
    shift, phase = _plan_tensors(bin_shifts, dev)
    tw = twiddle_table(n, dev)
    out = torch.empty((n_ch, len(bin_shifts), n), dtype=torch.float32,
                      device=dev)
    head = (native.ptr(spectra), native.ptr(code_k), native.ptr(tw),
            native.ptr(shift), native.ptr(phase), n_ch, nc, n)
    tail = (len(bin_shifts), native.ptr(out), native.stream_of(out))
    if not has_radix_plan(n):
        return FOURSTEP_KERNEL, out, (*head, *balanced_factors(n), *tail)
    plan = radix_plan(n)
    return KERNEL, out, (*head, (_INT * len(plan))(*plan), len(plan),
                         fft_threads(n), *tail)


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
    kernel, out, args = pcps_bins_launch_args(spectra, code_k, bin_shifts)
    kernel.launch(*args)
    return out
