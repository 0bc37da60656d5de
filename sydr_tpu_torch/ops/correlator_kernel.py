"""K1 ``epoch_correlate``: per-epoch correlators of the batched runtime.

Replaces ``sydr_tpu.ops.correlator_kernel.block_rowsum_streams`` (Pallas
``_kernel_rowsum``) plus the XLA boundary recompute that turned its row
totals into epoch sums. The CUDA kernel (``csrc/epoch_correlate.cu``)
returns the per-epoch correlators ``[block_ms, n_ch, 2 * n_taps]`` directly.

:func:`epoch_correlate` runs the kernel on CUDA tensors and
:func:`epoch_correlate_ref` (plain PyTorch, the same arithmetic) on CPU
tensors; there is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from sydr_tpu_torch.ops import native

CODE_WIDTH = 4160   # batch_runtime.tiled_code_bits row width
CODE_ORIGIN = 1023  # column of chip 0 in a tiled row
MAX_TAPS = 5

_VP = ctypes.c_void_p
_INT = ctypes.c_int
KERNEL = native.CudaKernel(
    "epoch_correlate.cu", "epoch_correlate_launch",
    [_VP] * 9 + [ctypes.POINTER(ctypes.c_float), ctypes.POINTER(_INT)]
    + [_INT] * 5 + [_VP, _VP])


def fma32(a, b, c):
    """``a * b + c`` rounded once to float32, for float32 operands.

    The float64 product of two float32 values is exact and the float64
    sum is within 2^-53, so this is a fused multiply-add up to a double
    rounding that needs a float64 result within 2^-53 of a float32
    midpoint. XLA's CPU backend contracts ``a * b + c`` into a fused
    multiply-add; the chip-index ``ceil`` depends on which rounding is
    used, so the port uses the fused form wherever a ``ceil``/``floor``
    reads such an expression (and ``__fmaf_rn`` in the CUDA kernel).
    """
    return (a.double() * b.double() + c.double()).float()


def epoch_correlate_ref(window_re, window_im, code_bits, c_int, omega,
                        code_step, fb_q, phic_q, bounds, taps, spms):
    """Plain PyTorch version of :func:`epoch_correlate` (same arguments).

    Builds every stream densely over the window, ``[n_ch, n_streams,
    n_win]``, then sums each epoch's samples with one ``scatter_add``.
    The chip index and carrier phase are fused multiply-adds
    (:func:`fma32`), rounded as the kernel's ``__fmaf_rn``.
    """
    dev = window_re.device
    n_ch, n_q = fb_q.shape
    n_win = window_re.shape[0]
    n_epochs = bounds.shape[0] - 1
    m = torch.arange(n_win, device=dev, dtype=torch.int64)
    q = m // spms
    lm = (m - q * spms).to(torch.float32)
    phase = fma32(-omega[:, None], lm[None, :], phic_q[:, q])
    cosv, sinv = torch.cos(phase), torch.sin(phase)
    mre = cosv * window_re[None, :] - sinv * window_im[None, :]
    mim = cosv * window_im[None, :] + sinv * window_re[None, :]

    origin = (CODE_ORIGIN + c_int.to(torch.int64))[:, None]
    streams = []
    for sp, k in taps:
        mk = m + k
        qk = torch.clamp(mk // spms, max=n_q - 1)
        lk = (mk - qk * spms).to(torch.float32)
        r = fb_q[:, qk] + sp
        idx = torch.ceil(fma32(lk[None, :], code_step[:, None], r)).to(
            torch.int64)
        pos = torch.clamp(origin + idx, 0, CODE_WIDTH - 1)
        chips = 2.0 * torch.gather(code_bits, 1, pos) - 1.0
        streams += [chips * mre, chips * mim]
    dense = torch.stack(streams, dim=1)                 # [n_ch, S, n_win]

    # Epoch id of every sample; samples outside [bounds[0], bounds[-1])
    # land in a spare bin n_epochs that is dropped.
    edges = bounds.to(torch.int64).t().contiguous()      # [n_ch, E + 1]
    seg = torch.searchsorted(
        edges, m.expand(n_ch, n_win).contiguous(), right=True) - 1
    seg = torch.where((seg < 0) | (seg >= n_epochs), n_epochs, seg)
    n_s = dense.shape[1]
    sums = torch.zeros(n_ch, n_s, n_epochs + 1, dtype=torch.float32,
                       device=dev)
    sums.scatter_add_(2, seg[:, None, :].expand(n_ch, n_s, n_win), dense)
    return sums[:, :, :n_epochs].permute(2, 0, 1).contiguous()


def epoch_correlate(window_re, window_im, code_bits, c_int, omega, code_step,
                    fb_q, phic_q, bounds, taps, spms):
    """Per-epoch correlators ``[n_epochs, n_ch, 2 * len(taps)]`` f32.

    Args:
        window_re, window_im: ``[n_win]`` f32 window, ``n_win = n_q * spms``.
        code_bits: ``[n_ch, 4160]`` f32 0/1 tiled code (``tiled_code_bits``).
        c_int: ``[n_ch]`` int32 integer chip of the block intercept.
        omega, code_step: ``[n_ch]`` f32 carrier rad/sample, chips/sample.
        fb_q, phic_q: ``[n_ch, n_q]`` f32 per-ms code / carrier anchors.
        bounds: ``[n_epochs + 1, n_ch]`` int32 epoch bounds in window
            samples (epoch ``e`` sums samples ``[bounds[e], bounds[e+1])``).
        taps: ``((spacing, sample_shift), ...)``, at most 5 taps.
        spms: samples per millisecond.
    """
    if window_re.device.type == "cpu":
        return epoch_correlate_ref(window_re, window_im, code_bits, c_int,
                                   omega, code_step, fb_q, phic_q, bounds,
                                   taps, spms)
    dev = window_re.device
    if dev.type != "cuda":
        raise ValueError(f"epoch_correlate: unsupported device {dev}")
    n_ch, n_q = fb_q.shape
    n_epochs = bounds.shape[0] - 1
    n_taps = len(taps)
    if not 1 <= n_taps <= MAX_TAPS:
        raise ValueError(f"epoch_correlate: {n_taps} taps (1..{MAX_TAPS})")
    f32, i32 = torch.float32, torch.int32
    native.check(window_re, "window_re", f32, (n_q * spms,), dev)
    native.check(window_im, "window_im", f32, (n_q * spms,), dev)
    native.check(code_bits, "code_bits", f32, (n_ch, CODE_WIDTH), dev)
    native.check(c_int, "c_int", i32, (n_ch,), dev)
    native.check(omega, "omega", f32, (n_ch,), dev)
    native.check(code_step, "code_step", f32, (n_ch,), dev)
    native.check(fb_q, "fb_q", f32, (n_ch, n_q), dev)
    native.check(phic_q, "phic_q", f32, (n_ch, n_q), dev)
    native.check(bounds, "bounds", i32, (n_epochs + 1, n_ch), dev)
    out = torch.empty((n_epochs, n_ch, 2 * n_taps), dtype=f32, device=dev)
    tap_sp = (ctypes.c_float * n_taps)(*[float(sp) for sp, _ in taps])
    tap_k = (ctypes.c_int * n_taps)(*[int(k) for _, k in taps])
    KERNEL.launch(
        native.ptr(window_re), native.ptr(window_im), native.ptr(code_bits),
        native.ptr(c_int), native.ptr(omega), native.ptr(code_step),
        native.ptr(fb_q), native.ptr(phic_q), native.ptr(bounds),
        tap_sp, tap_k, n_taps, n_epochs, n_ch, n_q, spms,
        native.ptr(out), native.stream_of(out))
    return out
