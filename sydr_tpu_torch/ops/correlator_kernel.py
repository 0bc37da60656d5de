"""Correlator kernels of the batched runtime: K1 ``epoch_correlate`` and
K3 ``block_cumsum_streams``.

K1 replaces ``sydr_tpu.ops.correlator_kernel.block_rowsum_streams``
(Pallas ``_kernel_rowsum``) plus the XLA boundary recompute that turned its
row totals into epoch sums. The CUDA kernel (``csrc/epoch_correlate.cu``)
returns the per-epoch correlators ``[block_ms, n_ch, 2 * n_taps]``
directly; a block serves one channel over a few epochs, each epoch a fixed
set of warps (:func:`launch_shape`).

K3 replaces ``sydr_tpu.ops.correlator_kernel.block_cumsum_streams``
(Pallas ``_kernel``), the prefix boundary form
(``TrackingConfig.boundary_mode = "prefix"``): the CUDA kernel
(``csrc/block_cumsum_streams.cu``) writes every stream's inclusive
per-sample prefix ``[n_ch, 2 * n_taps, n_win]``; pass B picks the epoch
bounds out of it.

Both kernels sum the same per-sample streams (``csrc/streams.cuh``;
:func:`_dense_streams` here). Each wrapper runs its kernel on CUDA tensors
and its plain PyTorch version (``*_ref``, the same arithmetic) on CPU
tensors; there is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from sydr_tpu_torch.ops import native

CODE_WIDTH = 4160   # batch_runtime.tiled_code_bits row width
CODE_ORIGIN = 1023  # column of chip 0 in a tiled row
MAX_TAPS = 5

_VP = ctypes.c_void_p
_INT = ctypes.c_int
_TAPS = [ctypes.POINTER(ctypes.c_float), ctypes.POINTER(_INT)]
KERNEL = native.CudaKernel(
    "epoch_correlate.cu", "epoch_correlate_launch",
    [_VP] * 9 + _TAPS + [_INT] * 7 + [_VP, _VP])
SM_COUNT = 132          # streaming multiprocessors of an H100
MAX_BLOCK_WARPS = 8     # warps per block of csrc/epoch_correlate.cu
CUMSUM_CHUNK = 1024   # samples per block of csrc/block_cumsum_streams.cu
CUMSUM_KERNEL = native.CudaKernel(
    "block_cumsum_streams.cu", "block_cumsum_streams_launch",
    [_VP] * 8 + _TAPS + [_INT] * 6 + [_VP] * 3)


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


def _dense_streams(window_re, window_im, code_bits, c_int, omega, code_step,
                   fb_q, phic_q, taps, spms):
    """Every per-sample stream over the window, ``[n_ch, 2 * n_taps,
    n_win]`` f32: tap ``t``'s chip times the carrier-mixed sample, I at
    ``2t`` and Q at ``2t + 1``.
    The chip index and carrier phase are fused multiply-adds
    (:func:`fma32`), rounded as the kernels' ``__fmaf_rn``
    (``csrc/streams.cuh``)."""
    dev = window_re.device
    n_q = fb_q.shape[1]
    m = torch.arange(window_re.shape[0], device=dev, dtype=torch.int64)
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
    return torch.stack(streams, dim=1)


def epoch_correlate_ref(window_re, window_im, code_bits, c_int, omega,
                        code_step, fb_q, phic_q, bounds, taps, spms):
    """Plain PyTorch version of :func:`epoch_correlate` (same arguments).

    Builds every stream densely over the window (:func:`_dense_streams`),
    then sums each epoch's samples with one ``scatter_add``.
    """
    dev = window_re.device
    n_ch = fb_q.shape[0]
    n_win = window_re.shape[0]
    n_epochs = bounds.shape[0] - 1
    dense = _dense_streams(window_re, window_im, code_bits, c_int, omega,
                           code_step, fb_q, phic_q, taps, spms)

    # Epoch id of every sample; samples outside [bounds[0], bounds[-1])
    # land in a spare bin n_epochs that is dropped.
    m = torch.arange(n_win, device=dev, dtype=torch.int64)
    edges = bounds.to(torch.int64).t().contiguous()      # [n_ch, E + 1]
    seg = torch.searchsorted(
        edges, m.expand(n_ch, n_win).contiguous(), right=True) - 1
    seg = torch.where((seg < 0) | (seg >= n_epochs), n_epochs, seg)
    n_s = dense.shape[1]
    sums = torch.zeros(n_ch, n_s, n_epochs + 1, dtype=torch.float32,
                       device=dev)
    sums.scatter_add_(2, seg[:, None, :].expand(n_ch, n_s, n_win), dense)
    return sums[:, :, :n_epochs].permute(2, 0, 1).contiguous()


def _check_stream_args(window_re, window_im, code_bits, c_int, omega,
                       code_step, fb_q, phic_q, taps, spms, name):
    """Raise unless the common kernel arguments are what the kernels take
    (contiguous, f32 / int32, on one CUDA device, consistent shapes)."""
    dev = window_re.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    if not 1 <= len(taps) <= MAX_TAPS:
        raise ValueError(f"{name}: {len(taps)} taps (1..{MAX_TAPS})")
    n_ch, n_q = fb_q.shape
    f32, i32 = torch.float32, torch.int32
    native.check_all(dev, (
        (window_re, "window_re", f32, (n_q * spms,)),
        (window_im, "window_im", f32, (n_q * spms,)),
        (code_bits, "code_bits", f32, (n_ch, CODE_WIDTH)),
        (c_int, "c_int", i32, (n_ch,)),
        (omega, "omega", f32, (n_ch,)),
        (code_step, "code_step", f32, (n_ch,)),
        (fb_q, "fb_q", f32, (n_ch, n_q)),
        (phic_q, "phic_q", f32, (n_ch, n_q))))


@functools.lru_cache(maxsize=16)
def _tap_arrays(taps):
    """The taps as the C arrays the launchers take (cached per tuple)."""
    n = len(taps)
    return ((ctypes.c_float * n)(*[float(sp) for sp, _ in taps]),
            (ctypes.c_int * n)(*[int(k) for _, k in taps]))


@functools.lru_cache(maxsize=64)
def launch_shape(n_epochs: int, n_ch: int, spms: int) -> tuple[int, int]:
    """``(warps_per_epoch, epochs_per_block)`` of a K1 launch.

    Warps per epoch: enough that the launch has some 16 warps for every
    SM of the card, at least one per 1280 samples of an epoch (40 a
    thread) and at most one per 256 (8 a thread), within the block's 8.
    Epochs per block: as many as the block's 8 warps hold, halved while
    the grid would have fewer blocks than the card has SMs (a block loads
    its channel's code row once, so fewer blocks load less, but an idle
    SM costs more).
    """
    want = -(-16 * SM_COUNT // max(1, n_epochs * n_ch))
    wpe = min(max(want, -(-spms // 1280)), max(1, spms // 256),
              MAX_BLOCK_WARPS)
    epb = max(1, MAX_BLOCK_WARPS // wpe)
    while epb > 1 and -(-n_epochs // epb) * n_ch < SM_COUNT:
        epb //= 2
    return wpe, epb


def epoch_correlate_launch_args(window_re, window_im, code_bits, c_int,
                                omega, code_step, fb_q, phic_q, bounds, taps,
                                spms):
    """Check the arguments of :func:`epoch_correlate` (CUDA tensors),
    allocate its output and return ``(out, args)`` with ``args`` the C
    arguments of :data:`KERNEL`'s entry point."""
    _check_stream_args(window_re, window_im, code_bits, c_int, omega,
                       code_step, fb_q, phic_q, taps, spms, "epoch_correlate")
    dev = window_re.device
    n_ch, n_q = fb_q.shape
    n_epochs = bounds.shape[0] - 1
    native.check(bounds, "bounds", torch.int32, (n_epochs + 1, n_ch), dev)
    out = torch.empty((n_epochs, n_ch, 2 * len(taps)), dtype=torch.float32,
                      device=dev)
    tap_sp, tap_k = _tap_arrays(tuple(taps))
    return out, (
        native.ptr(window_re), native.ptr(window_im), native.ptr(code_bits),
        native.ptr(c_int), native.ptr(omega), native.ptr(code_step),
        native.ptr(fb_q), native.ptr(phic_q), native.ptr(bounds),
        tap_sp, tap_k, len(taps), n_epochs, n_ch, n_q, spms,
        *launch_shape(n_epochs, n_ch, spms),
        native.ptr(out), native.stream_of(out))


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
    out, args = epoch_correlate_launch_args(
        window_re, window_im, code_bits, c_int, omega, code_step, fb_q,
        phic_q, bounds, taps, spms)
    KERNEL.launch(*args)
    return out


def block_cumsum_streams_ref(window_re, window_im, code_bits, c_int, omega,
                             code_step, fb_q, phic_q, taps, spms):
    """Plain PyTorch version of :func:`block_cumsum_streams` (same
    arguments): the dense streams, then ``torch.cumsum`` in f32."""
    return torch.cumsum(
        _dense_streams(window_re, window_im, code_bits, c_int, omega,
                       code_step, fb_q, phic_q, taps, spms), dim=-1)


def block_cumsum_streams_launch_args(window_re, window_im, code_bits, c_int,
                                     omega, code_step, fb_q, phic_q, taps,
                                     spms):
    """Check the arguments of :func:`block_cumsum_streams` (CUDA tensors),
    allocate its output and scratch and return ``(out, args, scratch)``
    with ``args`` the C arguments of :data:`CUMSUM_KERNEL`'s entry point;
    the caller keeps ``scratch`` until the launch is enqueued."""
    _check_stream_args(window_re, window_im, code_bits, c_int, omega,
                       code_step, fb_q, phic_q, taps, spms,
                       "block_cumsum_streams")
    dev = window_re.device
    n_ch, n_q = fb_q.shape
    n_win = window_re.shape[0]
    n_streams = 2 * len(taps)
    n_chunks = -(-n_win // CUMSUM_CHUNK)
    out = torch.empty((n_ch, n_streams, n_win), dtype=torch.float32,
                      device=dev)
    totals = torch.empty((n_ch, n_streams, n_chunks), dtype=torch.float32,
                         device=dev)
    tap_sp, tap_k = _tap_arrays(tuple(taps))
    return out, (
        native.ptr(window_re), native.ptr(window_im), native.ptr(code_bits),
        native.ptr(c_int), native.ptr(omega), native.ptr(code_step),
        native.ptr(fb_q), native.ptr(phic_q), tap_sp, tap_k, len(taps),
        n_ch, n_q, spms, n_win, n_chunks, native.ptr(totals),
        native.ptr(out), native.stream_of(out)), totals


def block_cumsum_streams(window_re, window_im, code_bits, c_int, omega,
                         code_step, fb_q, phic_q, taps, spms):
    """Inclusive per-sample prefix of every stream, ``[n_ch, 2 * len(taps),
    n_win]`` f32: ``out[c, s, t]`` sums stream ``s`` of channel ``c`` over
    window samples ``[0, t]``.

    Arguments as :func:`epoch_correlate`, without ``bounds``. The prefix
    accumulates in f32 (the JAX kernel rounds each sample to bf16 first).
    """
    if window_re.device.type == "cpu":
        return block_cumsum_streams_ref(window_re, window_im, code_bits,
                                        c_int, omega, code_step, fb_q,
                                        phic_q, taps, spms)
    out, args, _scratch = block_cumsum_streams_launch_args(
        window_re, window_im, code_bits, c_int, omega, code_step, fb_q,
        phic_q, taps, spms)
    CUMSUM_KERNEL.launch(*args)
    return out
