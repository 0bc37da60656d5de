"""Pass C of the batched runtime as one CUDA kernel launch a block.

``pass_c(cfg, st, geo, corr)`` returns what :func:`pass_c_plain` returns:
``channels.batch_runtime._pass_c`` followed by the block's anchor slew
(``channels.runtime._slew_anchor``), the new ``ChannelState`` and the
outputs, a dict of ``[block_ms, n_ch]`` tensors with ``_pass_c``'s keys,
dtypes and shapes. On CPU tensors it is that plain version (a Python loop
over the block's epochs, ~280 ``[n_ch]``-wide ops each, and the slew's
few). On CUDA tensors it launches ``csrc/pass_c.cu`` once: a warp a
channel, its lanes computing the epochs' carry-free values side by side
and the loop filters' carry in series (:data:`PASS_C_WARPS` channels a
CTA), the slew in its epilogue, the counterpart of the JAX package's fused
``lax.scan`` (``sydr_tpu/channels/batch_runtime.py`` ``_pass_c``) and the
slew after it. It replaces no Pallas kernel. There is no fallback from one
to the other.

The host side, which runs on any device: :func:`loop_consts` (the
configuration's constants, each the float32 value the plain version's op
sees on the card: a division of a tensor by a Python scalar is PyTorch's
CUDA multiplication by the scalar's reciprocal rounded to float32),
:func:`pass_c_launch_args` (the checks, the output tensors and the
pointers the kernel takes) and :func:`unpack` (the outputs as the plain
version returns them).
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from sydr_tpu_torch.channels.state import (
    F32_FIELDS,
    I32_SCALAR_FIELDS,
    ChannelState,
)
from sydr_tpu_torch.constants import (
    DLF_A2,
    DLF_A3,
    DLF_B3,
    DLF_W0_SCALE_1ST,
    DLF_W0_SCALE_2ND,
    DLF_W0_SCALE_3RD,
    GPS_L1CA_CODE_FREQ,
)
from sydr_tpu_torch.ops import native
from sydr_tpu_torch.ops import tracking as trk

_VP = ctypes.c_void_p
_INT = ctypes.c_int
_F32 = ctypes.c_float

PROFILES = {"borre": 0, "kaplan": 1, "kaplan_narrow_only": 2}
# The outputs' rows in the kernels' buffers (csrc/channel_layout.cuh's
# OutF, OutI and OutB), and every key in the plain version's order.
OUT_F32 = ("i_early", "q_early", "i_prompt", "q_prompt", "i_late",
           "q_late", "dll_error", "pll_error", "fll_error", "nco_code",
           "nco_carrier", "carrier_freq", "code_freq", "cn0", "pll_lock",
           "fll_lock", "rem_code", "bit_ip_sum")
OUT_I32 = ("lock_state", "flags", "unread", "required")
OUT_BOOL = ("active", "bit_ready")
OUTPUT_KEYS = ("active", "i_early", "q_early", "i_prompt", "q_prompt",
               "i_late", "q_late", "dll_error", "pll_error", "fll_error",
               "lock_state", "nco_code", "nco_carrier", "carrier_freq",
               "code_freq", "cn0", "pll_lock", "fll_lock", "flags",
               "unread", "required", "rem_code", "bit_ready", "bit_ip_sum")
HIST_BINS = 20


class LoopConsts(ctypes.Structure):
    """``csrc/loop_update.cuh``'s ``LoopConsts``, field by field."""

    _fields_ = [
        *[(name, _INT) for name in (
            "profile", "dlf_order", "fll_atan2", "cn0_beaulieu",
            "freq_rail_on", "block_step_on", "code_rail_on",
            "min_convergence_ms", "bit_sync_unanimous", "bit_sync_flips")],
        *[(name, _F32) for name in ("dll_k1", "dll_k2", "pll_k1", "pll_k2")],
        ("w0f", _F32 * 3), ("w0p", _F32 * 3),
        *[(name, _F32) for name in (
            "a2", "a3", "b3", "t_int", "alpha", "one_minus_alpha",
            "fll_thr_wide", "fll_thr_narrow", "pll_thr_narrow", "freq_rail",
            "block_step", "code_rail", "dominance", "two_pi", "pi",
            "half_pi", "rcp_two_pi", "rcp_dt", "rcp_ten", "cn0_alpha",
            "cn0_one_minus_alpha", "cn0_floor", "n_accum", "code_freq")],
        ("slew_on", _INT), ("slew_step", _F32),
    ]


class PassCArgs(ctypes.Structure):
    """``csrc/pass_c.cu``'s ``PassCArgs``: the device pointers."""

    _fields_ = [
        ("state_f", _VP * len(F32_FIELDS)),
        ("state_i", _VP * len(I32_SCALAR_FIELDS)),
        *[(name, _VP) for name in (
            "edge_hist", "corr", "active", "required", "unread_after",
            "rem_code", "rem_code_end", "rem_carrier_end", "delta",
            "unread_end", "out_f", "out_i", "out_b", "new_f", "new_i",
            "new_hist")],
    ]


PASS_C_KERNEL = native.CudaKernel(
    "pass_c.cu", "pass_c_launch",
    [ctypes.POINTER(LoopConsts), ctypes.POINTER(PassCArgs)] + [_INT] * 5
    + [_VP])
# Channels (warps) a CTA of the kernel: a power of two up to
# csrc/pass_c.cu's kMaxWarps, and the width launched.
PASS_C_MAX_WARPS = 8
PASS_C_WARPS = 4
TILE_EPOCHS = 32


def slab_bytes(warps: int, n_streams: int) -> int:
    """Shared memory of a CTA of ``warps`` channels (csrc/pass_c.cu's
    ``slab_bytes``), for a tile: the correlators, next code phases,
    required and unread counts (4 bytes each), activity (1 byte) and the
    outputs (a 4-byte word each of every row)."""
    rows = len(OUT_F32) + len(OUT_I32) + len(OUT_BOOL)
    return TILE_EPOCHS * warps * (4 * n_streams + 13 + 4 * rows)


def f32(x) -> float:
    """``x`` rounded to float32, as a Python float."""
    return float(np.float32(x))


def rcp(x) -> float:
    """What PyTorch's CUDA division of a float32 tensor by the Python
    scalar ``x`` multiplies by: the reciprocal taken in double, rounded to
    float32 (not the float32 reciprocal of float32 ``x``: at ``x = 1e-3``
    they are 1000 and 999.99994; probed on the card)."""
    return f32(1.0 / x)


def profile_code(cfg) -> int:
    if cfg.profile == "kaplan":
        return PROFILES["kaplan_narrow_only" if cfg.kaplan_narrow_only
                        else "kaplan"]
    return PROFILES["borre"]


@functools.lru_cache(maxsize=64)
def loop_consts(cfg) -> LoopConsts:
    """The kernel's constants for ``cfg`` (cached per configuration), as
    the plain version's ops see them (``ops/profiles.py::loop_update``,
    ``ops/tracking.py``, ``batch_runtime._pass_c``,
    ``runtime._slew_anchor``)."""
    dll_t1, dll_t2 = trk.loop_filter_taus(
        cfg.dll_bandwidth, cfg.dll_damping, cfg.dll_gain)
    pll_t1, pll_t2 = trk.loop_filter_taus(
        cfg.pll_bandwidth, cfg.pll_damping, cfg.pll_gain)
    cap = 0.12 / (cfg.block_ms * 1e-3) if cfg.runtime == "batch" \
        else float("inf")
    # Per lock state (pull-in, wide, narrow): the bandwidth tensor holds
    # f32(min(bw, cap)), then a division by the DLF scale.
    fll_bw = [min(cfg.fll_bandwidth_pullin, cap),
              min(cfg.fll_bandwidth_wide, cap),
              min(cfg.fll_bandwidth_narrow, cap)]
    pll_bw = [0.0, min(cfg.pll_bandwidth_wide, cap),
              min(cfg.pll_bandwidth_narrow, cap)]
    if cfg.profile == "kaplan" and cfg.kaplan_narrow_only:
        fll_bw, pll_bw = [fll_bw[2]] * 3, [pll_bw[2]] * 3
    scale_f, scale_p = ((DLF_W0_SCALE_2ND, DLF_W0_SCALE_3RD)
                        if cfg.dlf_order == 3
                        else (DLF_W0_SCALE_1ST, DLF_W0_SCALE_2ND))

    def scaled(bw, scale):
        return float(np.float32(bw) * np.float32(rcp(scale)))

    # borre's lock indicators take their default alpha.
    alpha = cfg.lock_indicator_alpha if cfg.profile == "kaplan" else 0.01
    return LoopConsts(
        profile=profile_code(cfg), dlf_order=3 if cfg.dlf_order == 3 else 2,
        fll_atan2=int(cfg.fll_discriminator == "atan2"),
        cn0_beaulieu=int(cfg.cn0_estimator == "beaulieu"),
        freq_rail_on=int(cfg.freq_rail_hz > 0),
        block_step_on=int(cfg.max_block_freq_step > 0),
        code_rail_on=int(cfg.code_rail_hz > 0),
        min_convergence_ms=cfg.min_convergence_ms,
        bit_sync_unanimous=cfg.bit_sync_unanimous,
        bit_sync_flips=cfg.bit_sync_flips,
        dll_k1=f32(dll_t2 / dll_t1), dll_k2=f32(cfg.dll_pdi / dll_t1),
        pll_k1=f32(pll_t2 / pll_t1), pll_k2=f32(cfg.pll_pdi / pll_t1),
        w0f=(_F32 * 3)(*[scaled(bw, scale_f) for bw in fll_bw]),
        w0p=(_F32 * 3)(*[scaled(bw, scale_p) for bw in pll_bw]),
        a2=f32(DLF_A2), a3=f32(DLF_A3), b3=f32(DLF_B3), t_int=f32(1e-3),
        alpha=f32(alpha), one_minus_alpha=f32(1.0 - alpha),
        fll_thr_wide=f32(cfg.fll_threshold_wide),
        fll_thr_narrow=f32(cfg.fll_threshold_narrow),
        pll_thr_narrow=f32(cfg.pll_threshold_narrow),
        freq_rail=f32(cfg.freq_rail_hz),
        block_step=f32(cfg.max_block_freq_step),
        code_rail=f32(cfg.code_rail_hz),
        dominance=f32(cfg.bit_sync_dominance),
        two_pi=f32(2.0 * math.pi), pi=f32(math.pi),
        half_pi=f32(math.pi / 2.0), rcp_two_pi=rcp(2.0 * math.pi),
        rcp_dt=rcp(1e-3), rcp_ten=rcp(10.0), cn0_alpha=f32(0.1),
        cn0_one_minus_alpha=f32(1.0 - 0.1), cn0_floor=f32(1e-12),
        n_accum=f32(20), code_freq=f32(GPS_L1CA_CODE_FREQ),
        slew_on=int(cfg.anchor_slew_hz_per_s > 0 and cfg.freq_rail_hz > 0),
        slew_step=f32(cfg.anchor_slew_hz_per_s * cfg.block_ms * 1e-3))


def active_stride(active) -> int:
    """The row stride the kernel reads ``geo["active"]`` with: its own
    for a contiguous tensor, 0 for a row expanded over the epochs (pass A's
    closed form); raise on any other layout."""
    n_epochs, n_ch = active.shape
    if active.is_contiguous():
        return n_ch
    if active.stride(0) == 0 and (n_ch == 1 or active.stride(1) == 1):
        return 0
    raise ValueError(f"active: strides {active.stride()} (contiguous or a "
                     f"row expanded over the epochs)")


def pass_c_launch_args(cfg, st: ChannelState, geo, corr,
                       warps: int = PASS_C_WARPS):
    """Check the arguments of :func:`pass_c` (on ``corr``'s device),
    allocate its outputs and return ``(bufs, args)``: ``bufs`` the output
    tensors (:func:`unpack`), ``args`` the C arguments of
    :data:`PASS_C_KERNEL`'s entry point but its stream (the constants
    and pointer structures, then ``n_ch, n_epochs, n_streams,
    active_stride, warps``)."""
    dev = corr.device
    if corr.dim() != 3:
        raise ValueError(f"corr: shape {tuple(corr.shape)}, expected "
                         f"[block_ms, n_ch, n_streams]")
    n_epochs, n_ch, n_streams = corr.shape
    if not (1 <= warps <= PASS_C_MAX_WARPS and warps & (warps - 1) == 0):
        raise ValueError(f"warps: {warps}, the kernel takes a power of two "
                         f"up to {PASS_C_MAX_WARPS}")
    want = 10 if profile_code(cfg) == PROFILES["kaplan"] else 6
    if n_streams < want:
        raise ValueError(f"corr: {n_streams} streams, the {cfg.profile} "
                         f"loops read {want}")
    f32t, i32t = torch.float32, torch.int32
    vec, seq = (n_ch,), (n_epochs, n_ch)
    native.check_all(dev, (
        *[(getattr(st, n), n, f32t, vec) for n in F32_FIELDS],
        *[(getattr(st, n), n, i32t, vec) for n in I32_SCALAR_FIELDS],
        (st.edge_hist, "edge_hist", i32t, (n_ch, HIST_BINS)),
        (corr, "corr", f32t, (n_epochs, n_ch, n_streams)),
        (geo["required"], "required", i32t, seq),
        (geo["unread_after"], "unread_after", i32t, seq),
        (geo["rem_code"], "rem_code", f32t, seq),
        (geo["rem_code_end"], "rem_code_end", f32t, vec),
        (geo["rem_carrier_end"], "rem_carrier_end", f32t, vec),
        (geo["delta"], "delta", f32t, vec),
        (geo["unread_end"], "unread_end", i32t, vec)))
    active = geo["active"]
    if not (active.device == dev and active.dtype == torch.bool
            and active.shape == seq):
        native.check(active, "active", torch.bool, seq, dev)
    stride = active_stride(active)

    bufs = {
        "out_f": torch.empty((len(OUT_F32), n_epochs, n_ch), dtype=f32t,
                             device=dev),
        "out_i": torch.empty((len(OUT_I32), n_epochs, n_ch), dtype=i32t,
                             device=dev),
        "out_b": torch.empty((len(OUT_BOOL), n_epochs, n_ch),
                             dtype=torch.bool, device=dev),
        "new_f": torch.empty((len(F32_FIELDS), n_ch), dtype=f32t,
                             device=dev),
        "new_i": torch.empty((len(I32_SCALAR_FIELDS), n_ch), dtype=i32t,
                             device=dev),
        "new_hist": torch.empty((n_ch, HIST_BINS), dtype=i32t, device=dev),
    }
    ptrs = PassCArgs(
        state_f=(_VP * len(F32_FIELDS))(
            *[native.ptr(getattr(st, n)) for n in F32_FIELDS]),
        state_i=(_VP * len(I32_SCALAR_FIELDS))(
            *[native.ptr(getattr(st, n)) for n in I32_SCALAR_FIELDS]),
        edge_hist=native.ptr(st.edge_hist), corr=native.ptr(corr),
        active=native.ptr(active),
        **{k: native.ptr(geo[k]) for k in (
            "required", "unread_after", "rem_code", "rem_code_end",
            "rem_carrier_end", "delta", "unread_end")},
        **{k: native.ptr(t) for k, t in bufs.items()})
    return bufs, (ctypes.byref(loop_consts(cfg)), ctypes.byref(ptrs),
                  n_ch, n_epochs, n_streams, stride, warps)


def unpack(bufs):
    """``(new_state, outputs)`` from the kernel's output tensors, as
    ``batch_runtime._pass_c`` returns them: every field and output a
    contiguous row of its buffer."""
    leaves = {n: bufs["new_f"][k] for k, n in enumerate(F32_FIELDS)}
    leaves.update({n: bufs["new_i"][k]
                   for k, n in enumerate(I32_SCALAR_FIELDS)})
    leaves["edge_hist"] = bufs["new_hist"]
    rows = {k: bufs["out_f"][j] for j, k in enumerate(OUT_F32)}
    rows.update({k: bufs["out_i"][j] for j, k in enumerate(OUT_I32)})
    rows.update({k: bufs["out_b"][j] for j, k in enumerate(OUT_BOOL)})
    return ChannelState(**leaves), {k: rows[k] for k in OUTPUT_KEYS}


def pass_c_plain(cfg, st: ChannelState, geo, corr):
    """The plain version of :func:`pass_c`: ``batch_runtime._pass_c``,
    then ``runtime._slew_anchor`` on its new state."""
    from sydr_tpu_torch.channels.batch_runtime import _pass_c
    from sydr_tpu_torch.channels.runtime import _slew_anchor

    new_state, outputs = _pass_c(cfg, st, geo, corr)
    return _slew_anchor(cfg, new_state), outputs


def pass_c(cfg, st: ChannelState, geo, corr):
    """Pass C of one block and the anchor slew: ``(new_state, outputs)``
    as :func:`pass_c_plain` (``batch_runtime._pass_c``'s arguments). CPU
    tensors take that plain version; CUDA tensors one launch of
    :data:`PASS_C_KERNEL`."""
    if corr.device.type == "cpu":
        return pass_c_plain(cfg, st, geo, corr)
    if corr.device.type != "cuda":
        raise ValueError(f"pass_c: unsupported device {corr.device}")
    bufs, args = pass_c_launch_args(cfg, st, geo, corr)
    PASS_C_KERNEL.launch(*args, native.stream_of(corr))
    return unpack(bufs)
