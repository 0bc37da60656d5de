"""Pass A and pass B's geometry of the batched runtime as one CUDA kernel
launch a block.

``block_geometry_all(cfg, st)`` returns ``(geo, inputs, bounds)``: ``geo``
the dict that ``channels.batch_runtime._pass_a`` returns (pass A's epoch
boundaries, phases and activity, the end-of-block values and the frozen
rates), ``inputs`` the correlation kernels' arguments after the window
planes and the code bits, ``(c_int, omega, code_step, fb_q, phic_q)``, and
``bounds`` the ``[block_ms + 1, n_ch]`` epoch bounds: what
``batch_runtime.pass_b_inputs`` returns for that ``geo``. These are the
arguments of K1 (``correlator_kernel.epoch_correlate``), K3
(``block_cumsum_streams``) and pass C (``loop_kernel.pass_c``).

On CPU tensors it is that plain composition (``_rates``,
``_pass_a_closed``, ``_intercept``, ``block_geometry`` and
``epoch_bounds``: ~130 ``[n_ch]``-wide ops). On CUDA tensors, with pass A
in its closed form (``TrackingConfig.pass_a="closed"``, the default), it
launches ``csrc/block_geometry.cu`` once: a warp a channel, its lanes over
the block's epochs and then over the anchor milliseconds, the counterpart
of what XLA fuses ahead of the correlation in the JAX package's jitted
``run_block_batched`` (``sydr_tpu/channels/batch_runtime.py:1237-1253``).
It replaces no Pallas kernel, and there is no fallback from one to the
other. ``pass_a="scan"``, the per-epoch oracle form that no configuration
of the main path uses, keeps the plain ops on every device.

The kernel's outputs equal the plain version's bit for bit, every integer
and every float: each operation rounds as the plain op does on the card
(``csrc/loop_update.cuh``'s helpers), with the constants of
:func:`geometry_consts`. ``geo["active"]`` comes back contiguous, where the
plain version expands one row over the epochs (``loop_kernel.active_stride``
reads either).

The host side, which runs on any device: :func:`geometry_consts`,
:func:`geometry_launch_args` (the checks, the output tensors and the
pointers the kernel takes) and :func:`unpack`.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from sydr_tpu_torch.channels.state import ChannelState
from sydr_tpu_torch.constants import (
    GPS_L1CA_CARRIER_FREQ,
    GPS_L1CA_CODE_FREQ,
    GPS_L1CA_CODE_LENGTH,
)
from sydr_tpu_torch.ops import native
from sydr_tpu_torch.ops.loop_kernel import f32, rcp

_VP = ctypes.c_void_p
_INT = ctypes.c_int
_F32 = ctypes.c_float

# The output rows in the kernel's buffers (csrc/block_geometry.cu's VecF,
# VecI, SeqF and SeqI), and the geo keys in the plain version's order.
VEC_F32 = ("delta", "code_step", "omega", "rem_code_end", "rem_carrier_end")
VEC_I32 = ("unread_end", "consumed_end", "c_int")
SEQ_F32 = ("rem_code", "rem_carrier")
SEQ_I32 = ("required", "b_start", "unread_after")
GEO_KEYS = ("required", "active", "b_start", "rem_code", "rem_carrier",
            "unread_after", "rem_code_end", "rem_carrier_end", "unread_end",
            "consumed_end", "code_step", "omega", "delta")
# The state fields the kernel reads, in GeoArgs' order.
STATE_F32 = ("rem_code", "rem_carrier", "carrier_freq", "code_freq_offset")
STATE_I32 = ("unread", "mode")


class GeoConsts(ctypes.Structure):
    """``csrc/block_geometry.cu``'s ``GeoConsts``, field by field."""

    _fields_ = [
        *[(name, _INT) for name in (
            "n_epochs", "n_anchors", "samples_per_ms", "tail_ms",
            "window_samples", "carrier_aiding")],
        *[(name, _F32) for name in (
            "intermediate_frequency", "aiding", "code_freq", "rcp_fs",
            "rcp_spms", "spms_over_fs", "spms", "two_pi", "code_length")],
    ]


class GeoArgs(ctypes.Structure):
    """``csrc/block_geometry.cu``'s ``GeoArgs``: the device pointers."""

    _fields_ = [(name, _VP) for name in (
        *STATE_F32, *STATE_I32, "vec_f", "vec_i", "seq_f", "seq_i",
        "active", "anchors", "bounds")]


GEOMETRY_KERNEL = native.CudaKernel(
    "block_geometry.cu", "block_geometry_launch",
    [ctypes.POINTER(GeoConsts), ctypes.POINTER(GeoArgs), _INT, _VP])
# Channels (warps) a CTA of the kernel: csrc/block_geometry.cu's kWarps.
GEO_WARPS = 4


@functools.lru_cache(maxsize=64)
def geometry_consts(cfg) -> GeoConsts:
    """The kernel's constants for ``cfg`` (cached per configuration), each
    the float32 value the plain version's op sees: a Python float rounded
    by its op, ``x * (1.0 / s)`` the multiplication by ``f32(1 / s)``
    (:func:`loop_kernel.rcp`)."""
    spms = cfg.samples_per_ms
    fs = cfg.sampling_frequency
    return GeoConsts(
        n_epochs=cfg.block_ms, n_anchors=cfg.tail_ms + cfg.block_ms,
        samples_per_ms=spms, tail_ms=cfg.tail_ms,
        window_samples=cfg.window_samples,
        carrier_aiding=int(cfg.carrier_aiding),
        intermediate_frequency=f32(cfg.intermediate_frequency),
        aiding=f32(GPS_L1CA_CODE_FREQ / GPS_L1CA_CARRIER_FREQ),
        code_freq=f32(GPS_L1CA_CODE_FREQ), rcp_fs=rcp(fs),
        rcp_spms=rcp(spms), spms_over_fs=f32(float(spms) / fs),
        spms=f32(spms), two_pi=f32(2.0 * math.pi),
        code_length=f32(GPS_L1CA_CODE_LENGTH))


def geometry_launch_args(cfg, st: ChannelState):
    """Check the state fields the kernel reads (on ``st.rem_code``'s
    device), allocate its outputs and return ``(bufs, args)``: ``bufs`` the
    output tensors (:func:`unpack`), ``args`` the C arguments of
    :data:`GEOMETRY_KERNEL`'s entry point but its stream (the constants and
    pointer structures, then ``n_ch``)."""
    dev = st.rem_code.device
    n_ch = st.rem_code.shape[0]
    vec = (n_ch,)
    native.check_all(dev, (
        *[(getattr(st, n), n, torch.float32, vec) for n in STATE_F32],
        *[(getattr(st, n), n, torch.int32, vec) for n in STATE_I32]))
    n_e, n_q = cfg.block_ms, cfg.tail_ms + cfg.block_ms
    f32t, i32t = torch.float32, torch.int32
    bufs = {
        "vec_f": torch.empty((len(VEC_F32), n_ch), dtype=f32t, device=dev),
        "vec_i": torch.empty((len(VEC_I32), n_ch), dtype=i32t, device=dev),
        "seq_f": torch.empty((len(SEQ_F32), n_e, n_ch), dtype=f32t,
                             device=dev),
        "seq_i": torch.empty((len(SEQ_I32), n_e, n_ch), dtype=i32t,
                             device=dev),
        "active": torch.empty((n_e, n_ch), dtype=torch.bool, device=dev),
        "anchors": torch.empty((2, n_ch, n_q), dtype=f32t, device=dev),
        "bounds": torch.empty((n_e + 1, n_ch), dtype=i32t, device=dev),
    }
    ptrs = GeoArgs(
        **{n: native.ptr(getattr(st, n)) for n in STATE_F32 + STATE_I32},
        **{k: native.ptr(t) for k, t in bufs.items()})
    return bufs, (ctypes.byref(geometry_consts(cfg)), ctypes.byref(ptrs),
                  n_ch)


def unpack(bufs):
    """``(geo, inputs, bounds)`` from the kernel's output tensors, as
    :func:`geometry_plain` returns them: every tensor a contiguous row of
    its buffer."""
    rows = {k: bufs["vec_f"][j] for j, k in enumerate(VEC_F32)}
    rows.update({k: bufs["vec_i"][j] for j, k in enumerate(VEC_I32)})
    rows.update({k: bufs["seq_f"][j] for j, k in enumerate(SEQ_F32)})
    rows.update({k: bufs["seq_i"][j] for j, k in enumerate(SEQ_I32)})
    rows["active"] = bufs["active"]
    geo = {k: rows[k] for k in GEO_KEYS}
    inputs = (rows["c_int"], geo["omega"], geo["code_step"],
              bufs["anchors"][0], bufs["anchors"][1])
    return geo, inputs, bufs["bounds"]


def geometry_plain(cfg, st: ChannelState):
    """The plain version: ``batch_runtime._pass_a`` and
    ``batch_runtime.pass_b_inputs`` in PyTorch ops."""
    from sydr_tpu_torch.channels import batch_runtime as br

    geo = br._pass_a(cfg, st)
    inputs, bounds = br.pass_b_inputs(cfg, st, geo)
    return geo, inputs, bounds


def block_geometry_all(cfg, st: ChannelState):
    """One block's ``(geo, inputs, bounds)`` (module note). CPU tensors,
    and ``pass_a="scan"`` on any device, take :func:`geometry_plain`; CUDA
    tensors with pass A's closed form one launch of
    :data:`GEOMETRY_KERNEL`."""
    dev = st.rem_code.device
    if dev.type == "cpu" or (dev.type == "cuda" and cfg.pass_a != "closed"):
        return geometry_plain(cfg, st)
    if dev.type != "cuda":
        raise ValueError(f"block_geometry_all: unsupported device {dev}")
    bufs, args = geometry_launch_args(cfg, st)
    GEOMETRY_KERNEL.launch(*args, native.stream_of(st.rem_code))
    return unpack(bufs)
