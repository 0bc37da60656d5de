"""The scan runtime's block as one CUDA kernel launch.

``scan_block(cfg, codes, st, window_re, window_im)`` returns what
``channels.runtime._run_block_plain`` returns: the new ``ChannelState``
(after the block's anchor slew) and the outputs, a dict of ``[block_ms,
n_ch]`` tensors with the same keys, dtypes and shapes. On CPU tensors it
is that plain version (a Python loop over the block's epochs, ~314
``[n_ch]``-wide ops each). On CUDA tensors it launches
``csrc/scan_block.cu`` once: a cluster of :data:`SCAN_CLUSTER` CTAs a
channel, their threads correlating each epoch's samples and each CTA's
loop warp reducing the cluster's partials and updating the loops, the
counterpart of the JAX package's jitted ``lax.scan``
(``sydr_tpu/channels/runtime.py`` ``run_block``). It replaces no Pallas
kernel. There is no fallback from one to the other.

The kernel rounds every operation before a sum as the plain version's op
does on the card, and sums each correlator in its own fixed order, not in
PyTorch's reduction tree: it is held to the plain version within bounds
(``tests/test_torch_cuda.py``), and to itself bit for bit across runs and
channel slices. The order depends on the cluster size, so that size is
one constant, never a function of the channel count: a channel shard sums
as the full launch does.

The host side, which runs on any device: :func:`scan_consts` (the scan
runtime's constants beside ``loop_kernel.loop_consts``, each the float32
value the plain version's op sees), :func:`scan_launch_args` (the checks,
the output tensors and the pointers the kernel takes),
:func:`max_active_clusters` (how many clusters the card runs at once),
:func:`check_protocol` (one launch of the kernel's checking build, for
tests and tools); the outputs unpack
with ``loop_kernel.unpack``, whose 24 keys and layout the scan outputs
share.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from sydr_tpu_torch.channels.state import (
    F32_FIELDS,
    I32_SCALAR_FIELDS,
    ChannelState,
)
from sydr_tpu_torch.constants import (
    GPS_L1CA_CARRIER_FREQ,
    GPS_L1CA_CODE_FREQ,
    GPS_L1CA_CODE_LENGTH,
)
from sydr_tpu_torch.ops import native
from sydr_tpu_torch.ops import profiles as prof
from sydr_tpu_torch.ops.loop_kernel import (
    HIST_BINS,
    OUT_BOOL,
    OUT_F32,
    OUT_I32,
    PROFILES,
    LoopConsts,
    f32,
    loop_consts,
    profile_code,
    rcp,
    unpack,
)

_VP = ctypes.c_void_p
_INT = ctypes.c_int
_F32 = ctypes.c_float

MAX_SPACINGS = 5
# Correlating threads a CTA (csrc/scan_block.cu's kThreads); each CTA also
# has its loop warp and its bookkeeping warp.
SCAN_THREADS = 256
# The CTAs a channel (the kernel's kCluster): the fastest of 1, 2 and 4 at
# every rate measured from 1.023 to 16.368 Msps (PERF.md section 6).
SCAN_CLUSTER = 4
# The largest window_size the kernel takes: its sample index is exact in
# float32 below 2^24, as the plain version's float32 arange.
MAX_WINDOW = 1 << 24
CODE_LEN = 1025


class ScanConsts(ctypes.Structure):
    """``csrc/scan_block.cu``'s ``ScanConsts``, field by field."""

    _fields_ = [
        ("code_ratio", ctypes.c_double),
        *[(name, _INT) for name in (
            "samples_per_ms", "tail_ms", "window_size", "n_spacings",
            "carrier_aiding", "slew_on")],
        ("spacing", _F32 * MAX_SPACINGS),
        *[(name, _F32) for name in (
            "intermediate_frequency", "aiding", "rcp_fs", "code_length",
            "slew_step")],
    ]


class ScanArgs(ctypes.Structure):
    """``csrc/scan_block.cu``'s ``ScanArgs``: the device pointers."""

    _fields_ = [
        ("state_f", _VP * len(F32_FIELDS)),
        ("state_i", _VP * len(I32_SCALAR_FIELDS)),
        *[(name, _VP) for name in (
            "edge_hist", "codes", "window_re", "window_im", "out_f", "out_i",
            "out_b", "new_f", "new_i", "new_hist")],
    ]


_LAUNCH_ARGTYPES = [ctypes.POINTER(LoopConsts), ctypes.POINTER(ScanConsts),
                    ctypes.POINTER(ScanArgs)] + [_INT] * 3 + [_VP]
SCAN_KERNEL = native.CudaKernel("scan_block.cu", "scan_block_launch",
                                _LAUNCH_ARGTYPES)
# The same source built to check its own hand-offs as it runs (the
# kernel's "protocol check": slots poisoned once consumed, epochs tagged,
# warps delayed at hashed points); the outputs are SCAN_KERNEL's bit for
# bit. Tests and tools launch it through check_protocol.
SCAN_CHECK_KERNEL = native.CudaKernel(
    "scan_block.cu", "scan_block_launch", _LAUNCH_ARGTYPES,
    flags=("-DSCAN_CHECK_PROTOCOL",))
# The check's fault kinds, in the kernel's order (its enum Fault).
PROTOCOL_FAULTS = ("partial read before its store",
                   "geometry read early or rewritten in use",
                   "exchange barrier a phase ahead",
                   "record read before its write",
                   "record written before its use")


def spacing_counts(cfg) -> tuple:
    """The spacing counts the kernel takes for ``cfg``'s loops: borre 3 to
    :data:`MAX_SPACINGS` (its loops read the first three), kaplan 5,
    narrow-only kaplan 3."""
    code = profile_code(cfg)
    if code == PROFILES["borre"]:
        return tuple(range(3, MAX_SPACINGS + 1))
    return (5,) if code == PROFILES["kaplan"] else (3,)


@functools.lru_cache(maxsize=64)
def scan_consts(cfg) -> ScanConsts:
    """The kernel's scan-runtime constants for ``cfg`` (cached per
    configuration), as the plain version's ops see them
    (``channels/runtime.py::_epoch``, ``scan_phase_advance`` and
    ``_slew_anchor``, ``ops/tracking.py::epl_correlate``)."""
    spacings = prof.spacings_for(cfg)
    padded = [f32(s) for s in spacings] + [0.0] * (
        MAX_SPACINGS - len(spacings))
    spms = cfg.samples_per_ms
    return ScanConsts(
        code_ratio=float(np.float32(GPS_L1CA_CODE_LENGTH)
                         * np.float32(1.0 / spms)),
        samples_per_ms=spms, tail_ms=cfg.tail_ms,
        window_size=cfg.window_size, n_spacings=len(spacings),
        carrier_aiding=int(cfg.carrier_aiding),
        slew_on=int(cfg.anchor_slew_hz_per_s > 0 and cfg.freq_rail_hz > 0),
        spacing=(_F32 * MAX_SPACINGS)(*padded[:MAX_SPACINGS]),
        intermediate_frequency=f32(cfg.intermediate_frequency),
        aiding=f32(GPS_L1CA_CODE_FREQ / GPS_L1CA_CARRIER_FREQ),
        rcp_fs=rcp(cfg.sampling_frequency),
        code_length=f32(GPS_L1CA_CODE_LENGTH),
        slew_step=f32(cfg.anchor_slew_hz_per_s * cfg.block_ms * 1e-3))


def scan_launch_args(cfg, codes, st: ChannelState, window_re, window_im):
    """Check the arguments of :func:`scan_block` (on ``window_re``'s
    device), allocate its outputs and return ``(bufs, args)``: ``bufs``
    the output tensors (``loop_kernel.unpack``), ``args`` the C arguments
    of :data:`SCAN_KERNEL`'s entry point but its stream (the constants and
    pointer structures, then ``n_ch, block_ms, n_window``)."""
    dev = window_re.device
    n_sp = len(prof.spacings_for(cfg))
    if n_sp not in spacing_counts(cfg):
        raise ValueError(f"spacings: {n_sp}, the kernel takes "
                         f"{spacing_counts(cfg)} for the {cfg.profile} loops")
    if not 1 <= cfg.window_size <= MAX_WINDOW:
        raise ValueError(f"window_size: {cfg.window_size}, the kernel takes "
                         f"1 to {MAX_WINDOW} samples")
    if cfg.block_ms < 1:
        raise ValueError(f"block_ms: {cfg.block_ms}, at least one epoch")
    if codes.dim() != 2 or codes.shape[0] < 1:
        raise ValueError(f"codes: shape {tuple(codes.shape)}, expected "
                         f"[n_ch >= 1, {CODE_LEN}]")
    n_ch, n_epochs = codes.shape[0], cfg.block_ms
    f32t, i32t = torch.float32, torch.int32
    vec, win = (n_ch,), (cfg.window_samples,)
    native.check_all(dev, (
        *[(getattr(st, n), n, f32t, vec) for n in F32_FIELDS],
        *[(getattr(st, n), n, i32t, vec) for n in I32_SCALAR_FIELDS],
        (st.edge_hist, "edge_hist", i32t, (n_ch, HIST_BINS)),
        (codes, "codes", f32t, (n_ch, CODE_LEN)),
        (window_re, "window_re", f32t, win),
        (window_im, "window_im", f32t, win)))

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
    ptrs = ScanArgs(
        state_f=(_VP * len(F32_FIELDS))(
            *[native.ptr(getattr(st, n)) for n in F32_FIELDS]),
        state_i=(_VP * len(I32_SCALAR_FIELDS))(
            *[native.ptr(getattr(st, n)) for n in I32_SCALAR_FIELDS]),
        edge_hist=native.ptr(st.edge_hist), codes=native.ptr(codes),
        window_re=native.ptr(window_re), window_im=native.ptr(window_im),
        **{k: native.ptr(t) for k, t in bufs.items()})
    return bufs, (ctypes.byref(loop_consts(cfg)),
                  ctypes.byref(scan_consts(cfg)), ctypes.byref(ptrs),
                  n_ch, n_epochs, cfg.window_samples)


def max_active_clusters(cfg, kernel=SCAN_KERNEL) -> int:
    """How many clusters of ``cfg``'s instance of ``kernel`` (a build of
    the scan kernel: :data:`SCAN_CLUSTER` CTAs a cluster in this tree's)
    the card runs at once (``cudaOccupancyMaxActiveClusters``); launches
    nothing."""
    query = kernel.entry(
        "scan_block_max_clusters",
        [ctypes.POINTER(LoopConsts), ctypes.POINTER(ScanConsts),
         ctypes.POINTER(_INT)])
    out = _INT(0)
    err = query(ctypes.byref(loop_consts(cfg)), ctypes.byref(scan_consts(cfg)),
                ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"scan_block_max_clusters: CUDA error {err}: "
                           f"{kernel.error_string(err)}")
    return out.value


def check_protocol(cfg, codes, st: ChannelState, window_re, window_im):
    """One launch of :data:`SCAN_CHECK_KERNEL` on CUDA tensors: ``(outputs,
    faults)``, the outputs as :func:`scan_block`'s (the buffers of
    :func:`scan_launch_args`, unpacked) and ``faults`` the check's fault
    counts of this launch by kind (:data:`PROTOCOL_FAULTS`)."""
    bufs, args = scan_launch_args(cfg, codes, st, window_re, window_im)
    read = SCAN_CHECK_KERNEL.entry("scan_block_protocol_faults",
                                   [ctypes.POINTER(ctypes.c_uint)])
    counts = (ctypes.c_uint * len(PROTOCOL_FAULTS))()

    def read_and_clear():
        torch.cuda.synchronize(window_re.device)
        err = read(counts)
        if err != 0:
            raise RuntimeError(f"scan_block_protocol_faults: CUDA error "
                               f"{err}: {SCAN_CHECK_KERNEL.error_string(err)}")

    read_and_clear()       # an earlier launch's counts
    SCAN_CHECK_KERNEL.launch(*args, native.stream_of(window_re))
    read_and_clear()
    return unpack(bufs), dict(zip(PROTOCOL_FAULTS, counts))


def scan_block(cfg, codes, st: ChannelState, window_re, window_im):
    """One block of the scan runtime: ``(new_state, outputs)`` as
    ``channels.runtime._run_block_plain`` (its arguments). CPU tensors take
    that plain version; CUDA tensors one launch of :data:`SCAN_KERNEL`, on
    clusters of :data:`SCAN_CLUSTER` CTAs a channel."""
    if window_re.device.type == "cpu":
        from sydr_tpu_torch.channels.runtime import _run_block_plain

        return _run_block_plain(cfg, codes, st, window_re, window_im)
    if window_re.device.type != "cuda":
        raise ValueError(f"scan_block: unsupported device {window_re.device}")
    bufs, args = scan_launch_args(cfg, codes, st, window_re, window_im)
    SCAN_KERNEL.launch(*args, native.stream_of(window_re))
    return unpack(bufs)
