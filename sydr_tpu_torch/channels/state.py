"""Per-channel tracking state as a dataclass of ``[n_channels]`` tensors.

Port of ``sydr_tpu.channels.state``: every satellite channel is a row of
the channel axis and all per-channel state lives in one dataclass of
``[n_ch]`` tensors (``edge_hist`` is ``[n_ch, 20]``), updated in lockstep.
Floats are ``torch.float32`` and integers ``torch.int32``, as in the JAX
package, which runs without x64.

Precision notes (device state is float32):
  * ``carrier_freq`` holds IF + Doppler (|f| < ~50 kHz) — f32 exact to ~4 mHz.
  * ``code_freq_offset`` holds the offset from the nominal 1.023 MHz chip
    rate, so sub-mHz DLL corrections stay representable.
  * Channels track an ``unread`` sample count relative to the stream write
    head instead of absolute sample positions.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sydr_tpu_torch.signal import cacode

# Channel modes (mirrors reference ChannelState enum; OFF/IDLE merged).
MODE_IDLE = 0
MODE_ACQUIRING = 1
MODE_TRACKING = 2

# Tracking flag bits (mirrors reference TrackingFlags bitmask).
FLAG_CODE_LOCK = 1 << 0
FLAG_BIT_SYNC = 1 << 1
FLAG_SUBFRAME_SYNC = 1 << 2
FLAG_TOW_DECODED = 1 << 3
FLAG_EPH_DECODED = 1 << 4
FLAG_FINE_LOCK = 1 << 5


@dataclasses.dataclass
class ChannelState:
    """All mutable per-channel DSP state, shape ``[n_channels]`` each."""

    mode: torch.Tensor              # int32: MODE_*
    flags: torch.Tensor             # int32 bitmask of FLAG_*
    carrier_freq: torch.Tensor      # f32 [Hz], IF + Doppler
    freq_anchor: torch.Tensor       # f32 [Hz] acquisition carrier (NCO rail)
    code_freq_offset: torch.Tensor  # f32 [Hz] offset from GPS_L1CA_CODE_FREQ
    rem_carrier: torch.Tensor       # f32 [rad]
    rem_code: torch.Tensor          # f32 [chips]
    dll_memory: torch.Tensor        # f32 last code discriminator value
    pll_memory: torch.Tensor        # f32 last phase discriminator value
    fll_memory: torch.Tensor        # f32 last freq discriminator value
    fll_vel: torch.Tensor           # f32 DLF velocity accumulator
    fll_acc: torch.Tensor           # f32 DLF acceleration accumulator
    i_prompt_prev: torch.Tensor     # f32
    q_prompt_prev: torch.Tensor     # f32
    unread: torch.Tensor            # int32 samples available to this channel
    code_counter: torch.Tensor      # int32 tracked code periods total
    ms_counter: torch.Tensor        # int32 free-running epoch counter mod 20
    edge_hist: torch.Tensor         # int32 [n_ch, 20] sign-flip histogram
    bit_edge: torch.Tensor          # int32 declared bit-edge phase [0, 20)
    accum_count: torch.Tensor       # int32 prompt entries in current bit accum
    ip_sum: torch.Tensor            # f32 20-ms prompt accumulators (C/N0)
    qp_sum: torch.Tensor            # f32
    cn0_ratio_sum: torch.Tensor     # f32 Beaulieu ratio accumulator
    ip_sq_sum: torch.Tensor         # f32 sum of iP^2
    qp_sq_sum: torch.Tensor         # f32 sum of qP^2
    cn0: torch.Tensor               # f32 [dB-Hz]
    pll_lock: torch.Tensor          # f32 lock indicator [-1, 1]
    fll_lock: torch.Tensor          # f32 lock indicator [0, 1]
    lock_state: torch.Tensor        # int32 Kaplan lock-state machine stage


FIELDS = tuple(f.name for f in dataclasses.fields(ChannelState))
I32_FIELDS = frozenset({
    "mode", "flags", "unread", "code_counter", "ms_counter", "edge_hist",
    "bit_edge", "accum_count", "lock_state"})


def init_state(n_channels: int, device) -> ChannelState:
    """Zeroed state for ``n_channels`` channels on ``device``."""
    def zeros(name):
        shape = (n_channels, 20) if name == "edge_hist" else (n_channels,)
        dtype = torch.int32 if name in I32_FIELDS else torch.float32
        return torch.zeros(shape, dtype=dtype, device=device)

    return ChannelState(**{name: zeros(name) for name in FIELDS})


def state_from_numpy(leaves: dict, device) -> ChannelState:
    """State from a ``{field: numpy array}`` dict (e.g. the JAX state's
    leaves converted with ``np.asarray``), each leaf cast to its field's
    dtype and placed on ``device``."""
    def leaf(name):
        dtype = np.int32 if name in I32_FIELDS else np.float32
        return torch.tensor(np.asarray(leaves[name], dtype=dtype),
                            device=device)

    return ChannelState(**{name: leaf(name) for name in FIELDS})


def state_to_numpy(st: ChannelState) -> dict:
    """``{field: numpy array}`` of every leaf, copied to the host."""
    return {name: np.array(getattr(st, name).cpu()) for name in FIELDS}


F32_FIELDS = tuple(n for n in FIELDS if n not in I32_FIELDS)
I32_SCALAR_FIELDS = tuple(
    n for n in FIELDS if n in I32_FIELDS and n != "edge_hist")


def pack_state(st: ChannelState) -> tuple[torch.Tensor, torch.Tensor]:
    """Every leaf in two row-major tensors: ``[n_ch, len(F32_FIELDS)]``
    float32 and ``[n_ch, len(I32_SCALAR_FIELDS) + 20]`` int32 (the scalar
    integer fields, then the 20 columns of ``edge_hist``)."""
    f = torch.stack([getattr(st, n) for n in F32_FIELDS], dim=1)
    i = torch.cat([torch.stack([getattr(st, n) for n in I32_SCALAR_FIELDS],
                               dim=1), st.edge_hist], dim=1)
    return f, i


def unpack_state(f: torch.Tensor, i: torch.Tensor) -> ChannelState:
    """Inverse of :func:`pack_state`, each leaf a contiguous copy (never a
    view of ``f`` or ``i``, which a graph's next replay overwrites)."""
    def copy(x):
        return x.clone(memory_format=torch.contiguous_format)

    leaves = {n: copy(f[:, k]) for k, n in enumerate(F32_FIELDS)}
    leaves.update({n: copy(i[:, k])
                   for k, n in enumerate(I32_SCALAR_FIELDS)})
    leaves["edge_hist"] = copy(i[:, len(I32_SCALAR_FIELDS):])
    return ChannelState(**leaves)


def code_table(prns: list[int]) -> np.ndarray:
    """Stacked padded code tables ``[n_channels, 1025]`` for the given PRNs.

    PRN 0 entries (unassigned channels) get an all-zero code.
    """
    rows = []
    for prn in prns:
        if prn <= 0:
            rows.append(np.zeros(1025, dtype=np.float32))
        else:
            rows.append(cacode.padded_code(prn))
    return np.stack(rows)
