"""Tracking configuration and the per-block helpers both runtimes share.

Port of ``sydr_tpu.channels.runtime``: :class:`TrackingConfig` keeps every
field and default of the JAX configuration so existing configs load
unchanged. ``use_pallas`` with ``boundary_mode`` other than ``"rowsum"``
picks the prefix boundary form of pass B (CUDA kernel K3,
``ops.correlator_kernel.block_cumsum_streams``) as it picks the JAX
prefix kernel; every other setting runs K1
(``ops.correlator_kernel.epoch_correlate``), which stands in for both the
JAX dense path and its row-sum kernel
(``channels.batch_runtime.prefix_form``). Fields that only steer a TPU
implementation (``pallas_interpret``, ``epl_method``,
``ablate_word_row``) are accepted and ignored.
The per-ms scan runtime (``run_block``) is not ported yet; the session
drives the batched runtime (``channels.batch_runtime``).
"""

from __future__ import annotations

import dataclasses

import torch

from sydr_tpu_torch.channels.state import FLAG_BIT_SYNC, ChannelState


@dataclasses.dataclass(frozen=True)
class TrackingConfig:
    """Static tracking configuration (see the JAX class for each field)."""

    sampling_frequency: float = 10e6
    intermediate_frequency: float = 0.0
    block_ms: int = 20
    tail_ms: int = 4
    window_size: int = 10240       # >= samples_per_ms * (1 + margin)
    spacings: tuple = (-0.5, 0.0, 0.5)
    # Borre loop filters (reference channel_GPS_L1CA_borre.ini).
    dll_bandwidth: float = 1.0
    dll_damping: float = 0.7
    dll_gain: float = 1.0
    dll_pdi: float = 1e-3
    pll_bandwidth: float = 8.0
    pll_damping: float = 0.7
    pll_gain: float = 0.25
    pll_pdi: float = 1e-3
    # Carrier-aided code NCO: scale the code rate by the carrier Doppler.
    carrier_aiding: bool = True
    min_convergence_ms: int = 100  # bit-sync arming delay
    bit_sync_flips: int = 10       # sign flips needed to declare bit sync
    bit_sync_unanimous: int = 5    # unanimous-histogram early declaration
    bit_sync_dominance: float = 0.6
    # "borre" (DLL + Costas PLL, 3 taps) or "kaplan" (FLL-assisted PLL +
    # lock-state machine, 5 taps; 3 with kaplan_narrow_only).
    profile: str = "borre"
    kaplan_narrow_only: bool = False
    spacing_wide: float = 0.5
    spacing_narrow: float = 0.2
    fll_bandwidth_pullin: float = 100.0
    fll_bandwidth_wide: float = 50.0
    fll_bandwidth_narrow: float = 15.0
    pll_bandwidth_wide: float = 25.0
    pll_bandwidth_narrow: float = 15.0
    fll_threshold_wide: float = 0.5
    fll_threshold_narrow: float = 0.8
    pll_threshold_narrow: float = 0.8
    lock_indicator_alpha: float = 0.005
    dlf_order: int = 2
    fll_discriminator: str = "atan"
    cn0_estimator: str = "nwpr"
    # Carrier NCO rail around the acquisition anchor [Hz]; 0 disables.
    freq_rail_hz: float = 400.0
    # Anchor slew rate once bit-synced [Hz/s]; 0 disables.
    anchor_slew_hz_per_s: float = 5.0
    # Batch runtime: bound on the carrier correction within one block.
    max_block_freq_step: float = 125.0
    # Code-rate-offset rail [Hz of the 1.023 MHz code clock]; 0 disables.
    code_rail_hz: float = 6.0
    runtime: str = "scan"
    use_pallas: bool = False        # with boundary_mode: K1 or K3
    pallas_interpret: bool = False  # TPU kernel selector: ignored here
    superblock: int = 1
    upload_int8: bool = True
    input_decimate: int = 1
    quantize_spacing: bool = False
    epl_method: str = "bitpack"     # scan-runtime EPL form: ignored here
    boundary_mode: str = "rowsum"   # "prefix" + use_pallas: K3
    pass_a: str = "closed"
    ablate_word_row: int = 0        # TPU fault injection: ignored here

    @property
    def samples_per_ms(self) -> int:
        return round(self.sampling_frequency * 1e-3)

    @property
    def window_samples(self) -> int:
        return (self.tail_ms + self.block_ms) * self.samples_per_ms


def _bit_sync_declare(cfg: TrackingConfig, edge_hist):
    """Bit-edge declaration rule from a mod-20 flip histogram ``[ch, 20]``.

    (a) unanimous: every observed flip in one bin and at least
    ``bit_sync_unanimous`` of them; (b) volume: at least
    ``bit_sync_flips`` flips with the mode bin holding
    ``bit_sync_dominance`` of them.
    """
    total = edge_hist.sum(dim=-1)
    mode = edge_hist.amax(dim=-1)
    if cfg.bit_sync_unanimous > 0:
        unanimous = (mode == total) & (total >= cfg.bit_sync_unanimous)
    else:
        unanimous = torch.zeros_like(total, dtype=torch.bool)
    dominant = (total >= cfg.bit_sync_flips) & (
        mode.to(torch.float32)
        >= cfg.bit_sync_dominance * total.to(torch.float32))
    return unanimous | dominant


def _slew_anchor(cfg: TrackingConfig, st: ChannelState) -> ChannelState:
    """Per-block rail re-anchoring (see ``anchor_slew_hz_per_s``)."""
    if cfg.anchor_slew_hz_per_s <= 0 or cfg.freq_rail_hz <= 0:
        return st
    max_step = cfg.anchor_slew_hz_per_s * cfg.block_ms * 1e-3
    synced = (st.flags & FLAG_BIT_SYNC) != 0
    anchor = st.freq_anchor + torch.clamp(
        st.carrier_freq - st.freq_anchor, -max_step, max_step)
    return dataclasses.replace(
        st, freq_anchor=torch.where(synced, anchor, st.freq_anchor))
