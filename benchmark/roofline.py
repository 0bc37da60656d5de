"""The card's peaks and the kernels' operation and byte counts.

Copied from ``chip_smoke.py`` (``PEAK_*``, ``stream_flops``, K2's count):
NVIDIA's H100 SXM data sheet, float32 outside the tensor cores and the HBM
rate, at the full 700 W power limit.
"""

from __future__ import annotations

import math

PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# Operations per (sample, channel) pair of the correlation streams: the
# carrier phase (one multiply-add), sincosf (~20 after the range
# reduction) and the complex mix (6); per tap the chip index (add,
# multiply-add, ceil) and two multiply-adds.
STREAM_MIX_FLOPS = 28
STREAM_TAP_FLOPS = 8

# The kernels these counts are for, as the profiler names them: K1
# (``csrc/epoch_correlate.cu``) and every entry of K2 (one block, the
# cluster, the two-step and Bluestein entries of ``csrc/pcps_bins*.cu``).
K1_KERNELS = r"epoch_correlate_kernel"
K2_KERNELS = (r"pcps_bins_kernel|pcps_bins_cluster_kernel|column_pass"
              r"|row_pass|column_forward|row_filter|column_inverse")


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S)


def stream_flops(n_samples: int, n_taps: int) -> float:
    """K1's operations over ``n_samples`` (sample, channel) pairs."""
    return float(n_samples) * (STREAM_MIX_FLOPS + STREAM_TAP_FLOPS * n_taps)


def k1_bytes(n_win: int, n_ch: int, n_epochs: int, n_taps: int) -> float:
    """K1's bytes: the window planes, the code rows (4160 float32 a
    channel), the per-ms anchors and the correlators, each once."""
    return (2 * 4 * n_win + n_ch * 4160 * 4
            + n_epochs * n_ch * 2 * n_taps * 4)


def fft_flops(n: int) -> float:
    """One complex transform of length ``n`` and its spectrum product:
    ``5 n log2 n + 10 n``."""
    return 5.0 * n * math.log2(n) + 10.0 * n


def k2_flops(rows: int, bins: int, non_coherent: int, n: int) -> float:
    """K2's operations: one product and inverse transform per row, bin and
    non-coherent block, whatever entry computes the map."""
    return rows * bins * non_coherent * fft_flops(n)


def k2_bytes(rows: int, bins: int, non_coherent: int, n: int,
             phases: int) -> float:
    """K2's bytes: the phase spectra and code spectra (complex64) read, the
    map (float32) written, once each."""
    return (phases * rows * non_coherent * n * 8 + rows * n * 8
            + rows * bins * n * 4)
