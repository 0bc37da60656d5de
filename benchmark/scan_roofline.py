"""The scan kernel's bound: operations, bytes and its carried chain.

The counts are copied from ``chip_smoke.py`` (``SCAN_SAMPLE_OPS``,
``SCAN_SPACING_OPS``, ``SCAN_CHAIN_OPS``, ``PASS_C_EPOCH_OPS``,
``PASS_C_OP_CYCLES``; ``scan_latency_ms``); the peaks are ``roofline``'s.
One block of ``csrc/scan_block.cu`` (``scan_block_kernel``) takes at least
the largest of three times:

- operations: per sample of each tracking channel's epoch, the carrier
  phase, its cosine and sine and the mix (``SCAN_SAMPLE_OPS``), and per
  spacing the chip index and the two products and sums
  (``SCAN_SPACING_OPS``); per channel and epoch the loop update and the
  bookkeeping (``PASS_C_EPOCH_OPS``), over the card's float32 peak;
- bytes: the window's two planes, the code rows, the state in and out and
  the outputs, each once, over the HBM rate;
- latency: each epoch's chain, one after the other: ``SCAN_CHAIN_OPS``
  dependent operations from an epoch's start to the next plus the depth
  of a tree of adds over its samples, at ``OP_CYCLES`` cycles each at the
  card's largest SM clock, and the empty launch.
"""

from __future__ import annotations

from benchmark import roofline

SCAN_SAMPLE_OPS = 38
SCAN_SPACING_OPS = 10
SCAN_CHAIN_OPS = 70
PASS_C_EPOCH_OPS = 300
OP_CYCLES = 4
# The H100 SXM's largest SM clock (nvidia-smi clocks.max.sm: 1980 MHz).
SM_CLOCK_HZ = 1.98e9
# An empty kernel's device time, behind a spin (chip_smoke.py's
# empty_launch_ms on the H100 at 700 W: 0.00165 ms).
EMPTY_LAUNCH_S = 1.65e-6
# The state's bytes a channel, one way: 28 four-byte fields and the
# 20-bin edge histogram.
STATE_BYTES = 4 * (28 + 20)
# The block's outputs a channel and epoch: 24 keys of four bytes.
OUTPUT_BYTES = 4 * 24
CODE_BYTES = 4 * 1025

KERNEL = r"scan_block_kernel"


def scan_flops(tracking: int, channels: int, block_ms: int, spms: int,
               taps: int) -> float:
    """A block's operations: ``tracking`` channels' samples (a code period
    of ``spms`` an epoch) and every channel's loop update."""
    return (float(tracking) * block_ms * spms
            * (SCAN_SAMPLE_OPS + SCAN_SPACING_OPS * taps)
            + float(channels) * block_ms * PASS_C_EPOCH_OPS)


def scan_bytes(channels: int, block_ms: int, window_samples: int) -> float:
    """A block's bytes: the window planes, the code rows, the state read
    and written and the outputs, each once."""
    return (2 * 4 * window_samples + channels * CODE_BYTES
            + 2 * channels * STATE_BYTES + block_ms * channels * OUTPUT_BYTES)


def scan_latency_s(block_ms: int, spms: int) -> float:
    """A block's carried chain: ``block_ms`` epochs of ``SCAN_CHAIN_OPS``
    and a tree over an epoch's ``spms`` samples, and the empty launch."""
    depth = block_ms * (SCAN_CHAIN_OPS + max(spms - 1, 0).bit_length())
    return depth * OP_CYCLES / SM_CLOCK_HZ + EMPTY_LAUNCH_S


def scan_bound_s(tracking: int, channels: int, block_ms: int, spms: int,
                 taps: int, window_samples: int) -> float:
    """The least time a block could take: the largest of the three."""
    return max(roofline.bound_s(
        scan_flops(tracking, channels, block_ms, spms, taps),
        scan_bytes(channels, block_ms, window_samples)),
        scan_latency_s(block_ms, spms))
