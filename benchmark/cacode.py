"""GPS L1 C/A Gold codes (IS-GPS-200), the yardstick's own copy.

Two 10-stage LFSRs, G1 (taps 3, 10) and G2 (taps 2, 3, 6, 8, 9, 10), all
ones at the start; chip = G1 xor G2 delayed by the PRN's G2 delay (table
3-Ia). Copied from ``sydr_tpu_torch/signal/cacode.py`` for PRN 1-37, so that
the sky generator and the plain references take no table from the
receiver.
"""

from __future__ import annotations

import functools

import numpy as np

CODE_LENGTH = 1023
CODE_FREQ = 1.023e6            # chips per second
CARRIER_FREQ = 1575.42e6       # L1 [Hz]

# G2 delay in chips of PRN 1-37 (index 0 unused).
G2_DELAYS = (
    0,
    5, 6, 7, 8, 17, 18, 139, 140, 141, 251,
    252, 254, 255, 256, 257, 258, 469, 470, 471, 472,
    473, 474, 509, 512, 513, 514, 515, 516, 859, 860,
    861, 862, 863, 950, 947, 948, 950,
)


def _lfsr(taps: tuple[int, ...]) -> np.ndarray:
    state = [1] * 10
    out = np.empty(CODE_LENGTH, dtype=np.uint8)
    for i in range(CODE_LENGTH):
        out[i] = state[9]
        fb = 0
        for t in taps:
            fb ^= state[t - 1]
        state = [fb] + state[:9]
    return out


@functools.lru_cache(maxsize=64)
def code_bits(prn: int) -> np.ndarray:
    """The 1023 chips of ``prn`` as 0/1 uint8."""
    if not 1 <= prn < len(G2_DELAYS):
        raise ValueError(f"PRN {prn} outside 1..{len(G2_DELAYS) - 1}")
    g1, g2 = _lfsr((3, 10)), _lfsr((2, 3, 6, 8, 9, 10))
    return np.bitwise_xor(g1, np.roll(g2, G2_DELAYS[prn]))


def code(prn: int) -> np.ndarray:
    """The chips of ``prn`` as +/-1 float64 (bit 1 is +1)."""
    return code_bits(prn).astype(np.float64) * 2.0 - 1.0


def upsampled(prn: int, fs: float) -> np.ndarray:
    """One code period at ``fs``, sample and hold: sample ``k`` holds chip
    ``trunc(k * CODE_FREQ / fs)``."""
    n = round(fs * CODE_LENGTH / CODE_FREQ)
    idx = np.trunc(np.arange(n) * (CODE_FREQ / fs)).astype(np.int64)
    return code(prn)[idx % CODE_LENGTH]
