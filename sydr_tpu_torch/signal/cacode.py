"""GPS L1 C/A (coarse/acquisition) Gold-code generation.

Functional parity with the reference generator
(``sydr/signal/ca.py`` and ``gnsssignal.py``), implemented
from the IS-GPS-200 specification: two 10-stage LFSRs (G1 with taps 3,10 and
G2 with taps 2,3,6,8,9,10), combined as ``G1 XOR delay(G2)`` where the delay
is the per-PRN G2 phase offset given by the spec (tables 3-Ia/3-Ib and the
expanded PRN 38-210 assignments).

Codes are returned as +/-1 float32 chips (length 1023), which is the form the
correlators consume. Raw 0/1 bits are available via ``ca_code_bits``.
"""

from __future__ import annotations

import functools

import numpy as np

from sydr_tpu_torch.constants import GPS_L1CA_CODE_FREQ, GPS_L1CA_CODE_LENGTH

# Per-PRN G2 circular delay in chips, indexed by PRN (1-based). From
# IS-GPS-200 (PRN 1-37 at the top; 38-63 from table 3-Ib; 64-210 from the
# L1C/A-expanded assignments). Index 0 is a placeholder.
_G2_DELAYS = np.array([
    0,
    5, 6, 7, 8, 17, 18, 139, 140, 141, 251,
    252, 254, 255, 256, 257, 258, 469, 470, 471, 472,
    473, 474, 509, 512, 513, 514, 515, 516, 859, 860,
    861, 862, 863, 950, 947, 948, 950,
    67, 103, 91, 19, 679, 225, 625, 946, 638, 161,
    1001, 554, 280, 710, 709, 775, 864, 558, 220, 397,
    55, 898, 759, 367, 299, 1018,
    729, 695, 780, 801, 788, 732, 34, 320, 327, 389,
    407, 525, 405, 221, 761, 260, 326, 955, 653, 699,
    422, 188, 438, 959, 539, 879, 677, 586, 153, 792,
    814, 446, 264, 1015, 278, 536, 819, 156, 957, 159,
    712, 885, 461, 248, 713, 126, 807, 279, 122, 197,
    693, 632, 771, 467, 647, 203, 145, 175, 52, 21,
    237, 235, 886, 657, 634, 762, 355, 1012, 176, 603,
    130, 359, 595, 68, 386, 797, 456, 499, 883, 307,
    127, 211, 121, 118, 163, 628, 853, 484, 289, 811,
    202, 1021, 463, 568, 904, 670, 230, 911, 684, 309,
    644, 932, 12, 314, 891, 212, 185, 675, 503, 150,
    395, 345, 846, 798, 992, 357, 995, 877, 112, 144,
    476, 193, 109, 445, 291, 87, 399, 292, 901, 339,
    208, 711, 189, 263, 537, 663, 942, 173, 900, 30,
    500, 935, 556, 373, 85, 652, 310,
], dtype=np.int64)

MAX_PRN = len(_G2_DELAYS) - 1


def _lfsr_sequence(taps: tuple[int, ...]) -> np.ndarray:
    """Run a 10-stage maximal LFSR (all-ones seed) for one full period.

    ``taps`` are the 1-based stage numbers fed back (XOR) into stage 1; the
    output is stage 10. Returns the 1023-bit output sequence as uint8.
    """
    state = np.ones(10, dtype=np.uint8)
    out = np.empty(GPS_L1CA_CODE_LENGTH, dtype=np.uint8)
    tap_idx = [t - 1 for t in taps]
    for i in range(GPS_L1CA_CODE_LENGTH):
        out[i] = state[9]
        fb = 0
        for t in tap_idx:
            fb ^= state[t]
        state[1:] = state[:-1]
        state[0] = fb
    return out


@functools.lru_cache(maxsize=1)
def _g1_g2() -> tuple[np.ndarray, np.ndarray]:
    g1 = _lfsr_sequence((3, 10))
    g2 = _lfsr_sequence((2, 3, 6, 8, 9, 10))
    return g1, g2


@functools.lru_cache(maxsize=256)
def ca_code_bits(prn: int) -> np.ndarray:
    """1023-chip C/A code for ``prn`` as 0/1 uint8."""
    if not 1 <= prn <= MAX_PRN:
        raise ValueError(f"PRN must be in [1, {MAX_PRN}], got {prn}")
    g1, g2 = _g1_g2()
    delayed_g2 = np.roll(g2, int(_G2_DELAYS[prn]))
    return np.bitwise_xor(g1, delayed_g2)


@functools.lru_cache(maxsize=256)
def ca_code(prn: int) -> np.ndarray:
    """1023-chip C/A code for ``prn`` as +/-1 float32 (bit 1 -> +1)."""
    bits = ca_code_bits(prn)
    code = bits.astype(np.float32) * 2.0 - 1.0
    code.setflags(write=False)
    return code


def first_10_chips_octal(prn: int) -> int:
    """First 10 chips of the code as an octal integer (IS-GPS-200 test vector)."""
    bits = ca_code_bits(prn)[:10]
    value = 0
    for b in bits:
        value = value * 2 + int(b)
    return int(oct(value)[2:])


def samples_per_code(sampling_frequency: float) -> int:
    """Number of samples covering one full code period at ``sampling_frequency``."""
    code_period = GPS_L1CA_CODE_LENGTH / GPS_L1CA_CODE_FREQ
    return round(sampling_frequency * code_period)


def upsample_code(code: np.ndarray, sampling_frequency: float) -> np.ndarray:
    """Sample-and-hold upsampling of a 1023-chip code to one code period.

    Matches the reference indexing (chip index = trunc(n * fc / fs), see
    ``sydr/signal/gnsssignal.py:35``).
    """
    n = samples_per_code(sampling_frequency)
    chip_idx = np.trunc(
        np.arange(n) * (GPS_L1CA_CODE_FREQ / sampling_frequency)
    ).astype(np.int64)
    return np.asarray(code)[chip_idx % GPS_L1CA_CODE_LENGTH]


def padded_code(prn: int) -> np.ndarray:
    """Code padded with one wraparound chip on each side, length 1025.

    ``padded_code[i + 1]`` is chip ``i``; index 0 is chip 1022 and index 1024
    is chip 0, so correlators may index ceil(phase) for phase in (-1, 1023].
    """
    code = ca_code(prn)
    return np.concatenate([code[-1:], code, code[:1]]).astype(np.float32)
