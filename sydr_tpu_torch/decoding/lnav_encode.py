"""LNAV navigation-message *encoder* (test/bench infrastructure).

The reference has no message generator — its end-to-end runs require a
recorded dataset. This encoder builds spec-conformant LNAV subframes (TLM +
HOW + ephemeris payloads with valid parity and word-boundary inversion) so
the synthetic IQ generator can produce fully decodable signals, closing the
loop for receiver-level tests: encode ephemeris -> modulate -> track ->
decode -> PVT.

Bit layout follows IS-GPS-200 section 20.3.3 as read back by the decoder
offsets (see ``sydr_tpu_torch/nav/ephemeris.py`` and the reference
``dsp/decoding.py:291-387``).
"""

from __future__ import annotations

import numpy as np

from sydr_tpu_torch.constants import (
    GPS_WEEK_ROLLOVER,
    LNAV_PREAMBLE,
    LNAV_SUBFRAME_SIZE,
    LNAV_WORD_SIZE,
)
from sydr_tpu_torch.decoding.lnav import compute_parity


def uint_to_bits(value: int, width: int) -> np.ndarray:
    if not 0 <= value < (1 << width):
        raise ValueError(f"{value} does not fit in {width} unsigned bits")
    return np.array(
        [(value >> (width - 1 - i)) & 1 for i in range(width)], dtype=np.uint8
    )


def int_to_bits(value: int, width: int) -> np.ndarray:
    """Two's-complement encoding."""
    lo, hi = -(1 << (width - 1)), 1 << (width - 1)
    if not lo <= value < hi:
        raise ValueError(f"{value} does not fit in {width} signed bits")
    return uint_to_bits(value & ((1 << width) - 1), width)


def scaled_int(value: float, scale_pow2: int, width: int, signed=True):
    raw = int(round(value / 2.0**scale_pow2))
    return int_to_bits(raw, width) if signed else uint_to_bits(raw, width)


def angle_bits(angle_rad: float, width: int = 32) -> np.ndarray:
    """Encode an angle in semicircles (scale 2^-(width-1)), wrapping into
    [-pi, pi) — broadcast angles are modular quantities."""
    raw = int(round(angle_rad / np.pi * 2.0 ** (width - 1)))
    return uint_to_bits(raw & ((1 << width) - 1), width)


def _solve_tail_bits(data24: np.ndarray, d29s: int, d30s: int) -> np.ndarray:
    """Choose d23, d24 so computed D29 = D30 = 0 (HOW and word 10)."""
    for d23 in (0, 1):
        for d24 in (0, 1):
            trial = data24.copy()
            trial[22], trial[23] = d23, d24
            p = compute_parity(trial, d29s, d30s)
            if p[4] == 0 and p[5] == 0:
                return trial
    raise AssertionError("unreachable: tail bits always solvable")


def _assemble_words(payload300: np.ndarray, d29s=0, d30s=0) -> np.ndarray:
    """Apply parity + transmit inversion to 10 words of source data.

    ``payload300`` holds source (non-inverted) data bits at d1..d24 of each
    word; parity positions are ignored on input and overwritten. Words 2 and
    10 get their tail bits solved so their transmitted parity ends 00 (the
    IS-GPS-200 "t" bits), keeping D30* = 0 at subframe boundaries.
    """
    out = np.zeros(LNAV_SUBFRAME_SIZE, dtype=np.uint8)
    for w in range(10):
        data = payload300[w * LNAV_WORD_SIZE: w * LNAV_WORD_SIZE + 24].copy()
        if w in (1, 9):
            data = _solve_tail_bits(data, d29s, d30s)
        parity = compute_parity(data, d29s, d30s)
        transmitted = data ^ d30s
        out[w * LNAV_WORD_SIZE: w * LNAV_WORD_SIZE + 24] = transmitted
        out[w * LNAV_WORD_SIZE + 24: (w + 1) * LNAV_WORD_SIZE] = parity
        d29s, d30s = int(parity[4]), int(parity[5])
    return out


def encode_subframe(
    subframe_id: int,
    tow_label_seconds: int,
    eph=None,
    week: int | None = None,
) -> np.ndarray:
    """Build one 300-bit subframe.

    Args:
        subframe_id: 1..5.
        tow_label_seconds: GPS seconds-of-week of the NEXT subframe start
            (must be a multiple of 6).
        eph: ephemeris object with the BRDC field set (required for 1-3).
        week: full GPS week (subframe 1 encodes week mod 1024).

    Returns 300 transmitted bits (0/1), starting with the preamble.
    """
    assert tow_label_seconds % 6 == 0
    p = np.zeros(LNAV_SUBFRAME_SIZE, dtype=np.uint8)
    # Word 1: TLM — preamble + message (zeros) + reserved.
    p[0:8] = LNAV_PREAMBLE
    # Word 2: HOW — truncated TOW count (17 bits), flags, subframe ID.
    p[30:47] = uint_to_bits(tow_label_seconds // 6, 17)
    p[49:52] = uint_to_bits(subframe_id, 3)

    if subframe_id == 1:
        wk = week if week is not None else eph.week
        p[60:70] = uint_to_bits(wk - GPS_WEEK_ROLLOVER * 1024, 10)
        p[72:76] = uint_to_bits(int(getattr(eph, "ura", 0)), 4)
        p[76:82] = uint_to_bits(int(getattr(eph, "health", 0)), 6)
        # 10-bit IODC (IS-GPS-200 20.3.3.3.1.5): 2 MSBs word 3, 8 LSBs word 8.
        iodc = uint_to_bits(int(getattr(eph, "iodc", 0)), 10)
        p[82:84] = iodc[:2]
        p[210:218] = iodc[2:]
        p[196:204] = scaled_int(eph.tgd, -31, 8)
        p[218:234] = uint_to_bits(int(round(eph.toc / 2.0**4)), 16)
        p[240:248] = scaled_int(eph.af2, -55, 8)
        p[248:264] = scaled_int(eph.af1, -43, 16)
        p[270:292] = scaled_int(eph.af0, -31, 22)
    elif subframe_id == 2:
        p[60:68] = uint_to_bits(int(getattr(eph, "iode", 0)), 8)
        p[68:84] = scaled_int(eph.crs, -5, 16)
        p[90:106] = scaled_int(eph.deltan / np.pi, -43, 16)
        m0 = angle_bits(eph.m0)
        p[106:114] = m0[:8]
        p[120:144] = m0[8:]
        p[150:166] = scaled_int(eph.cuc, -29, 16)
        ecc = uint_to_bits(int(round(eph.ecc / 2.0**-33)), 32)
        p[166:174] = ecc[:8]
        p[180:204] = ecc[8:]
        p[210:226] = scaled_int(eph.cus, -29, 16)
        sqrt_a = uint_to_bits(int(round(eph.sqrt_a / 2.0**-19)), 32)
        p[226:234] = sqrt_a[:8]
        p[240:264] = sqrt_a[8:]
        p[270:286] = uint_to_bits(int(round(eph.toe / 2.0**4)), 16)
    elif subframe_id == 3:
        p[60:76] = scaled_int(eph.cic, -29, 16)
        om0 = angle_bits(eph.omega0)
        p[76:84] = om0[:8]
        p[90:114] = om0[8:]
        p[120:136] = scaled_int(eph.cis, -29, 16)
        i0 = angle_bits(eph.i0)
        p[136:144] = i0[:8]
        p[150:174] = i0[8:]
        p[180:196] = scaled_int(eph.crc, -5, 16)
        om = angle_bits(eph.omega)
        p[196:204] = om[:8]
        p[210:234] = om[8:]
        p[240:264] = scaled_int(eph.omega_dot / np.pi, -43, 24)
        p[270:278] = uint_to_bits(int(getattr(eph, "iode", 0)), 8)
        p[278:292] = scaled_int(eph.i_dot / np.pi, -43, 14)
    # Subframes 4/5 (almanac) transmit zero payloads here.

    return _assemble_words(p)


def encode_message(
    eph, week: int, first_tow_label: int, n_subframes: int = 15
) -> np.ndarray:
    """Consecutive subframes cycling 1,2,3,4,5 starting at subframe 1.

    ``first_tow_label`` is the HOW label of the FIRST emitted subframe (the
    time its successor starts); successive labels advance by 6 s.

    Returns ``[n_subframes * 300]`` bits.
    """
    order = [1, 2, 3, 4, 5]
    bits = []
    for k in range(n_subframes):
        sid = order[k % 5]
        bits.append(
            encode_subframe(sid, first_tow_label + 6 * k, eph=eph, week=week)
        )
    return np.concatenate(bits)
