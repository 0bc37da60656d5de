"""GPS LNAV navigation-message decoding (host side).

Symbol-level decoding is branchy, ~50 bit/s/channel work — it runs on the
host from the device-streamed bit outputs (``bit_ready``/``bit_ip_sum``),
mirroring the capability of the reference decoder
(``sydr/dsp/decoding.py`` and the decode stage of
``channel_l1ca_borre.py:455-579``) with a cleaner state machine.

Bit convention: arrays of 0/1 uint8. Parity follows IS-GPS-200 table 20-XIV:
each 30-bit word carries 24 data bits (transmitted inverted when the previous
word's D30 is 1) and 6 parity bits computed from the source data bits and
D29*/D30* of the previous word.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from sydr_tpu_torch.constants import (
    LNAV_PREAMBLE,
    LNAV_SUBFRAME_SIZE,
    LNAV_WORD_SIZE,
)

# Parity tap tables: data-bit indices (1-based d1..d24) feeding each computed
# parity bit D25..D30, plus which of (D29*, D30*) seeds it.
_PARITY_TAPS = (
    (29, (1, 2, 3, 5, 6, 10, 11, 12, 13, 14, 17, 18, 20, 23)),
    (30, (2, 3, 4, 6, 7, 11, 12, 13, 14, 15, 18, 19, 21, 24)),
    (29, (1, 3, 4, 5, 7, 8, 12, 13, 14, 15, 16, 19, 20, 22)),
    (30, (2, 4, 5, 6, 8, 9, 13, 14, 15, 16, 17, 20, 21, 23)),
    (30, (1, 3, 5, 6, 7, 9, 10, 14, 15, 16, 17, 18, 21, 22, 24)),
    (29, (3, 5, 6, 8, 9, 10, 11, 13, 15, 19, 22, 23, 24)),
)

_PREAMBLE = np.array(LNAV_PREAMBLE, dtype=np.uint8)


def compute_parity(data24: np.ndarray, d29s: int, d30s: int) -> np.ndarray:
    """D25..D30 for source (non-inverted) data bits d1..d24."""
    out = np.empty(6, dtype=np.uint8)
    for i, (seed, taps) in enumerate(_PARITY_TAPS):
        acc = d29s if seed == 29 else d30s
        for t in taps:
            acc ^= int(data24[t - 1])
        out[i] = acc
    return out


def check_word(word30: np.ndarray, d29s: int, d30s: int) -> int:
    """Validate one received word.

    Args:
        word30: 30 received bits (data possibly inverted by D30*).
        d29s, d30s: bits 29/30 of the previous word as received.

    Returns:
        +1 parity OK, data polarity true; -1 parity OK, data bits must be
        inverted (D30* was 1); 0 parity failure. (Same contract as the
        reference ``ParityCheck``, dsp/decoding.py:111.)
    """
    data = word30[:24].astype(np.uint8)
    source = data ^ d30s  # undo transmit inversion
    expect = compute_parity(source, d29s, d30s)
    if np.array_equal(expect, word30[24:30]):
        return -1 if d30s else 1
    return 0


def check_preamble(bits: np.ndarray) -> bool:
    """Check a candidate subframe start.

    ``bits`` must be ``[i-2 : i+62]`` where ``i`` is the presumed first bit
    of the preamble: 2 leading parity bits of the previous word, then two
    full words. Accepts the preamble in either polarity, then validates the
    parity of both words (reference ``LNAV_CheckPreambule``,
    dsp/decoding.py:220-251).
    """
    bits = np.asarray(bits, dtype=np.uint8)
    if len(bits) < 2 + 2 * LNAV_WORD_SIZE:
        return False
    cand = bits[2:2 + len(_PREAMBLE)]
    if not (
        np.array_equal(cand, _PREAMBLE)
        or np.array_equal(cand, 1 - _PREAMBLE)
    ):
        return False
    w1 = bits[2:32]
    w2 = bits[32:62]
    ok1 = check_word(w1, int(bits[0]), int(bits[1]))
    if ok1 == 0:
        return False
    ok2 = check_word(w2, int(w1[28]), int(w1[29]))
    return ok2 != 0


def correct_polarity(subframe: np.ndarray, d30s: int) -> np.ndarray:
    """Undo the per-word data-bit inversion across a 300-bit subframe."""
    out = np.array(subframe, dtype=np.uint8)
    prev = d30s
    for w in range(10):
        sl = slice(w * LNAV_WORD_SIZE, w * LNAV_WORD_SIZE + 24)
        if prev:
            out[sl] ^= 1
        prev = out[w * LNAV_WORD_SIZE + 29]
    return out


def bits_to_uint(bits: np.ndarray) -> int:
    v = 0
    for b in bits:
        v = (v << 1) | int(b)
    return v


def bits_to_int(bits: np.ndarray) -> int:
    """Two's-complement signed value."""
    v = bits_to_uint(bits)
    if bits[0]:
        v -= 1 << len(bits)
    return v


def decode_tow_subframe_id(subframe: np.ndarray, d30s: int):
    """(tow_label_seconds, subframe_id, corrected_bits).

    ``tow_label_seconds`` is the HOW time-of-week label: the GPS time of the
    start of the NEXT subframe (IS-GPS-200 20.3.3.2).
    """
    bits = correct_polarity(subframe, d30s)
    tow = bits_to_uint(bits[30:47]) * 6
    sub_id = bits_to_uint(bits[49:52])
    return tow, sub_id, bits


@dataclasses.dataclass
class SubframeEvent:
    subframe_id: int
    tow_label: int          # seconds-of-week of the NEXT subframe start
    bits: np.ndarray        # polarity-corrected 300 bits
    bit_index: int          # stream index of the subframe's first bit


class LnavDecoder:
    """Per-channel stateful bit-stream decoder.

    Feed raw detected bits (0/1, possibly globally inverted — polarity is
    resolved through the preamble/parity checks); emits ``SubframeEvent``s.
    """

    SEARCH_LEN = 2 + 2 * LNAV_WORD_SIZE  # 62

    def __init__(self):
        self._bits: list[int] = []
        self._stream_pos = 0          # index of self._bits[0] in the stream
        self.subframe_sync = False
        self._sync_offset: int | None = None  # stream index of a subframe start

    def push_bit(self, bit: int) -> SubframeEvent | None:
        self._bits.append(int(bit))
        if not self.subframe_sync:
            self._search_sync()
            return None
        return self._try_decode()

    # ------------------------------------------------------------------
    def _search_sync(self):
        # A candidate start needs 62 bits of lookahead to validate; the
        # candidate examined is the bit SEARCH_LEN-2 positions back.
        n = len(self._bits)
        if n < self.SEARCH_LEN:
            return
        window = np.array(self._bits[-self.SEARCH_LEN:], dtype=np.uint8)
        if check_preamble(window):
            cand_stream = self._stream_pos + n - self.SEARCH_LEN + 2
            if (
                self._sync_offset is not None
                and (cand_stream - self._sync_offset) % LNAV_SUBFRAME_SIZE == 0
                and cand_stream > self._sync_offset
            ):
                # Second consistent preamble one subframe later: locked.
                self.subframe_sync = True
                # Drop bits before the previous subframe start minus the two
                # parity bits needed for polarity.
                keep_from = self._sync_offset - 2 - self._stream_pos
                if keep_from > 0:
                    del self._bits[:keep_from]
                    self._stream_pos += keep_from
            else:
                self._sync_offset = cand_stream

    # ------------------------------------------------------------------
    def _try_decode(self) -> SubframeEvent | None:
        # Layout once synced: bits[0:2] = previous parity tail, bits[2:302] =
        # subframe. Decode when the full subframe plus the NEXT preamble's
        # two validation words are present (mirrors the reference's
        # conservative re-check, channel_l1ca_borre.py:529-537).
        need = 2 + LNAV_SUBFRAME_SIZE + self.SEARCH_LEN - 2
        if len(self._bits) < need:
            return None
        arr = np.array(self._bits[:need], dtype=np.uint8)
        nxt = arr[2 + LNAV_SUBFRAME_SIZE - 2:]
        if not check_preamble(nxt):
            # Lost sync: restart the search.
            self.subframe_sync = False
            self._sync_offset = None
            dropped = len(self._bits) - self.SEARCH_LEN
            self._bits = self._bits[-self.SEARCH_LEN:]
            self._stream_pos += dropped
            return None
        tow, sub_id, bits = decode_tow_subframe_id(
            arr[2:2 + LNAV_SUBFRAME_SIZE], int(arr[1])
        )
        event = SubframeEvent(
            subframe_id=sub_id,
            tow_label=tow,
            bits=bits,
            bit_index=self._stream_pos + 2,
        )
        # Slide one full subframe forward.
        del self._bits[:LNAV_SUBFRAME_SIZE]
        self._stream_pos += LNAV_SUBFRAME_SIZE
        return event
