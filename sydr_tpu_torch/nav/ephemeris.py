"""Broadcast (BRDC) ephemeris: field set, subframe decode, completeness.

Mirrors the capability of the reference ``BRDCEphemeris``
(``sydr/space/ephemeris.py:20-164``): IS-GPS-200 subframe 1-3
field extraction with the spec scale factors, flag accumulation until an
ephemeris is complete, and IODC/IODE-based equality.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from sydr_tpu_torch.constants import GPS_PI, GPS_WEEK_ROLLOVER
from sydr_tpu_torch.decoding.lnav import bits_to_int, bits_to_uint


@dataclasses.dataclass
class Ephemeris:
    prn: int = 0
    # Clock (subframe 1)
    week: int = 0
    ura: int = 0
    health: int = 0
    iodc: int = 0
    toc: float = 0.0
    tgd: float = 0.0
    af2: float = 0.0
    af1: float = 0.0
    af0: float = 0.0
    # Orbit (subframes 2-3)
    iode: int = 0
    ecc: float = 0.0
    sqrt_a: float = 0.0
    toe: float = 0.0
    crs: float = 0.0
    deltan: float = 0.0
    m0: float = 0.0
    cuc: float = 0.0
    cus: float = 0.0
    cic: float = 0.0
    omega0: float = 0.0
    cis: float = 0.0
    i0: float = 0.0
    crc: float = 0.0
    omega: float = 0.0
    omega_dot: float = 0.0
    i_dot: float = 0.0

    has_subframe1: bool = False
    has_subframe2: bool = False
    has_subframe3: bool = False

    # Constellation tag ("G" GPS, "E" Galileo) — the L1 C/A receiver only
    # consumes GPS; mixed-constellation RINEX files tag records here.
    system: str = "G"

    @property
    def complete(self) -> bool:
        return self.has_subframe1 and self.has_subframe2 and self.has_subframe3

    def __eq__(self, other) -> bool:
        if not isinstance(other, Ephemeris):
            return NotImplemented
        return self.iodc == other.iodc and self.iode == other.iode

    # ------------------------------------------------------------------
    def apply_subframe(self, bits: np.ndarray) -> int:
        """Decode one polarity-corrected 300-bit subframe into this object.

        Returns the subframe ID. Field offsets and scale factors follow
        IS-GPS-200 20.3.3 (identical to the reference decoder,
        ``dsp/decoding.py:291-387``).
        """
        bits = np.asarray(bits, dtype=np.uint8)
        sid = bits_to_uint(bits[49:52])
        if sid == 1:
            self.week = bits_to_uint(bits[60:70]) + GPS_WEEK_ROLLOVER * 1024
            self.ura = bits_to_uint(bits[72:76])
            self.health = bits_to_uint(bits[76:82])
            # 10-bit IODC: 2 MSBs word 3 bits 23-24, 8 LSBs word 8 bits 1-8
            # (IS-GPS-200 20.3.3.3.1.5). The reference drops the first LSB
            # (dsp/decoding.py:326 has a TODO); fixed here like the other
            # spec-sign deviations.
            self.iodc = bits_to_uint(
                np.concatenate([bits[82:84], bits[210:218]])
            )
            self.toc = bits_to_uint(bits[218:234]) * 2.0**4
            self.tgd = bits_to_int(bits[196:204]) * 2.0**-31
            self.af2 = bits_to_int(bits[240:248]) * 2.0**-55
            self.af1 = bits_to_int(bits[248:264]) * 2.0**-43
            self.af0 = bits_to_int(bits[270:292]) * 2.0**-31
            self.has_subframe1 = True
        elif sid == 2:
            self.iode = bits_to_uint(bits[60:68])
            self.crs = bits_to_int(bits[68:84]) * 2.0**-5
            self.deltan = bits_to_int(bits[90:106]) * 2.0**-43 * GPS_PI
            self.m0 = (
                bits_to_int(np.concatenate([bits[106:114], bits[120:144]]))
                * 2.0**-31 * GPS_PI
            )
            self.cuc = bits_to_int(bits[150:166]) * 2.0**-29
            self.ecc = (
                bits_to_uint(np.concatenate([bits[166:174], bits[180:204]]))
                * 2.0**-33
            )
            self.cus = bits_to_int(bits[210:226]) * 2.0**-29
            self.sqrt_a = (
                bits_to_uint(np.concatenate([bits[226:234], bits[240:264]]))
                * 2.0**-19
            )
            self.toe = bits_to_uint(bits[270:286]) * 2.0**4
            self.has_subframe2 = True
        elif sid == 3:
            self.cic = bits_to_int(bits[60:76]) * 2.0**-29
            self.omega0 = (
                bits_to_int(np.concatenate([bits[76:84], bits[90:114]]))
                * 2.0**-31 * GPS_PI
            )
            self.cis = bits_to_int(bits[120:136]) * 2.0**-29
            self.i0 = (
                bits_to_int(np.concatenate([bits[136:144], bits[150:174]]))
                * 2.0**-31 * GPS_PI
            )
            self.crc = bits_to_int(bits[180:196]) * 2.0**-5
            self.omega = (
                bits_to_int(np.concatenate([bits[196:204], bits[210:234]]))
                * 2.0**-31 * GPS_PI
            )
            self.omega_dot = bits_to_int(bits[240:264]) * 2.0**-43 * GPS_PI
            self.iode = bits_to_uint(bits[270:278])
            self.i_dot = bits_to_int(bits[278:292]) * 2.0**-43 * GPS_PI
            self.has_subframe3 = True
        return sid
