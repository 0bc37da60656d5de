"""RINEX 3.x navigation-file reader/writer (GPS LNAV).

Reader parity with the reference ``RINEXNav``
(``sydr/io/RINEXNav.py``): parses GPS navigation records of a
RINEX 3.04 file into ``Ephemeris`` objects (AGNSS assisted mode). A writer
is provided as well so tests and tooling can round-trip ephemerides without
external datasets (the reference has no writer).
"""

from __future__ import annotations

import dataclasses
import datetime as _dt

from sydr_tpu_torch.nav.ephemeris import Ephemeris
from sydr_tpu_torch.nav.gpstime import GpsTime


@dataclasses.dataclass
class NavHeader:
    """RINEX nav header fields the receiver consumes.

    ``iono_alpha``/``iono_beta`` are the GPS Klobuchar corrections from the
    GPSA/GPSB ``IONOSPHERIC CORR`` lines (reference parses them in
    ``RINEXNav._readHeader``, ``sydr/io/RINEXNav.py:47-59``);
    ``gal_alpha`` the Galileo NeQuick-G coefficients (GAL line).
    """

    version: float = 3.04
    iono_alpha: tuple | None = None
    iono_beta: tuple | None = None
    gal_alpha: tuple | None = None

    @property
    def has_klobuchar(self) -> bool:
        return self.iono_alpha is not None and self.iono_beta is not None


def _f(x: str) -> float:
    """Parse a RINEX float (D exponents, embedded signs)."""
    return float(x.replace("D", "E").replace("d", "e"))


def _fmt(x: float) -> str:
    """Format a float in RINEX 19.12 'D' notation."""
    s = f"{x: .12E}"
    mant, exp = s.split("E")
    return f"{mant}D{int(exp):+03d}"


def read_header(path: str) -> NavHeader:
    """Parse the RINEX nav header (version + ionospheric corrections)."""
    hdr = NavHeader()
    with open(path) as fh:
        for line in fh:
            if "END OF HEADER" in line:
                break
            label = line[60:].strip()
            if label == "RINEX VERSION / TYPE":
                try:
                    hdr.version = float(line[0:9])
                except ValueError:
                    pass
            elif label == "IONOSPHERIC CORR":
                key = line[0:4].strip()
                vals = tuple(_f(line[5 + 12 * k: 5 + 12 * (k + 1)])
                             for k in range(4))
                if key == "GPSA":
                    hdr.iono_alpha = vals
                elif key == "GPSB":
                    hdr.iono_beta = vals
                elif key == "GAL":
                    hdr.gal_alpha = vals
    return hdr


def read_nav(path: str, systems: tuple = ("G",)) -> list[Ephemeris]:
    """Parse ephemeris records from a RINEX 3.x navigation file.

    GPS (``G``) records map fully onto :class:`Ephemeris`; Galileo (``E``)
    records share the Keplerian block (the reference parses both through the
    same field table, ``RINEXNav.py:85-136``) and are tagged via
    ``Ephemeris.system`` — the L1 C/A receiver consumes only GPS, but the
    reader keeps AGNSS files with mixed constellations usable.
    """
    with open(path) as fh:
        lines = fh.read().splitlines()

    # Skip header.
    body = 0
    for i, line in enumerate(lines):
        if "END OF HEADER" in line:
            body = i + 1
            break

    out = []
    i = body
    while i < len(lines):
        line = lines[i]
        if not line[:1] in systems or len(line) < 23:
            i += 1
            continue
        system = line[0]
        prn = int(line[1:3])
        toc_dt = _dt.datetime(
            int(line[4:8]), int(line[9:11]), int(line[12:14]),
            int(line[15:17]), int(line[18:20]), int(line[21:23]),
        )
        vals = [_f(line[23 + 19 * k: 23 + 19 * (k + 1)]) for k in range(3)]
        rows = []
        for r in range(1, 8):
            row_line = lines[i + r]
            row = []
            for k in range(4):
                seg = row_line[4 + 19 * k: 4 + 19 * (k + 1)]
                row.append(_f(seg) if seg.strip() else 0.0)
            rows.append(row)
        i += 8

        t = GpsTime.from_datetime(toc_dt)
        eph = Ephemeris(
            prn=prn,
            toc=t.seconds,
            af0=vals[0], af1=vals[1], af2=vals[2],
            iode=int(rows[0][0]), crs=rows[0][1], deltan=rows[0][2],
            m0=rows[0][3],
            cuc=rows[1][0], ecc=rows[1][1], cus=rows[1][2],
            sqrt_a=rows[1][3],
            toe=rows[2][0], cic=rows[2][1], omega0=rows[2][2],
            cis=rows[2][3],
            i0=rows[3][0], crc=rows[3][1], omega=rows[3][2],
            omega_dot=rows[3][3],
            i_dot=rows[4][0], week=int(rows[4][2]),
            ura=int(rows[5][0]), health=int(rows[5][1]),
            # Galileo: BGD E5a/E1 occupies the TGD slot and IODC is absent
            # (reference RINEXNav.py:128-131).
            tgd=rows[5][2],
            iodc=int(rows[5][3]) if system == "G" else 0,
            system=system,
        )
        eph.has_subframe1 = eph.has_subframe2 = eph.has_subframe3 = True
        out.append(eph)
    return out


def _fmt12(x: float) -> str:
    """RINEX 12.4 'D' notation for header iono lines (12-char field)."""
    s = f"{x: .4E}"
    mant, exp = s.split("E")
    return f"{mant:>8}D{int(exp):+03d}"


def write_nav(path: str, ephemerides: list[Ephemeris],
              header: NavHeader | None = None) -> None:
    """Write a minimal RINEX 3.04 GPS navigation file."""
    with open(path, "w") as fh:
        fh.write(
            f"{'3.04':>9}{'':11}{'N: GNSS NAV DATA':<20}"
            f"{'G: GPS':<20}{'RINEX VERSION / TYPE':<20}\n"
        )
        fh.write(f"{'sydr_tpu_torch':<60}{'PGM / RUN BY / DATE':<20}\n")
        if header is not None and header.has_klobuchar:
            for key, vals in (("GPSA", header.iono_alpha),
                              ("GPSB", header.iono_beta)):
                body = "".join(_fmt12(v) for v in vals)
                fh.write(f"{key:<4} {body:<55}{'IONOSPHERIC CORR':<20}\n")
        fh.write(f"{'':60}{'END OF HEADER':<20}\n")
        for eph in ephemerides:
            t = GpsTime(eph.week, eph.toc).to_datetime()
            fh.write(
                f"G{eph.prn:02d} {t.year:4d} {t.month:02d} {t.day:02d} "
                f"{t.hour:02d} {t.minute:02d} {t.second:02d}"
                f"{_fmt(eph.af0)}{_fmt(eph.af1)}{_fmt(eph.af2)}\n"
            )
            rows = [
                (float(eph.iode), eph.crs, eph.deltan, eph.m0),
                (eph.cuc, eph.ecc, eph.cus, eph.sqrt_a),
                (eph.toe, eph.cic, eph.omega0, eph.cis),
                (eph.i0, eph.crc, eph.omega, eph.omega_dot),
                (eph.i_dot, 1.0, float(eph.week), 0.0),
                (float(eph.ura), float(eph.health), eph.tgd,
                 float(eph.iodc)),
                (0.0, 0.0, 0.0, 0.0),
            ]
            for row in rows:
                fh.write("    " + "".join(_fmt(v) for v in row) + "\n")


def load_assisted_ephemerides(path: str) -> dict[int, Ephemeris]:
    """{prn: Ephemeris} for AGNSS assisted mode (GPS records)."""
    out: dict[int, Ephemeris] = {}
    for eph in read_nav(path):
        out[eph.prn] = eph
    return out


def load_assisted(path: str) -> tuple[dict[int, Ephemeris], NavHeader]:
    """AGNSS bundle: ({prn: Ephemeris}, header with iono corrections)."""
    return load_assisted_ephemerides(path), read_header(path)
