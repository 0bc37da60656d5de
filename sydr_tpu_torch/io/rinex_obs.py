"""RINEX 3.04 observation-file writer/reader (GPS C1C/L1C/D1C).

The reference carries a vestigial, broken observation reader
(``sydr/io/RINEXObs.py`` — stale import, never wired);
here observations are first-class: the receiver's pseudorange,
carrier-phase and Doppler measurements export to standard RINEX
observation files for external processing (RTKLIB etc.), and a reader
round-trips them for tests. L1C is the receiver's accumulated carrier
phase in cycles (RINEX sign convention: dL1C/dt = -D1C), anchored to the
pseudorange at the start of each continuous tracking arc.
"""

from __future__ import annotations

import datetime as _dt

from sydr_tpu_torch.nav.gpstime import GpsTime

OBS_TYPES = ("C1C", "L1C", "D1C")


def write_obs(path: str, epochs: list[dict], week: int,
              marker: str = "SYDR_TPU") -> None:
    """Write observation epochs.

    Args:
        epochs: list of ``{"tow": float, "obs": {prn: {"C1C": m,
            "L1C": cycles, "D1C": Hz}}}`` — missing observables write as
            blank fields.
        week: GPS week of the observations.
    """
    types_str = " ".join(OBS_TYPES)
    with open(path, "w") as fh:
        fh.write(
            f"{'3.04':>9}{'':11}{'OBSERVATION DATA':<20}{'G: GPS':<20}"
            f"{'RINEX VERSION / TYPE':<20}\n"
        )
        fh.write(f"{'sydr_tpu_torch':<60}{'PGM / RUN BY / DATE':<20}\n")
        fh.write(f"{marker:<60}{'MARKER NAME':<20}\n")
        fh.write(
            f"G    {len(OBS_TYPES)} {types_str:<53}"
            f"{'SYS / # / OBS TYPES':<20}\n"
        )
        fh.write(f"{'':60}{'END OF HEADER':<20}\n")
        for ep in epochs:
            t = GpsTime(week, ep["tow"]).to_datetime()
            frac = ep["tow"] % 1.0
            fh.write(
                f"> {t.year:4d} {t.month:02d} {t.day:02d} {t.hour:02d} "
                f"{t.minute:02d} {t.second + frac:11.7f}  0 "
                f"{len(ep['obs']):2d}\n"
            )
            for prn, vals in sorted(ep["obs"].items()):
                fields = []
                for ot in OBS_TYPES:
                    v = vals.get(ot)
                    # 16-char field: F14.3 + blank LLI + blank SSI
                    fields.append(f"{v:14.3f}  " if v is not None
                                  else " " * 16)
                fh.write(f"G{prn:02d}" + "".join(fields).rstrip() + "\n")


def read_obs(path: str) -> list[dict]:
    """Parse a GPS observation file written by :func:`write_obs`.

    Reads the observable list from the ``SYS / # / OBS TYPES`` header
    line (so older 2-observable C1C/D1C files parse too) and slices each
    record in standard 16-character fields.
    """
    epochs: list[dict] = []
    with open(path) as fh:
        lines = fh.read().splitlines()
    obs_types = list(OBS_TYPES)
    i = 0
    while i < len(lines) and "END OF HEADER" not in lines[i]:
        if lines[i][60:].startswith("SYS / # / OBS TYPES") and \
                lines[i].startswith("G"):
            parts = lines[i][:60].split()
            n = int(parts[1])
            obs_types = parts[2:2 + n]
        i += 1
    i += 1
    current = None
    for line in lines[i:]:
        if line.startswith(">"):
            parts = line[1:].split()
            dt = _dt.datetime(
                int(parts[0]), int(parts[1]), int(parts[2]),
                int(parts[3]), int(parts[4]), int(float(parts[5])),
            )
            t = GpsTime.from_datetime(dt)
            tow = t.seconds + (float(parts[5]) % 1.0)
            current = {"tow": tow, "obs": {}}
            epochs.append(current)
        elif line.startswith("G") and current is not None:
            prn = int(line[1:3])
            rec: dict = {}
            for k, ot in enumerate(obs_types):
                field = line[3 + 16 * k: 3 + 16 * k + 14].strip()
                if field:
                    rec[ot] = float(field)
            current["obs"][prn] = rec
    return epochs


def export_from_database(db, path: str) -> int:
    """Export the measurement table to a RINEX observation file.

    Returns the number of epochs written.
    """
    rows = db.fetch("measurement")
    week = 0  # position rows do not carry the week; callers may override
    mtype_to_obs = {"pseudorange": "C1C", "doppler": "D1C",
                    "carrier_phase": "L1C"}
    by_tow: dict[float, dict] = {}
    for r in rows:
        ep = by_tow.setdefault(r["tow"], {})
        o = ep.setdefault(r["prn"], {})
        ot = mtype_to_obs.get(r["mtype"])
        if ot is not None:
            o[ot] = r["value"]
    epochs = [
        {"tow": tow, "obs": obs} for tow, obs in sorted(by_tow.items())
    ]
    write_obs(path, epochs, week)
    return len(epochs)
