"""SQLite results persistence with dynamic schema.

Functional parity with the reference ``DatabaseHandler``
(``sydr/io/database.py``): buffered inserts of per-stage
result dicts into typed tables, automatic column creation for unseen keys
(numpy arrays stored as BLOBs), broadcast-ephemeris storage with
time-indexed retrieval, and fetch helpers for the report generator.

Differences from the reference: arrays are stored as raw little-endian
``.npy`` bytes rather than pickles (portable, no code execution on load),
and the fixed tables match this framework's block-oriented outputs.
"""

from __future__ import annotations

import io as _io
import os
import sqlite3

import numpy as np

_FIXED_TABLES = {
    "channel": ["channel_id INTEGER", "prn INTEGER"],
    "acquisition": [
        "channel_id INTEGER", "prn INTEGER", "doppler REAL",
        "code_index INTEGER", "metric REAL", "sample INTEGER",
    ],
    "tracking": [
        "channel_id INTEGER", "epoch INTEGER", "i_early REAL",
        "q_early REAL", "i_prompt REAL", "q_prompt REAL", "i_late REAL",
        "q_late REAL", "dll_error REAL", "pll_error REAL",
        "carrier_freq REAL", "code_freq REAL", "cn0 REAL",
        "pll_lock REAL", "fll_lock REAL", "flags INTEGER",
    ],
    "decoding": [
        "channel_id INTEGER", "prn INTEGER", "subframe_id INTEGER",
        "tow INTEGER", "bits BLOB",
    ],
    "position": [
        "tow REAL", "sample INTEGER", "x REAL", "y REAL", "z REAL",
        "clock_bias REAL", "n_satellites INTEGER", "gdop REAL",
    ],
    "measurement": [
        "tow REAL", "channel_id INTEGER", "prn INTEGER", "mtype TEXT",
        "value REAL", "raw_value REAL", "residual REAL",
    ],
    "gps_brdc": [
        "prn INTEGER", "toe REAL", "toc REAL", "week INTEGER",
        "iodc INTEGER", "iode INTEGER", "blob BLOB",
    ],
}


def _adapt(value):
    if isinstance(value, np.ndarray):
        buf = _io.BytesIO()
        np.save(buf, value, allow_pickle=False)
        return sqlite3.Binary(buf.getvalue())
    if isinstance(value, (np.integer,)):
        return int(value)
    if isinstance(value, (np.floating,)):
        return float(value)
    if isinstance(value, (np.bool_, bool)):
        return int(value)
    return value


def blob_to_array(blob: bytes) -> np.ndarray:
    return np.load(_io.BytesIO(blob), allow_pickle=False)


def _sql_type(value) -> str:
    if isinstance(value, (bool, np.bool_, int, np.integer)):
        return "INTEGER"
    if isinstance(value, (float, np.floating)):
        return "REAL"
    if isinstance(value, (bytes, np.ndarray)):
        return "BLOB"
    return "TEXT"


def open_database(path: str) -> "ResultDatabase":
    """Open an existing results database for analysis WITHOUT truncating it.

    The ``ResultDatabase`` constructor defaults to ``overwrite=True`` (a
    receiver run starts fresh); use this for post-run inspection.
    """
    return ResultDatabase(path, overwrite=False)


class ResultDatabase:
    """Buffered, dynamically-typed SQLite store for receiver results."""

    def __init__(self, path: str, overwrite: bool = True,
                 buffer_rows: int = 2000):
        if overwrite and path != ":memory:" and os.path.exists(path):
            os.remove(path)
        if path != ":memory:":
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.conn = sqlite3.connect(path)
        self.buffer_rows = buffer_rows
        self._buffers: dict[str, list[dict]] = {}
        self._columns: dict[str, list[str]] = {}
        for table, cols in _FIXED_TABLES.items():
            self.conn.execute(
                f"CREATE TABLE IF NOT EXISTS {table} "
                f"(id INTEGER PRIMARY KEY, {', '.join(cols)})"
            )
            self._columns[table] = [c.split()[0] for c in cols]
        self.conn.commit()

    # ------------------------------------------------------------------
    def add(self, table: str, row: dict) -> None:
        """Queue a row; unseen tables/columns are created on commit."""
        self._buffers.setdefault(table, []).append(row)
        if len(self._buffers[table]) >= self.buffer_rows:
            self._flush(table)

    def add_many(self, table: str, rows: list[dict]) -> None:
        self._buffers.setdefault(table, []).extend(rows)
        if len(self._buffers[table]) >= self.buffer_rows:
            self._flush(table)

    def _ensure_schema(self, table: str, row: dict) -> None:
        if table not in self._columns:
            self.conn.execute(
                f"CREATE TABLE IF NOT EXISTS {table} (id INTEGER PRIMARY KEY)"
            )
            self._columns[table] = []
        for key, value in row.items():
            if key not in self._columns[table]:
                self.conn.execute(
                    f"ALTER TABLE {table} ADD COLUMN {key} {_sql_type(value)}"
                )
                self._columns[table].append(key)

    def _flush(self, table: str) -> None:
        rows = self._buffers.get(table, [])
        if not rows:
            return
        keys: list[str] = []
        for r in rows:
            for k in r:
                if k not in keys:
                    keys.append(k)
        self._ensure_schema(table, {k: rows[-1].get(k) for k in keys})
        placeholders = ", ".join("?" for _ in keys)
        sql = f"INSERT INTO {table} ({', '.join(keys)}) VALUES ({placeholders})"
        self.conn.executemany(
            sql, [[_adapt(r.get(k)) for k in keys] for r in rows]
        )
        self._buffers[table] = []

    def commit(self) -> None:
        for table in list(self._buffers):
            self._flush(table)
        self.conn.commit()

    def close(self) -> None:
        self.commit()
        self.conn.close()

    # ------------------------------------------------------------------
    def fetch(self, table: str, where: str = "", params=()) -> list[dict]:
        self.commit()
        sql = f"SELECT * FROM {table}"
        if where:
            sql += f" WHERE {where}"
        cur = self.conn.execute(sql, params)
        cols = [d[0] for d in cur.description]
        return [dict(zip(cols, row)) for row in cur.fetchall()]

    def fetch_array(self, table: str, column: str, where: str = "",
                    params=()) -> np.ndarray:
        self.commit()
        sql = f"SELECT {column} FROM {table}"
        if where:
            sql += f" WHERE {where}"
        return np.array(
            [r[0] for r in self.conn.execute(sql, params).fetchall()]
        )

    # --- Broadcast ephemeris store ------------------------------------
    def store_ephemeris(self, eph) -> None:
        import dataclasses as dc

        fields = {
            f.name: getattr(eph, f.name)
            for f in dc.fields(eph)
            if isinstance(getattr(eph, f.name), (int, float, bool))
        }
        blob = repr(fields).encode()
        self.add("gps_brdc", {
            "prn": eph.prn, "toe": eph.toe, "toc": eph.toc,
            "week": eph.week, "iodc": eph.iodc, "iode": eph.iode,
            "blob": blob,
        })

    def fetch_ephemeris(self, prn: int, tow: float):
        """Latest stored ephemeris for ``prn`` closest to time ``tow``."""
        import ast

        from sydr_tpu_torch.nav.ephemeris import Ephemeris

        rows = self.fetch("gps_brdc", "prn = ?", (prn,))
        if not rows:
            return None
        best = min(rows, key=lambda r: abs(r["toe"] - tow))
        fields = ast.literal_eval(best["blob"].decode())
        eph = Ephemeris(**{
            k: v for k, v in fields.items()
            if k in {f.name for f in __import__("dataclasses").fields(Ephemeris)}
        })
        eph.has_subframe1 = eph.has_subframe2 = eph.has_subframe3 = True
        return eph
