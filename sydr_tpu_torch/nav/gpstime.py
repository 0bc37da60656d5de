"""GPS time: week/seconds-of-week arithmetic and calendar conversion.

Self-contained replacement for the reference's ``Time``/``Clock`` wrappers
over the ``gps_time`` package (``sydr/utils/time.py``):
week + float seconds-of-week with sub-nanosecond arithmetic, datetime
conversion (GPS epoch 1980-01-06, no leap-second tables — GPS system time),
and a steerable receiver clock.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt

from sydr_tpu_torch.constants import SECONDS_PER_WEEK

GPS_EPOCH = _dt.datetime(1980, 1, 6, 0, 0, 0)


@dataclasses.dataclass(order=True)
class GpsTime:
    week: int = 0
    seconds: float = 0.0   # seconds of week [0, 604800)

    def __post_init__(self):
        self.normalize()

    def normalize(self) -> "GpsTime":
        while self.seconds >= SECONDS_PER_WEEK:
            self.seconds -= SECONDS_PER_WEEK
            self.week += 1
        while self.seconds < 0:
            self.seconds += SECONDS_PER_WEEK
            self.week -= 1
        return self

    # ------------------------------------------------------------------
    def __add__(self, dt_seconds: float) -> "GpsTime":
        return GpsTime(self.week, self.seconds + float(dt_seconds))

    def __sub__(self, other):
        if isinstance(other, GpsTime):
            return (
                (self.week - other.week) * SECONDS_PER_WEEK
                + (self.seconds - other.seconds)
            )
        return GpsTime(self.week, self.seconds - float(other))

    @property
    def total_seconds(self) -> float:
        return self.week * SECONDS_PER_WEEK + self.seconds

    # ------------------------------------------------------------------
    @classmethod
    def from_datetime(cls, dt: _dt.datetime) -> "GpsTime":
        delta = (dt - GPS_EPOCH).total_seconds()
        week = int(delta // SECONDS_PER_WEEK)
        return cls(week, delta - week * SECONDS_PER_WEEK)

    def to_datetime(self) -> _dt.datetime:
        return GPS_EPOCH + _dt.timedelta(seconds=self.total_seconds)

    @classmethod
    def from_string(cls, s: str) -> "GpsTime":
        """Parse 'YYYY-MM-DD HH:MM:SS' (the reference AGNSS clock format)."""
        return cls.from_datetime(_dt.datetime.fromisoformat(s))

    def __repr__(self):
        return f"GpsTime(week={self.week}, tow={self.seconds:.6f})"


class ReceiverClock:
    """Steerable receiver clock tied to the sample counter.

    Mirrors the reference ``Clock`` semantics (``utils/time.py:136``):
    uninitialised until the first measurement epoch, advanced by sample
    count, corrected by the solved bias after each fix.
    """

    def __init__(self, sampling_frequency: float):
        self.fs = float(sampling_frequency)
        self.time: GpsTime | None = None
        self.anchor_sample: int = 0

    @property
    def initialised(self) -> bool:
        return self.time is not None

    def initialise(self, week: int, tow: float, sample: int) -> None:
        self.time = GpsTime(week, tow)
        self.anchor_sample = sample

    def at_sample(self, sample: int) -> GpsTime:
        assert self.time is not None, "clock not initialised"
        return self.time + (sample - self.anchor_sample) / self.fs

    def apply_correction(self, dt_seconds: float, sample: int) -> None:
        """Steer: re-anchor the clock at ``sample`` with a bias correction."""
        self.time = self.at_sample(sample) + dt_seconds
        self.anchor_sample = sample
