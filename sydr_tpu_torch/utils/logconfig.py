"""Layered logging configuration (reference parity).

The reference configures logging from ``config/logging.ini`` via
``logging.config.fileConfig`` — a DEBUG ``FileHandler`` writing
``.results/logfile.log`` plus an INFO console ``StreamHandler`` with a
shared ``time | level | logger | message`` format
(``sydr/logger.py:22-30``, ``config/logging.ini``).

``configure_logging`` reproduces that layering: pass ``config_path`` to an
ini in the reference's format and it is applied verbatim (fileConfig);
otherwise the same two-handler layout is built programmatically with the
run's output folder as the log-file location. ANSI level colouring stands
in for the reference's coloredlogs dependency (not in this image) and is
applied only on TTY consoles.
"""

from __future__ import annotations

import logging
import logging.config
import os

LOG_FORMAT = "%(asctime)s | %(levelname)-8s | %(name)-40s | %(message)s"

_LEVEL_COLORS = {
    "DEBUG": "\x1b[37m",
    "INFO": "\x1b[32m",
    "WARNING": "\x1b[33m",
    "ERROR": "\x1b[31m",
    "CRITICAL": "\x1b[1;31m",
}


class _ColorFormatter(logging.Formatter):
    def format(self, record):
        msg = super().format(record)
        color = _LEVEL_COLORS.get(record.levelname)
        return f"{color}{msg}\x1b[0m" if color else msg


def configure_logging(
    out_folder: str | None = None,
    console_level: str = "INFO",
    file_level: str = "DEBUG",
    config_path: str | None = None,
    color: bool | None = None,
) -> str | None:
    """Set up root logging; returns the log-file path (or None).

    ``config_path``: an ini in the reference's ``logging.ini`` layout —
    applied with ``fileConfig`` and returned as-is. Otherwise: console
    handler at ``console_level`` (+ ANSI colours on TTYs) and, when
    ``out_folder`` is given, a ``logfile.log`` file handler at
    ``file_level``; the root logger level is the minimum of the two so the
    file keeps full DEBUG detail while the console stays readable.
    """
    if config_path:
        logging.config.fileConfig(config_path,
                                  disable_existing_loggers=False)
        return None

    root = logging.getLogger()
    for h in list(root.handlers):
        root.removeHandler(h)

    import sys

    console = logging.StreamHandler(sys.stderr)
    console.setLevel(getattr(logging, console_level.upper()))
    if color is None:
        color = getattr(sys.stderr, "isatty", lambda: False)()
    console.setFormatter(
        _ColorFormatter(LOG_FORMAT) if color else logging.Formatter(
            LOG_FORMAT))
    root.addHandler(console)

    logfile = None
    if out_folder:
        os.makedirs(out_folder, exist_ok=True)
        logfile = os.path.join(out_folder, "logfile.log")
        fh = logging.FileHandler(logfile, mode="w")
        fh.setLevel(getattr(logging, file_level.upper()))
        fh.setFormatter(logging.Formatter(LOG_FORMAT))
        root.addHandler(fh)

    levels = [console.level] + ([fh.level] if out_folder else [])
    root.setLevel(min(levels))
    return logfile
