"""Live terminal dashboard (ANSI, dependency-free).

Covers the reference's enlighten status-bar GUI
(``sydr/enlightengui.py:67-155``): a receiver status
line (signal time, latest fix), a progress bar, and one colored line
per channel — state badge, C/N0 meter, Doppler, lock flags, TOW badge
and per-subframe 1-5 indicators (green once decoded, the reference's
``sf1..sf5`` colored cells) — redrawn in place each block.
"""

from __future__ import annotations

import sys

from sydr_tpu_torch.channels.state import (
    FLAG_BIT_SYNC,
    FLAG_CODE_LOCK,
    MODE_ACQUIRING,
    MODE_IDLE,
    MODE_TRACKING,
)

_CSI = "\x1b["
_RESET = f"{_CSI}0m"


def _c(text: str, code: str) -> str:
    return f"{_CSI}{code}m{text}{_RESET}"


# state -> (label, SGR code): reverse-video badges like enlighten's
# colored bars (white-on-steelblue / springgreen in the reference).
_MODE_BADGE = {
    MODE_IDLE: ("IDLE", "90"),          # dim gray
    MODE_ACQUIRING: ("ACQ ", "30;43"),  # black on yellow
    MODE_TRACKING: ("TRCK", "30;42"),   # black on green
}

_METER_CHARS = " ▁▂▃▄▅▆▇█"


def _cn0_meter(cn0: float, width: int = 6) -> str:
    """C/N0 as a small block meter spanning 25..50 dB-Hz."""
    frac = min(1.0, max(0.0, (cn0 - 25.0) / 25.0))
    full8 = int(round(frac * width * 8))
    out = []
    for k in range(width):
        lvl = min(8, max(0, full8 - 8 * k))
        out.append(_METER_CHARS[lvl])
    color = "32" if cn0 >= 38.0 else ("33" if cn0 >= 30.0 else "31")
    return _c("".join(out), color)


class Dashboard:
    def __init__(self, receiver, stream=None, enabled=True,
                 force: bool = False, total_ms: int | None = None):
        self.rx = receiver
        self.stream = stream or sys.stderr
        self.enabled = enabled and (force or self.stream.isatty())
        # run length for the progress bar (ms_to_process lives on
        # RunConfig, not ReceiverConfig — callers pass it in)
        self.total_ms = total_ms
        self._lines = 0

    def _flag_str(self, flags: int, ch) -> str:
        parts = []
        parts.append(_c("C", "32") if flags & FLAG_CODE_LOCK else "-")
        parts.append(_c("B", "32") if flags & FLAG_BIT_SYNC else "-")
        parts.append(_c("S", "32") if ch.decoder.subframe_sync else "-")
        return "".join(parts)

    def _subframe_cells(self, ch) -> str:
        """The reference's sf1..sf5 cells: green once decoded, red until."""
        return "".join(
            _c(str(s), "97;42" if s in ch.subframes_seen else "97;41")
            for s in (1, 2, 3, 4, 5)
        )

    def _tow_badge(self, ch) -> str:
        if ch.has_tow:
            return _c(f" TOW {ch.tow_ref:6.0f} ", "97;42")
        return _c(" TOW      - ", "97;41")

    def update(self, out) -> None:
        if not self.enabled:
            return
        rx = self.rx
        lines = []
        processed_s = rx.session.total_samples / rx.fs
        header = _c(f" sydr_tpu_torch │ signal {processed_s:8.1f} s ", "97;44")
        if rx.fixes:
            f = rx.fixes[-1]
            p = f.solution.position
            header += _c(
                f" fix ({p[0]:11.1f} {p[1]:11.1f} {p[2]:11.1f})"
                f" nsat={f.n_satellites} gdop={f.solution.gdop:.1f} ",
                "30;46")
        else:
            header += _c(" no fix yet ", "30;43")
        lines.append(header)

        # Progress bar against the configured run length when known.
        total_ms = self.total_ms
        if total_ms:
            frac = min(1.0, processed_s * 1e3 / total_ms)
            width = 40
            filled = int(round(frac * width))
            lines.append(
                "  " + _c("█" * filled, "32") + "░" * (width - filled)
                + f" {frac * 100:5.1f}%")

        for i, ch in enumerate(rx.channels):
            label, code = _MODE_BADGE.get(
                int(rx.session.mode_host[i]), ("?   ", "0"))
            cn0 = float(out["cn0"][-1, i])
            dop = float(out["carrier_freq"][-1, i]) \
                - rx.cfg.tracking.intermediate_frequency
            flags = int(out["flags"][-1, i])
            lines.append(
                f"  G{ch.prn:02d} {_c(label, code)} "
                f"{_cn0_meter(cn0)} {cn0:5.1f} dB-Hz "
                f"dop {dop:+7.0f} Hz [{self._flag_str(flags, ch)}] "
                f"{self._tow_badge(ch)} sf {self._subframe_cells(ch)}"
            )

        out_s = ""
        if self._lines:
            out_s += f"{_CSI}{self._lines}F{_CSI}J"
        out_s += "\n".join(lines) + "\n"
        self.stream.write(out_s)
        self.stream.flush()
        self._lines = len(lines)

    def close(self) -> None:
        if self.enabled:
            self.stream.write("\n")
            self.stream.flush()
