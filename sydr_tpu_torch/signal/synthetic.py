"""Synthetic GPS L1 C/A IQ signal generator.

The reference repository validates against a private recorded IQ file
(``config/receiver.ini:17``); this module replaces it with a
fully synthetic, parameterised signal source so every test and benchmark is
self-contained. It supports multiple satellites, carrier/code Doppler
(including consistent code-rate scaling), LNAV data-bit modulation, AWGN at a
target C/N0, and streaming generation in millisecond chunks with exact phase
continuity (float64 phase accumulators on the host).

Signal model for satellite ``s`` at receiver sample ``n`` (t = n/fs)::

    x_s(t) = A * D(phi(t)) * C(phi(t)) * exp(j * (2*pi*(f_if + fd)*t + theta0))

where ``phi(t)`` is the absolute code phase in chips advancing at
``fc * (1 + fd/fL1)`` (when code Doppler is enabled), ``C`` is the +/-1 C/A
chip at ``floor(phi) mod 1023``, and ``D`` the +/-1 nav bit at
``floor(phi / (1023*20))``. Data bit 0 starts at code phase 0.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from sydr_tpu_torch.constants import (
    GPS_L1CA_CARRIER_FREQ,
    GPS_L1CA_CODE_FREQ,
    GPS_L1CA_CODE_LENGTH,
    LNAV_MS_PER_BIT,
)
from sydr_tpu_torch.signal import cacode

_CHIPS_PER_BIT = GPS_L1CA_CODE_LENGTH * LNAV_MS_PER_BIT


@dataclasses.dataclass
class _SatState:
    prn: int
    code: np.ndarray              # +/-1 chips, float64 [1023]
    amplitude: float
    doppler_hz: float             # carrier Doppler (on top of f_if)
    code_phase: float             # absolute chips since data-bit 0 (may be <0)
    carrier_phase: float          # rad
    nav_bits: np.ndarray | None   # +/-1 per bit, cycled
    code_doppler: bool
    # Optional per-ms Doppler profile (piecewise constant per ms); when set it
    # overrides doppler_hz and is consumed one entry per generated ms.
    doppler_profile: np.ndarray | None = None
    profile_pos: int = 0

    def doppler_for_ms(self) -> float:
        if self.doppler_profile is None:
            return self.doppler_hz
        idx = min(self.profile_pos, len(self.doppler_profile) - 1)
        return float(self.doppler_profile[idx])


class IQGenerator:
    """Streaming multi-satellite IQ sample generator."""

    def __init__(
        self,
        sampling_frequency: float,
        intermediate_frequency: float = 0.0,
        noise: bool = True,
        seed: int = 0,
    ):
        self.fs = float(sampling_frequency)
        self.f_if = float(intermediate_frequency)
        self.noise = noise
        self.rng = np.random.default_rng(seed)
        self.samples_per_ms = round(self.fs * 1e-3)
        self._sats: list[_SatState] = []

    # ------------------------------------------------------------------
    def add_satellite(
        self,
        prn: int,
        doppler_hz: float = 0.0,
        code_phase_chips: float = 0.0,
        cn0_dbhz: float | None = None,
        nav_bits: np.ndarray | None = None,
        carrier_phase_rad: float = 0.0,
        code_doppler: bool = True,
        doppler_profile: np.ndarray | None = None,
    ) -> None:
        """Add a satellite signal to the mix.

        ``code_phase_chips`` is the code phase at t=0: the receiver sees chip
        ``code_phase_chips`` of the (absolute) code stream at its first
        sample. ``cn0_dbhz=None`` gives unit amplitude (use with
        ``noise=False`` for exact-correlator tests). With unit-variance
        complex noise, amplitude = sqrt(10^(cn0/10) / fs).
        """
        if cn0_dbhz is None:
            amplitude = 1.0
        else:
            amplitude = float(np.sqrt(10.0 ** (cn0_dbhz / 10.0) / self.fs))
        bits = None
        if nav_bits is not None:
            bits = np.asarray(nav_bits, dtype=np.float64)
            if set(np.unique(bits)) <= {0.0, 1.0}:
                bits = bits * 2.0 - 1.0
        self._sats.append(
            _SatState(
                prn=prn,
                code=cacode.ca_code(prn).astype(np.float64),
                amplitude=amplitude,
                doppler_hz=float(doppler_hz),
                code_phase=float(code_phase_chips),
                carrier_phase=float(carrier_phase_rad),
                nav_bits=bits,
                code_doppler=code_doppler,
                doppler_profile=(
                    None
                    if doppler_profile is None
                    else np.asarray(doppler_profile, dtype=np.float64)
                ),
            )
        )

    # ------------------------------------------------------------------
    def set_cn0(self, prn: int, cn0_dbhz: float) -> None:
        """Change a satellite's C/N0 mid-run (phase-continuous): the
        amplitude updates, the code/carrier state is untouched — for
        sensitivity sweeps that drop the signal level after lock
        (tools/track_benchmark.py)."""
        for sat in self._sats:
            if sat.prn == prn:
                sat.amplitude = float(
                    np.sqrt(10.0 ** (cn0_dbhz / 10.0) / self.fs))
                return
        raise KeyError(f"PRN {prn} not in generator")

    # ------------------------------------------------------------------
    def _sat_chunk(self, sat: _SatState, n: int) -> np.ndarray:
        """Generate ``n`` samples (one ms) for one satellite and advance it."""
        fd = sat.doppler_for_ms()
        t = np.arange(n) / self.fs
        carrier = sat.carrier_phase + 2.0 * np.pi * (self.f_if + fd) * t

        code_rate = GPS_L1CA_CODE_FREQ
        if sat.code_doppler:
            code_rate *= 1.0 + fd / GPS_L1CA_CARRIER_FREQ
        phi = sat.code_phase + code_rate * t

        chip_idx = np.floor(phi).astype(np.int64) % GPS_L1CA_CODE_LENGTH
        chips = sat.code[chip_idx]

        if sat.nav_bits is not None:
            bit_idx = np.floor_divide(
                np.floor(phi).astype(np.int64), _CHIPS_PER_BIT
            ) % len(sat.nav_bits)
            chips = chips * sat.nav_bits[bit_idx]

        x = sat.amplitude * chips * np.exp(1j * carrier)

        # Advance state with exact continuity.
        dt = n / self.fs
        sat.carrier_phase = np.remainder(
            sat.carrier_phase + 2.0 * np.pi * (self.f_if + fd) * dt, 2.0 * np.pi
        )
        # Keep absolute code phase (bit indexing needs it); rebase every bit
        # boundary crossing is unnecessary at f64 precision for hours of signal.
        sat.code_phase = sat.code_phase + code_rate * dt
        sat.profile_pos += 1
        return x

    # ------------------------------------------------------------------
    def generate_ms(self, n_ms: int) -> np.ndarray:
        """Generate the next ``n_ms`` milliseconds of IQ as complex64."""
        n = self.samples_per_ms
        out = np.zeros(n_ms * n, dtype=np.complex128)
        for ms in range(n_ms):
            sl = slice(ms * n, (ms + 1) * n)
            for sat in self._sats:
                out[sl] += self._sat_chunk(sat, n)
        if self.noise:
            out += self.rng.standard_normal(len(out)) * np.sqrt(0.5) + 1j * (
                self.rng.standard_normal(len(out)) * np.sqrt(0.5)
            )
        return out.astype(np.complex64)

    # ------------------------------------------------------------------
    def write_file(
        self, path: str, n_ms: int, dtype: str = "int8", scale: float | None = None
    ) -> None:
        """Write interleaved-IQ samples to a binary file (reader test input)."""
        iq = self.generate_ms(n_ms)
        if scale is None:
            peak = np.max(np.abs(np.concatenate([iq.real, iq.imag]))) or 1.0
            scale = 120.0 / peak if dtype == "int8" else 30000.0 / peak
        interleaved = np.empty(2 * len(iq), dtype=np.float64)
        interleaved[0::2] = iq.real * scale
        interleaved[1::2] = iq.imag * scale
        np.rint(interleaved).astype(dtype).tofile(path)
