"""Truth-consistent GNSS scenario simulation.

Generates IQ signal whose per-satellite code phases, carrier phases and
navigation messages are all derived from one geometric truth: a receiver
position, a constellation of broadcast ephemerides, and a GPS start time.
Decoding the signal and forming pseudoranges must reproduce the receiver
position — the closed-loop validation the reference can only do against a
private recorded dataset + surveyed position
(``config/receiver.ini:12-17``).

Timing model (per satellite ``s``):
  * Receiver samples are taken at ideal receiver times ``t = t0 + n/fs``
    (an optional fixed clock bias shifts the receiver label, not the
    physics).
  * The signal received at ``t`` left the satellite at ``t_tx = t - tau(t)``
    where ``tau`` solves the light-time equation against the Kepler orbit
    (with Sagnac/Earth-rotation correction).
  * The satellite transmits chip ``fc * (t_sv - t_ref)`` of its code/message
    stream, where ``t_sv = t_tx + clk(t_tx)`` is the satellite's *own* clock
    (broadcast clock error shifts its stream) and ``t_ref`` is the GPS time
    label of subframe-1 start.
  * Carrier phase at baseband: ``theta(t) = -2*pi*fL1*tau(t)`` + const.

Phases are evaluated exactly at every millisecond boundary (float64, Kepler
per ms) and linearly interpolated within the millisecond — the rate error
within 1 ms is < 1e-6 chips.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from sydr_tpu_torch.constants import (
    GPS_L1CA_CARRIER_FREQ,
    GPS_L1CA_CODE_FREQ,
    GPS_L1CA_CODE_LENGTH,
    LNAV_MS_PER_BIT,
    SPEED_OF_LIGHT,
)
from sydr_tpu_torch.decoding.lnav_encode import encode_message
from sydr_tpu_torch.nav.geodesy import correct_earth_rotation
from sydr_tpu_torch.nav.kepler import (
    satellite_position_velocity,
    satellite_position_velocity_vec,
)
from sydr_tpu_torch.signal import cacode

_CHIPS_PER_BIT = GPS_L1CA_CODE_LENGTH * LNAV_MS_PER_BIT


def demo_ephemerides(t0: float = 302400.0, week: int = 2190):
    """Six-satellite demo sky with good geometry over the Tampere-ish
    truth position used by the demo/tests (el 22-81 deg, azimuth-diverse).

    Shared by ``main.py --demo``, the e2e tests and the reference-parity
    harness so they all exercise the identical constellation.
    """
    from sydr_tpu_torch.nav.ephemeris import Ephemeris

    elements = [(2.094, 1.571), (1.047, 1.571), (3.142, 1.571),
                (2.094, 0.785), (0.0, 1.571), (4.189, 1.571)]
    return [
        Ephemeris(
            prn=k + 1, week=week, iodc=20 + k, iode=20 + k, toc=t0, toe=t0,
            af0=2e-5 * ((k % 5) - 2), af1=1e-12, tgd=1e-9 * (k % 4),
            ecc=0.003 + 0.0012 * k, sqrt_a=5153.7, m0=m0, omega0=om0,
            i0=0.96, deltan=4.5e-9, crs=15.0, crc=180.0, cuc=-8e-7,
            cus=7e-6, cic=-1e-7, cis=2e-8, omega_dot=-8e-9, i_dot=3e-10,
        )
        for k, (om0, m0) in enumerate(elements)
    ]


DEMO_RX_TRUTH = (2795125.165, 1236112.522, 5579646.006)


@dataclasses.dataclass
class ScenarioSat:
    eph: object                   # Ephemeris
    cn0_dbhz: float = 45.0
    nav_bits: np.ndarray | None = None   # +/-1 per bit (filled by Scenario)


class Scenario:
    """Multi-satellite truth simulation feeding an IQ sample stream."""

    def __init__(
        self,
        receiver_ecef: np.ndarray,
        ephemerides: list,
        start_tow: float,
        sampling_frequency: float,
        intermediate_frequency: float = 0.0,
        cn0_dbhz: float = 45.0,
        noise: bool = True,
        seed: int = 0,
        receiver_clock_bias_s: float = 0.0,
    ):
        """``start_tow`` must be a multiple of 6 (a subframe boundary): the
        simulation starts exactly when every satellite begins transmitting
        subframe 1 of its message at its own clock."""
        assert start_tow % 6 == 0
        self.rx = np.asarray(receiver_ecef, dtype=np.float64)
        self.fs = float(sampling_frequency)
        self.f_if = float(intermediate_frequency)
        self.t0 = float(start_tow)
        self.noise = noise
        self.rng = np.random.default_rng(seed)
        self.spms = round(self.fs * 1e-3)
        self.clock_bias = float(receiver_clock_bias_s)
        self.sats = []
        for eph in ephemerides:
            bits = encode_message(
                eph, eph.week, int(start_tow) + 6, n_subframes=40
            )
            self.sats.append(
                ScenarioSat(
                    eph=eph,
                    cn0_dbhz=cn0_dbhz,
                    nav_bits=bits.astype(np.float64) * 2.0 - 1.0,
                )
            )
        self._ms_generated = 0
        self._amp = {
            id(s): np.sqrt(10.0 ** (s.cn0_dbhz / 10.0) / self.fs)
            for s in self.sats
        }

    # ------------------------------------------------------------------
    def light_time(self, eph, t_receive: float) -> float:
        """Solve tau: receiver at t_receive, signal left at t_receive-tau."""
        tau = 0.075
        for _ in range(4):
            pos, _, _ = satellite_position_velocity(eph, t_receive - tau)
            pos = correct_earth_rotation(tau, pos)
            tau = np.linalg.norm(pos - self.rx) / SPEED_OF_LIGHT
        return float(tau)

    # ------------------------------------------------------------------
    def _phases_at_vec(self, sat: ScenarioSat, ts: np.ndarray):
        """Vectorised (code_phase, carrier_phase) at receiver times ``ts``."""
        tau = np.full(len(ts), 0.075)
        for _ in range(4):
            pos, _, _ = satellite_position_velocity_vec(sat.eph, ts - tau)
            ang = 7.2921151467e-5 * tau
            c, s_ = np.cos(ang), np.sin(ang)
            rot = np.stack([
                c * pos[:, 0] + s_ * pos[:, 1],
                -s_ * pos[:, 0] + c * pos[:, 1],
                pos[:, 2],
            ], axis=-1)
            tau = np.linalg.norm(rot - self.rx[None, :], axis=-1) \
                / SPEED_OF_LIGHT
        t_tx = ts - tau
        _, _, clk = satellite_position_velocity_vec(sat.eph, t_tx)
        t_sv = t_tx + clk - sat.eph.tgd
        code_phase = GPS_L1CA_CODE_FREQ * (t_sv - self.t0)
        carrier_phase = -2.0 * np.pi * GPS_L1CA_CARRIER_FREQ * tau \
            + 2.0 * np.pi * self.f_if * (ts - self.t0)
        return code_phase, carrier_phase

    # ------------------------------------------------------------------
    def _phase_at(self, sat: ScenarioSat, t: float):
        """(code_phase_chips, carrier_phase_rad) at receiver time ``t``.

        ``t`` is in true GPS seconds of week. The transmitted chip index is
        referenced to the satellite's own clock: the satellite emits chip
        fc*(t_sv - t_ref), t_sv = t_tx + clk(t_tx).
        """
        tau = self.light_time(sat.eph, t)
        t_tx = t - tau
        _, _, clk = satellite_position_velocity(sat.eph, t_tx)
        # The L1 signal carries the satellite clock error minus the L1 group
        # delay (IS-GPS-200 20.3.3.3.3.2: dt_sv(L1) = dt_sv - TGD).
        t_sv = t_tx + clk - sat.eph.tgd
        code_phase = GPS_L1CA_CODE_FREQ * (t_sv - self.t0)
        carrier_phase = -2.0 * np.pi * GPS_L1CA_CARRIER_FREQ * tau \
            + 2.0 * np.pi * self.f_if * (t - self.t0)
        return code_phase, carrier_phase

    # ------------------------------------------------------------------
    def generate_ms(self, n_ms: int) -> np.ndarray:
        """Next ``n_ms`` milliseconds of IQ as complex128 (host truth)."""
        spms = self.spms
        out = np.zeros(n_ms * spms, dtype=np.complex128)
        frac = np.arange(spms) / spms

        for sat in self.sats:
            code = cacode.ca_code(sat.eph.prn).astype(np.float64)
            amp = self._amp[id(sat)]
            # Millisecond-boundary phases (n_ms + 1 points, vectorised).
            ts = self.t0 + (self._ms_generated + np.arange(n_ms + 1)) * 1e-3
            cb, thb = self._phases_at_vec(sat, ts)
            for m in range(n_ms):
                (c0, th0), (c1, th1) = (cb[m], thb[m]), (cb[m + 1], thb[m + 1])
                phi = c0 + (c1 - c0) * frac
                theta = th0 + (th1 - th0) * frac
                chip = np.floor(phi).astype(np.int64)
                chips = code[chip % GPS_L1CA_CODE_LENGTH]
                bit_idx = chip // _CHIPS_PER_BIT
                data = sat.nav_bits[
                    np.clip(bit_idx, 0, len(sat.nav_bits) - 1)
                ]
                sl = slice(m * spms, (m + 1) * spms)
                out[sl] += amp * chips * data * np.exp(1j * theta)

        if self.noise:
            n = len(out)
            out += self.rng.standard_normal(n) * np.sqrt(0.5) + 1j * (
                self.rng.standard_normal(n) * np.sqrt(0.5)
            )
        self._ms_generated += n_ms
        return out

    # ------------------------------------------------------------------
    def write_file(
        self,
        path: str,
        n_ms: int,
        dtype: str = "int8",
        scale: float | None = None,
        chunk_ms: int = 1000,
    ) -> None:
        """Stream ``n_ms`` of interleaved-IQ samples to a binary file.

        The format matches the reference's RF front-end
        (``sydr/signal/rfsignal.py``: int8/int16
        interleaved I,Q), so one file can feed both receivers for parity
        runs. Generated in ``chunk_ms`` pieces: the full capture never has
        to fit in memory."""
        if scale is None:
            # Headroom for the multi-satellite sum + noise: unit-variance
            # complex noise dominates; +/-6 sigma fits comfortably in int8.
            scale = 120.0 / 6.0 if dtype == "int8" else 30000.0 / 6.0
        lim = 127 if dtype == "int8" else 32767
        with open(path, "wb") as f:
            done = 0
            while done < n_ms:
                n = min(chunk_ms, n_ms - done)
                iq = self.generate_ms(n)
                interleaved = np.empty(2 * len(iq), dtype=np.float64)
                interleaved[0::2] = iq.real * scale
                interleaved[1::2] = iq.imag * scale
                np.clip(np.rint(interleaved), -lim, lim).astype(
                    dtype).tofile(f)
                done += n

    # ------------------------------------------------------------------
    def truth_state(self, t: float):
        """Truth Doppler/delay per satellite at receiver time ``t`` (for
        assertions in tests)."""
        res = []
        for sat in self.sats:
            tau = self.light_time(sat.eph, t)
            pos, vel, _ = satellite_position_velocity(sat.eph, t - tau)
            los = (pos - self.rx)
            los /= np.linalg.norm(los)
            rdot = float(vel @ los)
            doppler = -rdot / SPEED_OF_LIGHT * GPS_L1CA_CARRIER_FREQ
            res.append({
                "prn": sat.eph.prn,
                "tau": tau,
                "doppler": doppler,
                "range": tau * SPEED_OF_LIGHT,
            })
        return res
