"""Iterated weighted least-squares PVT solver.

Replaces the reference's normal-equation LSE + receiver iteration loop
(``sydr/navigation/lse.py:45-62`` and
``receiver_gps_l1ca.py:289-381``) with one function: geometry rebuild, Sagnac
correction, and state update run per iteration; solved with ``lstsq`` for
conditioning rather than an explicit normal-matrix inverse.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from sydr_tpu_torch.constants import SPEED_OF_LIGHT
from sydr_tpu_torch.nav.geodesy import correct_earth_rotation
from sydr_tpu_torch.nav.kepler import satellite_position_velocity


@dataclasses.dataclass
class PvtSolution:
    position: np.ndarray          # ECEF [m]
    clock_bias_m: float           # receiver clock bias [m]
    residuals: np.ndarray         # post-fit residuals [m]
    precision: np.ndarray         # sqrt(diag(Qx)) for x, y, z, dt
    n_iterations: int
    converged: bool
    sat_positions: np.ndarray     # rotated ECEF, [n, 3]
    geometry: np.ndarray          # final design matrix [n, 4]

    @property
    def gdop(self) -> float:
        q = np.linalg.inv(self.geometry.T @ self.geometry)
        return float(np.sqrt(np.trace(q)))


def solve_pvt(
    pseudoranges: np.ndarray,
    ephemerides: list,
    receive_time: float,
    approx_position: np.ndarray,
    weights: np.ndarray | None = None,
    max_iterations: int = 10,
    tol: float = 1e-6,
) -> PvtSolution | None:
    """Single-epoch pseudorange PVT.

    Args:
        pseudoranges: corrected pseudoranges [m] (satellite clock and TGD
            already applied), shape [n].
        ephemerides: matching Ephemeris objects.
        receive_time: receiver time of the epoch (GPS seconds of week).
        approx_position: ECEF [3] starting point (may be zeros).

    Returns ``None`` when the geometry is singular / under-determined.
    """
    pr = np.asarray(pseudoranges, dtype=np.float64)
    n = len(pr)
    if n < 4:
        return None
    w = np.ones(n) if weights is None else np.asarray(weights, np.float64)

    x = np.zeros(4)
    x[:3] = np.asarray(approx_position, dtype=np.float64)

    g = np.zeros((n, 4))
    y = np.zeros(n)
    converged = False
    it = 0
    for it in range(max_iterations):
        sat_pos = np.zeros((n, 3))
        for i, eph in enumerate(ephemerides):
            travel = pr[i] / SPEED_OF_LIGHT
            pos, _, _ = satellite_position_velocity(
                eph, receive_time - travel
            )
            sat_pos[i] = correct_earth_rotation(travel, pos)

        rho = np.linalg.norm(sat_pos - x[:3], axis=1)
        y = pr - rho - x[3]
        g[:, :3] = (x[:3] - sat_pos) / rho[:, None]
        g[:, 3] = 1.0

        gw = g * w[:, None]
        try:
            dx, *_ = np.linalg.lstsq(gw, y * w, rcond=None)
        except np.linalg.LinAlgError:
            return None
        x = x + dx
        if np.linalg.norm(dx[:3]) < tol:
            converged = True
            break

    rho = np.linalg.norm(sat_pos - x[:3], axis=1)
    residuals = pr - rho - x[3]

    try:
        qx = np.linalg.inv(g.T @ g)
        precision = np.sqrt(np.diag(qx))
    except np.linalg.LinAlgError:
        precision = np.full(4, np.nan)

    return PvtSolution(
        position=x[:3],
        clock_bias_m=float(x[3]),
        residuals=residuals,
        precision=precision,
        n_iterations=it + 1,
        converged=converged,
        sat_positions=sat_pos,
        geometry=g,
    )


def solve_velocity(
    dopplers_hz: np.ndarray,
    ephemerides: list,
    receive_time: float,
    position: np.ndarray,
    carrier_frequency: float = 1575.42e6,
) -> tuple[np.ndarray, float] | None:
    """Receiver velocity + clock drift from carrier Doppler measurements.

    The reference only forms Doppler measurements in its legacy tree
    (``old/receiver_gps_l1.py:441-451``) and never solves velocity; here the
    measured Doppler (tracked carrier frequency minus IF) closes a linear
    least-squares velocity solution:

        -c/fL1 * doppler_i = (v_rx - v_sat_i) . los_i + c*clock_drift

    Returns (velocity_ecef [3] m/s, clock_drift [s/s]) or None if
    under-determined.
    """
    d = np.asarray(dopplers_hz, dtype=np.float64)
    n = len(d)
    if n < 4:
        return None
    g = np.zeros((n, 4))
    y = np.zeros(n)
    for i, eph in enumerate(ephemerides):
        sat_pos, sat_vel, _ = satellite_position_velocity(eph, receive_time)
        los = sat_pos - position
        los /= np.linalg.norm(los)
        # rr = (v_sat - v_rx).los + c*drift and d = -rr*fL1/c, so
        #   v_rx.los - c*drift = v_sat.los + d*c/fL1
        y[i] = sat_vel @ los + d[i] * SPEED_OF_LIGHT / carrier_frequency
        g[i, :3] = los
        g[i, 3] = -1.0
    try:
        x, *_ = np.linalg.lstsq(g, y, rcond=None)
    except np.linalg.LinAlgError:
        return None
    return x[:3], float(x[3] / SPEED_OF_LIGHT)
