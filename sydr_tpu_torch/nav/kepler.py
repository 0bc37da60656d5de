"""Satellite position/clock from broadcast ephemeris (Kepler propagation).

Host-side float64 numpy, vectorised over satellites — replaces the per-object
solver of the reference (``sydr/space/satellite.py:59-120``).
Implements IS-GPS-200 20.3.3.4.3: mean anomaly propagation, Kepler iteration,
argument-of-latitude/radius/inclination harmonic corrections, relativistic
clock term, and node rotation into ECEF.
"""

from __future__ import annotations

import numpy as np

from sydr_tpu_torch.constants import (
    EARTH_GM,
    EARTH_ROTATION_RATE,
    HALF_WEEK_SECONDS,
    RELATIVISTIC_CLOCK_F,
)


def time_check(t):
    """Wrap a time difference into [-half_week, half_week]."""
    t = np.asarray(t, dtype=np.float64)
    t = np.where(t > HALF_WEEK_SECONDS, t - 2 * HALF_WEEK_SECONDS, t)
    t = np.where(t < -HALF_WEEK_SECONDS, t + 2 * HALF_WEEK_SECONDS, t)
    return t


def satellite_clock_correction(eph, transmit_time):
    """Clock polynomial (without the relativistic term)."""
    dt = time_check(np.asarray(transmit_time, dtype=np.float64) - eph.toc)
    return (eph.af2 * dt + eph.af1) * dt + eph.af0


def satellite_position_velocity(eph, transmit_time: float):
    """ECEF position [m], velocity [m/s] and clock correction [s].

    ``transmit_time`` is GPS seconds-of-week at signal transmission (per the
    satellite's own clock). Returns (pos[3], vel[3], clock_corr) where
    ``clock_corr`` includes the relativistic term; the caller applies
    ``+ clock_corr * c`` to the pseudorange (and TGD separately).
    """
    t = float(transmit_time)
    dt = float(time_check(t - eph.toc))
    clk = (eph.af2 * dt + eph.af1) * dt + eph.af0
    t_corr = t - clk

    tk = float(time_check(t_corr - eph.toe))
    a = eph.sqrt_a**2
    n0 = np.sqrt(EARTH_GM / a**3)
    n = n0 + eph.deltan

    m = np.remainder(eph.m0 + n * tk, 2 * np.pi)
    e_anom = m
    for _ in range(12):
        prev = e_anom
        e_anom = m + eph.ecc * np.sin(e_anom)
        if abs(e_anom - prev) < 1e-13:
            break

    dtr = RELATIVISTIC_CLOCK_F * eph.ecc * eph.sqrt_a * np.sin(e_anom)

    nu = np.arctan2(
        np.sqrt(1 - eph.ecc**2) * np.sin(e_anom), np.cos(e_anom) - eph.ecc
    )
    phi = np.remainder(nu + eph.omega, 2 * np.pi)

    du = eph.cuc * np.cos(2 * phi) + eph.cus * np.sin(2 * phi)
    dr = eph.crc * np.cos(2 * phi) + eph.crs * np.sin(2 * phi)
    di = eph.cic * np.cos(2 * phi) + eph.cis * np.sin(2 * phi)

    u = phi + du
    r = a * (1 - eph.ecc * np.cos(e_anom)) + dr
    inc = eph.i0 + eph.i_dot * tk + di

    node = np.remainder(
        eph.omega0
        + (eph.omega_dot - EARTH_ROTATION_RATE) * tk
        - EARTH_ROTATION_RATE * eph.toe,
        2 * np.pi,
    )

    xp = r * np.cos(u)
    yp = r * np.sin(u)
    pos = np.array([
        xp * np.cos(node) - yp * np.cos(inc) * np.sin(node),
        xp * np.sin(node) + yp * np.cos(inc) * np.cos(node),
        yp * np.sin(inc),
    ])

    # Velocity (analytic derivatives; IS-GPS-200 table 20-IV extensions).
    e_dot = n / (1 - eph.ecc * np.cos(e_anom))
    nu_dot = e_dot * np.sqrt(1 - eph.ecc**2) / (1 - eph.ecc * np.cos(e_anom))
    u_dot = nu_dot * (
        1 + 2 * (eph.cus * np.cos(2 * phi) - eph.cuc * np.sin(2 * phi))
    )
    r_dot = (
        a * eph.ecc * np.sin(e_anom) * e_dot
        + 2 * nu_dot * (eph.crs * np.cos(2 * phi) - eph.crc * np.sin(2 * phi))
    )
    i_dot_t = eph.i_dot + 2 * nu_dot * (
        eph.cis * np.cos(2 * phi) - eph.cic * np.sin(2 * phi)
    )
    node_dot = eph.omega_dot - EARTH_ROTATION_RATE

    xp_dot = r_dot * np.cos(u) - r * np.sin(u) * u_dot
    yp_dot = r_dot * np.sin(u) + r * np.cos(u) * u_dot
    vel = np.array([
        xp_dot * np.cos(node)
        - yp_dot * np.cos(inc) * np.sin(node)
        + yp * np.sin(inc) * np.sin(node) * i_dot_t
        - pos[1] * node_dot,
        xp_dot * np.sin(node)
        + yp_dot * np.cos(inc) * np.cos(node)
        - yp * np.sin(inc) * np.cos(node) * i_dot_t
        + pos[0] * node_dot,
        yp_dot * np.sin(inc) + yp * np.cos(inc) * i_dot_t,
    ])

    # IS-GPS-200 20.3.3.3.3.1: dt_sv = clock polynomial + relativistic term
    # (the reference subtracts dtr, satellite.py:116, which contradicts the
    # spec sign; we follow the spec).
    clock_corr = (eph.af2 * dt + eph.af1) * dt + eph.af0 + dtr
    return pos, vel, clock_corr


def satellite_position(eph, transmit_time: float):
    """(position[3], clock_correction) — reference-equivalent signature."""
    pos, _, clk = satellite_position_velocity(eph, transmit_time)
    return pos, clk


def satellite_position_velocity_vec(eph, transmit_times):
    """Vectorised ECEF position/velocity/clock over an array of times.

    Same math as :func:`satellite_position_velocity` with fixed-count Kepler
    iterations; returns (pos [n, 3], vel [n, 3], clk [n]).
    """
    t = np.asarray(transmit_times, dtype=np.float64)
    dt = time_check(t - eph.toc)
    clk = (eph.af2 * dt + eph.af1) * dt + eph.af0
    t_corr = t - clk

    tk = time_check(t_corr - eph.toe)
    a = eph.sqrt_a**2
    n0 = np.sqrt(EARTH_GM / a**3)
    n = n0 + eph.deltan

    m = np.remainder(eph.m0 + n * tk, 2 * np.pi)
    e_anom = m.copy()
    for _ in range(12):
        e_anom = m + eph.ecc * np.sin(e_anom)

    dtr = RELATIVISTIC_CLOCK_F * eph.ecc * eph.sqrt_a * np.sin(e_anom)
    nu = np.arctan2(
        np.sqrt(1 - eph.ecc**2) * np.sin(e_anom), np.cos(e_anom) - eph.ecc
    )
    phi = np.remainder(nu + eph.omega, 2 * np.pi)

    du = eph.cuc * np.cos(2 * phi) + eph.cus * np.sin(2 * phi)
    dr = eph.crc * np.cos(2 * phi) + eph.crs * np.sin(2 * phi)
    di = eph.cic * np.cos(2 * phi) + eph.cis * np.sin(2 * phi)
    u = phi + du
    r = a * (1 - eph.ecc * np.cos(e_anom)) + dr
    inc = eph.i0 + eph.i_dot * tk + di
    node = np.remainder(
        eph.omega0 + (eph.omega_dot - EARTH_ROTATION_RATE) * tk
        - EARTH_ROTATION_RATE * eph.toe,
        2 * np.pi,
    )
    xp = r * np.cos(u)
    yp = r * np.sin(u)
    pos = np.stack([
        xp * np.cos(node) - yp * np.cos(inc) * np.sin(node),
        xp * np.sin(node) + yp * np.cos(inc) * np.cos(node),
        yp * np.sin(inc),
    ], axis=-1)

    e_dot = n / (1 - eph.ecc * np.cos(e_anom))
    nu_dot = e_dot * np.sqrt(1 - eph.ecc**2) / (1 - eph.ecc * np.cos(e_anom))
    u_dot = nu_dot * (
        1 + 2 * (eph.cus * np.cos(2 * phi) - eph.cuc * np.sin(2 * phi)))
    r_dot = (
        a * eph.ecc * np.sin(e_anom) * e_dot
        + 2 * nu_dot * (eph.crs * np.cos(2 * phi) - eph.crc * np.sin(2 * phi))
    )
    i_dot_t = eph.i_dot + 2 * nu_dot * (
        eph.cis * np.cos(2 * phi) - eph.cic * np.sin(2 * phi))
    node_dot = eph.omega_dot - EARTH_ROTATION_RATE
    xp_dot = r_dot * np.cos(u) - r * np.sin(u) * u_dot
    yp_dot = r_dot * np.sin(u) + r * np.cos(u) * u_dot
    vel = np.stack([
        xp_dot * np.cos(node) - yp_dot * np.cos(inc) * np.sin(node)
        + yp * np.sin(inc) * np.sin(node) * i_dot_t - pos[..., 1] * node_dot,
        xp_dot * np.sin(node) + yp_dot * np.cos(inc) * np.cos(node)
        - yp * np.sin(inc) * np.cos(node) * i_dot_t + pos[..., 0] * node_dot,
        yp_dot * np.sin(inc) + yp * np.cos(inc) * i_dot_t,
    ], axis=-1)

    clock_corr = (eph.af2 * dt + eph.af1) * dt + eph.af0 + dtr
    return pos, vel, clock_corr
