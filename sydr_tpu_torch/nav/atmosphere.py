"""Atmospheric delay models: Collins troposphere, Klobuchar ionosphere.

The reference carries these in its legacy tree (Collins implemented,
Klobuchar present but disabled — ``sydr/old/navigation.py:
239-328``); here both are first-class. Inputs/outputs in SI units; angles in
radians.
"""

from __future__ import annotations

import numpy as np

from sydr_tpu_torch.constants import (
    SPEED_OF_LIGHT,
    TROPO_AVG_BETA,
    TROPO_AVG_E0,
    TROPO_AVG_LAMBDA,
    TROPO_AVG_P0,
    TROPO_AVG_T0,
    TROPO_GM,
    TROPO_K1,
    TROPO_K2,
    TROPO_LAT_GRID,
    TROPO_RD,
    TROPO_VAR_BETA,
    TROPO_VAR_E0,
    TROPO_VAR_LAMBDA,
    TROPO_VAR_P0,
    TROPO_VAR_T0,
)

_G = 9.80665


def _interp(table, lat_deg):
    return np.interp(abs(lat_deg), TROPO_LAT_GRID, table)


def tropo_delay_collins(
    elevation: float,
    latitude: float,
    height: float,
    day_of_year: int = 1,
    southern: bool = False,
) -> float:
    """Collins (UNB3-style) tropospheric zenith delay mapped to elevation [m].

    Args:
        elevation: satellite elevation [rad].
        latitude: receiver geodetic latitude [rad].
        height: receiver height above sea level [m].
        day_of_year: annual cycle phase.
    """
    lat_deg = np.rad2deg(latitude)
    dmin = 211.0 if southern else 28.0
    cosfac = np.cos(2 * np.pi * (day_of_year - dmin) / 365.25)

    p0 = _interp(TROPO_AVG_P0, lat_deg) - _interp(TROPO_VAR_P0, lat_deg) * cosfac
    t0 = _interp(TROPO_AVG_T0, lat_deg) - _interp(TROPO_VAR_T0, lat_deg) * cosfac
    e0 = _interp(TROPO_AVG_E0, lat_deg) - _interp(TROPO_VAR_E0, lat_deg) * cosfac
    beta = _interp(TROPO_AVG_BETA, lat_deg) - _interp(TROPO_VAR_BETA, lat_deg) * cosfac
    lam = _interp(TROPO_AVG_LAMBDA, lat_deg) - _interp(TROPO_VAR_LAMBDA, lat_deg) * cosfac

    # Zenith delays at sea level (Saastamoinen-form).
    z_dry0 = 1e-6 * TROPO_K1 * TROPO_RD * p0 / TROPO_GM
    z_wet0 = (
        1e-6 * TROPO_K2 * TROPO_RD
        / (TROPO_GM * (lam + 1.0) - beta * TROPO_RD)
        * e0 / t0
    )

    # Height scaling.
    base = 1.0 - beta * height / t0
    base = max(base, 1e-6)
    z_dry = z_dry0 * base ** (_G / (TROPO_RD * beta))
    z_wet = z_wet0 * base ** ((lam + 1.0) * _G / (TROPO_RD * beta) - 1.0)

    # Black & Eisner mapping function.
    el_deg = np.rad2deg(max(elevation, np.deg2rad(2.0)))
    mapping = 1.001 / np.sqrt(0.002001 + np.sin(np.deg2rad(el_deg)) ** 2)
    return (z_dry + z_wet) * mapping


def iono_delay_klobuchar(
    elevation: float,
    azimuth: float,
    latitude: float,
    longitude: float,
    gps_tow: float,
    alpha=(0.0, 0.0, 0.0, 0.0),
    beta=(0.0, 0.0, 0.0, 0.0),
) -> float:
    """Klobuchar single-frequency ionospheric delay for GPS L1 [m].

    ``alpha``/``beta`` are the broadcast coefficients (subframe 4); all
    angles in radians. Implements IS-GPS-200 20.3.3.5.2.5 (semicircle
    arithmetic internally).
    """
    el = elevation / np.pi          # semicircles
    lat = latitude / np.pi
    lon = longitude / np.pi

    psi = 0.0137 / (el + 0.11) - 0.022
    phi_i = lat + psi * np.cos(azimuth)
    phi_i = np.clip(phi_i, -0.416, 0.416)
    lam_i = lon + psi * np.sin(azimuth) / np.cos(phi_i * np.pi)
    phi_m = phi_i + 0.064 * np.cos((lam_i - 1.617) * np.pi)

    t = 4.32e4 * lam_i + gps_tow
    t = t % 86400.0

    amp = sum(a * phi_m**n for n, a in enumerate(alpha))
    amp = max(amp, 0.0)
    per = sum(b * phi_m**n for n, b in enumerate(beta))
    per = max(per, 72000.0)

    x = 2.0 * np.pi * (t - 50400.0) / per
    slant = 1.0 + 16.0 * (0.53 - el) ** 3

    if abs(x) < 1.57:
        delay = slant * (5e-9 + amp * (1.0 - x**2 / 2.0 + x**4 / 24.0))
    else:
        delay = slant * 5e-9
    return delay * SPEED_OF_LIGHT
