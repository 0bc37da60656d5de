"""Geodesy utilities: Earth-rotation (Sagnac) correction, ECEF/LLA/ENU.

Self-contained float64 numpy (the reference leans on ``pymap3d`` for frame
conversions, ``utils/coordinate.py:82-103``, and Borre's ``e_r_corr`` for the
Sagnac rotation, ``utils/geodesy.py:7-36``).
"""

from __future__ import annotations

import numpy as np

from sydr_tpu_torch.constants import EARTH_RADIUS, EARTH_ROTATION_RATE, WGS84_F

_E2 = WGS84_F * (2.0 - WGS84_F)  # first eccentricity squared


def correct_earth_rotation(travel_time: float, sat_pos: np.ndarray):
    """Rotate satellite ECEF coordinates by the Earth rotation during signal
    travel (R3(omega_e * tau) @ pos)."""
    ang = EARTH_ROTATION_RATE * travel_time
    c, s = np.cos(ang), np.sin(ang)
    x, y, z = sat_pos
    return np.array([c * x + s * y, -s * x + c * y, z])


def ecef_to_geodetic(pos: np.ndarray):
    """ECEF [m] -> (lat [rad], lon [rad], height [m]); Bowring's iteration."""
    x, y, z = pos
    lon = np.arctan2(y, x)
    p = np.hypot(x, y)
    lat = np.arctan2(z, p * (1.0 - _E2))
    for _ in range(6):
        n = EARTH_RADIUS / np.sqrt(1.0 - _E2 * np.sin(lat) ** 2)
        h = p / np.cos(lat) - n
        lat = np.arctan2(z, p * (1.0 - _E2 * n / (n + h)))
    n = EARTH_RADIUS / np.sqrt(1.0 - _E2 * np.sin(lat) ** 2)
    h = p / np.cos(lat) - n
    return lat, lon, h


def geodetic_to_ecef(lat: float, lon: float, height: float):
    n = EARTH_RADIUS / np.sqrt(1.0 - _E2 * np.sin(lat) ** 2)
    return np.array([
        (n + height) * np.cos(lat) * np.cos(lon),
        (n + height) * np.cos(lat) * np.sin(lon),
        (n * (1.0 - _E2) + height) * np.sin(lat),
    ])


def ecef_to_enu(pos: np.ndarray, ref: np.ndarray):
    """ECEF vector -> local East/North/Up at reference point ``ref``."""
    lat, lon, _ = ecef_to_geodetic(ref)
    d = np.asarray(pos, dtype=np.float64) - np.asarray(ref, dtype=np.float64)
    sl, cl = np.sin(lat), np.cos(lat)
    so, co = np.sin(lon), np.cos(lon)
    east = -so * d[..., 0] + co * d[..., 1]
    north = -sl * co * d[..., 0] - sl * so * d[..., 1] + cl * d[..., 2]
    up = cl * co * d[..., 0] + cl * so * d[..., 1] + sl * d[..., 2]
    return np.stack([east, north, up], axis=-1)


def ecef_vector_to_enu(vec: np.ndarray, ref: np.ndarray):
    """Rotate a free ECEF vector (e.g. velocity) into local ENU at ``ref``
    — no translation, unlike :func:`ecef_to_enu` which differences
    positions first."""
    lat, lon, _ = ecef_to_geodetic(ref)
    v = np.asarray(vec, dtype=np.float64)
    sl, cl = np.sin(lat), np.cos(lat)
    so, co = np.sin(lon), np.cos(lon)
    east = -so * v[..., 0] + co * v[..., 1]
    north = -sl * co * v[..., 0] - sl * so * v[..., 1] + cl * v[..., 2]
    up = cl * co * v[..., 0] + cl * so * v[..., 1] + sl * v[..., 2]
    return np.stack([east, north, up], axis=-1)


def elevation_azimuth(sat_pos: np.ndarray, rx_pos: np.ndarray):
    """Satellite elevation/azimuth [rad] as seen from ``rx_pos`` (ECEF)."""
    enu = ecef_to_enu(sat_pos, rx_pos)
    e, n, u = enu[..., 0], enu[..., 1], enu[..., 2]
    horiz = np.hypot(e, n)
    return np.arctan2(u, horiz), np.remainder(np.arctan2(e, n), 2 * np.pi)
