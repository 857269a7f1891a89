"""Geodetic coordinate transforms.

Behavioral equivalents of the reference Common/ geodesy utilities
(cart2geo.m, togeod.m, topocent.m, e_r_corr.m, findUtmZone.m, cart2utm.m,
geo2cart.m, check_t.m) — reimplemented from the standard geodesy
formulations (Kai Borre's algorithms are the common ancestor).
"""

from __future__ import annotations

import numpy as np

from .constants import OMEGA_E_DOT, WGS84_A, WGS84_FINV


def check_t(time: float) -> float:
    """Half-week crossover correction ±302400 s (check_t.m:4-12)."""
    half_week = 302400.0
    if time > half_week:
        return time - 2 * half_week
    if time < -half_week:
        return time + 2 * half_week
    return time


def e_r_corr(travel_time: float, x_sat: np.ndarray) -> np.ndarray:
    """Rotate satellite ECEF by earth rotation during signal travel
    (e_r_corr.m)."""
    omegatau = 7.292115147e-5 * travel_time   # value as used by e_r_corr.m
    c, s = np.cos(omegatau), np.sin(omegatau)
    rot = np.asarray([[c, s, 0.0], [-s, c, 0.0], [0.0, 0.0, 1.0]])
    return rot @ np.asarray(x_sat, np.float64)


def togeod(a: float, finv: float, x: float, y: float, z: float):
    """Cartesian -> geodetic (deg, deg, m) by iteration (togeod.m)."""
    h = 0.0
    tolsq = 1e-10
    maxit = 50
    rtd = 180.0 / np.pi
    esq = (2.0 - 1.0 / finv) / finv if finv >= 1e-20 else 0.0
    oneesq = 1.0 - esq

    P = np.hypot(x, y)
    dlambda = np.arctan2(y, x) * rtd if P > 1e-20 else 0.0
    if dlambda < 0:
        dlambda += 360.0
    r = np.hypot(P, z)
    sinphi = z / r if r > 1e-20 else 0.0
    dphi = np.arcsin(sinphi)
    if r < 1e-20:
        return 0.0, dlambda, 0.0
    h = r - a * (1 - sinphi * sinphi / finv)
    for _ in range(maxit):
        sinphi, cosphi = np.sin(dphi), np.cos(dphi)
        n_phi = a / np.sqrt(1 - esq * sinphi * sinphi)
        dP = P - (n_phi + h) * cosphi
        dZ = z - (n_phi * oneesq + h) * sinphi
        h += sinphi * dZ + cosphi * dP
        dphi += (cosphi * dZ - sinphi * dP) / (n_phi + h)
        if dP * dP + dZ * dZ < tolsq:
            break
    return dphi * rtd, dlambda, h


def topocent(x: np.ndarray, dx: np.ndarray):
    """Azimuth/elevation/distance of dx seen from position x
    (topocent.m)."""
    dtr = np.pi / 180.0
    phi, lam, _ = togeod(6378137.0, 298.257223563, *np.asarray(x,
                                                               np.float64))
    cl, sl = np.cos(lam * dtr), np.sin(lam * dtr)
    cb, sb = np.cos(phi * dtr), np.sin(phi * dtr)
    f = np.asarray([[-sl, -sb * cl, cb * cl],
                    [cl, -sb * sl, cb * sl],
                    [0.0, cb, sb]])
    e, n, u = f.T @ np.asarray(dx, np.float64)
    hor = np.hypot(e, n)
    if hor < 1e-20:
        az, el = 0.0, 90.0
    else:
        az = np.arctan2(e, n) / dtr
        el = np.arctan2(u, hor) / dtr
    if az < 0:
        az += 360.0
    return az, el, float(np.linalg.norm(dx))


def geo2cart(phi_deg: float, lam_deg: float, h: float, system: int = 5):
    """Geodetic -> cartesian (geo2cart.m inverse of cart2geo)."""
    a_tab = [6378388.0, 6378160.0, 6378135.0, 6378137.0, 6378137.0]
    f_tab = [1 / 297.0, 1 / 298.247, 1 / 298.26, 1 / 298.257222101,
             1 / 298.257223563]
    a = a_tab[system - 1]
    f = f_tab[system - 1]
    phi = np.radians(phi_deg)
    lam = np.radians(lam_deg)
    ex2 = (2 - f) * f / ((1 - f) ** 2)
    c = a * np.sqrt(1 + ex2)
    N = c / np.sqrt(1 + ex2 * np.cos(phi) ** 2)
    x = (N + h) * np.cos(phi) * np.cos(lam)
    y = (N + h) * np.cos(phi) * np.sin(lam)
    z = ((1 - (2 - f) * f) * N + h) * np.sin(phi)
    return x, y, z
