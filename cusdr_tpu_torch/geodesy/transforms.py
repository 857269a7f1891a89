"""Geodetic coordinate transforms.

Behavioral equivalents of the reference Common/ geodesy utilities
(cart2geo.m, togeod.m, topocent.m, e_r_corr.m, findUtmZone.m, cart2utm.m,
geo2cart.m, check_t.m) — reimplemented from the standard geodesy
formulations (Kai Borre's algorithms are the common ancestor).
"""

from __future__ import annotations

import numpy as np

from ..constants import OMEGA_E_DOT, WGS84_A, WGS84_FINV


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


def cart2geo(x: float, y: float, z: float, system: int = 5):
    """Cartesian -> geodetic on one of 5 reference ellipsoids; default
    WGS-84 (cart2geo.m).  Returns (phi_deg, lambda_deg, h)."""
    a_tab = [6378388.0, 6378160.0, 6378135.0, 6378137.0, 6378137.0]
    f_tab = [1 / 297.0, 1 / 298.247, 1 / 298.26, 1 / 298.257222101,
             1 / 298.257223563]
    a = a_tab[system - 1]
    f = f_tab[system - 1]
    lam = np.arctan2(y, x)
    ex2 = (2 - f) * f / ((1 - f) ** 2)
    c = a * np.sqrt(1 + ex2)
    phi = np.arctan(z / (np.hypot(x, y) * (1 - (2 - f) * f)))
    h = 0.1
    oldh = 0.0
    it = 0
    while abs(h - oldh) > 1e-12 and it < 100:
        oldh = h
        N = c / np.sqrt(1 + ex2 * np.cos(phi) ** 2)
        phi = np.arctan(z / (np.hypot(x, y)
                             * (1 - (2 - f) * f * N / (N + h))))
        h = np.hypot(x, y) / np.cos(phi) - N
        it += 1
    return np.degrees(phi), np.degrees(lam), h


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


def find_utm_zone(latitude_deg: float, longitude_deg: float) -> int:
    """UTM zone number from lat/lon with the Norway/Svalbard exceptions
    (findUtmZone.m)."""
    if not -180.0 <= longitude_deg <= 180.0:
        raise ValueError("longitude outside [-180, 180]")
    if not -80.0 <= latitude_deg <= 84.0:
        raise ValueError("latitude outside [-80, 84]")
    zone = int((longitude_deg + 180.0) // 6) + 1
    lat, lon = latitude_deg, longitude_deg
    if 56 <= lat < 64 and 3 <= lon < 12:
        zone = 32
    if lat >= 72:
        if 0 <= lon < 9:
            zone = 31
        elif 9 <= lon < 21:
            zone = 33
        elif 21 <= lon < 33:
            zone = 35
        elif 33 <= lon < 42:
            zone = 37
    return zone


def _clsin(ar, degree, argument):
    """Clenshaw summation of sine series (clsin.m)."""
    cos_arg = 2 * np.cos(argument)
    hr1 = 0.0
    hr = 0.0
    for t in range(degree, 0, -1):
        hr2 = hr1
        hr1 = hr
        hr = ar[t - 1] + cos_arg * hr1 - hr2
    return hr * np.sin(argument)


def _clksin(ar, degree, arg_real, arg_imag):
    """Clenshaw summation of complex sine series (clksin.m)."""
    sin_arg_r = np.sin(arg_real)
    cos_arg_r = np.cos(arg_real)
    sinh_arg_i = np.sinh(arg_imag)
    cosh_arg_i = np.cosh(arg_imag)
    r = 2 * cos_arg_r * cosh_arg_i
    i = -2 * sin_arg_r * sinh_arg_i
    hr1 = hr = hi1 = hi = 0.0
    for t in range(degree, 0, -1):
        hr2, hi2 = hr1, hi1
        hr1, hi1 = hr, hi
        hr = ar[t - 1] + r * hr1 - i * hi1 - hr2
        hi = i * hr1 + r * hi1 - hi2
    return (sin_arg_r * cosh_arg_i * hr + cos_arg_r * sinh_arg_i * hi,
            cos_arg_r * sinh_arg_i * hr - sin_arg_r * cosh_arg_i * hi)


def cart2utm(x: float, y: float, z: float, zone: int):
    """ECEF cartesian -> UTM (E, N, U) via the Krüger/Borre transverse-
    Mercator series (cart2utm.m: ED50-style datum shift, Clenshaw
    summations).  Returns (E, N, U) in meters."""
    a = 6378388.0
    f = 1.0 / 297.0
    ex2 = (2 - f) * f / ((1 - f) ** 2)
    c = a * np.sqrt(1 + ex2)
    vec = np.asarray([x, y, z - 4.5], np.float64)
    alpha = 0.756e-6
    R = np.asarray([[1.0, -alpha, 0.0],
                    [alpha, 1.0, 0.0],
                    [0.0, 0.0, 1.0]])
    trans = np.asarray([89.5, 93.8, 127.6])
    scale = 0.9999988
    v = scale * (R @ vec) + trans
    L = np.arctan2(v[1], v[0])
    N1 = 6395000.0
    B = np.arctan2(v[2] / ((1 - f) ** 2 * N1),
                   np.linalg.norm(v[:2]) / N1)
    U = 0.1
    oldU = 0.0
    iterations = 0
    rho = np.linalg.norm(v[:2])
    while abs(U - oldU) > 1e-4 and iterations < 100:
        oldU = U
        N1 = c / np.sqrt(1 + ex2 * (np.cos(B) ** 2))
        B = np.arctan2(v[2] / ((1 - f) ** 2 * N1 + U), rho / (N1 + U))
        U = rho / np.cos(B) - N1
        iterations += 1

    # Normalized meridian quadrant (König & Weise)
    m0 = 0.0004
    n = f / (2 - f)
    m = n ** 2 * (1.0 / 4.0 + n * n / 64.0)
    w = (a * (-n - m0 + m * (1 - m0))) / (1 + n)
    Q_n = a + w
    # Easting and longitude of central meridian
    E0 = 500000.0
    L0 = np.radians((zone - 30) * 6 - 3)

    # Geographic->geodetic and geodetic->spherical-TM series coefficients
    # (cart2utm.m:86-116; the inverse-direction gb/utg sets live in
    # utm2cart/utm2geo if ever needed)
    bg = [-3.37077907e-3, 4.73444769e-6, -8.29914570e-9, 1.58785330e-11]
    gtu = [8.41275991e-4, 7.67306686e-7, 1.21291230e-9, 2.48508228e-12]

    neg_geo = B < 0
    Bg_r = abs(B)
    Bg_r = Bg_r + _clsin(bg, 4, 2 * Bg_r)
    Lg_r = L - L0
    cos_BN = np.cos(Bg_r)
    Np = np.arctan2(np.sin(Bg_r), np.cos(Lg_r) * cos_BN)
    Ep = np.arctanh(np.sin(Lg_r) * cos_BN)
    # spherical normalized N, E -> ellipsoidal (cart2utm.m:84-91:
    # Clenshaw on doubled arguments, then halved before the correction)
    dN, dE = _clksin(gtu, 4, 2 * Np, 2 * Ep)
    Np = Np + dN
    Ep = Ep + dE
    E = Q_n * Ep + E0
    N = Q_n * Np
    if neg_geo:
        N = -N + 20000000.0
    return float(E), float(N), float(U)


def deg2dms(deg: float):
    """Decimal degrees -> (deg, min, sec) (deg2dms.m semantics)."""
    sign = -1 if deg < 0 else 1
    deg = abs(deg)
    d = int(deg)
    m = int((deg - d) * 60)
    s = (deg - d - m / 60.0) * 3600.0
    return sign * d, m, s


def dms2deg(d: float, m: float, s: float) -> float:
    sign = -1 if d < 0 else 1
    return sign * (abs(d) + m / 60.0 + s / 3600.0)
