"""Keplerian broadcast-ephemeris satellite position and clock.

Behavioral equivalent of GPS/GPS_L1CA/include/satpos.m (Kepler iteration,
harmonic corrections, earth-rotated ascending node, relativistic clock
term).  The same routine serves Galileo I/NAV-F/NAV and BeiDou MEO/IGSO
ephemerides with their constellation constants; BeiDou GEO (+5 deg rotated
frame, BDS/B1I/include/satpos.m:127-141) and B-CNAV quasi-Keplerian deltas
(GPS_L2C/include/satpos.m) layer on top.
"""

from __future__ import annotations

import numpy as np

from .constants import GM_EARTH, GPS_PI, OMEGA_E_DOT, REL_F
from .transforms import check_t


def sat_pos_kepler(transmit_time: float, eph: dict,
                   gm: float = GM_EARTH,
                   omega_e_dot: float = OMEGA_E_DOT):
    """Satellite ECEF position [m] and clock correction [s] at
    ``transmit_time`` (satpos.m:46-143).

    Returns (pos[3], clk_corr).
    """
    # clock correction without relativity first (satpos.m:50-60)
    dt = check_t(transmit_time - eph["t_oc"])
    clk = (eph["a_f2"] * dt + eph["a_f1"]) * dt + eph["a_f0"] \
        - eph.get("T_GD", 0.0)
    time = transmit_time - clk

    a = eph["sqrtA"] ** 2
    tk = check_t(time - eph["t_oe"])
    n0 = np.sqrt(gm / a ** 3)
    n = n0 + eph["deltan"]
    M = eph["M_0"] + n * tk
    M = np.remainder(M + 2 * GPS_PI, 2 * GPS_PI)

    E = M
    for _ in range(10):
        e_old = E
        E = M + eph["e"] * np.sin(E)
        if abs(np.remainder(E - e_old, 2 * GPS_PI)) < 1e-12:
            break
    E = np.remainder(E + 2 * GPS_PI, 2 * GPS_PI)

    dtr = REL_F * eph["e"] * eph["sqrtA"] * np.sin(E)

    nu = np.arctan2(np.sqrt(1 - eph["e"] ** 2) * np.sin(E),
                    np.cos(E) - eph["e"])
    phi = np.remainder(nu + eph["omega"], 2 * GPS_PI)

    u = phi + eph["C_uc"] * np.cos(2 * phi) + eph["C_us"] * np.sin(2 * phi)
    r = a * (1 - eph["e"] * np.cos(E)) \
        + eph["C_rc"] * np.cos(2 * phi) + eph["C_rs"] * np.sin(2 * phi)
    i = eph["i_0"] + eph["iDot"] * tk \
        + eph["C_ic"] * np.cos(2 * phi) + eph["C_is"] * np.sin(2 * phi)

    xk1 = np.cos(u) * r
    yk1 = np.sin(u) * r

    Omega = eph["omega_0"] + (eph["omegaDot"] - omega_e_dot) * tk \
        - omega_e_dot * eph["t_oe"]
    Omega = np.remainder(Omega + 2 * GPS_PI, 2 * GPS_PI)

    pos = np.asarray([
        xk1 * np.cos(Omega) - yk1 * np.cos(i) * np.sin(Omega),
        xk1 * np.sin(Omega) + yk1 * np.cos(i) * np.cos(Omega),
        yk1 * np.sin(i)])

    clk = clk + dtr    # satpos.m:140-143
    return pos, clk
