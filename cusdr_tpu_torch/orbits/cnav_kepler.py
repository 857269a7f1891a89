"""Quasi-Keplerian satellite position for CNAV-family ephemerides
(GPS CNAV MT10/11, BeiDou B-CNAV1/B-CNAV2).

Behavioral equivalent of GPS/GPS_L2C/include/satpos.m (ΔA/ȦDot semi-major
axis, Δn0/Δṅ0 mean-motion corrections, ω̇_REF + Δω̇) and
BDS/B1C/include/satpos.m (A_ref split MEO vs IGSO/GEO).
"""

from __future__ import annotations

import numpy as np

from ..constants import GM_EARTH, GPS_PI, OMEGA_E_DOT, REL_F
from ..geodesy.transforms import check_t

# IS-GPS-200 CNAV reference values (GPS_L2C/include/satpos.m:39-40)
GPS_A_REF = 26559710.0
GPS_OMEGA_DOT_REF = -2.6e-9 * GPS_PI

# BDS B-CNAV reference values (BDS/B1C/include/satpos.m:38-39)
BDS_A_REF_MEO = 27906100.0
BDS_A_REF_IGSO_GEO = 42162200.0


def sat_pos_cnav(transmit_time: float, eph: dict,
                 a_ref: float = GPS_A_REF,
                 omega_dot_ref: float = GPS_OMEGA_DOT_REF,
                 gm: float = GM_EARTH,
                 omega_e_dot: float = OMEGA_E_DOT,
                 isc_key: str = "ISC_L2C"):
    """Returns (pos[3], clk_corr) per GPS_L2C/include/satpos.m:25-160."""
    dt = check_t(transmit_time - eph["t_oc"])
    clk = (eph["a_f2"] * dt + eph["a_f1"]) * dt + eph["a_f0"]
    valid = eph.get("idValid", set())
    if 30 in valid or ("T_GD" in eph and isc_key in eph):
        clk = clk - eph.get("T_GD", 0.0) + eph.get(isc_key, 0.0)
    time = transmit_time - clk

    tk = check_t(time - eph["t_oe"])
    a0 = a_ref + eph["deltaA"]
    a = a0 + eph.get("ADot", 0.0) * tk
    n0 = np.sqrt(gm / a0 ** 3)
    delta_n = eph["delta_n_0"] + 0.5 * eph.get("delta_n_0Dot", 0.0) * tk
    n = n0 + delta_n
    M = np.remainder(eph["M_0"] + n * tk + 2 * GPS_PI, 2 * GPS_PI)

    E = M
    for _ in range(10):
        e_old = E
        E = M + eph["e"] * np.sin(E)
        if abs(np.remainder(E - e_old, 2 * GPS_PI)) < 1e-12:
            break
    E = np.remainder(E + 2 * GPS_PI, 2 * GPS_PI)

    nu = np.arctan2(np.sqrt(1 - eph["e"] ** 2) * np.sin(E),
                    np.cos(E) - eph["e"])
    phi = np.remainder(nu + eph["omega"], 2 * GPS_PI)
    u = phi + eph["C_uc"] * np.cos(2 * phi) + eph["C_us"] * np.sin(2 * phi)
    r = a * (1 - eph["e"] * np.cos(E)) \
        + eph["C_rc"] * np.cos(2 * phi) + eph["C_rs"] * np.sin(2 * phi)
    i = eph["i_0"] + eph.get("i_0Dot", 0.0) * tk \
        + eph["C_ic"] * np.cos(2 * phi) + eph["C_is"] * np.sin(2 * phi)

    xk1, yk1 = np.cos(u) * r, np.sin(u) * r
    omega_dot = omega_dot_ref + eph.get("delta_omegaDot", 0.0)
    Omega = eph["omega_0"] + (omega_dot - omega_e_dot) * tk \
        - omega_e_dot * eph["t_oe"]
    Omega = np.remainder(Omega + 2 * GPS_PI, 2 * GPS_PI)

    pos = np.asarray([
        xk1 * np.cos(Omega) - yk1 * np.cos(i) * np.sin(Omega),
        xk1 * np.sin(Omega) + yk1 * np.cos(i) * np.cos(Omega),
        yk1 * np.sin(i)])
    clk = clk + REL_F * eph["e"] * np.sqrt(a) * np.sin(E)
    return pos, clk
