"""GLONASS satellite position: RK4 integration of broadcast state vectors.

Behavioral equivalent of GLO/GLO_GL1/include/satpos.m: ECEF (PZ-90)
rotating-frame equations of motion with the J2 zonal harmonic and
luni-solar acceleration held constant, integrated with classic RK4 in 60 s
steps from the ephemeris reference epoch; clock correction
−(τn + τc − γ·dt) (satpos.m:25-58).
"""

from __future__ import annotations

import numpy as np

from ..constants import GLO_AE, GLO_GM, GLO_J2, GLO_OMEGA


def _deriv(state: np.ndarray, acc: np.ndarray) -> np.ndarray:
    """d/dt of [x,y,z,vx,vy,vz] in the rotating PZ-90 frame."""
    x, y, z, vx, vy, vz = state
    r2 = x * x + y * y + z * z
    r = np.sqrt(r2)
    c = -GLO_GM / r ** 3
    j = -1.5 * GLO_J2 * GLO_GM * GLO_AE ** 2 / r ** 5
    zz = 5.0 * z * z / r2
    ax = c * x + j * x * (1 - zz) + GLO_OMEGA ** 2 * x \
        + 2 * GLO_OMEGA * vy + acc[0]
    ay = c * y + j * y * (1 - zz) + GLO_OMEGA ** 2 * y \
        - 2 * GLO_OMEGA * vx + acc[1]
    az = c * z + j * z * (3 - zz) + acc[2]
    return np.asarray([vx, vy, vz, ax, ay, az])


def sat_pos_glonass(transmit_time: float, eph: dict, tau_c: float = 0.0):
    """Returns (pos[3] meters, clk_corr seconds).

    eph fields (ephemeris.m of the GLONASS receivers): t_b [s within day],
    pos/vel/acc in km (xDis..zAcc), tau_n, gamma; transmit_time measured on
    the same within-day scale as t_b.
    """
    dt = transmit_time - eph["t_b"]
    clk = -(eph["tau_n"] + tau_c - eph["gamma"] * dt)
    time = dt - clk

    state = np.asarray([eph["x"], eph["y"], eph["z"],
                        eph["vx"], eph["vy"], eph["vz"]], np.float64) * 1e3
    acc = np.asarray([eph["ax"], eph["ay"], eph["az"]], np.float64) * 1e3

    remaining = float(time)
    step = 60.0 if remaining >= 0 else -60.0
    while remaining != 0.0:
        tau = step if abs(remaining) >= abs(step) else remaining
        k1 = _deriv(state, acc)
        k2 = _deriv(state + 0.5 * tau * k1, acc)
        k3 = _deriv(state + 0.5 * tau * k2, acc)
        k4 = _deriv(state + tau * k3, acc)
        state = state + (tau / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
        remaining -= tau
    return state[:3], clk
