"""Iterative least-squares navigation solution with DOP.

Behavioral equivalent of Common/leastSquarePos.m: 10 Gauss-Newton
iterations, earth-rotation correction of satellite positions, topocentric
az/el, Goad-Goodman troposphere, rank guard, DOP from inv(AᵀA).
"""

from __future__ import annotations

import numpy as np

from ..constants import SPEED_OF_LIGHT
from ..geodesy.transforms import e_r_corr, topocent
from ..geodesy.tropo import tropo


def least_square_pos(sat_pos: np.ndarray, obs: np.ndarray,
                     use_trop_corr: bool = True, n_iter: int = 10):
    """Solve receiver position + clock bias.

    sat_pos: [3, N] ECEF satellite positions at transmit time
    obs: [N] pseudoranges corrected by SV clock [m]

    Returns (pos[4] = x,y,z,dt_m, el[N], az[N], dop[5]) — dop is
    [GDOP, PDOP, HDOP, VDOP, TDOP] (leastSquarePos.m:108-121).
    """
    n_sats = sat_pos.shape[1]
    pos = np.zeros(4)
    az = np.zeros(n_sats)
    el = np.zeros(n_sats)
    A = np.zeros((n_sats, 4))
    omc = np.zeros(n_sats)

    for it in range(n_iter):
        for i in range(n_sats):
            if it == 0:
                rot_x = sat_pos[:, i]
                trop = 2.0
            else:
                rho2 = np.sum((sat_pos[:, i] - pos[:3]) ** 2)
                travel = np.sqrt(rho2) / SPEED_OF_LIGHT
                rot_x = e_r_corr(travel, sat_pos[:, i])
                az[i], el[i], _ = topocent(pos[:3], rot_x - pos[:3])
                if use_trop_corr:
                    trop = tropo(np.sin(np.radians(el[i])), 0.0, 1013.0,
                                 293.0, 50.0, 0.0, 0.0, 0.0)
                else:
                    trop = 0.0
            rng = np.linalg.norm(rot_x - pos[:3])
            omc[i] = obs[i] - rng - pos[3] - trop
            A[i] = [-(rot_x[0] - pos[0]) / rng,
                    -(rot_x[1] - pos[1]) / rng,
                    -(rot_x[2] - pos[2]) / rng,
                    1.0]

        if np.linalg.matrix_rank(A) != 4:
            return np.zeros(4), el, az, np.full(5, np.inf)
        x, *_ = np.linalg.lstsq(A, omc, rcond=None)
        pos = pos + x

    q = np.linalg.inv(A.T @ A)
    dop = np.asarray([
        np.sqrt(np.trace(q)),
        np.sqrt(q[0, 0] + q[1, 1] + q[2, 2]),
        np.sqrt(q[0, 0] + q[1, 1]),
        np.sqrt(q[2, 2]),
        np.sqrt(q[3, 3])])
    return pos, el, az, dop
