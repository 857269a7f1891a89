"""Least-squares navigation solutions over a stack of measurement epochs.

The port's own module, with no counterpart in the reference package: it
computes what ``pvt.lsq.least_square_pos`` and ``pvt.pseudorange
.transmit_times`` compute, epoch by epoch, for many measurement epochs at
once, as numpy array expressions over (epochs x satellites).  The
arithmetic is the scalar code's, in float64, with its iteration count,
troposphere model, rank guard and branches; only the order of a few sums
differs, so the results agree to rounding (tests/test_torch_pvt_batch.py).
``receiver.nav_solve`` solves a record's fix epochs through it, a few
batched passes a record instead of one scalar solve per epoch.
"""

from __future__ import annotations

import numpy as np

from ..constants import SPEED_OF_LIGHT

_DTR = np.pi / 180.0
_RTD = 180.0 / np.pi
# topocent's ellipsoid (WGS 84) and togeod's iteration limits
_A = 6378137.0
_FINV = 298.257223563
_ESQ = (2.0 - 1.0 / _FINV) / _FINV
_TOLSQ = 1e-10
_MAXIT = 50


def transmit_times_batch(track, chans, subframe_start_epoch, tow,
                         meas_samples, cfg, sig) -> np.ndarray:
    """``transmit_times`` at every sample of ``meas_samples``: [samples,
    channels] seconds, inf outside ``chans``; a channel at a time, one
    ``searchsorted`` over all the samples."""
    meas = np.asarray(meas_samples, np.int64)
    out = np.full((len(meas), len(track.prns)), np.inf)
    code_period = sig.code_length_chips / sig.chip_rate_hz
    for ch in chans:
        abs_sample = track.abs_sample[ch]
        idx = np.searchsorted(abs_sample, meas, side="right") - 1
        step = track.code_freq[ch, idx] / cfg.sampling_freq
        code_phase = (track.rem_code_phase[ch, idx]
                      + step * (meas - abs_sample[idx]))
        out[:, ch] = ((code_phase / sig.code_length_chips
                       + idx - subframe_start_epoch[ch]) * code_period
                      + tow[ch])
    return out


def _togeod_lat_lon(x, y, z):
    """``togeod``'s latitude and longitude [deg] per lane; each lane
    iterates until its own convergence test passes."""
    p = np.hypot(x, y)
    lam = np.where(p > 1e-20, np.arctan2(y, x) * _RTD, 0.0)
    lam = np.where(lam < 0, lam + 360.0, lam)
    r = np.hypot(p, z)
    sinphi = np.where(r > 1e-20, z / r, 0.0)
    phi = np.arcsin(sinphi)
    h = r - _A * (1 - sinphi * sinphi / _FINV)
    run = r >= 1e-20            # the scalar returns latitude 0 below it
    for _ in range(_MAXIT):
        if not run.any():
            break
        sinphi, cosphi = np.sin(phi), np.cos(phi)
        n_phi = _A / np.sqrt(1 - _ESQ * sinphi * sinphi)
        d_p = p - (n_phi + h) * cosphi
        d_z = z - (n_phi * (1.0 - _ESQ) + h) * sinphi
        h_next = h + sinphi * d_z + cosphi * d_p
        phi = np.where(run, phi + (cosphi * d_z - sinphi * d_p)
                       / (n_phi + h_next), phi)
        h = np.where(run, h_next, h)
        run &= ~(d_p * d_p + d_z * d_z < _TOLSQ)
    return np.where(r < 1e-20, 0.0, phi * _RTD), lam


def _topocent_az_el(pos, dx):
    """``topocent``'s azimuth and elevation [deg] of dx [E, 3, N] seen from
    pos [E, 3]."""
    phi, lam = _togeod_lat_lon(pos[:, 0], pos[:, 1], pos[:, 2])
    cl, sl = np.cos(lam * _DTR)[:, None], np.sin(lam * _DTR)[:, None]
    cb, sb = np.cos(phi * _DTR)[:, None], np.sin(phi * _DTR)[:, None]
    x, y, z = dx[:, 0], dx[:, 1], dx[:, 2]
    e = -sl * x + cl * y
    n = -sb * cl * x - sb * sl * y + cb * z
    u = cb * cl * x + cb * sl * y + sb * z
    hor = np.hypot(e, n)
    flat = hor < 1e-20
    az = np.where(flat, 0.0, np.arctan2(e, n) / _DTR)
    el = np.where(flat, 90.0, np.arctan2(u, hor) / _DTR)
    return np.where(az < 0, az + 360.0, az), el


def _tropo(sinel):
    """``tropo(sinel, 0.0, 1013.0, 293.0, 50.0, 0.0, 0.0, 0.0)`` per lane
    (the station and weather ``least_square_pos`` passes)."""
    hsta, p, tkel, hum, hp, htkel, hhum = 0.0, 1013.0, 293.0, 50.0, 0.0, \
        0.0, 0.0
    a_e = 6378.137
    b0 = 7.839257e-5
    tlapse = -6.5
    tkhum = tkel + tlapse * (hhum - htkel)
    atkel = 7.5 * (tkhum - 273.15) / (237.3 + tkhum - 273.15)
    e0 = 0.0611 * hum * 10.0 ** atkel
    tksea = tkel - tlapse * htkel
    em = -978.77 / (2.8704e6 * tlapse * 1.0e-5)
    tkelh = tksea + tlapse * hhum
    e0sea = e0 * (tksea / tkelh) ** (4.0 * em)
    tkelp = tksea + tlapse * hp
    psea = p * (tksea / tkelp) ** em

    sinel = np.maximum(sinel, 0.0)
    result = np.zeros_like(sinel)
    refsea = 77.624e-6 / tksea
    htop = 1.1385e-5 / refsea
    refsea = refsea * psea
    ref = refsea * ((htop - hsta) / htop) ** 4

    for pass_no in (0, 1):   # dry then wet component
        rtop = (a_e + htop) ** 2 - (a_e + hsta) ** 2 * (1.0 - sinel ** 2)
        rtop = np.sqrt(np.maximum(rtop, 0.0)) - (a_e + hsta) * sinel
        a = -sinel / (htop - hsta)
        b = -b0 * (1.0 - sinel ** 2) / (htop - hsta)
        big_b = b ** 2 > 1.0e-35
        alpha = (2 * a, 2 * a ** 2 + 4 * b / 3, a * (a ** 2 + 3 * b),
                 a ** 4 / 5 + 2.4 * a ** 2 * b + 1.2 * b ** 2,
                 2 * a * b * (a ** 2 + 3 * b) / 3,
                 b ** 2 * (6 * a ** 2 + 4 * b) * 1.428571e-1,
                 np.where(big_b, a * b ** 3 / 2, 0.0),
                 np.where(big_b, b ** 4 / 9, 0.0))
        dr = rtop + sum(al * rtop ** (i + 2) for i, al in enumerate(alpha))
        result = result + dr * ref * 1000.0
        if pass_no == 0:
            refsea = (371900.0e-6 / tksea - 12.92e-6) / tksea
            htop = 1.1385e-5 * (1255.0 / tksea + 0.05) / refsea
            ref = refsea * e0sea * ((htop - hsta) / htop) ** 4
    return result


def least_square_pos_batch(sat_pos: np.ndarray, obs: np.ndarray,
                           use_trop_corr: bool = True, n_iter: int = 10):
    """``least_square_pos`` for E epochs of N satellites each.

    sat_pos: [E, 3, N] ECEF satellite positions at transmit time
    obs: [E, N] pseudoranges corrected by SV clock [m]

    Returns (pos[E, 4], el[E, N], az[E, N], dop[E, 5]); row e is what
    ``least_square_pos(sat_pos[e], obs[e], use_trop_corr, n_iter)``
    returns.  An epoch whose geometry falls below rank 4 ends there as the
    scalar ends it (pos zeros, el and az as they stood, dop inf) while the
    others go on; one that turns non-finite, where the scalar's SVD would
    raise, ends with pos NaN.  One batched SVD an iteration gives both the
    rank (``matrix_rank``'s tolerance) and the step: with all four
    singular values above that tolerance, ``lstsq(rcond=None)`` keeps them
    all, so its step is the pseudo-inverse's.
    """
    sat_pos = np.asarray(sat_pos, np.float64)
    obs = np.asarray(obs, np.float64)
    n_ep, _, n_sats = sat_pos.shape
    pos = np.zeros((n_ep, 4))
    el = np.zeros((n_ep, n_sats))
    az = np.zeros((n_ep, n_sats))
    live = np.ones(n_ep, bool)
    rank_failed = np.zeros(n_ep, bool)
    broken = np.zeros(n_ep, bool)
    tol = max(n_sats, 4) * np.finfo(np.float64).eps
    A = np.ones((n_ep, n_sats, 4))
    with np.errstate(all="ignore"):
        for it in range(n_iter):
            xyz = pos[:, :3, None]
            if it == 0:
                rot_x = sat_pos
                trop = 2.0
            else:
                travel = (np.sqrt(np.sum((sat_pos - xyz) ** 2, axis=1))
                          / SPEED_OF_LIGHT)
                omegatau = 7.292115147e-5 * travel    # e_r_corr
                c, s = np.cos(omegatau), np.sin(omegatau)
                x, y = sat_pos[:, 0], sat_pos[:, 1]
                rot_x = np.stack([c * x + s * y, -s * x + c * y,
                                  sat_pos[:, 2]], axis=1)
                az_i, el_i = _topocent_az_el(pos[:, :3], rot_x - xyz)
                az = np.where(live[:, None], az_i, az)
                el = np.where(live[:, None], el_i, el)
                trop = (_tropo(np.sin(np.radians(el))) if use_trop_corr
                        else 0.0)
            d = rot_x - xyz
            rng = np.sqrt(np.sum(d * d, axis=1))
            omc = obs - rng - pos[:, 3:] - trop
            A[..., :3] = np.moveaxis(-d / rng[:, None], 1, 2)

            finite = np.isfinite(A).all(axis=(1, 2)) \
                & np.isfinite(omc).all(axis=1)
            broken |= live & ~finite
            live &= finite
            u, sv, vt = np.linalg.svd(np.where(live[:, None, None], A, 0.0),
                                      full_matrices=False)
            rank = np.count_nonzero(sv > sv.max(axis=1, keepdims=True)
                                    * tol, axis=1)
            rank_failed |= live & (rank != 4)
            live &= rank == 4
            coef = np.einsum("enk,en->ek", u, np.where(live[:, None], omc,
                                                       0.0))
            step = np.einsum("ekj,ek->ej", vt,
                             coef / np.where(live[:, None], sv, 1.0))
            pos = np.where(live[:, None], pos + step, pos)

        ata = np.einsum("enk,enj->ekj", A, A)
        q = np.linalg.inv(np.where(live[:, None, None], ata, np.eye(4)))
    d0, d1, d2, d3 = (q[:, i, i] for i in range(4))
    dop = np.sqrt(np.stack([d0 + d1 + d2 + d3, d0 + d1 + d2, d0 + d1, d2,
                            d3], axis=1))
    dop[~live] = np.inf
    pos[rank_failed] = 0.0
    pos[broken] = np.nan
    return pos, el, az, dop
