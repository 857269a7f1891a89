"""Per-signal nav decoding adapters: tracking outputs -> (eph, frame-start
epoch, time-of-week).

Each adapter converts the per-epoch prompt correlators of one channel into
the codec's symbol stream (handling NH/secondary despreading and symbol
rates) and runs the matching transport decoder.  This is the glue the
reference spreads across 12 receivers' postNavigation/NAVdecoding files.

All adapters return (eph dict | None, start_epoch, tow_seconds) where
``start_epoch`` is the epoch index of the decoded frame start (for
pseudorange formation) and ``tow`` is the signal time at that epoch.
"""

from __future__ import annotations

import numpy as np

from ..signals import codes as C
from . import bcnav, bds_d1, cnav, glonass_nav, lnav
from . import galileo_nav as gal
from .bits import find_preamble


def _symbols_from_epochs(i_p: np.ndarray, epochs_per_symbol: int,
                         secondary: np.ndarray | None = None,
                         phase: int = 0) -> np.ndarray:
    """Sum epochs into nav symbols, optionally despreading a ±1 secondary
    code aligned at ``phase`` (epochs)."""
    x = np.asarray(i_p, np.float64)
    if phase:
        x = x[phase:]
    n = (len(x) // epochs_per_symbol) * epochs_per_symbol
    x = x[:n].reshape(-1, epochs_per_symbol)
    if secondary is not None:
        x = x * np.asarray(secondary, np.float64)[None, :]
    return x.sum(axis=1)


def _best_secondary_phase(i_p: np.ndarray, secondary: np.ndarray) -> int:
    """Epoch offset maximizing despread symbol energy (NH alignment)."""
    m = len(secondary)
    n_sym = (len(i_p) - m) // m
    best, best_p = -1.0, 0
    x = np.asarray(i_p, np.float64)
    for p in range(m):
        s = x[p:p + n_sym * m].reshape(-1, m) * secondary[None, :]
        e = np.abs(s.sum(axis=1)).sum()
        if e > best:
            best, best_p = e, p
    return best_p


# --------------------------------------------------------------------------

def decode_lnav(track, ch, cfg, sig):
    """GPS L1 C/A (NAVdecoding.m flow) — see receiver.decode_nav_channel
    for the original implementation."""
    # the port's own receiver module (torch, no jax), not the reference's
    from ..receiver import decode_nav_channel
    return decode_nav_channel(track, ch, cfg, sig)


def decode_cnav(track, ch, cfg, sig):
    """GPS L2C (20 ms epochs = 1 symbol) and L5 (1 ms epochs, NH10 per
    10 ms symbol) CNAV streams."""
    i_p = track.i_p[ch]
    if sig.name == "gps_l5c":
        phase = _best_secondary_phase(i_p, C.NH10.astype(np.float64))
        sym = _symbols_from_epochs(i_p, 10, C.NH10, phase)
        epochs_per_sym = 10.0
        msg_seconds = 6.0
    else:
        phase = 0
        sym = np.asarray(i_p, np.float64)
        epochs_per_sym = 1.0
        msg_seconds = 12.0
    eph, first, tow = cnav.decode_stream(sym, msg_seconds=msg_seconds)
    if not cnav.has_ephemeris(eph) or not np.isfinite(tow):
        return None, -1, np.inf
    return eph, int(phase + first * epochs_per_sym), float(tow)


_GAL_KEPLER_MAP = {"CUC": "C_uc", "CUS": "C_us", "CRC": "C_rc",
                   "CRS": "C_rs", "CIC": "C_ic", "CIS": "C_is",
                   "Omega_0": "omega_0", "OmegaDot": "omegaDot"}


def _normalize_gal(eph: dict) -> dict:
    for src, dst in _GAL_KEPLER_MAP.items():
        if src in eph:
            eph[dst] = eph[src]
    eph.setdefault("T_GD", 0.0)   # BGD applied separately if needed
    return eph


def decode_inav_e1(track, ch, cfg, sig):
    """Galileo E1B: one 4 ms epoch per I/NAV symbol."""
    eph, first, tow = gal.inav_decode_symbol_stream(track.i_p[ch])
    if not gal.inav_has_ephemeris(eph) or not np.isfinite(tow):
        return None, -1, np.inf
    return _normalize_gal(eph), int(first), float(tow)


def decode_inav_e5b(track, ch, cfg, sig):
    """Galileo E5b-I: 1 ms epochs, CS4 secondary per 4 ms symbol."""
    i_p = track.i_p[ch]
    sec = C.E5BI_SECONDARY.astype(np.float64)
    phase = _best_secondary_phase(i_p, sec)
    sym = _symbols_from_epochs(i_p, 4, sec, phase)
    eph, first, tow = gal.inav_decode_symbol_stream(sym)
    if not gal.inav_has_ephemeris(eph) or not np.isfinite(tow):
        return None, -1, np.inf
    return _normalize_gal(eph), int(phase + 4 * first), float(tow)


def decode_fnav(track, ch, cfg, sig):
    """Galileo E5a-I: 1 ms epochs, CS20 secondary per 20 ms symbol
    (GAL_E5a/include/NAVdecoding.m:95-130)."""
    i_p = track.i_p[ch]
    sec = C.E5AI_SECONDARY.astype(np.float64)
    phase = _best_secondary_phase(i_p, sec)
    sym = _symbols_from_epochs(i_p, 20, sec, phase)
    eph, first, tow = gal.fnav_decode_symbol_stream(sym)
    if not gal.fnav_has_ephemeris(eph) or not np.isfinite(tow):
        return None, -1, np.inf
    return _normalize_gal(eph), int(phase + 20 * first), float(tow)


def decode_glonass(track, ch, cfg, sig):
    """GLONASS: 1 ms epochs feed the bi-binary decoder directly."""
    eph, first, tod = glonass_nav.decode_prompt_stream(track.i_p[ch])
    if not glonass_nav.has_ephemeris(eph) or not np.isfinite(tod):
        return None, -1, np.inf
    # adapt state-vector keys for the orbit integrator
    eph.update(x=eph["xDis"], y=eph["yDis"], z=eph["zDis"],
               vx=eph["xVel"], vy=eph["yVel"], vz=eph["zVel"],
               ax=eph["xAcc"], ay=eph["yAcc"], az=eph["zAcc"],
               gamma=eph["gam"])
    return eph, int(first), float(tod)


def decode_bds_d1(track, ch, cfg, sig):
    """BeiDou B1I/B3I D1 (MEO/IGSO) or D2 (GEO PRN<=5)
    (BDS/B1I/include/NAVdecoding.m)."""
    prn = int(track.prns[ch])
    if prn <= 5:
        return _decode_bds_d2(track, ch, cfg, sig)
    i_p = track.i_p[ch]
    sec = C.NH20.astype(np.float64)
    phase = _best_secondary_phase(i_p, sec)
    bits_pm = _symbols_from_epochs(i_p, 20, sec, phase)

    pre_pm = 2.0 * bds_d1.PREAMBLE.astype(np.float64) - 1.0

    def verify(start_bit):
        seg = bits_pm[start_bit:start_bit + 1500]
        if len(seg) < 1500:
            return False
        bits = (seg > 0).astype(np.uint8)
        dec, sow = bds_d1.decode_frame(bits)
        return np.isfinite(sow)

    start = find_preamble(bits_pm, pre_pm, 1, 300, verify)
    if start < 0:
        return None, -1, np.inf
    bits = (bits_pm[start:start + 1500] > 0).astype(np.uint8)
    eph, sow = bds_d1.decode_frame(bits)
    if not bds_d1.has_ephemeris(eph) or not np.isfinite(sow):
        return None, -1, np.inf
    eph["a_f0"] = eph.get("a0", 0.0)
    eph["a_f1"] = eph.get("a1", 0.0)
    eph["a_f2"] = eph.get("a2", 0.0)
    eph["T_GD"] = eph.get("T_GD_1", 0.0)
    return eph, int(phase + 20 * start), float(sow)


def decode_bcnav1(track, ch, cfg, sig):
    """BeiDou B1C: 10 ms epochs; frame sync by the 1800-chip pilot
    secondary over the PILOT prompt, data symbols from the data prompt
    (BCNAV1decoding.m:25-60)."""
    prn = int(track.prns[ch])
    pilot = np.where(np.asarray(track.pilot_ip[ch]) > 0, 1, -1)
    sec = C.b1c_secondary(prn).astype(np.float64)
    data = np.asarray(track.i_p[ch], np.float64)
    n = len(pilot)
    if n < 1800:
        return None, -1, np.inf
    corr = np.correlate(pilot.astype(np.float64), sec, mode="valid")
    eph = {}
    for idx in np.argsort(-np.abs(corr)):
        if np.abs(corr[idx]) < 1750:
            break
        if idx + 1800 > n:
            continue
        ok, dprn, soh = bcnav.bcnav1_decode_frame(
            data[idx:idx + 1800], eph)
        if ok and bcnav.bcnav1_has_ephemeris(eph):
            # SOH counts 18 s frames within the hour; signal time at the
            # frame start = HOW*3600 + SOH... use SOW-equivalent below
            how = eph.get("HOW", 0.0)
            tow = how * 3600.0 + soh
            return eph, int(idx), float(tow)
    return None, -1, np.inf


def decode_bcnav2(track, ch, cfg, sig):
    """BeiDou B2a: 1 ms epochs, NH5 per 5 ms symbol
    (BCNAV2decoding.m:30-95)."""
    i_p = track.i_p[ch]
    sec = C.NH5.astype(np.float64)
    phase = _best_secondary_phase(i_p, sec)
    sym = _symbols_from_epochs(i_p, 5, sec, phase)
    eph, first, sow = bcnav.bcnav2_decode_symbol_stream(sym)
    if not bcnav.bcnav2_has_ephemeris(eph) or not np.isfinite(sow):
        return None, -1, np.inf
    return eph, int(phase + 5 * first), float(sow)


def _decode_bds_d2(track, ch, cfg, sig):
    """BeiDou GEO D2: 2 ms bits, no NH, 0.6 s subframes
    (NAVdecoding.m PRN<=5 branch)."""
    i_p = track.i_p[ch]
    bits_pm = _symbols_from_epochs(i_p, 2)
    pre_pm = 2.0 * bds_d1.PREAMBLE.astype(np.float64) - 1.0

    def verify(start_bit):
        seg = bits_pm[start_bit:start_bit + 150 * 100]
        if len(seg) < 150 * 100:
            return False
        dec, sow = bds_d1.decode_d2_frames(
            (seg > 0).astype(np.uint8))
        return np.isfinite(sow)

    start = find_preamble(bits_pm, pre_pm, 1, 300, verify)
    if start < 0:
        return None, -1, np.inf
    seg = bits_pm[start:]
    eph, sow = bds_d1.decode_d2_frames((seg > 0).astype(np.uint8))
    if not bds_d1.has_d2_ephemeris(eph) or not np.isfinite(sow):
        return None, -1, np.inf
    eph["is_geo"] = True
    return eph, int(2 * start), float(sow)


DECODERS = {
    "lnav": decode_lnav,
    "cnav": decode_cnav,
    "cnav2_l5": decode_cnav,
    "inav": None,        # resolved per signal below
    "fnav": decode_fnav,
    "glonass": decode_glonass,
    "bds_d1": decode_bds_d1,
    "bcnav1": decode_bcnav1,
    "bcnav2": decode_bcnav2,
}


def decode_channel(track, ch, cfg, sig):
    """Dispatch to the signal's nav decoder."""
    codec = sig.nav_codec
    if codec == "inav":
        fn = decode_inav_e1 if sig.name == "gal_e1c" else decode_inav_e5b
    else:
        fn = DECODERS.get(codec)
    if fn is None:
        return None, -1, np.inf
    return fn(track, ch, cfg, sig)
