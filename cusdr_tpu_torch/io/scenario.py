"""Geometrically consistent multi-SV scenario builder.

Creates synthetic broadcast ephemerides, computes Sagnac-consistent signal
delays/Dopplers for a static receiver, and returns SynthSV entries whose
code timing, carrier Doppler and nav-message bits are mutually consistent —
so the full pipeline (acquire → track → decode → PVT) can be validated
against a known receiver position.  This is infrastructure the reference
lacks entirely (SURVEY.md §4: validation was golden IF recordings only).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np

from ..constants import GPS_PI, SPEED_OF_LIGHT
from ..geodesy.transforms import e_r_corr, geo2cart, topocent
from ..orbits.kepler import sat_pos_kepler
from .synth import SynthSV


def make_gps_eph(prn: int, toe: float, *, m0: float, omega0: float,
                 inc_deg: float = 55.0, week: int = 1214) -> dict:
    """A plausible GPS MEO broadcast ephemeris (IS-GPS-200 nominal orbit)."""
    rng = np.random.default_rng(prn)
    return dict(
        weekNumber=float(week), accuracy=0.0, health=0.0,
        IODC=float(prn), IODE_sf2=float(prn), IODE_sf3=float(prn),
        T_GD=float(rng.uniform(-8e-9, 8e-9)),
        t_oc=toe, t_oe=toe,
        a_f2=0.0, a_f1=float(rng.uniform(-2e-12, 2e-12)),
        a_f0=float(rng.uniform(-2e-4, 2e-4)),
        C_rs=float(rng.uniform(-80, 80)), C_rc=float(rng.uniform(150, 350)),
        C_uc=float(rng.uniform(-6e-6, 6e-6)),
        C_us=float(rng.uniform(2e-6, 9e-6)),
        C_ic=float(rng.uniform(-2e-7, 2e-7)),
        C_is=float(rng.uniform(-2e-7, 2e-7)),
        deltan=float(rng.uniform(3.5e-9, 5.5e-9)),
        M_0=m0, e=float(rng.uniform(0.003, 0.02)),
        sqrtA=5153.65 + float(rng.uniform(-1.0, 1.0)),
        omega_0=omega0, omega=float(rng.uniform(-GPS_PI, GPS_PI)),
        omegaDot=-8.1e-9, i_0=np.radians(inc_deg),
        iDot=float(rng.uniform(-8e-10, 8e-10)),
    )


def _signal_delay(eph: dict, rx_ecef: np.ndarray, t_rx: float,
                  satpos_fn=None):
    """Solve τ, clk: signal received at GPS time t_rx was transmitted at
    t_tx = t_rx − τ with the satellite at its t_tx position rotated by
    ωτ (the same physics leastSquarePos.m applies via e_r_corr).

    Returns (tau_seconds, clk_seconds) — clk evaluated at t_tx.
    """
    satpos_fn = satpos_fn or sat_pos_kepler
    tau = 0.075
    clk = 0.0
    for _ in range(5):
        t_tx = t_rx - tau
        pos, clk = satpos_fn(t_tx, eph)
        rng = np.linalg.norm(e_r_corr(tau, pos) - rx_ecef)
        tau = rng / SPEED_OF_LIGHT
    return tau, clk


@dataclass
class Scenario:
    rx_ecef: np.ndarray
    rx_llh: tuple
    tow0: float          # GPS time at sample 0
    frame_t0: float      # GPS time of nav-frame start (multiple of 30 s)
    svs: List[SynthSV]
    eph_by_prn: Dict[int, dict]
    elevations: Dict[int, float]


def make_gps_scenario(cfg, sig, *, n_svs: int = 6,
                      rx_llh=(40.0, -105.26, 1610.0),
                      tow0: float = 351000.0 + 2.0,
                      duration_s: float = 40.0,
                      cn0_dbhz: float = 46.0,
                      min_elev_deg: float = 15.0,
                      nav_frames: int = 3) -> Scenario:
    """Build a consistent L1 C/A scene for a static receiver.

    The nav frame starts at frame_t0 = 30·floor(tow0/30) − 30, so the bit
    stream covers transmit times from before sample 0 through the run.
    """
    rx = np.asarray(geo2cart(*rx_llh, 5))
    frame_t0 = 30.0 * np.floor(tow0 / 30.0) - 30.0
    toe = float(np.round(tow0 / 16.0) * 16.0)   # t_oe near scenario time

    from ..nav import lnav

    svs = []
    eph_by_prn = {}
    elevations = {}
    rng = np.random.default_rng(42)
    prn = 0
    while len(svs) < n_svs and prn < 32:
        prn += 1
        eph = make_gps_eph(
            prn, toe,
            m0=float(rng.uniform(-GPS_PI, GPS_PI)),
            omega0=float(rng.uniform(-GPS_PI, GPS_PI)))
        pos, _ = sat_pos_kepler(tow0, eph)
        _, elev, _ = topocent(rx, pos - rx)
        if elev < min_elev_deg:
            continue

        # quadratic fit of code-time-vs-receiver-time g(t)
        ts = np.asarray([0.0, duration_s / 2.0, duration_s])
        g = np.empty(3)
        for k, dt in enumerate(ts):
            tau, clk = _signal_delay(eph, rx, tow0 + dt)
            g[k] = dt + (tow0 - frame_t0) - tau + clk
        # g(t) = g0 + g1·t + g2·t²
        g2 = (g[0] - 2 * g[1] + g[2]) / (2 * (duration_s / 2.0) ** 2)
        g1 = (g[2] - g[0]) / duration_s - g2 * duration_s
        g0 = g[0]

        fc = sig.carrier_freq_hz
        doppler = (g1 - 1.0) * fc
        doppler_rate = 2.0 * g2 * fc
        code_phase = -g0 * cfg.sampling_freq / g1

        nav_bits = lnav.nav_bit_stream(eph, int(frame_t0),
                                       n_frames=nav_frames)
        svs.append(SynthSV(
            prn=prn, code_phase=float(code_phase),
            doppler_hz=float(doppler), doppler_rate=float(doppler_rate),
            cn0_dbhz=cn0_dbhz,
            carrier_phase=float(rng.uniform(0, 2 * np.pi)),
            nav_bits=nav_bits))
        eph_by_prn[prn] = eph
        elevations[prn] = float(elev)

    if len(svs) < n_svs:
        raise RuntimeError(f"only {len(svs)} SVs above the mask — "
                           "adjust scenario geometry")
    return Scenario(rx_ecef=rx, rx_llh=rx_llh, tow0=tow0,
                    frame_t0=frame_t0, svs=svs, eph_by_prn=eph_by_prn,
                    elevations=elevations)


def make_generic_scenario(cfg, sig, *, eph_factory, satpos_fn,
                          nav_stream_fn, frame_period_s: float,
                          n_svs: int = 6,
                          rx_llh=(40.0, -105.26, 1610.0),
                          tow0: float = 351000.0 + 2.0,
                          duration_s: float = 40.0,
                          cn0_dbhz: float = 46.0,
                          min_elev_deg: float = 15.0,
                          prn_pool=None) -> Scenario:
    """Signal-agnostic consistent scene builder.

    eph_factory(prn, toe, m0, omega0) -> eph dict
    satpos_fn(t, eph) -> (pos, clk)  — the SAME orbit model the receiver
      will use to solve (receiver.sat_pos_for_signal)
    nav_stream_fn(eph, frame_t0) -> ±1 nav symbol stream starting at
      signal time frame_t0
    frame_period_s: nav frame repetition (30 s LNAV/D1, ...)
    """
    rx = np.asarray(geo2cart(*rx_llh, 5))
    frame_t0 = (frame_period_s * np.floor(tow0 / frame_period_s)
                - frame_period_s)
    toe = float(np.round(tow0 / 16.0) * 16.0)

    svs = []
    eph_by_prn = {}
    elevations = {}
    rng = np.random.default_rng(42)
    pool = list(prn_pool) if prn_pool is not None else list(range(1, 33))
    for prn in pool:
        if len(svs) >= n_svs:
            break
        # scenario generation must be total: rejection-sampling one
        # geometry draw per PRN can leave fewer than n_svs visible from
        # a small pool (this errored the L5C e2e fixture) — redraw each
        # PRN's orbit plane until it clears the elevation mask
        for _ in range(64):
            eph = eph_factory(prn, toe,
                              m0=float(rng.uniform(-GPS_PI, GPS_PI)),
                              omega0=float(rng.uniform(-GPS_PI, GPS_PI)))
            pos, _ = satpos_fn(tow0, eph)
            _, elev, _ = topocent(rx, pos - rx)
            if elev >= min_elev_deg:
                break
        else:
            continue
        ts = np.asarray([0.0, duration_s / 2.0, duration_s])
        g = np.empty(3)
        for k, dt in enumerate(ts):
            tau, clk = _signal_delay(eph, rx, tow0 + dt, satpos_fn)
            g[k] = dt + (tow0 - frame_t0) - tau + clk
        g2 = (g[0] - 2 * g[1] + g[2]) / (2 * (duration_s / 2.0) ** 2)
        g1 = (g[2] - g[0]) / duration_s - g2 * duration_s
        g0 = g[0]

        fc = sig.carrier_freq_hz
        svs.append(SynthSV(
            prn=prn, code_phase=float(-g0 * cfg.sampling_freq / g1),
            doppler_hz=float((g1 - 1.0) * fc),
            doppler_rate=float(2.0 * g2 * fc),
            cn0_dbhz=cn0_dbhz,
            carrier_phase=float(rng.uniform(0, 2 * np.pi)),
            nav_bits=nav_stream_fn(eph, frame_t0)))
        eph_by_prn[prn] = eph
        elevations[prn] = float(elev)

    if len(svs) < n_svs:
        raise RuntimeError(f"only {len(svs)} SVs above the mask")
    return Scenario(rx_ecef=rx, rx_llh=rx_llh, tow0=tow0,
                    frame_t0=frame_t0, svs=svs, eph_by_prn=eph_by_prn,
                    elevations=elevations)
