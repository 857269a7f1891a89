"""Skies from a seed: a geometric GPS sky with LNAV frames (after
cusdr_tpu_torch/io/scenario.py's ``make_gps_scenario``, whose ephemeris
and delay model are copied here), its Galileo counterpart with F/NAV
pages (after ``make_generic_scenario``), and a snapshot sky of SVs at
random code phases and Dopplers with random nav bits (chip_smoke.py's
phase 4 scene).

Every seed gives the same amount of work: a geometric sky always holds
``n_svs`` SVs above the mask, a snapshot sky ``n_svs`` distinct PRNs."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

from ..frozen import galileo_nav, lnav
from ..frozen.constants import GPS_PI, SPEED_OF_LIGHT
from ..frozen.kepler import sat_pos_kepler
from ..frozen.transforms import e_r_corr, geo2cart, topocent
from .synth import SV

L1_HZ = 1575.42e6
E5A_HZ = 1176.45e6
GAL_GM = 3.986004418e14
RX_LLH = (40.0, -105.26, 1610.0)


def rng_of(seed: int, *stream: int) -> np.random.Generator:
    """A numpy generator for ``seed`` (any whole number) and a stream."""
    return np.random.default_rng([int(seed) % (1 << 63), *stream])


def make_gps_eph(prn: int, toe: float, *, m0: float, omega0: float,
                 inc_deg: float = 55.0, week: int = 1214) -> dict:
    """A plausible GPS MEO broadcast ephemeris (IS-GPS-200 nominal
    orbit); copied from cusdr_tpu_torch/io/scenario.py."""
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


def make_gal_eph(prn: int, toe: float, *, m0: float,
                 omega0: float) -> dict:
    """A plausible Galileo MEO broadcast ephemeris under its F/NAV names,
    with the Keplerian names the orbit model reads beside them."""
    rng = np.random.default_rng(1000 + prn)
    eph = dict(
        SVID=float(prn), IODnav1=57.0, IODnav2=57.0, IODnav3=57.0,
        IODnav4=57.0, t_oc=toe, t_oe=toe, WN=1200.0, E5a_HS=0.0,
        a_f0=float(rng.uniform(-5e-4, 5e-4)),
        a_f1=float(rng.uniform(-5e-12, 5e-12)), a_f2=0.0,
        a_i0=30.0, a_i1=0.1, a_i2=0.001,
        BGD_E1E5a=float(rng.uniform(-5e-9, 5e-9)),
        M_0=m0, e=float(rng.uniform(2e-4, 2e-3)),
        sqrtA=5440.588 + float(rng.uniform(-0.5, 0.5)),
        Omega_0=omega0, OmegaDot=-5.5e-9,
        i_0=float(np.radians(56.0) + rng.uniform(-0.01, 0.01)),
        omega=float(rng.uniform(-GPS_PI, GPS_PI)),
        iDot=float(rng.uniform(-5e-10, 5e-10)),
        deltan=float(rng.uniform(2.5e-9, 3.5e-9)),
        CUC=float(rng.uniform(-4e-6, 4e-6)),
        CUS=float(rng.uniform(2e-6, 9e-6)),
        CRC=float(rng.uniform(150, 300)), CRS=float(rng.uniform(-80, 80)),
        CIC=float(rng.uniform(-1e-7, 1e-7)),
        CIS=float(rng.uniform(-1e-7, 1e-7)),
        A0=0.0, A1=0.0, delt_LS=18.0, t_ot=0.0)
    return gal_kepler(eph)


_GAL_KEPLER = {"CUC": "C_uc", "CUS": "C_us", "CRC": "C_rc", "CRS": "C_rs",
               "CIC": "C_ic", "CIS": "C_is", "Omega_0": "omega_0",
               "OmegaDot": "omegaDot"}


def gal_kepler(eph: dict) -> dict:
    """``eph`` with the Keplerian names beside the F/NAV ones (and no
    group delay), as the receiver's orbit model reads a Galileo ephemeris
    (nav/dispatch.py's ``_normalize_gal``)."""
    for src, dst in _GAL_KEPLER.items():
        if src in eph:
            eph[dst] = eph[src]
    eph.setdefault("T_GD", 0.0)
    return eph


def gal_pos(t: float, eph: dict):
    """Galileo SV position and clock: the Keplerian model with Galileo's
    GM."""
    return sat_pos_kepler(t, eph, gm=GAL_GM)


def fnav_stream(eph: dict, frame_t0: float, n_pages: int) -> np.ndarray:
    """+-1 F/NAV symbols of pages 1, 2, 3, 4, 1, ... from signal time
    ``frame_t0``, each page's TOW its start."""
    pages = [galileo_nav.fnav_encode_page(1 + i % 4, eph,
                                          tow_raw=int(frame_t0) + 10 * i)
             for i in range(n_pages)]
    return 1 - 2 * np.concatenate(pages).astype(np.int8)


def _signal_delay(eph: dict, rx_ecef: np.ndarray, t_rx: float,
                  pos_fn=sat_pos_kepler):
    """(travel time, SV clock) of the signal received at ``t_rx``, with
    the SV at its transmit-time position rotated by the earth's turn."""
    tau, clk = 0.075, 0.0
    for _ in range(5):
        pos, clk = pos_fn(t_rx - tau, eph)
        tau = np.linalg.norm(e_r_corr(tau, pos) - rx_ecef) / SPEED_OF_LIGHT
    return tau, clk


@dataclass
class Sky:
    """The SVs of a record and what the reference needs of their truth:
    the receiver, the nav frame start (signal time of chip 0 of every
    SV's nav stream) and the broadcast ephemerides (empty for a snapshot
    sky)."""
    svs: List[SV]
    rx_ecef: np.ndarray = None
    frame_t0: float = 0.0
    eph_by_prn: Dict[int, dict] = field(default_factory=dict)


def _geometric_sky(seed: int, *, fs: float, n_svs: int, duration_s: float,
                   cn0_dbhz: float, prns, frame_s: float, carrier_hz: float,
                   toe_s: float, make_eph, pos_fn, nav_fn,
                   min_elev_deg: float = 15.0) -> Sky:
    """``n_svs`` SVs of ``prns`` above the mask seen from a static receiver
    at a time of week drawn from ``seed``, orbits drawn from ``seed``: code
    timing, Doppler and its rate fitted to the geometry over
    ``duration_s``, nav symbols ``nav_fn(eph, frame_t0)`` from the frame
    boundary ``frame_s`` before the record; the ephemerides' reference
    time on the nav message's ``toe_s`` grid."""
    rng = rng_of(seed, 0)
    rx = np.asarray(geo2cart(*RX_LLH, 5))
    tow0 = float(np.round(rng.uniform(86_400.0, 518_400.0), 3))
    frame_t0 = frame_s * np.floor(tow0 / frame_s) - frame_s
    toe = float(np.round(tow0 / toe_s) * toe_s)
    svs, ephs = [], {}
    for prn in rng.permutation(np.asarray(prns)):
        if len(svs) == n_svs:
            break
        prn = int(prn)
        for _ in range(64):
            eph = make_eph(prn, toe,
                           m0=float(rng.uniform(-GPS_PI, GPS_PI)),
                           omega0=float(rng.uniform(-GPS_PI, GPS_PI)))
            pos, _ = pos_fn(tow0, eph)
            if topocent(rx, pos - rx)[1] >= min_elev_deg:
                break
        else:
            continue
        ts = np.asarray([0.0, duration_s / 2.0, duration_s])
        g = np.empty(3)
        for k, dt in enumerate(ts):
            tau, clk = _signal_delay(eph, rx, tow0 + dt, pos_fn)
            g[k] = dt + (tow0 - frame_t0) - tau + clk
        # code time since the frame start: g0 + g1 t + g2 t^2
        g2 = (g[0] - 2 * g[1] + g[2]) / (2 * (duration_s / 2.0) ** 2)
        g1 = (g[2] - g[0]) / duration_s - g2 * duration_s
        svs.append(SV(
            prn=prn, code_phase=float(-g[0] * fs / g1),
            doppler_hz=float((g1 - 1.0) * carrier_hz),
            doppler_rate=float(2.0 * g2 * carrier_hz), cn0_dbhz=cn0_dbhz,
            carrier_phase=float(rng.uniform(0, 2 * np.pi)),
            nav_bits=nav_fn(eph, frame_t0)))
        ephs[prn] = eph
    if len(svs) < n_svs:
        raise RuntimeError(f"only {len(svs)} SVs above the mask")
    return Sky(svs=svs, rx_ecef=rx, frame_t0=float(frame_t0),
               eph_by_prn=ephs)


def gps_sky(seed: int, *, fs: float, n_svs: int, duration_s: float,
            cn0_dbhz: float, nav_frames: int) -> Sky:
    """A geometric GPS sky (PRNs 1-32) with LNAV frames over
    ``nav_frames`` x 30 s from the 30 s frame boundary before the
    record."""
    return _geometric_sky(
        seed, fs=fs, n_svs=n_svs, duration_s=duration_s, cn0_dbhz=cn0_dbhz,
        prns=np.arange(1, 33), frame_s=30.0, carrier_hz=L1_HZ, toe_s=16.0,
        make_eph=make_gps_eph, pos_fn=sat_pos_kepler,
        nav_fn=lambda eph, t0: lnav.nav_bit_stream(eph, int(t0),
                                                   n_frames=nav_frames))


def galileo_sky(seed: int, *, fs: float, n_svs: int, duration_s: float,
                cn0_dbhz: float, prns, nav_pages: int) -> Sky:
    """A geometric Galileo sky (``prns``) on E5a with F/NAV pages 1-4
    repeated, ``nav_pages`` x 10 s from the 40 s boundary before the
    record."""
    return _geometric_sky(
        seed, fs=fs, n_svs=n_svs, duration_s=duration_s, cn0_dbhz=cn0_dbhz,
        prns=prns, frame_s=40.0, carrier_hz=E5A_HZ, toe_s=60.0,
        make_eph=make_gal_eph,
        pos_fn=gal_pos,
        nav_fn=lambda eph, t0: fnav_stream(eph, t0, nav_pages))


def snapshot_sky(seed: int, capture: int, *, samples_per_code: int,
                 prns, n_svs: int, cn0_dbhz: float, seconds: float,
                 nav_symbol_ms: float, doppler_hz: float) -> Sky:
    """``n_svs`` distinct PRNs of ``prns`` at code phases uniform over a
    code period, Dopplers uniform within +-``doppler_hz``, random carrier
    phases and nav symbols: capture ``capture`` of the pool of ``seed``."""
    rng = rng_of(seed, 1, capture)
    n_bits = int(seconds * 1000 / nav_symbol_ms) + 2
    svs = [SV(prn=int(p),
              code_phase=float(rng.uniform(0, samples_per_code - 1)),
              doppler_hz=float(rng.uniform(-doppler_hz, doppler_hz)),
              cn0_dbhz=cn0_dbhz,
              carrier_phase=float(rng.uniform(0, 2 * np.pi)),
              nav_bits=rng.choice([-1.0, 1.0], n_bits))
           for p in rng.choice(np.asarray(prns), n_svs, replace=False)]
    return Sky(svs=svs)
