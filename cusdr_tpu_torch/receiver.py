"""End-to-end receiver pipeline: acquisition → tracking → nav decode → PVT.

Counterpart of cusdr_tpu/receiver.py.  Acquisition and tracking
(sequential, or time-parallel with ``cfg.time_blocks > 1``) run on the
caller's ``device``; nav decode and PVT are the package's numpy layers.
``run_multi`` acquires several signals, one record each, then tracks all
their banks at once (tracking/multi.py).  The LNAV decoder lives here, as
in the reference, and ``nav.dispatch`` reaches it from this module.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from . import resolve_device
from .acquisition.pcps import acquire
from .config import ReceiverConfig
from .constants import SPEED_OF_LIGHT
from .geodesy.transforms import cart2geo, cart2utm, find_utm_zone
from .io.ingest import read_if_file
from .nav import lnav
from .nav.bits import find_preamble
from .orbits.kepler import sat_pos_kepler
from .pvt.lsq import least_square_pos
from .pvt.pseudorange import calculate_pseudoranges, transmit_times
from .runtime.profiling import StageTimer
from .signals.defs import get_signal
from .tracking.engine import track


@dataclass
class NavSolutions:
    """Per-measurement-epoch navigation results."""
    X: List[float] = field(default_factory=list)
    Y: List[float] = field(default_factory=list)
    Z: List[float] = field(default_factory=list)
    dt: List[float] = field(default_factory=list)
    latitude: List[float] = field(default_factory=list)
    longitude: List[float] = field(default_factory=list)
    height: List[float] = field(default_factory=list)
    E: List[float] = field(default_factory=list)
    N: List[float] = field(default_factory=list)
    U: List[float] = field(default_factory=list)
    dop: List[np.ndarray] = field(default_factory=list)
    local_time: List[float] = field(default_factory=list)
    curr_meas_sample: List[int] = field(default_factory=list)
    el: List[np.ndarray] = field(default_factory=list)
    az: List[np.ndarray] = field(default_factory=list)
    utm_zone: int = 0


def decode_nav_channel(track_res, ch: int, cfg, sig):
    """Frame-sync + decode one channel's LNAV message.

    Returns (eph dict or None, subframe_start_epoch, tow_seconds)."""
    i_p = track_res.i_p[ch]
    ms_per_bit = int(round(sig.nav_symbol_ms / sig.code_period_ms))

    def verify(start_ms: int) -> bool:
        # parity of TLM+HOW, using the 2 preceding bits
        seg = i_p[start_ms - 2 * ms_per_bit:
                  start_ms + 60 * ms_per_bit]
        if len(seg) < 62 * ms_per_bit:
            return False
        sums = seg.reshape(62, ms_per_bit).sum(axis=1)
        bits = (sums > 0).astype(np.int8)
        ok1, _ = lnav.check_word(bits[2:32], int(bits[0]), int(bits[1]))
        ok2, _ = lnav.check_word(bits[32:62], int(bits[30]), int(bits[31]))
        if ok1 and ok2:
            return True
        inv = 1 - bits
        ok1, _ = lnav.check_word(inv[2:32], int(inv[0]), int(inv[1]))
        ok2, _ = lnav.check_word(inv[32:62], int(inv[30]), int(inv[31]))
        return ok1 and ok2

    start = find_preamble(i_p, lnav.PREAMBLE, ms_per_bit,
                          lnav.SUBFRAME_MS, verify)
    if start < 0:
        return None, -1, np.inf

    # 1500 bits + 2 preceding for the parity chain
    n_need = (2 + 1500) * ms_per_bit
    seg = i_p[start - 2 * ms_per_bit: start - 2 * ms_per_bit + n_need]
    if len(seg) < n_need:
        return None, -1, np.inf
    sums = seg.reshape(1502, ms_per_bit).sum(axis=1)
    bits = (sums > 0).astype(np.int8)
    # polarity from the preamble sign
    pre = 2 * bits[2:10].astype(np.int8) - 1
    if np.array_equal(pre, -lnav.PREAMBLE):
        bits = 1 - bits
    eph, tow = lnav.decode_frame(bits[2:], int(bits[0]), int(bits[1]))
    if tow is None or not {1, 2, 3} <= eph["idValid"]:
        return None, -1, np.inf
    return eph, start, float(tow)


def sat_pos_for_signal(sig, transmit_time: float, eph: dict):
    """Constellation-appropriate satellite position/clock."""
    from .constants import BDS_GM, BDS_OMEGA_E_DOT
    from .orbits.cnav_kepler import (BDS_A_REF_IGSO_GEO, BDS_A_REF_MEO,
                                     sat_pos_cnav)
    from .orbits.glonass import sat_pos_glonass
    codec = sig.nav_codec
    if codec in ("lnav",):
        return sat_pos_kepler(transmit_time, eph)
    if codec in ("cnav", "cnav2_l5"):
        return sat_pos_cnav(transmit_time, eph)
    if codec in ("inav", "fnav"):
        # Galileo: Keplerian with GTRF constants
        return sat_pos_kepler(transmit_time, eph, gm=3.986004418e14)
    if codec == "glonass":
        return sat_pos_glonass(transmit_time, eph,
                               tau_c=eph.get("tau_c", 0.0))
    if codec == "bds_d1":
        if eph.get("is_geo"):
            from .orbits.kepler import sat_pos_bds_geo
            return sat_pos_bds_geo(transmit_time, eph, BDS_GM,
                                   BDS_OMEGA_E_DOT)
        return sat_pos_kepler(transmit_time, eph, gm=BDS_GM,
                              omega_e_dot=BDS_OMEGA_E_DOT)
    if codec in ("bcnav1", "bcnav2"):
        a_ref = BDS_A_REF_MEO if eph.get("SatType", 3) == 3 \
            else BDS_A_REF_IGSO_GEO
        return sat_pos_cnav(transmit_time, eph, a_ref=a_ref,
                            gm=BDS_GM, omega_e_dot=BDS_OMEGA_E_DOT,
                            isc_key="ISC_B1Cd")
    raise ValueError(f"no orbit model for codec {codec}")


def nav_solve(cfg, sig, track_res) -> Optional[NavSolutions]:
    """Decode all channels, then fix every nav_sol_period_ms."""
    from .nav.dispatch import decode_channel
    n_ch = len(track_res.prns)
    sub_start = np.full(n_ch, -1, np.int64)
    tow = np.full(n_ch, np.inf)
    eph_by_prn: Dict[int, dict] = {}
    active = []
    for ch in range(n_ch):
        eph, start, t = decode_channel(track_res, ch, cfg, sig)
        if eph is not None and eph.get("health", 0) == 0:
            eph_by_prn[track_res.prns[ch]] = eph
            sub_start[ch] = start
            tow[ch] = t
            active.append(ch)
    if len(active) < 4:
        return None

    # per-channel last usable sample (a dropped channel keeps its earlier
    # epochs)
    n_epochs = track_res.abs_sample.shape[1]
    last_sample = np.empty(n_ch, np.int64)
    for ch in range(n_ch):
        au = int(getattr(track_res, "active_until",
                         np.full(n_ch, n_epochs))[ch])
        au = max(au, 1)
        last_sample[ch] = (track_res.abs_sample[ch, au - 1]
                           + track_res.blksize[ch, au - 1])
    sample_start = max(track_res.abs_sample[ch, sub_start[ch]]
                       for ch in active) + 1
    sample_end = max(last_sample[ch] for ch in active) - 1
    step = int(cfg.sampling_freq * cfg.nav_sol_period_ms / 1000)
    n_meas = int((sample_end - sample_start) // step)
    if n_meas < 1:
        return None

    # time-parallel predict mode: mask measurement epochs inside each
    # block's re-convergence transient (parallel/timeblocks.py)
    settle = int(getattr(track_res, "settle_epochs", 0) or 0)
    epb = int(getattr(track_res, "epochs_per_block", 0) or 0)

    sol = NavSolutions()
    local_time = np.inf
    sat_elev = np.full(n_ch, np.inf)
    for m in range(n_meas):
        meas_sample = int(sample_start + step * m)
        chans = [ch for ch in active
                 if sat_elev[ch] >= cfg.elevation_mask_deg
                 and meas_sample < last_sample[ch]]
        if len(chans) < 4:
            continue
        if settle and epb:
            # block boundaries differ across channels by up to a code
            # period, so each channel is tested against its own abs_sample
            # grid; a channel inside a block's transient drops out of this
            # measurement epoch only
            chans = [ch for ch in chans
                     if (int(np.searchsorted(track_res.abs_sample[ch],
                                             meas_sample, side="right"))
                         - 1) % epb >= settle]
            if len(chans) < 4:
                continue
        tx = transmit_times(track_res, chans, sub_start, tow,
                            meas_sample, cfg, sig)
        raw_p, local_time = calculate_pseudoranges(tx, chans, local_time,
                                                   cfg)
        sat_pos = np.zeros((3, len(chans)))
        sat_clk = np.zeros(len(chans))
        for k, ch in enumerate(chans):
            sat_pos[:, k], sat_clk[k] = sat_pos_for_signal(
                sig, tx[ch], eph_by_prn[track_res.prns[ch]])
        obs = raw_p[chans] + sat_clk * SPEED_OF_LIGHT
        xyzdt, el, az, dop = least_square_pos(sat_pos, obs,
                                              cfg.use_trop_corr)
        if not np.all(np.isfinite(xyzdt)):
            continue
        for ch, e in zip(chans, el):
            sat_elev[ch] = e
        local_time -= xyzdt[3] / SPEED_OF_LIGHT
        sol.X.append(xyzdt[0])
        sol.Y.append(xyzdt[1])
        sol.Z.append(xyzdt[2])
        sol.dt.append(0.0 if m == 0 else xyzdt[3])
        sol.dop.append(dop)
        sol.local_time.append(local_time)
        sol.curr_meas_sample.append(meas_sample)
        elv = np.full(n_ch, np.nan)
        azv = np.full(n_ch, np.nan)
        for ch, e, a in zip(chans, el, az):
            elv[ch], azv[ch] = e, a
        sol.el.append(elv)
        sol.az.append(azv)
        lat, lon, h = cart2geo(*xyzdt[:3], 5)
        sol.latitude.append(lat)
        sol.longitude.append(lon)
        sol.height.append(h)
        sol.utm_zone = find_utm_zone(lat, lon)
        e_, n_, u_ = cart2utm(*xyzdt[:3], sol.utm_zone)
        sol.E.append(e_)
        sol.N.append(n_)
        sol.U.append(u_)
    return sol if sol.X else None


def as_interleaved(cfg, samples_iq):
    """A real sample stream (cfg.file_type == 1) as interleaved I/Q with
    Q = 0; interleaved I/Q as it is."""
    if cfg.file_type == 1:
        inter = np.zeros(2 * len(samples_iq), samples_iq.dtype)
        inter[0::2] = samples_iq
        return inter
    return samples_iq


def acquisition_samples(cfg, sig) -> int:
    """Leading samples acquisition reads: the coarse slabs (noncoh *
    coherent periods + 1) and the fine stage (fine_n_codes + 1 periods; 45
    covers the default 40 ms window with margin)."""
    n_coh = max(1, int(round(cfg.acq_coh_time
                             / max(sig.code_period_ms, 1e-9))))
    return (cfg.acq_non_coh_time * n_coh
            + max(cfg.fine_n_codes, 45) + 2) * cfg.samples_per_code


def _acquire_record(cfg, sig, samples_iq, device):
    """Real-branch interleave + acquisition on the leading samples
    (``acquisition_samples``).  Returns (interleaved samples,
    AcquisitionResult)."""
    samples_iq = as_interleaved(cfg, samples_iq)
    n_acq = acquisition_samples(cfg, sig)
    acq_sig = (samples_iq[0:2 * n_acq:2].astype(np.float32)
               + 1j * samples_iq[1:2 * n_acq:2].astype(np.float32))
    return samples_iq, acquire(cfg, sig, acq_sig, device)


def _stage_seconds(timer: StageTimer) -> Dict[str, float]:
    """``ReceiverResults.timings`` from a StageTimer's stages."""
    return {f"{name}_s": rec.seconds for name, rec in timer.stages.items()}


def run_multi(entries, device="cuda", n_ms=None, mesh=None) -> list:
    """Several signals at once, one IF record each, on ``device``.

    entries: sequence of (cfg, samples_iq or None); None reads
    ``cfg.file_name``.  Each signal is acquired on its own, then every
    signal's channel bank is tracked at once (``tracking.multi
    .track_multi``, no lock gate), then nav/PVT solves per signal.
    ``n_ms``: common span, default the least ``cfg.ms_to_process`` given.
    With ``mesh`` the channel banks are tracked with their rows split over
    its 'ch' axis (acquisition and navigation stay on ``device``).
    Returns a list of ReceiverResults, one per entry; each one's timings
    hold its own acquisition and navigation seconds and the seconds of
    the shared tracking stage."""
    from .tracking.multi import track_multi
    device = resolve_device(device)
    staged = []
    for cfg, samples_iq in entries:
        sig = get_signal(cfg.signal)
        if samples_iq is None:
            samples_iq = read_if_file(cfg.file_name, cfg)
        timer = StageTimer(sampling_freq=cfg.sampling_freq, device=device)
        with timer.stage("acquisition",
                         samples=acquisition_samples(cfg, sig)):
            samples_iq, acq = _acquire_record(cfg, sig, samples_iq, device)
        channels = acq.best_channels(cfg.num_channels)
        staged.append((cfg, sig, samples_iq, acq, channels, timer))
    specs = [(c, s, iq, ch) for c, s, iq, _, ch, _ in staged if ch]
    if n_ms is None:
        lims = [c.ms_to_process for c, *_ in staged if c.ms_to_process]
        n_ms = min(lims) if lims else None
    shared = StageTimer(device=device)
    trks = []
    if specs:
        with shared.stage("tracking"):
            trks = (track_multi(specs, n_ms=n_ms, device=device)
                    if mesh is None else
                    track_multi(specs, n_ms=n_ms, mesh=mesh))
    out, ti = [], 0
    for cfg, sig, iq, acq, channels, timer in staged:
        if not channels:
            out.append(ReceiverResults(acq, None, None, [],
                                       _stage_seconds(timer)))
            continue
        trk = trks[ti]
        ti += 1
        timer.stages["tracking"] = shared.stages["tracking"]
        with timer.stage("navigation"):
            nav = nav_solve(cfg, sig, trk)
        out.append(ReceiverResults(acq, trk, nav, channels,
                                   _stage_seconds(timer)))
    return out


@dataclass
class ReceiverResults:
    acq: object
    track: object
    nav: Optional[NavSolutions]
    channels: list
    # host-clock seconds per stage ("acquisition_s", "tracking_s",
    # "navigation_s"), each ended with the device synchronised, so the
    # device work is included (runtime.profiling.StageTimer)
    timings: Dict[str, float] = field(default_factory=dict)


class Receiver:
    """One-signal receiver front to back, on ``device``: the card unless
    the caller asks for another (``"cuda"`` raises where there is none)."""

    def __init__(self, cfg: ReceiverConfig, device="cuda"):
        self.cfg = cfg
        self.sig = get_signal(cfg.signal)
        self.device = resolve_device(device)

    def acquire(self, samples_iq: np.ndarray):
        """Acquisition on the record's leading samples.  Returns (the
        record as interleaved I/Q, AcquisitionResult)."""
        return _acquire_record(self.cfg, self.sig, samples_iq, self.device)

    def track(self, samples_iq: np.ndarray, channels,
              n_epochs: Optional[int] = None):
        """Track ``channels`` through the interleaved record: sequentially,
        or time-parallel with ``cfg.time_blocks > 1`` (n_epochs rounded
        down to a block multiple)."""
        cfg = self.cfg
        if cfg.time_blocks > 1:
            from .parallel.timeblocks import track_time_parallel
            spc = cfg.samples_per_code
            total = len(samples_iq) // 2
            max_phase = max(ch[2] for ch in channels)
            if n_epochs is None:
                n_epochs = int((total - max_phase - 2 * spc) // spc)
            n_epochs = (n_epochs // cfg.time_blocks) * cfg.time_blocks
            return track_time_parallel(
                cfg, self.sig, samples_iq, channels, n_epochs,
                cfg.time_blocks, device=self.device)
        return track(cfg, self.sig, samples_iq, channels, self.device,
                     n_epochs=n_epochs)

    def run(self, samples_iq: Optional[np.ndarray] = None,
            n_epochs: Optional[int] = None) -> ReceiverResults:
        """samples_iq: interleaved I/Q, int8 or int16 (cfg.data_type), or,
        for cfg.file_type == 1, a real sample stream of either type,
        processed as I + j·0 (the carrier mix selects the +IF signal; its
        image at -IF lies outside the correlator's band); None reads
        ``cfg.file_name``."""
        cfg = self.cfg
        if samples_iq is None:
            samples_iq = read_if_file(cfg.file_name, cfg)
        timer = StageTimer(sampling_freq=cfg.sampling_freq,
                           device=self.device)
        with timer.stage("acquisition",
                         samples=acquisition_samples(cfg, self.sig)):
            samples_iq, acq = self.acquire(samples_iq)
        channels = acq.best_channels(cfg.num_channels)
        if not channels:
            return ReceiverResults(acq, None, None, [],
                                   _stage_seconds(timer))
        with timer.stage("tracking", samples=len(samples_iq) // 2):
            track_res = self.track(samples_iq, channels, n_epochs)
        with timer.stage("navigation"):
            nav = nav_solve(cfg, self.sig, track_res)
        return ReceiverResults(acq, track_res, nav, channels,
                               _stage_seconds(timer))
