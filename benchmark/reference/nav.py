"""Navigation and PVT, worked out again.

Each nav codec (``codecs/<name>.py``) frame-syncs and decodes a
channel's prompt sums and says what a channel should decode to, from the
transmitted message; ``signal_time`` says when, from the sky's geometry;
``solve`` is a frozen copy of the receiver's ``nav_solve``: transmit
times at each measurement sample from the tracking state, pseudoranges,
satellite positions, and the iterative least-squares fix.  In the control
the transmit times are rounded to float32 before the fix.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..frozen.constants import SPEED_OF_LIGHT
from ..frozen.kepler import sat_pos_kepler
from ..frozen.lsq import least_square_pos
from ..frozen.pseudorange import calculate_pseudoranges, transmit_times
from .precision import Precision


def ms_per_bit(g: dict) -> int:
    """Epochs (code periods) per nav symbol."""
    return int(round(g["nav_symbol_ms"]
                     / (1e3 * g["code_length_chips"] / g["chip_rate_hz"])))


class _Track:
    """The tracking arrays ``transmit_times`` reads, as attributes."""

    def __init__(self, trk: dict):
        for k in ("prns", "abs_sample", "code_freq", "rem_code_phase",
                  "blksize"):
            setattr(self, k, trk[k])


class _Sig:
    def __init__(self, g: dict):
        self.code_length_chips = g["code_length_chips"]
        self.chip_rate_hz = g["chip_rate_hz"]


class _Cfg:
    def __init__(self, s: dict):
        self.sampling_freq = s["sampling_freq"]
        self.start_offset_ms = s["start_offset_ms"]


def signal_time(sv, frame_t0: float, sample: int, s: dict, g: dict):
    """Signal time [s] of ``sv`` received at ``sample``: its chip count
    since the frame start over the chip rate, plus the frame start."""
    fs = s["sampling_freq"]
    t = sample / fs
    chip = ((sample - sv.code_phase) * g["chip_rate_hz"]
            * (1.0 + sv.doppler_hz / g["carrier_freq_hz"]) / fs
            + 0.5 * g["chip_rate_hz"] * sv.doppler_rate
            / g["carrier_freq_hz"] * t * t)
    return frame_t0 + chip / g["chip_rate_hz"]


def solve(trk: dict, decoded: Dict[int, tuple], s: dict, g: dict,
          prec: Precision, pos_fn=sat_pos_kepler):
    """Fixes from the tracking arrays and each channel's (eph, subframe
    start, TOW) in ``decoded`` (channel -> tuple; channels missing or with
    no eph do not take part).  Returns {measurement sample: xyz [3]}."""
    n_ch = len(trk["prns"])
    sub_start = np.full(n_ch, -1, np.int64)
    tow = np.full(n_ch, np.inf)
    eph_by_ch, active = {}, []
    for ch in range(n_ch):
        eph, start, t = decoded.get(ch, (None, -1, np.inf))
        if eph is not None and eph.get("health", 0) == 0:
            eph_by_ch[ch], sub_start[ch], tow[ch] = eph, start, t
            active.append(ch)
    if len(active) < 4:
        return {}
    n_epochs = trk["abs_sample"].shape[1]
    last = np.empty(n_ch, np.int64)
    for ch in range(n_ch):
        au = max(int(trk["active_until"][ch]), 1)
        last[ch] = trk["abs_sample"][ch, au - 1] + trk["blksize"][ch, au - 1]
    first = max(trk["abs_sample"][ch, sub_start[ch]] for ch in active) + 1
    end = max(last[ch] for ch in active) - 1
    step = int(s["sampling_freq"] * s["nav_sol_period_ms"] / 1000)
    n_meas = int((end - first) // step)
    track, sig, cfg = _Track(trk), _Sig(g), _Cfg(s)
    fixes = {}
    local_time = np.inf
    elev = np.full(n_ch, np.inf)
    for m in range(max(n_meas, 0)):
        meas = int(first + step * m)
        chans = [ch for ch in active
                 if elev[ch] >= s["elevation_mask_deg"] and meas < last[ch]]
        if len(chans) < 4:
            continue
        tx = prec.state(transmit_times(track, chans, sub_start, tow, meas,
                                       cfg, sig))
        raw, local_time = calculate_pseudoranges(tx, chans, local_time, cfg)
        pos = np.zeros((3, len(chans)))
        clk = np.zeros(len(chans))
        for j, ch in enumerate(chans):
            pos[:, j], clk[j] = pos_fn(tx[ch], eph_by_ch[ch])
        xyzdt, el, _, _ = least_square_pos(pos, raw[chans]
                                           + clk * SPEED_OF_LIGHT,
                                           s["use_trop_corr"])
        if not np.all(np.isfinite(xyzdt)):
            continue
        for ch, e in zip(chans, el):
            elev[ch] = e
        local_time -= xyzdt[3] / SPEED_OF_LIGHT
        fixes[meas] = np.asarray(xyzdt[:3])
    return fixes
