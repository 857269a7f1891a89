"""Stage-level checkpointing: acquisition / tracking / navigation results.

The port's copy of cusdr_tpu/checkpoint.py: the same files, so either
package reads the other's.  Only the channel-state pair differs, which
moves the port's torch tensors (``load_channel_state`` takes a device).

Equivalent of the reference's .mat handoffs
(GPS/GPS_L1CA/include/postProcessing.m:101,125,135 save("acqResults"),
save("trkResults"), save("navResults")) plus skipAcquisition-style resume
(postProcessing.m:80).  Everything is stored as compressed .npz.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from .acquisition.pcps import AcquisitionResult


def save_acquisition(path, acq: AcquisitionResult):
    extra = {}
    if acq.pilot_phase is not None:
        extra["pilot_phase"] = acq.pilot_phase
    np.savez_compressed(path, prns=acq.prns, carr_freq=acq.carr_freq,
                        code_phase=acq.code_phase,
                        peak_metric=acq.peak_metric,
                        detected=acq.detected,
                        coarse_freq=acq.coarse_freq, **extra)


def load_acquisition(path) -> AcquisitionResult:
    d = np.load(path)
    return AcquisitionResult(prns=d["prns"], carr_freq=d["carr_freq"],
                             code_phase=d["code_phase"],
                             peak_metric=d["peak_metric"],
                             detected=d["detected"],
                             coarse_freq=d["coarse_freq"],
                             pilot_phase=(d["pilot_phase"]
                                          if "pilot_phase" in d.files
                                          else None))


def save_tracking(path, track_res):
    arrays = {k: getattr(track_res, k) for k in (
        "i_e", "q_e", "i_p", "q_p", "i_l", "q_l", "pilot_ip", "pilot_qp",
        "carr_freq", "code_freq", "dll_discr", "dll_filt", "pll_discr",
        "pll_filt", "rem_code_phase", "rem_carr_phase", "abs_sample",
        "blksize")}
    arrays["prns"] = np.asarray(track_res.prns)
    cno_len = max((len(v) for v in track_res.cno.values()), default=0)
    cno = np.full((len(track_res.prns), cno_len), np.nan)
    for ch, v in track_res.cno.items():
        cno[ch, :len(v)] = v
    arrays["cno"] = cno
    np.savez_compressed(path, **arrays)


def load_tracking(path, cfg):
    from .tracking.engine import TrackResults
    d = np.load(path)
    merged = {k: d[k] for k in d.files if k not in ("prns", "cno")}
    # TrackResults expects [n_epochs, C] transposed inputs; stored [C, E]
    transposed = {k: v.T for k, v in merged.items()}
    res = TrackResults(d["prns"].tolist(), {k: v for k, v in
                                            merged.items()}, cfg)
    return res


def save_navigation(path, nav):
    data = {k: np.asarray(getattr(nav, k)) for k in (
        "X", "Y", "Z", "dt", "latitude", "longitude", "height",
        "E", "N", "U", "local_time", "curr_meas_sample")}
    data["dop"] = np.asarray(nav.dop)
    data["el"] = np.asarray(nav.el)
    data["az"] = np.asarray(nav.az)
    data["utm_zone"] = np.asarray(nav.utm_zone)
    np.savez_compressed(path, **data)


def save_channel_state(path, state):
    """Persist the live tracking carry (per-time-block checkpoint of the
    channel-state pytree, SURVEY.md §5 build note); the port's tensors are
    read back from their device."""
    arrays = {f: getattr(state, f).cpu().numpy() for f in state._fields}
    np.savez_compressed(path, **arrays)


def load_channel_state(path, device):
    """The channel state saved by ``save_channel_state`` (by this package
    or the reference's) as the port's ``ChannelState``: torch tensors on
    ``device``, in the engine's dtypes (f64 loop state, int64 abs_sample,
    int32 pilot_period, bool active)."""
    import torch
    from .tracking.engine import ChannelState
    dtypes = {"abs_sample": torch.int64, "pilot_period": torch.int32,
              "active": torch.bool}
    d = np.load(path)
    return ChannelState(**{
        f: torch.as_tensor(d[f], dtype=dtypes.get(f, torch.float64),
                           device=device)
        for f in ChannelState._fields})
