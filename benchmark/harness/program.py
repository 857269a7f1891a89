"""The system under test, cusdr_tpu_torch, as the harness drives it: a
configuration built from a cell's configuration file, its receiver on the
device, and its results as plain arrays for the reference."""

from __future__ import annotations

import numpy as np

_TRACK_FIELDS = ("i_e", "q_e", "i_p", "q_p", "i_l", "q_l", "pilot_ip",
                 "pilot_qp", "carr_freq", "code_freq", "rem_code_phase",
                 "rem_carr_phase", "abs_sample", "blksize", "dll_discr",
                 "pll_discr")


def receiver(config: dict, device):
    """``Receiver(cfg, device)`` of the configuration's preset with every
    setting the file holds."""
    from cusdr_tpu_torch.config import CNoConfig, get_config
    from cusdr_tpu_torch.receiver import Receiver
    settings = dict(config["settings"])
    for k, v in settings.items():
        if isinstance(v, list):
            settings[k] = tuple(v)
    cno = settings.pop("cno", None)
    cfg = get_config(config["preset"]).replace(**settings)
    if cno is not None:
        cfg = cfg.replace(cno=CNoConfig(**cno))
    return Receiver(cfg, device=device)


def plain(res) -> dict:
    """A ReceiverResults as the reference reads it."""
    a = res.acq
    acq = dict(prns=np.asarray(a.prns), peak_metric=np.asarray(a.peak_metric),
               detected=np.asarray(a.detected),
               code_phase=np.asarray(a.code_phase),
               carr_freq=np.asarray(a.carr_freq),
               coarse_freq=np.asarray(a.coarse_freq))
    trk = None
    if res.track is not None:
        t = res.track
        trk = {k: np.asarray(getattr(t, k)) for k in _TRACK_FIELDS}
        trk["prns"] = np.asarray(t.prns)
        trk["active_until"] = np.asarray(t.active_until)
    fixes = {}
    if res.nav is not None:
        n = res.nav
        fixes = {int(m): np.asarray([x, y, z]) for m, x, y, z in
                 zip(n.curr_meas_sample, n.X, n.Y, n.Z)}
    return dict(acq=acq, channels=list(res.channels), track=trk,
                fixes=fixes, timings=dict(res.timings))


def work(res) -> dict:
    """What the record asked of the tracking kernel, from its shapes: rows,
    epochs, valid epochs and samples, and the span of the record that its
    windows cover."""
    if res.track is None:
        return dict(rows=0, epochs=0, valid_epochs=0, valid_samples=0,
                    span=0)
    bsz = np.asarray(res.track.blksize)
    first = np.asarray(res.track.abs_sample)
    valid = bsz > 0
    span = int((first + bsz)[valid].max() - first[valid].min()) \
        if valid.any() else 0
    return dict(rows=int(bsz.shape[0]), epochs=int(bsz.shape[1]),
                valid_epochs=int(valid.sum()),
                valid_samples=int(bsz.sum()), span=span)
