"""The control: the reference put in the program's place, one precision
step below the configuration's (correlations in bfloat16, loop state,
phases and the navigation solution in float32), at the same record and
the same sampled epochs.  Its outputs, judged by ``check_record`` like
the program's, must come out over the limits."""

from __future__ import annotations

import numpy as np

from . import acquisition, nav, tracking
from .check import sample_epochs
from .codecs import codec_of
from .precision import CONTROL


def control_outputs(iq: np.ndarray, prog: dict, sky, s: dict, g: dict,
                    codes, device, rng: np.random.Generator) -> dict:
    """The program's outputs with the control's in their place: its
    acquisition; at each sampled epoch of the program's chain (``rng``
    draws them as ``check_record`` will) its sums and its next state; its
    fixes from the same decoded frames, where the sky sent any."""
    acq = acquisition.acquire(iq, s, g, codes, device, CONTROL)
    out = dict(acq=dict(prns=acq.prns, peak_metric=acq.metric,
                        detected=acq.detected, code_phase=acq.code_phase,
                        carr_freq=acq.carr_freq,
                        coarse_freq=acq.coarse_freq),
               channels=prog["channels"], track=None, fixes={})
    trk = prog["track"]
    if trk is None:
        return out
    trk = {k: (v.copy() if isinstance(v, np.ndarray) else v)
           for k, v in trk.items()}
    chan, ep, _ = sample_epochs(trk, rng)
    r = tracking.recompute(iq, trk, chan, ep,
                           tracking.tables_for(trk, s, g, codes), s, g,
                           device, CONTROL)
    for nm in ("i_e", "q_e", "i_p", "q_p", "i_l", "q_l", "pilot_ip",
               "pilot_qp"):
        if nm in r:
            trk[nm][chan, ep] = r[nm]
    for nm, key in (("carr_freq", "carr_next"), ("code_freq", "code_next"),
                    ("rem_code_phase", "rem_code_next"),
                    ("rem_carr_phase", "rem_carr_next")):
        trk[nm][chan, ep + 1] = r[key]
    out["track"] = trk
    if not sky.eph_by_prn:
        return out
    ms_per_bit = nav.ms_per_bit(g)
    codec = codec_of(g["nav_codec"])
    decoded = {}
    for c in range(len(trk["prns"])):
        got = codec.decode(prog["track"]["i_p"][c], ms_per_bit)
        if got[0] is not None:
            decoded[c] = got
    out["fixes"] = nav.solve(prog["track"], decoded, s, g, CONTROL,
                             codec.pos)
    return out
