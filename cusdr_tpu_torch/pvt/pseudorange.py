"""Pseudorange formation from tracking results.

Behavioral equivalent of Common/calculatePseudoranges.m: at a chosen
measurement sample, each channel's transmit time is reconstructed from the
epoch that contains the sample (remCodePhase + codeFreq extrapolation) and
the epoch count since the decoded frame start; local receiver time is
initialized at first fix from max(transmitTime) + startOffset.
"""

from __future__ import annotations

import numpy as np

from ..constants import SPEED_OF_LIGHT


def transmit_times(track, chans, subframe_start_epoch, tow,
                   curr_meas_sample: int, cfg, sig) -> np.ndarray:
    """Transmit time [s] per channel at ``curr_meas_sample``
    (calculatePseudoranges.m:67-92).

    track: TrackResults; chans: channel indices; subframe_start_epoch[ch]:
    epoch index of frame start (0-based); tow[ch]: TOW [s] at that epoch.
    """
    out = np.full(len(track.prns), np.inf)
    code_period = sig.code_length_chips / sig.chip_rate_hz
    for ch in chans:
        abs_sample = track.abs_sample[ch]
        # epoch whose block contains the measurement sample
        idx = int(np.searchsorted(abs_sample, curr_meas_sample,
                                  side="right")) - 1
        step = track.code_freq[ch, idx] / cfg.sampling_freq
        code_phase = (track.rem_code_phase[ch, idx]
                      + step * (curr_meas_sample - abs_sample[idx]))
        out[ch] = ((code_phase / sig.code_length_chips
                    + idx - subframe_start_epoch[ch]) * code_period
                   + tow[ch])
    return out


def calculate_pseudoranges(tx_times: np.ndarray, chans, local_time: float,
                           cfg):
    """(pseudoranges [m], updated local_time)
    (calculatePseudoranges.m:94-104)."""
    if not np.isfinite(local_time):
        local_time = np.max(tx_times[chans]) + cfg.start_offset_ms / 1000.0
    rho = (local_time - tx_times) * SPEED_OF_LIGHT
    return rho, local_time
