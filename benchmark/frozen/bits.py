"""Bit/frame synchronization utilities shared by all nav codecs.

Reference: GPS/GPS_L1CA/include/NAVdecoding.m:63-152 — threshold prompt
correlators, correlate with an upsampled preamble, verify spacing and
word parity.
"""

from __future__ import annotations

import numpy as np


def find_preamble(i_p: np.ndarray, preamble_bits: np.ndarray,
                  ms_per_bit: int, spacing_ms: int,
                  verify) -> int:
    """Locate the first verified preamble in the prompt stream.

    i_p: per-ms (per-epoch) prompt correlators
    preamble_bits: ±1 pattern
    spacing_ms: required preamble repetition distance (6000 ms for LNAV,
      NAVdecoding.m:110-112)
    verify: callable(start_ms) -> bool, extra check (e.g. parity of the
      first two words)

    Returns 0-based ms index of preamble start, or -1.
    """
    bits = np.where(np.asarray(i_p) > 0, 1, -1).astype(np.float64)
    pattern = np.kron(np.asarray(preamble_bits, np.float64),
                      np.ones(ms_per_bit))
    # full cross-correlation; index i = pattern aligned at ms i
    corr = np.correlate(bits, pattern, mode="full")[len(pattern) - 1:]
    thresh = len(pattern) * 0.95
    candidates = np.where(np.abs(corr) > thresh)[0]
    # exclude boundaries (NAVdecoding.m:98-100)
    lo = 2 * ms_per_bit
    hi = len(bits) - spacing_ms - len(pattern)
    candidates = candidates[(candidates >= lo) & (candidates < hi)]
    cand_set = set(candidates.tolist())
    for c in candidates:
        if (c + spacing_ms) in cand_set or (c - spacing_ms) in cand_set:
            if verify(int(c)):
                return int(c)
    return -1
