"""Galileo F/NAV on E5a-I: the CS20 secondary code's phase, 20 ms
symbols, and the pages' ephemeris (frozen copy of nav/dispatch.py's
``decode_fnav``)."""

from __future__ import annotations

import numpy as np

from ...frozen import galileo_nav as gal
from ...frozen.codes import E5AI_SECONDARY
from ...frozen.kepler import sat_pos_kepler
from ...traffic.scenario import GAL_GM, gal_kepler

NEVER = 30_000
ALWAYS = 52_000
SKIP = ("idValid", "TOW", "TOW_raw")


def decode(i_p: np.ndarray, ms_per_bit: int):
    """(eph, first page's start epoch, its TOW) of one channel's E5a-I
    prompt sums: the CS20 secondary code's phase, 20 ms symbols, F/NAV
    pages; or (None, -1, inf)."""
    x = np.asarray(i_p, np.float64)
    sec = E5AI_SECONDARY.astype(np.float64)
    m = len(sec)
    n_sym = (len(x) - m) // m
    energy = [np.abs((x[p:p + n_sym * m].reshape(-1, m) * sec).sum(1)).sum()
              for p in range(m)]
    phase = int(np.argmax(energy))
    y = x[phase:]
    n = (len(y) // ms_per_bit) * ms_per_bit
    sym = (y[:n].reshape(-1, ms_per_bit) * sec[None, :]).sum(axis=1)
    eph, first, tow = gal.fnav_decode_symbol_stream(sym)
    if not gal.fnav_has_ephemeris(eph) or not np.isfinite(tow):
        return None, -1, np.inf
    return gal_kepler(eph), int(phase + ms_per_bit * first), float(tow)


def broadcast(eph: dict, tow: float) -> dict:
    """``eph`` encoded in pages 1-4 (fields quantized to their scale) and
    decoded again."""
    pages = [gal.fnav_encode_page(1 + i % 4, eph, tow_raw=int(tow) + 10 * i)
             for i in range(5)]
    got, _, _ = gal.fnav_decode_symbol_stream(
        1.0 - 2.0 * np.concatenate(pages))
    return gal_kepler(got)


def pos(t, eph):
    return sat_pos_kepler(t, eph, gm=GAL_GM)
