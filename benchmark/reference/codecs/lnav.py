"""GPS LNAV: frame sync on the preamble of a channel's prompt sums,
parity, and the subframes' ephemeris (frozen copy of
cusdr_tpu_torch/receiver.py's ``decode_nav_channel``)."""

from __future__ import annotations

import numpy as np

from ...frozen import lnav
from ...frozen.bits import find_preamble
from ...frozen.kepler import sat_pos_kepler

NEVER = 30_000 + 40
ALWAYS = 36_000 + 240
SKIP = ("idValid", "TOW")


def decode(i_p: np.ndarray, ms_per_bit: int):
    """(eph, subframe start epoch, TOW [s]) of one channel's prompt sums,
    or (None, -1, inf)."""

    def verify(start: int) -> bool:
        seg = i_p[start - 2 * ms_per_bit:start + 60 * ms_per_bit]
        if len(seg) < 62 * ms_per_bit:
            return False
        bits = (seg.reshape(62, ms_per_bit).sum(axis=1) > 0).astype(np.int8)
        for b in (bits, 1 - bits):
            ok1, _ = lnav.check_word(b[2:32], int(b[0]), int(b[1]))
            ok2, _ = lnav.check_word(b[32:62], int(b[30]), int(b[31]))
            if ok1 and ok2:
                return True
        return False

    start = find_preamble(i_p, lnav.PREAMBLE, ms_per_bit, lnav.SUBFRAME_MS,
                          verify)
    if start < 0:
        return None, -1, np.inf
    n_need = 1502 * ms_per_bit
    seg = i_p[start - 2 * ms_per_bit:start - 2 * ms_per_bit + n_need]
    if len(seg) < n_need:
        return None, -1, np.inf
    bits = (seg.reshape(1502, ms_per_bit).sum(axis=1) > 0).astype(np.int8)
    pre = 2 * bits[2:10].astype(np.int8) - 1
    if np.array_equal(pre, -lnav.PREAMBLE):
        bits = 1 - bits
    eph, tow = lnav.decode_frame(bits[2:], int(bits[0]), int(bits[1]))
    if tow is None or not {1, 2, 3} <= eph["idValid"]:
        return None, -1, np.inf
    return eph, start, float(tow)


def broadcast(eph: dict, tow: float) -> dict:
    """``eph`` encoded in a frame (fields quantized to their scale) and
    decoded again."""
    got, _ = lnav.decode_frame(lnav.encode_frame(eph, int(tow)))
    return got


def pos(t, eph):
    return sat_pos_kepler(t, eph)
