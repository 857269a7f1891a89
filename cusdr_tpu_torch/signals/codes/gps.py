"""GPS spreading codes: L1 C/A, L2 CM/CL, L5 I/Q.

Algorithms implemented from IS-GPS-200/IS-GPS-705 semantics; behavior matches
the reference generators (GPS/GPS_L1CA/include/generateCAcode.m,
GPS/GPS_L2C/include/generateL2Ccode.m, GPS/GPS_L5C/include/generateL5Icode.m)
including chip-sign conventions.  Per-PRN constants are ICD data loaded from
``data/gps_*.npz``.
"""

from __future__ import annotations

import functools

import numpy as np

from .lfsr import fibonacci_lfsr, galois_lfsr, int_to_bits
from .tables import load_table

# IS-GPS-200 table 3-I: G2 delay per PRN (1-32), then WAAS/EGNOS PRNs
# 120-138 mapped to indices 33-51 (generateCAcode.m:42-50).
G2_DELAYS = (
    5, 6, 7, 8, 17, 18, 139, 140, 141, 251,
    252, 254, 255, 256, 257, 258, 469, 470, 471, 472,
    473, 474, 509, 512, 513, 514, 515, 516, 859, 860,
    861, 862,
    # SBAS (true PRN = index + 87)
    145, 175, 52, 21, 237, 235, 886, 657,
    634, 762, 355, 1012, 176, 603, 130, 359, 595, 68,
    386,
)


@functools.lru_cache(maxsize=None)
def _g1_g2():
    g1 = fibonacci_lfsr(10, (3, 10), 10, 1023)
    g2 = fibonacci_lfsr(10, (2, 3, 6, 8, 9, 10), 10, 1023)
    return g1, g2


@functools.lru_cache(maxsize=None)
def l1ca(prn: int) -> np.ndarray:
    """GPS L1 C/A code: 1023 ±1 chips (int8); bit 1 -> +1.

    PRN 1..32 (GPS) or 33..51 (SBAS, true PRN = prn+87).
    """
    if not 1 <= prn <= len(G2_DELAYS):
        raise ValueError(f"L1 C/A PRN {prn} outside 1..{len(G2_DELAYS)}")
    g1, g2 = _g1_g2()
    shift = G2_DELAYS[prn - 1]
    bits = g1 ^ np.roll(g2, shift)
    return (2 * bits.astype(np.int8) - 1)


def _l2c_shift_pos(prn: int) -> int:
    if 1 <= prn <= 63:
        return prn - 1
    if 159 <= prn <= 210:
        return prn - 96
    raise ValueError(f"L2C PRN {prn} does not exist")


@functools.lru_cache(maxsize=None)
def l2cm(prn: int) -> np.ndarray:
    """GPS L2 CM code: 10230 ±1 chips (bit 1 -> -1), NOT return-to-zero."""
    init = int(load_table("gps_l2c")["cm_init"][_l2c_shift_pos(prn)])
    bits = galois_lfsr(27, (4, 7, 9, 12, 15, 17, 19, 22, 23, 24, 25),
                       int_to_bits(init, 27), 10230)
    return (1 - 2 * bits.astype(np.int8))


@functools.lru_cache(maxsize=4)
def l2cl(prn: int) -> np.ndarray:
    """GPS L2 CL code: 767250 ±1 chips (bit 1 -> -1), NOT return-to-zero."""
    init = int(load_table("gps_l2c")["cl_init"][_l2c_shift_pos(prn)])
    bits = galois_lfsr(27, (4, 7, 9, 12, 15, 17, 19, 22, 23, 24, 25),
                       int_to_bits(init, 27), 767250)
    return (1 - 2 * bits.astype(np.int8))


def l2cm_rz(prn: int) -> np.ndarray:
    """Time-multiplexed return-to-zero CM: chips at even slots, zeros at odd
    (generateCMcode.m tail)."""
    cm = l2cm(prn)
    out = np.zeros(2 * cm.size, dtype=np.int8)
    out[0::2] = cm
    return out


def l2cl_rz(prn: int) -> np.ndarray:
    """Return-to-zero CL: zeros at even slots, chips at odd
    (generateCLcode.m tail)."""
    cl = l2cl(prn)
    out = np.zeros(2 * cl.size, dtype=np.int8)
    out[1::2] = cl
    return out


# --- GPS L5 (IS-GPS-705) ----------------------------------------------------

_XA_TAPS = (9, 10, 12, 13)
_XB_TAPS = (1, 3, 4, 6, 7, 8, 12, 13)
# XA short-cycles: when the register hits this state it resets to all-ones,
# giving an 8190-chip period (generateL5Icode.m:52-57).
_XA_RESET = (1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 1)


@functools.lru_cache(maxsize=None)
def _l5_xa() -> np.ndarray:
    return fibonacci_lfsr(13, _XA_TAPS, 13, 10230, reset_state=_XA_RESET)


def _l5(prn: int, component: str) -> np.ndarray:
    if not 1 <= prn <= 210:
        raise ValueError(f"L5 PRN {prn} outside 1..210")
    key = "i_advance" if component == "I" else "q_advance"
    adv = int(load_table("gps_l5")[key][prn - 1])
    xb = fibonacci_lfsr(13, _XB_TAPS, 13, 10230, advance=adv)
    bits = _l5_xa() ^ xb
    return (1 - 2 * bits.astype(np.int8))


@functools.lru_cache(maxsize=None)
def l5i(prn: int) -> np.ndarray:
    """GPS L5 data code: 10230 ±1 chips @ 10.23 Mcps."""
    return _l5(prn, "I")


@functools.lru_cache(maxsize=None)
def l5q(prn: int) -> np.ndarray:
    """GPS L5 pilot code: 10230 ±1 chips @ 10.23 Mcps."""
    return _l5(prn, "Q")
