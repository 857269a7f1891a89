"""BeiDou spreading codes: B1I, B3I, B2a data/pilot, B1C Weil codes.

Algorithms per BDS-SIS-ICD (B1I/B3I/B2a/B1C); behavior matches the reference
generators (BDS/B1I/include/generateCAcode.m, generateCAcode53.m,
BDS/B3I/include/generateB3Icode.m, BDS/B2a/include/generateB2a*Code.m,
BDS/B1C/include/generate*BOC*.m, generate2ndCode.m) including chip-sign and
BOC expansion conventions.  Per-PRN constants are ICD data in data/bds_*.npz.
"""

from __future__ import annotations

import functools

import numpy as np

from .lfsr import fibonacci_lfsr, int_to_bits
from .tables import load_table

# BDS B1I/B3I G1/G2 initial state 01010101010 (generateCAcode.m:44,57)
_B1I_INIT = (0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0)


@functools.lru_cache(maxsize=None)
def _b1i_g1() -> np.ndarray:
    return fibonacci_lfsr(11, (1, 7, 8, 9, 10, 11), 11, 2046,
                          init_bits=_B1I_INIT)


@functools.lru_cache(maxsize=None)
def b1i(prn: int) -> np.ndarray:
    """B1I ranging code: 2046 ±1 chips @ 2.046 Mcps; bit 1 -> +1.

    PRN 1-37 use two G2 phase taps (generateCAcode.m:60-71); PRN 38-63 add a
    third tap (generateCAcode53.m:79-90).
    """
    t = load_table("bds_b1i")
    if not 1 <= prn <= len(t["g2s1"]):
        raise ValueError(f"B1I PRN {prn} outside ICD phase-assignment table "
                         f"(1..{len(t['g2s1'])})")
    if prn <= 37:
        out_taps = (int(t["g2s1"][prn - 1]), int(t["g2s2"][prn - 1]))
    else:
        out_taps = (int(t["g2s1"][prn - 1]), int(t["g2s2"][prn - 1]),
                    int(t["g2s3"][prn - 38]))
    g2 = fibonacci_lfsr(11, (1, 2, 3, 4, 5, 8, 9, 11), 0, 2046,
                        init_bits=_B1I_INIT, out_taps=out_taps)
    bits = _b1i_g1() ^ g2
    return (2 * bits.astype(np.int8) - 1)


# --- B3I --------------------------------------------------------------------

# CA short-cycles at 8190 via reset state 1111111111001
# (generateB3Icode.m:46-53).
_B3I_CA_RESET = (1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0)


@functools.lru_cache(maxsize=None)
def _b3i_ca() -> np.ndarray:
    return fibonacci_lfsr(13, (1, 3, 4, 13), 13, 10230,
                          reset_state=_B3I_CA_RESET)


@functools.lru_cache(maxsize=None)
def b3i(prn: int) -> np.ndarray:
    """B3I ranging code: 10230 ±1 chips @ 10.23 Mcps (bit 1 -> -1 per
    register convention, code = CA^CB)."""
    if not 1 <= prn <= 63:
        raise ValueError(f"B3I PRN {prn} outside 1..63")
    adv = int(load_table("bds_b3i")["cb_init"][prn - 1])
    cb = fibonacci_lfsr(13, (1, 5, 6, 7, 9, 10, 12, 13), 13, 10230,
                        advance=adv)
    bits = _b3i_ca() ^ cb
    return (1 - 2 * bits.astype(np.int8))


# --- B2a --------------------------------------------------------------------

def _b2a(prn: int, which: str) -> np.ndarray:
    """B2a data/pilot: two 13-stage registers; reg1 resets to all-ones after
    chip 8190 (generateB2aDataCode.m:104-137)."""
    if not 1 <= prn <= 63:
        raise ValueError(f"B2a PRN {prn} outside 1..63")
    t = load_table("bds_b2a")
    if which == "data":
        taps1, taps2 = (1, 5, 11, 13), (3, 5, 9, 11, 12, 13)
        init2 = t["data_reg2"][prn - 1]
    else:
        taps1, taps2 = (3, 6, 7, 13), (1, 5, 7, 8, 12, 13)
        init2 = t["pilot_reg2"][prn - 1]
    r1 = fibonacci_lfsr(13, taps1, 13, 10230)
    # reg1 is reset to all-ones AFTER emitting chip 8190: the remaining
    # 2040 chips replay the start of its natural sequence.
    r1[8190:] = r1[:2040]
    r2 = fibonacci_lfsr(13, taps2, 13, 10230, init_bits=init2)
    bits = r1 ^ r2
    return (1 - 2 * bits.astype(np.int8))


@functools.lru_cache(maxsize=None)
def b2a_data(prn: int) -> np.ndarray:
    """B2a data component primary code: 10230 ±1 chips @ 10.23 Mcps."""
    return _b2a(prn, "data")


@functools.lru_cache(maxsize=None)
def b2a_pilot(prn: int) -> np.ndarray:
    """B2a pilot component primary code."""
    return _b2a(prn, "pilot")


# --- B1C (Weil codes from Legendre sequences) -------------------------------

@functools.lru_cache(maxsize=None)
def _legendre_bits(N: int) -> np.ndarray:
    """L(k)=1 if k is a quadratic residue mod prime N, else 0; L(0)=0
    (generatePilotBOC11.m:62-69 via JacobiSymbol)."""
    bits = np.zeros(N, dtype=np.uint8)
    k = np.arange(1, N, dtype=np.int64)
    bits[np.unique((k * k) % N)] = 1
    bits[0] = 0
    return bits


def _weil(N: int, w: int, p: int, length: int) -> np.ndarray:
    """Truncated Weil sequence: out[i] = L((i+p-1)%N) ^ L((i+p-1+w)%N)
    (generatePilotBOC11.m:74-82)."""
    L = _legendre_bits(N)
    k = (np.arange(length, dtype=np.int64) + p - 1) % N
    return L[k] ^ L[(k + w) % N]


def _b1c_primary_chips(prn: int, key: str) -> np.ndarray:
    if not 1 <= prn <= 63:
        raise ValueError(f"B1C PRN {prn} outside 1..63")
    wp = load_table("bds_b1c")[key][prn - 1]
    w, p = int(wp[0]), int(wp[1])
    bits = _weil(10243, w, p, 10230)
    return (1 - 2 * bits.astype(np.int8))


@functools.lru_cache(maxsize=None)
def b1c_data_primary(prn: int) -> np.ndarray:
    """B1C data primary Weil code, 10230 ±1 chips @ 1.023 Mcps."""
    return _b1c_primary_chips(prn, "data_wp")


@functools.lru_cache(maxsize=None)
def b1c_pilot_primary(prn: int) -> np.ndarray:
    """B1C pilot primary Weil code."""
    return _b1c_primary_chips(prn, "pilot_wp")


@functools.lru_cache(maxsize=None)
def b1c_secondary(prn: int) -> np.ndarray:
    """B1C pilot secondary Weil code: 1800 ±1 chips, N=3607
    (generate2ndCode.m:60-82)."""
    if not 1 <= prn <= 63:
        raise ValueError(f"B1C PRN {prn} outside 1..63")
    wp = load_table("bds_b1c")["sec_wp"][prn - 1]
    w, p = int(wp[0]), int(wp[1])
    bits = _weil(3607, w, p, 1800)
    return (1 - 2 * bits.astype(np.int8))


def boc11_b1c(chips: np.ndarray) -> np.ndarray:
    """B1C BOC(1,1) expansion: each chip -> [-c, +c]
    (generatePilotBOC11.m:88-95)."""
    out = np.empty(chips.size * 2, dtype=np.int8)
    out[0::2] = -chips
    out[1::2] = chips
    return out


def boc61_b1c(chips: np.ndarray) -> np.ndarray:
    """B1C pilot BOC(6,1) expansion: chip -> 12 half-cycles (-1)^i * c,
    i=1..12 (generatePilotBOC61.m:89-96)."""
    signs = np.asarray([(-1) ** i for i in range(1, 13)], dtype=np.int8)
    return (chips[:, None] * signs[None, :]).reshape(-1)


@functools.lru_cache(maxsize=None)
def b1c_data_boc11(prn: int) -> np.ndarray:
    """B1C data with BOC(1,1): 20460 ±1 half-chips."""
    return boc11_b1c(b1c_data_primary(prn))


@functools.lru_cache(maxsize=None)
def b1c_pilot_boc11(prn: int) -> np.ndarray:
    """B1C pilot with BOC(1,1): 20460 ±1 half-chips."""
    return boc11_b1c(b1c_pilot_primary(prn))


@functools.lru_cache(maxsize=None)
def b1c_pilot_boc61(prn: int) -> np.ndarray:
    """B1C pilot with BOC(6,1): 122760 ±1 twelfth-chips (QMBOC wideband
    component, WB_tracking.m:176-188)."""
    return boc61_b1c(b1c_pilot_primary(prn))


# NH20 secondary code (B1I D1 NAV / L5 / B3I; BDS-SIS-ICD §5.1.3)
NH20 = np.asarray([1, 1, 1, 1, 1, -1, 1, 1, -1, -1,
                   1, -1, 1, -1, 1, 1, -1, -1, -1, 1], dtype=np.int8)

# NH10 used by L5 I component (IS-GPS-705: Neuman-Hofman 10)
NH10 = np.asarray([1, 1, 1, 1, -1, 1, -1, 1, 1, -1], dtype=np.int8)

# B2a data NH5 (BCNAV2decoding.m:69)
NH5 = np.asarray([1, 1, 1, -1, 1], dtype=np.int8)
