"""Galileo spreading codes: E1B/E1C memory codes (+BOC(1,1)), E5a/E5b I/Q.

E1 primary codes are ICD memory codes (Galileo OS SIS ICD Annex C), stored
bit-packed in data/gal_e1.npz.  E5 codes are register pairs per OS SIS ICD
§3.3; behavior matches GAL/GAL_E5a/include/generateE5aIcode.m and siblings,
including chip-sign and BOC expansion conventions
(generateE1Bcode.m:58-65, generatePilotBOC11-style orderings).
"""

from __future__ import annotations

import functools

import numpy as np

from .lfsr import dual_shift_left_lfsr, int_to_bits
from .tables import load_table

# Feedback tap words (octal) for the two E5 base registers
# (generateE5aIcode.m:55-57, generateE5bIcode.m:56-57).
_E5_TAPS = {
    "e5a": (0o40503, 0o50661),
    "e5b": (0o64021, 0o51445),
}


def _taps_mask(word: int) -> np.ndarray:
    """Top 14 bits of the octal tap word, MSB first
    (generateE5aIcode.m:62-68)."""
    nbits = word.bit_length()
    return int_to_bits(word, nbits)[:14]


def _e5_code(band: str, table_key: str, prn: int) -> np.ndarray:
    if not 1 <= prn <= 50:
        raise ValueError(f"E5 PRN {prn} outside 1..50")
    t1, t2 = (_taps_mask(w) for w in _E5_TAPS[band])
    init = int(load_table("gal_e5")[table_key][prn - 1])
    # Start value occupies the low bits of the 14-cell register
    # (generateE5aIcode.m:70-76).
    init_bits = int_to_bits(init, 14)
    bits = dual_shift_left_lfsr(14, t1, t2, init_bits, 10230)
    return (1 - 2 * bits.astype(np.int8))


@functools.lru_cache(maxsize=None)
def e5ai(prn: int) -> np.ndarray:
    """E5a data primary code, 10230 ±1 chips @ 10.23 Mcps."""
    return _e5_code("e5a", "e5ai_init", prn)


@functools.lru_cache(maxsize=None)
def e5aq(prn: int) -> np.ndarray:
    """E5a pilot primary code."""
    return _e5_code("e5a", "e5aq_init", prn)


@functools.lru_cache(maxsize=None)
def e5bi(prn: int) -> np.ndarray:
    """E5b data primary code."""
    return _e5_code("e5b", "e5bi_init", prn)


@functools.lru_cache(maxsize=None)
def e5bq(prn: int) -> np.ndarray:
    """E5b pilot primary code."""
    return _e5_code("e5b", "e5bq_init", prn)


def _hex_to_chips(hexstr: str, nbits: int) -> np.ndarray:
    """Hex string -> ±1 chips, MSB first, bit 1 -> -1
    (generateE5aQ_secondary.m tail)."""
    val = int(hexstr, 16)
    bits = np.asarray([(val >> (nbits - 1 - i)) & 1 for i in range(nbits)],
                      dtype=np.int8)
    return 1 - 2 * bits


@functools.lru_cache(maxsize=None)
def e5aq_secondary(prn: int) -> np.ndarray:
    """CS100 secondary code for E5a-Q: 100 ±1 chips (OS SIS ICD table 19)."""
    if not 1 <= prn <= 50:
        raise ValueError(f"E5 PRN {prn} outside 1..50")
    hexstr = str(load_table("gal_e5")["e5aq_sec"][prn - 1])
    return _hex_to_chips(hexstr, 100)


@functools.lru_cache(maxsize=None)
def e5bq_secondary(prn: int) -> np.ndarray:
    """CS100 secondary code for E5b-Q."""
    hexstr = str(load_table("gal_e5")["e5bq_sec"][prn - 1])
    return _hex_to_chips(hexstr, 100)


# E5a-I secondary CS20 '842E9' (generateE5aIcode.m tail); E5b-I CS4 'E'
E5AI_SECONDARY = _hex_to_chips("842E9", 20)
E5BI_SECONDARY = _hex_to_chips("E", 4)

# E1C secondary CS25_1 (Galileo OS SIS ICD; GAL_E1C/include/acquisition.m:138)
E1C_SECONDARY = np.asarray(
    [1, 1, -1, -1, -1, 1, 1, 1, 1, 1, 1, 1, -1, 1, -1, 1, -1, -1, 1, -1,
     -1, 1, 1, -1, 1], dtype=np.int8)


@functools.lru_cache(maxsize=None)
def _e1_primary(which: str, prn: int) -> np.ndarray:
    if not 1 <= prn <= 50:
        raise ValueError(f"E1 PRN {prn} outside 1..50")
    packed = load_table("gal_e1")[which][prn - 1]
    bits = np.unpackbits(packed)[:4092]
    return (1 - 2 * bits.astype(np.int8))


def e1b_primary(prn: int) -> np.ndarray:
    """E1B data primary memory code, 4092 ±1 chips (bit 1 -> -1)."""
    return _e1_primary("e1b", prn)


def e1c_primary(prn: int) -> np.ndarray:
    """E1C pilot primary memory code."""
    return _e1_primary("e1c", prn)


def boc11(chips: np.ndarray, first_sign: int) -> np.ndarray:
    """Expand chips with a BOC(1,1) square subcarrier into half-chips.

    first_sign=+1 gives [+c, -c] (E1B convention, generateE1Bcode.m:58-65);
    first_sign=-1 gives [-c, +c] (B1C convention, generatePilotBOC11.m:88-95).
    """
    out = np.empty(chips.size * 2, dtype=np.int8)
    out[0::2] = first_sign * chips
    out[1::2] = -first_sign * chips
    return out


@functools.lru_cache(maxsize=None)
def e1b(prn: int) -> np.ndarray:
    """E1B with BOC(1,1): 8184 ±1 half-chips."""
    return boc11(e1b_primary(prn), +1)


@functools.lru_cache(maxsize=None)
def e1c(prn: int) -> np.ndarray:
    """E1C with BOC(1,1): 8184 ±1 half-chips (generateE1Ccode.m)."""
    return boc11(e1c_primary(prn), +1)
