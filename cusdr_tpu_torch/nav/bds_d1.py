"""BeiDou D1 navigation message codec (B1I/B3I MEO/IGSO, 50 bps + NH20).

Mirrors BDS/B1I/include/NAVdecoding.m + ephemeris.m (PRN 6-58 branch):
11-bit preamble, 30-bit words where words 2-10 carry two bit-interleaved
BCH(15,11) half-words (ephemeris.m:246-266 deinterleave), subframes 1-3
hold clock/ephemeris fields with split bit segments, SOW spans words 1-2.
Includes the matching encoder for loopback synthesis.
"""

from __future__ import annotations

import numpy as np

from ..constants import GPS_PI as BDS_PI
from .bitfields import get_bits, put_bits

PREAMBLE = np.asarray([1, 1, 1, 0, 0, 0, 1, 0, 0, 1, 0], np.uint8)

# --- BCH(15,11), g(x) = x^4 + x + 1 ----------------------------------------

_G = 0b10011


def _bch15_syndrome(word15: int) -> int:
    reg = 0
    for k in range(14, -1, -1):
        reg = (reg << 1) ^ ((word15 >> k) & 1)
        if reg & 0x10:
            reg ^= _G
    return reg & 0xF


def bch15_encode(data11: int) -> int:
    """11 data bits -> 15-bit codeword (systematic, parity in low 4)."""
    shifted = data11 << 4
    return shifted | _bch15_syndrome(shifted)


def bch15_decode(word15: int):
    """Single-error-correcting decode; returns (data11, ok)."""
    syn = _bch15_syndrome(word15)
    if syn == 0:
        return word15 >> 4, True
    for pos in range(15):
        if _bch15_syndrome(1 << pos) == syn:
            word15 ^= (1 << pos)
            return word15 >> 4, True
    return word15 >> 4, False


# --- interleaving -----------------------------------------------------------

def _deinterleave_word(w30: np.ndarray) -> np.ndarray:
    """Transmitted word -> [d1(11) d2(11) p1(4) p2(4)]
    (ephemeris.m:248-254)."""
    return np.concatenate([w30[0:22:2], w30[1:22:2],
                           w30[22:30:2], w30[23:30:2]])


def _interleave_word(d: np.ndarray) -> np.ndarray:
    """Inverse of _deinterleave_word."""
    out = np.empty(30, np.uint8)
    out[0:22:2] = d[0:11]
    out[1:22:2] = d[11:22]
    out[22:30:2] = d[22:26]
    out[23:30:2] = d[26:30]
    return out


# --- field tables (deinterleaved subframe coordinates, 1-based) -------------
# (name, ((start,len),...), scale_exp, signed, factor) — ephemeris.m:306-359

_SF1 = [
    ("SatH1", ((43, 1),), 0, False, 1.0),
    ("IODC", ((44, 5),), 0, False, 1.0),
    ("URAI", ((49, 4),), 0, False, 1.0),
    ("WN", ((61, 13),), 0, False, 1.0),
    ("t_oc", ((74, 9), (91, 8)), 3, False, 1.0),
    ("T_GD_1", ((99, 10),), 0, True, 1e-10),
    ("alpha0", ((127, 8),), -30, True, 1.0),
    ("alpha1", ((135, 8),), -27, True, 1.0),
    ("alpha2", ((151, 8),), -24, True, 1.0),
    ("alpha3", ((159, 8),), -24, True, 1.0),
    ("beta0", ((167, 6), (181, 2)), 11, True, 1.0),
    ("beta1", ((183, 8),), 14, True, 1.0),
    ("beta2", ((191, 8),), 16, True, 1.0),
    ("beta3", ((199, 4), (211, 4)), 16, True, 1.0),
    ("a2", ((215, 11),), -66, True, 1.0),
    ("a0", ((226, 7), (241, 17)), -33, True, 1.0),
    ("a1", ((258, 5), (271, 17)), -50, True, 1.0),
    ("IODE", ((288, 5),), 0, False, 1.0),
]
_SF2 = [
    ("deltan", ((43, 10), (61, 6)), -43, True, BDS_PI),
    ("C_uc", ((67, 16), (91, 2)), -31, True, 1.0),
    ("M_0", ((93, 20), (121, 12)), -31, True, BDS_PI),
    ("e", ((133, 10), (151, 22)), -33, False, 1.0),
    ("C_us", ((181, 18),), -31, True, 1.0),
    ("C_rc", ((199, 4), (211, 14)), -6, True, 1.0),
    ("C_rs", ((225, 8), (241, 10)), -6, True, 1.0),
    ("sqrtA", ((251, 12), (271, 20)), -19, False, 1.0),
    ("t_oe_msb", ((291, 2),), 0, False, 1.0),
]
_SF3 = [
    ("t_oe_lsb", ((43, 10), (61, 5)), 0, False, 1.0),
    ("i_0", ((66, 17), (91, 15)), -31, True, BDS_PI),
    ("C_ic", ((106, 7), (121, 11)), -31, True, 1.0),
    ("omegaDot", ((132, 11), (151, 13)), -43, True, BDS_PI),
    ("C_is", ((164, 9), (181, 9)), -31, True, 1.0),
    ("iDot", ((190, 13), (211, 1)), -43, True, BDS_PI),
    ("omega_0", ((212, 21), (241, 11)), -31, True, BDS_PI),
    ("omega", ((252, 11), (271, 21)), -31, True, BDS_PI),
]
_FIELDS = {1: _SF1, 2: _SF2, 3: _SF3}


def _get_segs(bits, segs):
    val = 0
    nbits = 0
    for start, n in segs:
        val = (val << n) | get_bits(bits, start, n)
        nbits += n
    return val, nbits


def _twos(v, n):
    return v - (1 << n) if v >= (1 << (n - 1)) else v


def decode_subframe(sub300: np.ndarray, eph: dict):
    """Decode one deinterleaved, BCH-corrected 300-bit subframe.

    Returns (subframe_id, sow_of_this_subframe)."""
    sfid = get_bits(sub300, 16, 3)
    sow = (get_bits(sub300, 19, 8) << 12) | get_bits(sub300, 31, 12)
    if sfid in _FIELDS:
        for name, segs, exp, signed, factor in _FIELDS[sfid]:
            raw, nbits = _get_segs(sub300, segs)
            if signed:
                raw = _twos(raw, nbits)
            eph[name] = raw * (2.0 ** exp) * factor
        eph.setdefault("idValid", set()).add(sfid)
    return sfid, sow


def finalize_eph(eph: dict):
    """Combine split t_oe (ephemeris.m:357-362)."""
    if "t_oe_msb" in eph and "t_oe_lsb" in eph:
        eph["t_oe"] = (int(eph["t_oe_msb"]) * (1 << 15)
                       + int(eph["t_oe_lsb"])) * 8.0
    return eph


def encode_subframe(sfid: int, eph: dict, sow: int) -> np.ndarray:
    """Build one transmitted 300-bit D1 subframe (interleaved, BCH
    parities, preamble)."""
    sub = np.zeros(300, np.uint8)
    sub[0:11] = PREAMBLE
    put_bits(sub, 16, 3, sfid)
    put_bits(sub, 19, 8, sow >> 12)
    put_bits(sub, 31, 12, sow & 0xFFF)
    for name, segs, exp, signed, factor in _FIELDS.get(sfid, []):
        nbits = sum(n for _, n in segs)
        raw = int(round(eph.get(name, 0.0) / factor / (2.0 ** exp)))
        if raw < 0:
            raw += (1 << nbits)
        pos = nbits
        for start, n in segs:
            pos -= n
            put_bits(sub, start, n, (raw >> pos) & ((1 << n) - 1))
    # word 1: BCH over bits 16-26 -> parity 27-30
    cw = bch15_encode(get_bits(sub, 16, 11))
    put_bits(sub, 16, 15, cw)
    # words 2-10: two BCH(15,11) halves; parities at +22..+30
    out = sub.copy()
    for w in range(1, 10):
        base = 30 * w
        d1 = get_bits(sub, base + 1, 11)
        d2 = get_bits(sub, base + 12, 11)
        c1 = bch15_encode(d1)
        c2 = bch15_encode(d2)
        deint = np.zeros(30, np.uint8)
        put_bits(deint, 1, 11, d1)
        put_bits(deint, 12, 11, d2)
        put_bits(deint, 23, 4, c1 & 0xF)
        put_bits(deint, 27, 4, c2 & 0xF)
        out[base:base + 30] = _interleave_word(deint)
    return out


def decode_frame(bits1500: np.ndarray, eph: dict | None = None):
    """Decode 5 transmitted subframes (NAVdecoding.m + ephemeris.m flow).

    Returns (eph, sow_of_first_subframe)."""
    eph = {} if eph is None else eph
    bits = np.asarray(bits1500, np.uint8)
    if np.array_equal(bits[:11], 1 - PREAMBLE):
        bits = 1 - bits
    elif not np.array_equal(bits[:11], PREAMBLE):
        return eph, np.inf
    sow_first = np.inf
    for i in range(5):
        sub = bits[300 * i:300 * (i + 1)].copy()
        # deinterleave words 2-10
        desub = sub.copy()
        ok = True
        for w in range(1, 10):
            base = 30 * w
            desub[base:base + 30] = _deinterleave_word(sub[base:base + 30])
            d1, ok1 = bch15_decode((get_bits(desub, base + 1, 11) << 4)
                                   | get_bits(desub, base + 23, 4))
            d2, ok2 = bch15_decode((get_bits(desub, base + 12, 11) << 4)
                                   | get_bits(desub, base + 27, 4))
            put_bits(desub, base + 1, 11, d1)
            put_bits(desub, base + 12, 11, d2)
            ok = ok and ok1 and ok2
        w1, ok1 = bch15_decode(get_bits(desub, 16, 15))
        put_bits(desub, 16, 11, w1)
        if not (ok and ok1):
            continue
        sfid, sow = decode_subframe(desub, eph)
        if np.isinf(sow_first) and 1 <= sfid <= 5:
            sow_first = sow - 6 * i
    finalize_eph(eph)
    eph["SOW"] = sow_first
    return eph, sow_first


def has_ephemeris(eph: dict) -> bool:
    return {1, 2, 3} <= eph.get("idValid", set())


# ===========================================================================
# D2 NAV (GEO, PRN 1-5, 500 bps): ephemeris split over 10 pages of
# subframe 1 (ephemeris.m:95-220 GEO branch)
# ===========================================================================

# page -> [(name, ((start,len),...), exp, signed, factor)] with *_msb/_lsb
# partial fields combined in finalize_d2
_D2_PAGES = {
    1: [("SatH1", ((47, 1),), 0, False, 1.0),
        ("IODC", ((48, 5),), 0, False, 1.0),
        ("URAI", ((61, 4),), 0, False, 1.0),
        ("WN", ((65, 13),), 0, False, 1.0),
        ("t_oc", ((78, 5), (91, 12)), 3, False, 1.0),
        ("T_GD_1", ((103, 10),), 0, True, 1e-10)],
    2: [("alpha0", ((47, 6), (61, 2)), -30, True, 1.0),
        ("alpha1", ((63, 8),), -27, True, 1.0),
        ("alpha2", ((71, 8),), -24, True, 1.0),
        ("alpha3", ((79, 4), (91, 4)), -24, True, 1.0),
        ("beta0", ((95, 8),), 11, True, 1.0),
        ("beta1", ((103, 8),), 14, True, 1.0),
        ("beta2", ((111, 2), (121, 6)), 16, True, 1.0),
        ("beta3", ((127, 8),), 16, True, 1.0)],
    3: [("a0", ((101, 12), (121, 12)), -33, True, 1.0),
        ("a1_msb", ((133, 4),), 0, False, 1.0)],
    4: [("a1_lsb", ((47, 6), (61, 12)), 0, False, 1.0),
        ("a2", ((73, 10), (91, 1)), -66, True, 1.0),
        ("IODE", ((92, 5),), 0, False, 1.0),
        ("deltan", ((97, 16),), -43, True, BDS_PI),
        ("C_uc_msb", ((121, 14),), 0, False, 1.0)],
    5: [("C_uc_lsb", ((47, 4),), 0, False, 1.0),
        ("M_0", ((51, 2), (61, 22), (91, 8)), -31, True, BDS_PI),
        ("C_us", ((99, 14), (121, 4)), -31, True, 1.0),
        ("e_msb", ((125, 10),), 0, False, 1.0)],
    6: [("e_lsb", ((47, 6), (61, 16)), 0, False, 1.0),
        ("sqrtA", ((77, 6), (91, 22), (121, 4)), -19, False, 1.0),
        ("C_ic_msb", ((125, 10),), 0, False, 1.0)],
    7: [("C_ic_lsb", ((47, 6), (61, 2)), 0, False, 1.0),
        ("C_is", ((63, 18),), -31, True, 1.0),
        ("t_oe", ((81, 2), (91, 15)), 3, False, 1.0),
        ("i_0_msb", ((106, 7), (121, 14)), 0, False, 1.0)],
    8: [("i_0_lsb", ((47, 6), (61, 5)), 0, False, 1.0),
        ("C_rc", ((66, 17), (91, 1)), -6, True, 1.0),
        ("C_rs", ((92, 18),), -6, True, 1.0),
        ("omegaDot_msb", ((110, 3), (121, 16)), 0, False, 1.0)],
    9: [("omegaDot_lsb", ((47, 5),), 0, False, 1.0),
        ("omega_0", ((52, 1), (61, 22), (91, 9)), -31, True, BDS_PI),
        ("omega_msb", ((100, 13), (121, 14)), 0, False, 1.0)],
    10: [("omega_lsb", ((47, 5),), 0, False, 1.0),
         ("iDot", ((52, 1), (61, 13)), -43, True, BDS_PI)],
}

# (msb_name, lsb_name, out_name, total_bits, exp, signed, factor)
_D2_SPLITS = [
    ("a1_msb", "a1_lsb", "a1", (4, 18), -50, True, 1.0),
    ("C_uc_msb", "C_uc_lsb", "C_uc", (14, 4), -31, True, 1.0),
    ("e_msb", "e_lsb", "e", (10, 22), -33, False, 1.0),
    ("C_ic_msb", "C_ic_lsb", "C_ic", (10, 8), -31, True, 1.0),
    ("i_0_msb", "i_0_lsb", "i_0", (21, 11), -31, True, BDS_PI),
    ("omegaDot_msb", "omegaDot_lsb", "omegaDot", (19, 5), -43, True,
     BDS_PI),
    ("omega_msb", "omega_lsb", "omega", (27, 5), -31, True, BDS_PI),
]


def decode_d2_subframe(sub300: np.ndarray, eph: dict):
    """Decode one deinterleaved D2 subframe; returns (sfid, pnum, sow)."""
    sfid = get_bits(sub300, 16, 3)
    sow = (get_bits(sub300, 19, 8) << 12) | get_bits(sub300, 31, 12)
    pnum = 0
    if sfid == 1:
        pnum = get_bits(sub300, 43, 4)
        for name, segs, exp, signed, factor in _D2_PAGES.get(pnum, []):
            raw, nbits = _get_segs(sub300, segs)
            if signed:
                raw = _twos(raw, nbits)
            eph[name] = raw * (2.0 ** exp) * factor
        if pnum:
            eph.setdefault("idValid", set()).add(100 + pnum)
    return sfid, pnum, sow


def finalize_d2(eph: dict) -> dict:
    """Combine the msb/lsb split fields (ephemeris.m:196-228)."""
    for m, l, out, (nm, nl), exp, signed, factor in _D2_SPLITS:
        if m in eph and l in eph:
            raw = (int(eph[m]) << nl) | int(eph[l])
            if signed:
                raw = _twos(raw, nm + nl)
            eph[out] = raw * (2.0 ** exp) * factor
    eph["a_f0"] = eph.get("a0", 0.0)
    eph["a_f1"] = eph.get("a1", 0.0)
    eph["a_f2"] = eph.get("a2", 0.0)
    eph["T_GD"] = eph.get("T_GD_1", 0.0)
    return eph


def encode_d2_subframe(pnum: int, eph: dict, sow: int) -> np.ndarray:
    """Build one transmitted D2 subframe-1 page (interleaved + BCH)."""
    sub = np.zeros(300, np.uint8)
    sub[0:11] = PREAMBLE
    put_bits(sub, 16, 3, 1)
    put_bits(sub, 19, 8, sow >> 12)
    put_bits(sub, 31, 12, sow & 0xFFF)
    put_bits(sub, 43, 4, pnum)
    for name, segs, exp, signed, factor in _D2_PAGES.get(pnum, []):
        nbits = sum(n for _, n in segs)
        raw = int(round(eph.get(name, 0.0) / factor / (2.0 ** exp)))
        if raw < 0:
            raw += (1 << nbits)
        pos = nbits
        for start, n in segs:
            pos -= n
            put_bits(sub, start, n, (raw >> pos) & ((1 << n) - 1))
    cw = bch15_encode(get_bits(sub, 16, 11))
    put_bits(sub, 16, 15, cw)
    out = sub.copy()
    for w in range(1, 10):
        base = 30 * w
        d1 = get_bits(sub, base + 1, 11)
        d2 = get_bits(sub, base + 12, 11)
        deint = np.zeros(30, np.uint8)
        put_bits(deint, 1, 11, d1)
        put_bits(deint, 12, 11, d2)
        put_bits(deint, 23, 4, bch15_encode(d1) & 0xF)
        put_bits(deint, 27, 4, bch15_encode(d2) & 0xF)
        out[base:base + 30] = _interleave_word(deint)
    return out


def decode_d2_frames(bits: np.ndarray, eph: dict | None = None):
    """Decode consecutive transmitted D2 subframes (0.6 s each).

    Returns (eph, sow_of_first_subframe)."""
    eph = {} if eph is None else eph
    bits = np.asarray(bits, np.uint8)
    if np.array_equal(bits[:11], 1 - PREAMBLE):
        bits = 1 - bits
    elif not np.array_equal(bits[:11], PREAMBLE):
        return eph, np.inf
    sow_first = np.inf
    n_sub = len(bits) // 300
    for i in range(n_sub):
        sub = bits[300 * i:300 * (i + 1)].copy()
        desub = sub.copy()
        ok = True
        for w in range(1, 10):
            base = 30 * w
            desub[base:base + 30] = _deinterleave_word(sub[base:base + 30])
            d1, ok1 = bch15_decode((get_bits(desub, base + 1, 11) << 4)
                                   | get_bits(desub, base + 23, 4))
            d2, ok2 = bch15_decode((get_bits(desub, base + 12, 11) << 4)
                                   | get_bits(desub, base + 27, 4))
            put_bits(desub, base + 1, 11, d1)
            put_bits(desub, base + 12, 11, d2)
            ok = ok and ok1 and ok2
        w1, ok1 = bch15_decode(get_bits(desub, 16, 15))
        put_bits(desub, 16, 11, w1)
        if not (ok and ok1):
            continue
        sfid, pnum, sow = decode_d2_subframe(desub, eph)
        if np.isfinite(sow) and np.isinf(sow_first) and sfid == 1:
            sow_first = sow - 0.6 * i
    finalize_d2(eph)
    eph["SOW"] = sow_first
    return eph, sow_first


def has_d2_ephemeris(eph: dict) -> bool:
    return {101, 103, 104, 105, 106, 107, 108, 109,
            110} <= eph.get("idValid", set())
