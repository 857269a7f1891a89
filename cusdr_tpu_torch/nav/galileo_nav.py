"""Galileo I/NAV (E1B, E5b-I) and F/NAV (E5a-I) message codecs.

Transport semantics mirror GAL/GAL_E1C/include/NAVdecoding.m and
GAL/GAL_E5a/include/NAVdecoding.m; field layouts mirror the respective
include/ephemeris.m parsers (word types 1-6 for I/NAV, page types 1-4 for
F/NAV).  The convolutional code is K=7 [171,133] with the G2 branch
INVERTED per the Galileo OS SIS ICD (the reference expresses this as
poly2trellis(7,[171 ~133])).

Encoders are provided for loopback test synthesis.
"""

from __future__ import annotations

import numpy as np

from ..constants import GPS_PI as GAL_PI
from ..runtime.profiling import span
from .bitfields import extract_fields, get_bits, place_fields, put_bits
from .fec import conv_encode, crc24q_append, crc24q_check, viterbi_decode

# --- Galileo FEC: G2 inverted ----------------------------------------------

def gal_conv_encode(bits: np.ndarray, tail: bool = True) -> np.ndarray:
    coded = conv_encode(bits, tail=tail)
    coded = coded.copy()
    coded[1::2] ^= 1          # invert G2 branch (OS SIS ICD §4.1.4)
    return coded


def gal_viterbi_decode(soft: np.ndarray, n_bits: int) -> np.ndarray:
    s = np.asarray(soft, np.float64).copy()
    s[1::2] = -s[1::2]        # un-invert G2 in the soft domain
    return viterbi_decode(s, n_bits)


def _deinterleave(symbols: np.ndarray, cols: int, rows: int) -> np.ndarray:
    """Block de-interleaver: reshape(x,cols,rows)' then column-major
    flatten (NAVdecoding.m:119-128 / E5a:140-142 MATLAB semantics)."""
    m = symbols.reshape((cols, rows), order="F").T      # [rows, cols]
    return m.reshape(-1, order="F")


def _interleave(bits: np.ndarray, cols: int, rows: int) -> np.ndarray:
    """Inverse of _deinterleave (for synthesis): y such that
    _deinterleave(y) == bits."""
    idx = _deinterleave(np.arange(bits.size), cols, rows)
    y = np.empty_like(bits)
    y[idx] = bits
    return y


# ===========================================================================
# I/NAV (E1B / E5b-I): 250-symbol pages, even/odd halves
# ===========================================================================

INAV_SYNC = np.asarray([0, 1, 0, 1, 1, 0, 0, 0, 0, 0], np.uint8)

_INAV_WORDS = {
    1: [("IODnav1", 7, 10, 0, False, 1.0),
        ("t_oe", 17, 14, 0, False, 60.0),
        ("M_0", 31, 32, -31, True, GAL_PI),
        ("e", 63, 32, -33, False, 1.0),
        ("sqrtA", 95, 32, -19, False, 1.0)],
    2: [("IODnav2", 7, 10, 0, False, 1.0),
        ("Omega_0", 17, 32, -31, True, GAL_PI),
        ("i_0", 49, 32, -31, True, GAL_PI),
        ("omega", 81, 32, -31, True, GAL_PI),
        ("iDot", 113, 14, -43, True, GAL_PI)],
    3: [("IODnav3", 7, 10, 0, False, 1.0),
        ("OmegaDot", 17, 24, -43, True, GAL_PI),
        ("deltan", 41, 16, -43, True, GAL_PI),
        ("CUC", 57, 16, -29, True, 1.0),
        ("CUS", 73, 16, -29, True, 1.0),
        ("CRC", 89, 16, -5, True, 1.0),
        ("CRS", 105, 16, -5, True, 1.0)],
    4: [("IODnav4", 7, 10, 0, False, 1.0),
        ("SVID", 17, 6, 0, False, 1.0),
        ("CIC", 23, 16, -29, True, 1.0),
        ("CIS", 39, 16, -29, True, 1.0),
        ("t_oc", 55, 14, 0, False, 60.0),
        ("a_f0", 69, 31, -34, True, 1.0),
        ("a_f1", 100, 21, -46, True, 1.0),
        ("a_f2", 121, 6, -59, True, 1.0)],
    5: [("a_i0", 7, 11, -2, False, 1.0),
        ("a_i1", 18, 11, -8, True, 1.0),
        ("a_i2", 29, 14, -15, True, 1.0),
        ("BGD_E1E5a", 48, 10, -32, True, 1.0),
        ("BGD_E1E5b", 58, 10, -32, True, 1.0),
        ("E5b_HS", 68, 2, 0, False, 1.0),
        ("E1b_HS", 70, 2, 0, False, 1.0),
        ("WN", 74, 12, 0, False, 1.0),
        ("TOW_raw", 86, 20, 0, False, 1.0)],
    6: [("A0", 7, 32, -30, True, 1.0),
        ("A1", 39, 24, -50, True, 1.0),
        ("delt_LS", 63, 8, 0, True, 1.0),
        ("t_ot", 71, 8, 0, False, 3600.0),
        ("WN_ot", 79, 8, 0, False, 1.0)],
}


def inav_decode_page_pair(even114: np.ndarray, odd106: np.ndarray,
                          eph: dict):
    """Check CRC of a de-FEC'd even/odd page pair and decode its word.

    even114/odd106: decoded bits after tail removal
    (GAL_E1C/include/NAVdecoding.m:76-117).
    Returns word type (0 if CRC failed).
    """
    page = np.concatenate([even114, odd106])
    if not crc24q_check(page[:196 + 24]):
        return 0
    word = np.concatenate([even114[2:114], odd106[2:18]])   # 128 bits
    wt = get_bits(word, 1, 6)
    if wt in _INAV_WORDS:
        extract_fields(word, _INAV_WORDS[wt], eph)
        eph.setdefault("idValid", set()).add(wt)
    return wt


def inav_encode_page_pair(word128: np.ndarray) -> np.ndarray:
    """Build one 500-symbol even+odd page pair (2 × 250) from a 128-bit
    word: split 112/16, add flags, CRC, FEC, interleave, sync."""
    even = np.zeros(114, np.uint8)
    odd = np.zeros(106, np.uint8)
    even[0] = 0   # even/odd flag
    even[1] = 0   # page type nominal
    even[2:114] = word128[:112]
    odd[0] = 1
    odd[1] = 0
    odd[2:18] = word128[112:128]
    # CRC-24Q over the first 196 pair bits, stored in odd[82:106]
    # (pair = even(114)+odd(106); decode checks page[:220])
    payload = np.concatenate([even, odd[:82]])
    odd[82:106] = crc24q_append(payload)[196:]
    halves = []
    # each half is 120 coded bits: even = 114 + 6 tail; odd = 106 + 8
    # SSP (zeros here) + 6 tail (GAL_E1C/include/NAVdecoding.m:76,96)
    for half in (even, np.concatenate([odd, np.zeros(8, np.uint8)])):
        coded = gal_conv_encode(half, tail=True)     # 240 symbols
        inter = _interleave(coded.astype(np.uint8), 30, 8)
        halves.append(np.concatenate([INAV_SYNC, inter]))
    return np.concatenate(halves)      # 500 page symbols (0/1)


def inav_word(wt: int, eph: dict, tow_raw: int | None = None) -> np.ndarray:
    """Build the 128-bit I/NAV word of type wt from eph."""
    word = np.zeros(128, np.uint8)
    put_bits(word, 1, 6, wt)
    if wt in _INAV_WORDS:
        e = dict(eph)
        if wt == 5 and tow_raw is not None:
            e["TOW_raw"] = float(tow_raw)
        place_fields(word, _INAV_WORDS[wt], e)
    return word


def inav_decode_symbol_stream(symbols: np.ndarray, eph: dict | None = None):
    """Full I/NAV transport from ±1 page symbols at 250 sps.

    Mirrors GAL_E1C/include/NAVdecoding.m:30-120: sync-pattern search with
    250/500 spacing, polarity fix, per-half de-interleave + Viterbi, CRC.

    Returns (eph, first_symbol_index, tow) where tow is the GST at the
    start of the first detected even page.
    """
    eph = {} if eph is None else eph
    sym = np.where(np.asarray(symbols) > 0, 1, -1).astype(np.float64)
    sync_pm = 1.0 - 2.0 * INAV_SYNC.astype(np.float64)
    corr = np.correlate(sym, sync_pm, mode="valid")
    cands = np.where(np.abs(corr) >= 9.99)[0]
    cand_set = set(cands.tolist())
    first = None
    tow = np.inf
    for idx in cands:
        if not ((idx + 250) in cand_set and (idx + 500) in cand_set):
            continue
        pol = 1.0 if corr[idx] > 0 else -1.0
        pair_idx = 0
        k = idx
        while k + 500 <= len(sym):
            page = pol * sym[k:k + 500]
            halves = []
            ok = True
            for h in range(2):
                body = page[10 + 250 * h: 250 * (h + 1)]
                with span("nav.fec"):
                    deint = _deinterleave(body, 30, 8)
                    bits = gal_viterbi_decode(deint, 120)
                halves.append(bits)
            if halves[0][0] != 0 or halves[1][0] != 1:
                k += 500
                pair_idx += 1
                continue
            wt = inav_decode_page_pair(halves[0][:114], halves[1][:106],
                                       eph)
            if wt > 0 and first is None:
                first = int(idx)
            if wt == 5 and np.isinf(tow):
                # TOW field refers to the start of its own page pair;
                # refer it back to the first detected page
                tow = eph["TOW_raw"] - 2.0 * (pair_idx
                                              - (idx != first) * 0)
                tow = eph["TOW_raw"] - 2.0 * pair_idx
            k += 500
            pair_idx += 1
        if first is not None:
            break
    eph["TOW"] = tow
    return eph, (np.inf if first is None else first), tow


def inav_has_ephemeris(eph: dict) -> bool:
    return {1, 2, 3, 4, 5} <= eph.get("idValid", set())


# ===========================================================================
# F/NAV (E5a-I): 500-symbol (10 s) pages at 50 sps
# ===========================================================================

FNAV_SYNC = np.asarray([1, 0, 1, 1, 0, 1, 1, 1, 0, 0, 0, 0], np.uint8)

_FNAV_PAGES = {
    1: [("SVID", 7, 6, 0, False, 1.0),
        ("IODnav1", 13, 10, 0, False, 1.0),
        ("t_oc", 23, 14, 0, False, 60.0),
        ("a_f0", 37, 31, -34, True, 1.0),
        ("a_f1", 68, 21, -46, True, 1.0),
        ("a_f2", 89, 6, -59, True, 1.0),
        ("a_i0", 103, 11, -2, False, 1.0),
        ("a_i1", 114, 11, -8, True, 1.0),
        ("a_i2", 125, 14, -15, True, 1.0),
        ("BGD_E1E5a", 144, 10, -32, True, 1.0),
        ("E5a_HS", 154, 2, 0, False, 1.0),
        ("WN", 156, 12, 0, False, 1.0),
        ("TOW_raw", 168, 20, 0, False, 1.0)],
    2: [("IODnav2", 7, 10, 0, False, 1.0),
        ("M_0", 17, 32, -31, True, GAL_PI),
        ("OmegaDot", 49, 24, -43, True, GAL_PI),
        ("e", 73, 32, -33, False, 1.0),
        ("sqrtA", 105, 32, -19, False, 1.0),
        ("Omega_0", 137, 32, -31, True, GAL_PI),
        ("iDot", 169, 14, -43, True, GAL_PI)],
    3: [("IODnav3", 7, 10, 0, False, 1.0),
        ("i_0", 17, 32, -31, True, GAL_PI),
        ("omega", 49, 32, -31, True, GAL_PI),
        ("deltan", 81, 16, -43, True, GAL_PI),
        ("CUC", 97, 16, -29, True, 1.0),
        ("CUS", 113, 16, -29, True, 1.0),
        ("CRC", 129, 16, -5, True, 1.0),
        ("CRS", 145, 16, -5, True, 1.0),
        ("t_oe", 161, 14, 0, False, 60.0)],
    4: [("IODnav4", 7, 10, 0, False, 1.0),
        ("CIC", 17, 16, -29, True, 1.0),
        ("CIS", 33, 16, -29, True, 1.0),
        ("A0", 49, 32, -30, True, 1.0),
        ("A1", 81, 24, -50, True, 1.0),
        ("delt_LS", 105, 8, 0, True, 1.0),
        ("t_ot", 113, 8, 0, False, 3600.0)],
}


def fnav_decode_page(bits238: np.ndarray, eph: dict) -> int:
    """CRC-check + field-extract one F/NAV page (E5a ephemeris.m)."""
    if not crc24q_check(bits238):
        return 0
    pt = get_bits(bits238, 1, 6)
    if pt in _FNAV_PAGES:
        extract_fields(bits238, _FNAV_PAGES[pt], eph)
        eph.setdefault("idValid", set()).add(pt)
    return pt


def fnav_encode_page(pt: int, eph: dict,
                     tow_raw: int | None = None) -> np.ndarray:
    """Build one 500-symbol F/NAV page: 214 data bits + CRC24 -> FEC ->
    61x8 interleave -> 12 sync symbols."""
    data = np.zeros(214, np.uint8)
    put_bits(data, 1, 6, pt)
    e = dict(eph)
    if pt == 1 and tow_raw is not None:
        e["TOW_raw"] = float(tow_raw)
    place_fields(data, _FNAV_PAGES[pt], e)
    page = crc24q_append(data)                     # 238 bits
    coded = gal_conv_encode(page, tail=True)       # 488 symbols
    inter = _interleave(coded.astype(np.uint8), 61, 8)
    return np.concatenate([FNAV_SYNC, inter])      # 500 symbols (0/1)


def fnav_decode_symbol_stream(symbols: np.ndarray, eph: dict | None = None):
    """F/NAV transport from ±1 symbols at 50 sps
    (GAL_E5a/include/NAVdecoding.m:95-160).

    Returns (eph, first_symbol_index, tow at first page start)."""
    eph = {} if eph is None else eph
    sym = np.where(np.asarray(symbols) > 0, 1, -1).astype(np.float64)
    sync_pm = 1.0 - 2.0 * FNAV_SYNC.astype(np.float64)
    corr = np.correlate(sym, sync_pm, mode="valid")
    cands = np.where(np.abs(corr) >= 11.99)[0]
    cand_set = set(cands.tolist())
    first = None
    tow = np.inf
    for idx in cands:
        if (idx + 500) not in cand_set and (idx - 500) not in cand_set:
            continue
        pol = 1.0 if corr[idx] > 0 else -1.0
        k = idx
        page_idx = 0
        while k + 500 <= len(sym):
            body = pol * sym[k + 12:k + 500]
            with span("nav.fec"):
                deint = _deinterleave(body, 61, 8)
                bits = gal_viterbi_decode(deint, 244)[:238]
            pt = fnav_decode_page(bits, eph)
            if pt > 0:
                if first is None:
                    first = int(idx)
                if pt == 1 and np.isinf(tow):
                    tow = eph["TOW_raw"] - 10.0 * page_idx
            k += 500
            page_idx += 1
        if first is not None:
            break
    eph["TOW"] = tow
    return eph, (np.inf if first is None else first), tow


def fnav_has_ephemeris(eph: dict) -> bool:
    return {1, 2, 3} <= eph.get("idValid", set())
