"""BeiDou B-CNAV1 (B1C) and B-CNAV2 (B2a) message codecs.

B-CNAV1 mirrors BDS/B1C/include/BCNAV1decoding.m + ephemeris.m: frame sync
by the 1800-chip pilot secondary code, subframe 1 via BCH(21,6)+BCH(51,8)
maximum-likelihood decode (PRN + seconds-of-hour), subframes 2/3
de-interleaved 36×48 with systematic LDPC symbols taken directly and
CRC-24Q checked (no LDPC correction, matching the reference).

B-CNAV2 mirrors BDS/B2a/include/BCNAV2decoding.m + ephemeris.m: 24-symbol
preamble (kron'd with the NH5 data secondary), 600-symbol frames, LDPC
systematic bits taken directly, CRC-24Q, MT10/11/30-ff field extraction.

Encoders build loopback-valid frames (systematic LDPC parity symbols are
left zero — exactly what the reference's decoder ignores).
"""

from __future__ import annotations

import numpy as np

from ..constants import GPS_PI as BDS_PI
from .bitfields import extract_fields, get_bits, place_fields, put_bits
from .fec import (bch_codebook_21_6, bch_codebook_51_8, bch_ml_decode,
                  crc24q_append, crc24q_check)

# ===========================================================================
# B-CNAV1 (B1C)
# ===========================================================================

# ephemeris.m field layout over the 878-bit decodedNav array:
# [prn(6) soh(8) | sf2(600-24crc=576 used... first 569) | sf3(264)]
# offsets below are 1-based into decodedNav (=[sub1(14) sub2(600) sub3(264)])

_B1C_SF2 = [
    ("WN", 15, 13, 0, False, 1.0),
    ("HOW", 28, 8, 0, False, 1.0),
    ("IODC", 36, 11, 0, False, 1.0),
    ("IODE", 46, 8, 0, False, 1.0),       # note ref overlap 32:39
    ("t_oe", 54, 11, 0, False, 300.0),
    ("SatType", 65, 2, 0, False, 1.0),
    ("deltaA", 67, 26, -9, True, 1.0),
    ("ADot", 93, 25, -21, True, 1.0),
    ("delta_n_0", 118, 17, -44, True, BDS_PI),
    ("delta_n_0Dot", 135, 23, -57, True, BDS_PI),
    ("M_0", 158, 33, -32, True, BDS_PI),
    ("e", 191, 33, -34, False, 1.0),
    ("omega", 224, 33, -32, True, BDS_PI),
    ("omega_0", 257, 33, -32, True, BDS_PI),
    ("i_0", 290, 33, -32, True, BDS_PI),
    ("delta_omegaDot", 323, 19, -44, True, BDS_PI),
    ("i_0Dot", 342, 15, -44, True, BDS_PI),
    ("C_is", 357, 16, -30, True, 1.0),
    ("C_ic", 373, 16, -30, True, 1.0),
    ("C_rs", 389, 24, -8, True, 1.0),
    ("C_rc", 413, 24, -8, True, 1.0),
    ("C_us", 437, 21, -30, True, 1.0),
    ("C_uc", 458, 21, -30, True, 1.0),
    ("t_oc", 479, 11, 0, False, 300.0),
    ("a_f0", 490, 25, -34, True, 1.0),
    ("a_f1", 515, 22, -50, True, 1.0),
    ("a_f2", 537, 11, -66, True, 1.0),
    ("T_GDB2ap", 548, 12, -34, True, 1.0),
    ("ISC_B1Cd", 560, 12, -34, True, 1.0),
    ("T_GDB1Cp", 572, 12, -34, True, 1.0),
]


def bcnav1_decode_frame(symbols1800: np.ndarray, eph: dict):
    """Decode one 1800-symbol B-CNAV1 frame (±soft data symbols aligned to
    the pilot-secondary frame start).

    Returns (ok, prn, soh_seconds) and fills eph
    (BCNAV1decoding.m:40-128)."""
    s = np.asarray(symbols1800, np.float64)
    for pol in (1.0, -1.0):
        sym = pol * s
        m1 = bch_ml_decode(sym[0:21], bch_codebook_21_6())
        # verify by re-encoding: correlation sign high enough
        cb = bch_codebook_21_6()
        expect = 1.0 - 2.0 * cb[m1]
        if expect @ sym[0:21] < 0.6 * 21:
            continue
        m2 = bch_ml_decode(sym[21:72], bch_codebook_51_8())
        bits = (sym[72:] < 0).astype(np.uint8)          # +1 => bit 0
        mat = bits.reshape(36, 48, order="F")
        f3cols = np.arange(2, 35, 3)
        f2cols = np.asarray([c for c in range(36) if c not in set(f3cols)])
        frame2 = mat[f2cols, :].reshape(-1)             # 1200 symbols
        frame3 = mat[f3cols, :].reshape(-1)             # 528 symbols
        sf2 = frame2[:600]
        sf3 = frame3[:264]
        if not (crc24q_check(sf2) and crc24q_check(sf3)):
            continue
        decoded = np.concatenate([
            np.asarray([(m1 >> (5 - i)) & 1 for i in range(6)], np.uint8),
            np.asarray([(m2 >> (7 - i)) & 1 for i in range(8)], np.uint8),
            sf2, sf3])
        prn = get_bits(decoded, 1, 6)
        soh = get_bits(decoded, 7, 8) * 18
        for name, start, n, exp, signed, factor in _B1C_SF2:
            raw = get_bits(decoded, start, n)
            if signed and raw >= (1 << (n - 1)):
                raw -= (1 << n)
            eph[name] = raw * (2.0 ** exp) * factor
        eph["SOH"] = float(soh)
        eph["PRN"] = prn
        eph.setdefault("idValid", set()).update({1, 2, 3})
        return True, prn, soh
    return False, 0, np.inf


def bcnav1_encode_frame(prn: int, soh_18s: int, eph: dict) -> np.ndarray:
    """Build one 1800-symbol frame (0/1) for loopback synthesis."""
    decoded = np.zeros(878, np.uint8)
    put_bits(decoded, 1, 6, prn)
    put_bits(decoded, 7, 8, soh_18s)
    for name, start, n, exp, signed, factor in _B1C_SF2:
        raw = int(round(eph.get(name, 0.0) / factor / (2.0 ** exp)))
        if raw < 0:
            raw += (1 << n)
        put_bits(decoded, start, n, raw)
    # CRCs over sf2[:576]+24 and sf3[:240]+24
    sf2 = decoded[14:614].copy()
    sf2[576:600] = crc24q_append(sf2[:576])[576:]
    sf3 = decoded[614:878].copy()
    sf3[240:264] = crc24q_append(sf3[:240])[240:]
    # BCH codewords for subframe 1
    cb21 = bch_codebook_21_6()
    cb51 = bch_codebook_51_8()
    w1 = cb21[get_bits(decoded, 1, 6)]
    w2 = cb51[get_bits(decoded, 7, 8)]
    # interleave subframes 2/3 into the 1728-symbol block
    mat = np.zeros((36, 48), np.uint8)
    f3cols = np.arange(2, 35, 3)
    f2cols = np.asarray([c for c in range(36) if c not in set(f3cols)])
    frame2 = np.zeros(1200, np.uint8)
    frame2[:600] = sf2
    frame3 = np.zeros(528, np.uint8)
    frame3[:264] = sf3
    mat[f2cols, :] = frame2.reshape(25, 48)
    mat[f3cols, :] = frame3.reshape(11, 48)
    block = mat.reshape(-1, order="F")
    return np.concatenate([w1, w2, block]).astype(np.uint8)


def bcnav1_has_ephemeris(eph: dict) -> bool:
    return {1, 2, 3} <= eph.get("idValid", set())


# ===========================================================================
# B-CNAV2 (B2a)
# ===========================================================================

# 24-bit preamble (BCNAV2decoding.m:74, ±1 with +1 = bit 0 convention)
BCNAV2_PREAMBLE_PM = np.asarray(
    [-1, -1, -1, 1, 1, 1, -1, 1, 1, -1, 1, 1, -1, -1, 1, -1, -1, -1, -1,
     1, -1, 1, 1, 1], np.int8)
BCNAV2_PREAMBLE_BITS = ((1 - BCNAV2_PREAMBLE_PM) // 2).astype(np.uint8)

_B2A_MSGS = {
    10: [("WN", 31, 13, 0, False, 1.0),
         ("t_oe", 62, 11, 0, False, 300.0),
         ("SatType", 73, 2, 0, False, 1.0),
         ("deltaA", 75, 26, -9, True, 1.0),
         ("ADot", 101, 25, -21, True, 1.0),
         ("delta_n_0", 126, 17, -44, True, BDS_PI),
         ("delta_n_0Dot", 143, 23, -57, True, BDS_PI),
         ("M_0", 166, 33, -32, True, BDS_PI),
         ("e", 199, 33, -34, False, 1.0),
         ("omega", 232, 33, -32, True, BDS_PI)],
    11: [("omega_0", 43, 33, -32, True, BDS_PI),
         ("i_0", 76, 33, -32, True, BDS_PI),
         ("delta_omegaDot", 109, 19, -44, True, BDS_PI),
         ("i_0Dot", 128, 15, -44, True, BDS_PI),
         ("C_is", 143, 16, -30, True, 1.0),
         ("C_ic", 159, 16, -30, True, 1.0),
         ("C_rs", 175, 24, -8, True, 1.0),
         ("C_rc", 199, 24, -8, True, 1.0),
         ("C_us", 223, 21, -30, True, 1.0),
         ("C_uc", 244, 21, -30, True, 1.0)],
    30: [("t_oc", 43, 11, 0, False, 300.0),
         ("a_f0", 54, 25, -34, True, 1.0),
         ("a_f1", 79, 22, -50, True, 1.0),
         ("a_f2", 101, 11, -66, True, 1.0),
         ("T_GDB2ap", 122, 12, -34, True, 1.0),
         ("ISC_B2ad", 134, 12, -34, True, 1.0)],
}


def bcnav2_decode_message(bits288: np.ndarray, eph: dict):
    """CRC-check + decode one 288-bit B-CNAV2 message; returns
    (message_type, sow) (ephemeris.m of B2a)."""
    if not crc24q_check(bits288):
        return 0, np.inf
    mid = get_bits(bits288, 7, 6)
    sow = get_bits(bits288, 13, 18) * 3
    if mid in _B2A_MSGS:
        for name, start, n, exp, signed, factor in _B2A_MSGS[mid]:
            raw = get_bits(bits288, start, n)
            if signed and raw >= (1 << (n - 1)):
                raw -= (1 << n)
            eph[name] = raw * (2.0 ** exp) * factor
        eph.setdefault("idValid", set()).add(mid)
        eph["PRN"] = get_bits(bits288, 1, 6)
        eph.setdefault("SOW", float(sow))
    return mid, sow


def bcnav2_encode_frame(mid: int, prn: int, sow: int,
                        eph: dict) -> np.ndarray:
    """One 600-symbol frame (0/1): 24 preamble + 288 systematic bits +
    288 zero parity symbols."""
    bits = np.zeros(264, np.uint8)
    put_bits(bits, 1, 6, prn)
    put_bits(bits, 7, 6, mid)
    put_bits(bits, 13, 18, sow // 3)
    for name, start, n, exp, signed, factor in _B2A_MSGS.get(mid, []):
        raw = int(round(eph.get(name, 0.0) / factor / (2.0 ** exp)))
        if raw < 0:
            raw += (1 << n)
        put_bits(bits, start, n, raw)
    msg = crc24q_append(bits)                  # 288 bits
    return np.concatenate([BCNAV2_PREAMBLE_BITS, msg,
                           np.zeros(288, np.uint8)])


def bcnav2_decode_symbol_stream(symbols: np.ndarray,
                                eph: dict | None = None):
    """B-CNAV2 transport from ±1 5 ms nav symbols
    (BCNAV2decoding.m:30-95).

    Returns (eph, first_symbol_index, sow)."""
    eph = {} if eph is None else eph
    sym = np.where(np.asarray(symbols) > 0, 1, -1).astype(np.float64)
    pre = BCNAV2_PREAMBLE_PM.astype(np.float64)
    corr = np.correlate(sym, pre, mode="valid")
    cands = np.where(np.abs(corr) >= 23.99)[0]
    first = None
    sow_first = np.inf
    for idx in cands:
        if idx + 600 > len(sym):
            continue
        pol = 1.0 if corr[idx] > 0 else -1.0
        frame = pol * sym[idx:idx + 600]
        bits = (frame[24:24 + 288] < 0).astype(np.uint8)
        mid, sow = bcnav2_decode_message(bits, eph)
        if mid > 0 and first is None:
            first = int(idx)
            sow_first = sow
    return eph, (np.inf if first is None else first), sow_first


def bcnav2_has_ephemeris(eph: dict) -> bool:
    return {10, 11, 30} <= eph.get("idValid", set())
