"""GPS LNAV (50 bps) message codec: parity, ephemeris decode, and an
encoder for synthetic end-to-end tests.

Decode semantics mirror GPS/GPS_L1CA/include/NAVdecoding.m,
Common/navPartyChk.m, include/checkPhase.m and include/ephemeris.m; field
scaling is IS-GPS-200 Table 20-I/20-III.  (One deliberate divergence: IODC
LSBs are taken from subframe bits 211-218 per IS-GPS-200; the reference
reads bits 197-204 there, which are T_GD's.)

The encoder inverts the decoder: it builds 5 subframes (1500 bits) with a
valid D29*/D30* parity chain, solving the non-information bits of words 2
and 10 so their parity ends 00 (IS-GPS-200 20.3.5.2).
"""

from __future__ import annotations

import numpy as np

from ..constants import GPS_PI

PREAMBLE = np.asarray([1, -1, -1, -1, 1, -1, 1, 1], np.int8)
MS_PER_BIT = 20
SUBFRAME_MS = 6000

# Parity XOR index sets over source data bits d1..d24 (1-based), per
# IS-GPS-200 Table 20-XIV (navPartyChk.m:68-92).
_P = [
    (29, (1, 2, 3, 5, 6, 10, 11, 12, 13, 14, 17, 18, 20, 23)),   # D25
    (30, (2, 3, 4, 6, 7, 11, 12, 13, 14, 15, 18, 19, 21, 24)),   # D26
    (29, (1, 3, 4, 5, 7, 8, 12, 13, 14, 15, 16, 19, 20, 22)),    # D27
    (30, (2, 4, 5, 6, 8, 9, 13, 14, 15, 16, 17, 20, 21, 23)),    # D28
    (30, (1, 3, 5, 6, 7, 9, 10, 14, 15, 16, 17, 18, 21, 22, 24)),  # D29
    (29, (3, 5, 6, 8, 9, 10, 11, 13, 15, 19, 22, 23, 24)),       # D30
]


def _parity(d_source: np.ndarray, d29s: int, d30s: int) -> np.ndarray:
    """Compute D25..D30 from 24 source bits + previous word's D29*/D30*."""
    out = np.empty(6, np.int8)
    for k, (star, idxs) in enumerate(_P):
        acc = d29s if star == 29 else d30s
        for i in idxs:
            acc ^= int(d_source[i - 1])
        out[k] = acc
    return out


def check_word(word30: np.ndarray, d29s: int, d30s: int):
    """Verify one transmitted 30-bit word (0/1 array).

    Returns (ok, source_bits[24]).  Transmitted data bits are source ⊕ D30*
    (checkPhase.m); parity bits are transmitted as computed.
    """
    data = word30[:24] ^ d30s
    expect = _parity(data, d29s, d30s)
    return bool(np.array_equal(expect, word30[24:30])), data


def encode_word(d_source: np.ndarray, d29s: int, d30s: int,
                solve_tail: bool = False) -> np.ndarray:
    """Build one transmitted 30-bit word.

    solve_tail: choose source bits d23,d24 to force D29=D30=0
    (HOW / word-10 non-information bits, IS-GPS-200 20.3.5.2).
    """
    d = np.asarray(d_source, np.int8).copy()
    if solve_tail:
        for d23 in (0, 1):
            for d24 in (0, 1):
                d[22], d[23] = d23, d24
                p = _parity(d, d29s, d30s)
                if p[4] == 0 and p[5] == 0:
                    break
            else:
                continue
            break
    p = _parity(d, d29s, d30s)
    return np.concatenate([d ^ d30s, p]).astype(np.int8)


# ---------------------------------------------------------------------------
# Field placement tables: (name, start_bit(1-based, within 300-bit
# subframe), length, scale_exponent, signed, factor)
# Multi-segment fields are listed as tuples of (start, length).
# Positions per ephemeris.m:96-146 / IS-GPS-200 Table 20-III.
# ---------------------------------------------------------------------------

_SF1 = [
    ("weekNumber", ((61, 10),), 0, False, 1.0),
    ("accuracy", ((73, 4),), 0, False, 1.0),
    ("health", ((77, 6),), 0, False, 1.0),
    ("IODC", ((83, 2), (211, 8)), 0, False, 1.0),
    ("T_GD", ((197, 8),), -31, True, 1.0),
    ("t_oc", ((219, 16),), 4, False, 1.0),
    ("a_f2", ((241, 8),), -55, True, 1.0),
    ("a_f1", ((249, 16),), -43, True, 1.0),
    ("a_f0", ((271, 22),), -31, True, 1.0),
]
_SF2 = [
    ("IODE_sf2", ((61, 8),), 0, False, 1.0),
    ("C_rs", ((69, 16),), -5, True, 1.0),
    ("deltan", ((91, 16),), -43, True, GPS_PI),
    ("M_0", ((107, 8), (121, 24)), -31, True, GPS_PI),
    ("C_uc", ((151, 16),), -29, True, 1.0),
    ("e", ((167, 8), (181, 24)), -33, False, 1.0),
    ("C_us", ((211, 16),), -29, True, 1.0),
    ("sqrtA", ((227, 8), (241, 24)), -19, False, 1.0),
    ("t_oe", ((271, 16),), 4, False, 1.0),
]
_SF3 = [
    ("C_ic", ((61, 16),), -29, True, 1.0),
    ("omega_0", ((77, 8), (91, 24)), -31, True, GPS_PI),
    ("C_is", ((121, 16),), -29, True, 1.0),
    ("i_0", ((137, 8), (151, 24)), -31, True, GPS_PI),
    ("C_rc", ((181, 16),), -5, True, 1.0),
    ("omega", ((197, 8), (211, 24)), -31, True, GPS_PI),
    ("omegaDot", ((241, 24),), -43, True, GPS_PI),
    ("IODE_sf3", ((271, 8),), 0, False, 1.0),
    ("iDot", ((279, 14),), -43, True, GPS_PI),
]
_FIELDS = {1: _SF1, 2: _SF2, 3: _SF3}


def _extract(bits: np.ndarray, segs) -> int:
    val = 0
    for start, length in segs:
        for b in bits[start - 1:start - 1 + length]:
            val = (val << 1) | int(b)
    return val


def _twos(val: int, nbits: int) -> int:
    return val - (1 << nbits) if val >= (1 << (nbits - 1)) else val


def decode_subframe(bits300: np.ndarray, eph: dict) -> int:
    """Decode one polarity-corrected subframe into ``eph``; returns its ID
    (ephemeris.m:87-158)."""
    sfid = _extract(bits300, ((50, 3),))
    if sfid in _FIELDS:
        for name, segs, exp, signed, factor in _FIELDS[sfid]:
            nbits = sum(L for _, L in segs)
            raw = _extract(bits300, segs)
            if signed:
                raw = _twos(raw, nbits)
            val = raw * (2.0 ** exp) * factor
            if name == "weekNumber":
                val = raw + 1024.0    # ephemeris.m:98
            eph[name] = val
    return sfid


def decode_frame(bits1500: np.ndarray, d29_star: int = 0,
                 d30_star: int = 0):
    """Decode 5 consecutive subframes (transmitted-domain 0/1 bits).

    d29_star/d30_star: last two transmitted bits of the word preceding the
    frame (NAVdecoding.m:157 reads one extra bit; we need both for the
    parity check of word 1).

    Returns (eph dict, TOW of the FIRST subframe in seconds)
    (NAVdecoding.m:154-178, ephemeris.m:73-169).
    """
    eph: dict = {"idValid": set()}
    tow = None
    d29s = int(d29_star)
    d30s = int(d30_star)
    for i in range(5):
        sub = np.asarray(bits1500[300 * i:300 * (i + 1)], np.int8).copy()
        ok_all = True
        for w in range(10):
            word = sub[30 * w:30 * (w + 1)]
            ok, data = check_word(word, d29s, d30s)
            ok_all = ok_all and ok
            d29s, d30s = int(word[28]), int(word[29])
            sub[30 * w:30 * w + 24] = data     # polarity-corrected
        if not ok_all:
            continue
        sfid = decode_subframe(sub, eph)
        eph["idValid"].add(sfid)
        if i == 4:
            # HOW TOW is the start of the NEXT subframe; first subframe
            # started 30 s earlier (ephemeris.m:162-169)
            tow = _extract(sub, ((31, 17),)) * 6 - 30
    eph["TOW"] = tow
    return eph, tow


# ---------------------------------------------------------------------------
# Encoder (test synthesis)
# ---------------------------------------------------------------------------

def _place(bits300: np.ndarray, segs, value: int, nbits: int):
    if value < 0:
        value += (1 << nbits)
    bitpos = nbits
    for start, length in segs:
        for k in range(length):
            bitpos -= 1
            bits300[start - 1 + k] = (value >> bitpos) & 1


def encode_frame(eph: dict, tow_first: int, d29_star: int = 0,
                 d30_star: int = 0) -> np.ndarray:
    """Build 5 transmitted subframes (1500 bits 0/1) for eph + TOW.

    tow_first: TOW [s] at the start of the first encoded subframe
    (multiple of 6).  Subframes 4/5 carry only TLM/HOW + valid parity.
    Returns transmitted-domain bits; prepend source-domain history as
    needed (the decoder needs the previous word's D30*).
    """
    frames = []
    d29s, d30s = int(d29_star), int(d30_star)
    for i in range(5):
        sfid = i + 1
        src = np.zeros(300, np.int8)
        # TLM word: preamble 10001011 + reserved
        src[0:8] = [1, 0, 0, 0, 1, 0, 1, 1]
        # HOW: truncated TOW of NEXT subframe (17 bits), then subframe id
        tow_next = (tow_first + (i + 1) * 6) // 6
        _place(src, ((31, 17),), tow_next % (1 << 17), 17)
        _place(src, ((50, 3),), sfid, 3)
        if sfid in _FIELDS:
            for name, segs, exp, signed, factor in _FIELDS[sfid]:
                nbits = sum(L for _, L in segs)
                val = eph.get(name, 0.0)
                if name == "weekNumber":
                    raw = int(round(val - 1024.0))
                else:
                    raw = int(round(val / factor / (2.0 ** exp)))
                _place(src, segs, raw, nbits)
        # build words with parity chain
        out = np.zeros(300, np.int8)
        for w in range(10):
            solve = w in (1, 9)     # HOW and word 10
            word = encode_word(src[30 * w:30 * w + 24], d29s, d30s,
                               solve_tail=solve)
            out[30 * w:30 * (w + 1)] = word
            d29s, d30s = int(word[28]), int(word[29])
        frames.append(out)
    return np.concatenate(frames)


def nav_bit_stream(eph: dict, tow_first: int, n_frames: int = 3
                   ) -> np.ndarray:
    """±1 LNAV bit stream of ``n_frames`` consecutive 30 s frames."""
    chunks = []
    d29s = d30s = 0
    for f in range(n_frames):
        bits = encode_frame(eph, tow_first + f * 30, d29s, d30s)
        d29s, d30s = int(bits[-2]), int(bits[-1])
        chunks.append(bits)
    allbits = np.concatenate(chunks)
    return (2 * allbits.astype(np.int8) - 1)
