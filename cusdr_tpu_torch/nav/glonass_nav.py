"""GLONASS navigation-message codec (L1/L2 C/A, 50 bps, bi-binary).

Transport mirrors GLO/GLO_GL1/include/NAVdecoding.m + ephemeris.m: 2 s
strings = 0.3 s time mark (30 bits @ 10 ms) + 1.7 s of differentially
encoded bi-binary data (170 half-bits = 85 bits); strings verified with the
(85,77+8) Hamming check (dataVerification.m); 15-string superframe slice
decoded as one differential chain (ephemeris.m:31-44); state-vector
ephemeris with sign-magnitude fields (ephemeris.m strings 1-5).
"""

from __future__ import annotations

import numpy as np

from .bitfields import get_bits, put_bits
from .fec import _GLO_CHECKS, glonass_hamming_check

# 30-bit time mark (NAVdecoding.m:15-16), ±1 with +1 = binary 1
TIME_MARK = np.asarray([1, 1, 1, 1, 1, -1, -1, -1, 1, 1, -1, 1, 1, 1, -1,
                        1, -1, 1, -1, -1, -1, -1, 1, -1, -1, 1, -1, 1, 1,
                        -1], np.int8)

STRING_MS = 2000          # 2 s per string
MARK_MS = 300             # time mark duration
BIT_HALF_MS = 10          # bi-binary half-bit duration

# sign-magnitude fields: (name, sign_pos, mag_start, mag_bits, scale)
# positions are 1-based into the 85-bit string in transmission order
# (string[1] = idle bit 85); ephemeris.m strings 1-5.
_STRINGS = {
    1: [("xVel", 22, 23, 23, 2.0 ** -20),
        ("xAcc", 46, 47, 4, 2.0 ** -30),
        ("xDis", 51, 52, 26, 2.0 ** -11)],
    2: [("yVel", 22, 23, 23, 2.0 ** -20),
        ("yAcc", 46, 47, 4, 2.0 ** -30),
        ("yDis", 51, 52, 26, 2.0 ** -11)],
    3: [("gam", 7, 8, 10, 2.0 ** -40),
        ("zVel", 22, 23, 23, 2.0 ** -20),
        ("zAcc", 46, 47, 4, 2.0 ** -30),
        ("zDis", 51, 52, 26, 2.0 ** -11)],
    4: [("tau_n", 6, 7, 21, 2.0 ** -30),
        ("dtau", 28, 29, 4, 2.0 ** -30)],
}


def decode_string(bits85: np.ndarray, eph: dict) -> int:
    """Decode one 85-bit string (transmission order) into eph; returns
    string id (ephemeris.m:48-150)."""
    sid = get_bits(bits85, 2, 4)
    for name, spos, mstart, mbits, scale in _STRINGS.get(sid, []):
        sign = -1.0 if bits85[spos - 1] else 1.0
        eph[name] = sign * get_bits(bits85, mstart, mbits) * scale
    if sid == 1:
        eph["TOD"] = (get_bits(bits85, 10, 5) * 3600
                      + get_bits(bits85, 15, 6) * 60
                      + get_bits(bits85, 21, 1) * 30)
        eph["P1"] = get_bits(bits85, 8, 2)
    elif sid == 2:
        eph["tb"] = get_bits(bits85, 10, 7) * 15 * 60
        eph["t_b"] = eph["tb"]
    elif sid == 3:
        eph["health"] = get_bits(bits85, 21, 1)
    elif sid == 4:
        eph["E"] = get_bits(bits85, 33, 5)
        eph["FT"] = get_bits(bits85, 53, 4)
        eph["n"] = get_bits(bits85, 74, 5)
    elif sid == 5:
        eph["N_A"] = get_bits(bits85, 6, 11)
        sign = -1.0 if bits85[17 - 1] else 1.0
        eph["tau_c"] = sign * get_bits(bits85, 18, 31) * 2.0 ** -31
    if sid:
        eph.setdefault("idValid", set()).add(sid)
    return sid


def encode_string(sid: int, eph: dict) -> np.ndarray:
    """Build one 85-bit string (transmission order) with valid Hamming
    check bits (inverse of decode_string + dataVerification)."""
    b = np.zeros(85, np.uint8)       # b[0] = bit 85 (idle, 0)
    put_bits(b, 2, 4, sid)

    def put_signmag(spos, mstart, mbits, value, scale):
        b[spos - 1] = 1 if value < 0 else 0
        put_bits(b, mstart, mbits, int(round(abs(value) / scale)))

    for name, spos, mstart, mbits, scale in _STRINGS.get(sid, []):
        put_signmag(spos, mstart, mbits, eph.get(name, 0.0), scale)
    if sid == 1:
        tod = int(eph.get("TOD", 0))
        put_bits(b, 10, 5, tod // 3600)
        put_bits(b, 15, 6, (tod % 3600) // 60)
        put_bits(b, 21, 1, (tod % 60) // 30)
    elif sid == 2:
        put_bits(b, 10, 7, int(eph.get("tb", 0)) // (15 * 60))
    elif sid == 3:
        put_bits(b, 21, 1, int(eph.get("health", 0)))
    elif sid == 4:
        put_bits(b, 33, 5, int(eph.get("E", 0)))
    elif sid == 5:
        put_bits(b, 6, 11, int(eph.get("N_A", 0)))
        tau_c = eph.get("tau_c", 0.0)
        b[17 - 1] = 1 if tau_c < 0 else 0
        put_bits(b, 18, 31, int(round(abs(tau_c) * 2 ** 31)))

    # solve Hamming check bits 1..8 (bit i lives at b[85-i])
    def bit(i):
        return int(b[85 - i])

    for j, grp in enumerate(_GLO_CHECKS[:7], start=1):
        acc = 0
        for i in grp:
            acc ^= bit(i)
        b[85 - j] = acc
    acc = 0
    for i in range(1, 86):
        acc ^= bit(i)
    b[85 - 8] ^= acc
    assert glonass_hamming_check(b)
    return b


def encode_symbol_stream(strings) -> np.ndarray:
    """±1 stream at 10 ms per value: for each 85-bit string, a 30-symbol
    time mark + 170 differential bi-binary half-bits.

    The differential chain is continuous over the concatenated data bits
    (matching ephemeris.m:31-44 which decodes the concatenation with a
    single XOR chain).
    """
    all_bits = np.concatenate([np.asarray(s, np.uint8) for s in strings])
    rel = np.zeros(all_bits.size, np.uint8)
    acc = 0
    for k, bbit in enumerate(all_bits):
        acc ^= int(bbit)        # rel[k-1] ^ bits[k] = rel[k]
        rel[k] = acc
    out = []
    for si in range(len(strings)):
        out.append(TIME_MARK)
        seg = rel[85 * si:85 * (si + 1)]
        halves = np.empty(170, np.int8)
        halves[0::2] = 2 * seg.astype(np.int8) - 1        # odd: rel
        halves[1::2] = 1 - 2 * seg.astype(np.int8)        # even: ~rel
        out.append(halves)
    return np.concatenate(out)


def _meander_decode(half_bits: np.ndarray) -> np.ndarray:
    """bi-binary half-bit 0/1 values -> absolute bits
    (NAVdecoding.m:75-86 / ephemeris.m:31-44)."""
    odd = half_bits[0::2].astype(np.int8)
    even = half_bits[1::2].astype(np.int8)
    rel = ((odd - even + 1) // 2).astype(np.uint8)
    bits = np.zeros(rel.size, np.uint8)
    bits[1:] = rel[:-1] ^ rel[1:]
    return bits


def decode_prompt_stream(i_p: np.ndarray, eph: dict | None = None):
    """Full GLONASS nav decode from 1 ms prompt correlators.

    Returns (eph, first_string_start_ms, TOD) — start is the ms index of
    the first data bit after the verified time mark (NAVdecoding.m flow).
    """
    eph = {} if eph is None else eph
    sym = np.where(np.asarray(i_p) > 0, 1, -1).astype(np.float64)
    pattern = np.kron(TIME_MARK.astype(np.float64), np.ones(10))
    corr = np.correlate(sym, pattern, mode="valid")
    cands = np.where(np.abs(corr) > 271)[0] + MARK_MS
    cand_set = set(cands.tolist())
    need = 14 * STRING_MS + 1700
    for start in cands:
        if (start + STRING_MS) not in cand_set:
            continue
        if start + need > len(sym):
            continue
        # polarity from the time-mark correlation sign
        pol = 1.0 if corr[start - MARK_MS] > 0 else -1.0
        seg = pol * sym[start:start + 1700]
        halves = (seg.reshape(170, 10).sum(axis=1) > 0).astype(np.uint8)
        bits = _meander_decode(halves)
        if not glonass_hamming_check(bits):
            continue
        # decode 15 consecutive strings with one differential chain
        all_halves = []
        for s in range(15):
            seg = pol * sym[start + s * STRING_MS:
                            start + s * STRING_MS + 1700]
            all_halves.append(
                (seg.reshape(170, 10).sum(axis=1) > 0).astype(np.uint8))
        allbits = _meander_decode(np.concatenate(all_halves))
        tod = np.inf
        for s in range(15):
            sid = decode_string(allbits[85 * s:85 * (s + 1)], eph)
            if sid == 1 and np.isinf(tod):
                tod = eph["TOD"] - 2.0 * s
        eph["TOD_first"] = tod
        return eph, int(start), tod
    return eph, np.inf, np.inf


def has_ephemeris(eph: dict) -> bool:
    return {1, 2, 3, 4} <= eph.get("idValid", set())
