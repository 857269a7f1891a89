"""Forward-error-correction primitives shared by the modern nav messages.

 * Viterbi decoder, K=7, rate 1/2, G=[171,133] octal — used by GPS CNAV
   (GPS_L2C/include/CNAVdecoding.m:70-86), Galileo I/NAV and F/NAV
   (GAL_E1C/include/NAVdecoding.m:122) — plus the matching encoder for
   test synthesis.
 * CRC-24Q (Qualcomm, polynomial 0x1864CFB) — CNAV/I/NAV/F/NAV/B-CNAV
   message check (CNAVdecoding.m:123-127).
 * BCH(21,6)/BCH(51,8) maximum-likelihood correlation decode used by
   BeiDou B-CNAV1 subframe 1 (BDS/B1C/include/BCH21_6Decoding.m:43-85).
 * (15,11) Hamming check used by GLONASS strings
   (GLO/GLO_GL1/include/dataVerification.m).

All are vectorized numpy on host — at ≤250 symbols/s/channel these are
far off the hot path (SURVEY.md §7 step 5).
"""

from __future__ import annotations

import functools

import numpy as np

# --- Convolutional code K=7, rate 1/2, G1=171o G2=133o ----------------------

_K = 7
_G1 = 0o171
_G2 = 0o133


def _parity(x: np.ndarray) -> np.ndarray:
    x = x ^ (x >> 4)
    x = x ^ (x >> 2)
    x = x ^ (x >> 1)
    return x & 1


@functools.lru_cache(maxsize=1)
def _trellis():
    """Transition tables over 64 states (state = 6 most recent input bits,
    MATLAB poly2trellis(7,[171 133]) convention: state <<1 | bit, output
    bits from G1(MSB-first taps) then G2)."""
    states = np.arange(64, dtype=np.int64)
    nxt = np.empty((64, 2), np.int64)
    out = np.empty((64, 2, 2), np.int8)
    for b in (0, 1):
        # 7-bit register with the newest bit at the MSB (poly2trellis
        # convention: generator taps read MSB-first, newest..oldest)
        reg = (b << 6) | states
        nxt[:, b] = reg >> 1
        out[:, b, 0] = _parity(reg & _G1)
        out[:, b, 1] = _parity(reg & _G2)
    return nxt, out


def conv_encode(bits: np.ndarray, tail: bool = True) -> np.ndarray:
    """Encode 0/1 bits with the K=7 [171,133] code (2 output bits per
    input); optional 6-bit zero tail flush."""
    data = np.concatenate([np.asarray(bits, np.uint8),
                           np.zeros(6 if tail else 0, np.uint8)])
    nxt, out = _trellis()
    state = 0
    y = np.empty(2 * len(data), np.int8)
    for i, b in enumerate(data):
        y[2 * i] = out[state, b, 0]
        y[2 * i + 1] = out[state, b, 1]
        state = nxt[state, b]
    return y


def viterbi_decode(soft: np.ndarray, n_bits: int,
                   truncated: bool = True) -> np.ndarray:
    """Viterbi decode ±soft symbols (2 per bit; positive = binary 0...
    convention: symbol s relates to code bit c by s = 1-2c, i.e. +1 ⇒ 0).

    soft: [2*n_bits(+tail)] float — received symbols.
    truncated: traceback from the best end state ('trunc' mode of vitdec,
    CNAVdecoding.m:85-86).

    Returns decoded bits [n_bits] (uint8).  Vectorized over the 64 states.
    """
    nxt, out = _trellis()
    sym = np.asarray(soft, np.float64)
    n_steps = len(sym) // 2
    # branch metric: correlation of expected (1-2c) with received
    exp0 = 1.0 - 2.0 * out[:, :, 0].astype(np.float64)   # [64,2]
    exp1 = 1.0 - 2.0 * out[:, :, 1].astype(np.float64)

    metrics = np.full(64, -1e18)
    metrics[0] = 0.0
    back = np.empty((n_steps, 64), np.int8)      # chosen input bit
    prev = np.empty((n_steps, 64), np.int64)     # predecessor state

    # precompute predecessor lists: for each state s' the two (s, b)
    preds = [[] for _ in range(64)]
    for s in range(64):
        for b in (0, 1):
            preds[nxt[s, b]].append((s, b))
    pred_state = np.asarray([[p[0][0], p[1][0]] for p in preds])
    pred_bit = np.asarray([[p[0][1], p[1][1]] for p in preds])

    for t in range(n_steps):
        s0, s1 = sym[2 * t], sym[2 * t + 1]
        bm = exp0 * s0 + exp1 * s1                   # [64, 2]
        cand = metrics[pred_state] + bm[pred_state, pred_bit]  # [64, 2]
        choice = np.argmax(cand, axis=1)
        metrics = cand[np.arange(64), choice]
        prev[t] = pred_state[np.arange(64), choice]
        back[t] = pred_bit[np.arange(64), choice]

    state = int(np.argmax(metrics)) if truncated else 0
    bits = np.empty(n_steps, np.uint8)
    for t in range(n_steps - 1, -1, -1):
        bits[t] = back[t, state]
        state = prev[t, state]
    return bits[:n_bits]


# --- CRC-24Q ---------------------------------------------------------------

_CRC24Q_POLY = 0x1864CFB


@functools.lru_cache(maxsize=1)
def _crc24q_table():
    table = np.zeros(256, np.uint32)
    for i in range(256):
        crc = i << 16
        for _ in range(8):
            crc <<= 1
            if crc & 0x1000000:
                crc ^= _CRC24Q_POLY
        table[i] = crc & 0xFFFFFF
    return table

def crc24q(bits: np.ndarray) -> int:
    """CRC-24Q over a 0/1 bit array (MSB-first), init 0."""
    bits = np.asarray(bits, np.uint8)
    pad = (-len(bits)) % 8
    if pad:
        bits = np.concatenate([np.zeros(pad, np.uint8), bits])
    data = np.packbits(bits)
    table = _crc24q_table()
    crc = 0
    for byte in data:
        crc = ((crc << 8) & 0xFFFFFF) ^ int(table[((crc >> 16) ^ byte)
                                                  & 0xFF])
    return crc


def crc24q_check(bits_with_crc: np.ndarray) -> bool:
    """True iff the last 24 bits are the CRC-24Q of the preceding bits."""
    bits = np.asarray(bits_with_crc, np.uint8)
    return crc24q(bits[:-24]) == int(
        bits[-24:].dot(1 << np.arange(23, -1, -1)))


def crc24q_append(bits: np.ndarray) -> np.ndarray:
    crc = crc24q(bits)
    tail = np.asarray([(crc >> k) & 1 for k in range(23, -1, -1)],
                      np.uint8)
    return np.concatenate([np.asarray(bits, np.uint8), tail])


# --- BCH maximum-likelihood correlation decode (B-CNAV1 subframe 1) --------

def _bch_codebook(n: int, k: int, taps_1based) -> np.ndarray:
    """All 2^k codewords of the B-CNAV1 BCH codes.

    Mirrors the reference's exhaustive encoder
    (BCH21_6Decoding.m:16-42): the k info bits (MSB first) are loaded
    reversed into a k-stage register; each step emits the last cell,
    then shifts right with feedback = XOR of the tapped cells.
    """
    words = np.zeros((1 << k, n), np.int8)
    taps = [t - 1 for t in taps_1based]
    for m in range(1 << k):
        info = [(m >> (k - 1 - i)) & 1 for i in range(k)]
        r = info[::-1]
        seq = []
        for _ in range(n):
            seq.append(r[-1])
            fb = 0
            for t in taps:
                fb ^= r[t]
            r = [fb] + r[:-1]
        words[m] = seq
    return words


@functools.lru_cache(maxsize=None)
def bch_codebook_21_6() -> np.ndarray:
    """BCH(21,6) codewords (B1C subframe-1 PRN/SOH field;
    BCH21_6Decoding.m taps [2 4 5 6])."""
    return _bch_codebook(21, 6, (2, 4, 5, 6))


@functools.lru_cache(maxsize=None)
def bch_codebook_51_8() -> np.ndarray:
    """BCH(51,8) codewords (B1C subframe-1 SOW field;
    BCH51_8Decoding.m taps [1 4 5 6 7 8])."""
    return _bch_codebook(51, 8, (1, 4, 5, 6, 7, 8))


def bch_ml_decode(soft: np.ndarray, codebook: np.ndarray) -> int:
    """Maximum-likelihood decode: correlate soft symbols (+1 ⇒ bit 0)
    against every codeword, return the info-word index
    (BCH21_6Decoding.m:43-85)."""
    expect = 1.0 - 2.0 * codebook.astype(np.float64)
    return int(np.argmax(expect @ np.asarray(soft, np.float64)))


# --- GLONASS (85,77+8) Hamming check ---------------------------------------

# Parity-check groups per GLONASS ICD 4.7 (dataVerification.m): each check
# bit covers a fixed set of data-bit positions.
_GLO_CHECKS = [
    (9, 10, 12, 13, 15, 17, 19, 20, 22, 24, 26, 28, 30, 32, 34, 35, 37,
     39, 41, 43, 45, 47, 49, 51, 53, 55, 57, 59, 61, 63, 65, 66, 68, 70,
     72, 74, 76, 78, 80, 82, 84),
    (9, 11, 12, 14, 15, 18, 19, 21, 22, 25, 26, 29, 30, 33, 34, 36, 37,
     40, 41, 44, 45, 48, 49, 52, 53, 56, 57, 60, 61, 64, 65, 67, 68, 71,
     72, 75, 76, 79, 80, 83, 84),
    (10, 11, 12, 16, 17, 18, 19, 23, 24, 25, 26, 31, 32, 33, 34, 38, 39,
     40, 41, 46, 47, 48, 49, 54, 55, 56, 57, 62, 63, 64, 65, 69, 70, 71,
     72, 77, 78, 79, 80, 85),
    (13, 14, 15, 16, 17, 18, 19, 27, 28, 29, 30, 31, 32, 33, 34, 42, 43,
     44, 45, 46, 47, 48, 49, 58, 59, 60, 61, 62, 63, 64, 65, 73, 74, 75,
     76, 77, 78, 79, 80),
    (20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 50, 51,
     52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63, 64, 65, 81, 82, 83,
     84, 85),
    (35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
     52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63, 64, 65),
    (66, 67, 68, 69, 70, 71, 72, 73, 74, 75, 76, 77, 78, 79, 80, 81, 82,
     83, 84, 85),
]


def glonass_hamming_check(bits85: np.ndarray) -> bool:
    """GLONASS string check: bits85[0] is bit 85 (MSB, idle=0), bits85[84]
    is bit 1.  Data bits 9..85, check bits 1..8 (GLONASS ICD 4.7).

    Returns True when the string passes.
    """
    b = np.asarray(bits85, np.uint8)
    if len(b) != 85:
        raise ValueError("need 85 bits")
    # bit index i (1..85) -> array position 85-i
    def bit(i):
        return int(b[85 - i])

    c = []
    for j, grp in enumerate(_GLO_CHECKS, start=1):
        acc = bit(j)
        for i in grp:
            acc ^= bit(i)
        c.append(acc)
    # C8: parity(bits 1..8) xor parity(bits 9..85)
    acc = 0
    for i in range(1, 86):
        acc ^= bit(i)
    c8 = acc
    # acceptance rule of dataVerification.m:28-32: all-zero, or exactly
    # one of C1..C7 set together with C8 set
    if all(v == 0 for v in c) and c8 == 0:
        return True
    return sum(c) == 1 and c8 == 1
