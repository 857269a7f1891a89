"""GPS CNAV message codec (L2C 25 bps / L5 50 bps data).

Decode semantics mirror GPS/GPS_L2C/include/CNAVdecoding.m +
include/ephemeris.m: rate-1/2 K=7 convolutional stream with unknown G1/G2
symbol phase, preamble 10001011 search on the decoded bits, polarity fix,
CRC-24Q over the 300-bit message, then message-type field extraction
(MT10/11 ephemeris halves, MT30-37 clock).  The encoder inverts the path
for test synthesis.  TOW = bits 21:37 ×6 − 12 (ephemeris.m:239).
"""

from __future__ import annotations

import numpy as np

from ..constants import GPS_PI
from .fec import conv_encode, crc24q_append, crc24q_check, viterbi_decode

PREAMBLE = np.asarray([1, 0, 0, 0, 1, 0, 1, 1], np.uint8)
MSG_BITS = 300

# (name, start(1-based), nbits, scale_exp, signed, factor)
_MT10 = [
    ("PRN", 9, 6, 0, False, 1.0),
    ("weekNumber", 39, 13, 0, False, 1.0),
    ("health", 53, 1, 0, False, 1.0),
    ("T_op", 55, 11, 0, False, 300.0),
    ("URA_ED", 66, 5, 0, True, 1.0),
    ("t_oe", 71, 11, 0, False, 300.0),
    ("deltaA", 82, 26, -9, True, 1.0),
    ("ADot", 108, 25, -21, True, 1.0),
    ("delta_n_0", 133, 17, -44, True, GPS_PI),
    ("delta_n_0Dot", 150, 23, -57, True, GPS_PI),
    ("M_0", 173, 33, -32, True, GPS_PI),
    ("e", 206, 33, -34, False, 1.0),
    ("omega", 239, 33, -32, True, GPS_PI),
]
_MT11 = [
    ("PRN", 9, 6, 0, False, 1.0),
    ("t_oe", 39, 11, 0, False, 300.0),
    ("omega_0", 50, 33, -32, True, GPS_PI),
    ("i_0", 83, 33, -32, True, GPS_PI),
    ("delta_omegaDot", 116, 17, -44, True, GPS_PI),
    ("i_0Dot", 133, 15, -44, True, GPS_PI),
    ("C_is", 148, 16, -30, True, 1.0),
    ("C_ic", 164, 16, -30, True, 1.0),
    ("C_rs", 180, 24, -8, True, 1.0),
    ("C_rc", 204, 24, -8, True, 1.0),
    ("C_us", 228, 21, -30, True, 1.0),
    ("C_uc", 249, 21, -30, True, 1.0),
]
_MT30 = [
    ("PRN", 9, 6, 0, False, 1.0),
    ("t_oc", 61, 11, 0, False, 300.0),
    ("a_f0", 72, 26, -35, True, 1.0),
    ("a_f1", 98, 20, -48, True, 1.0),
    ("a_f2", 118, 10, -60, True, 1.0),
    ("T_GD", 128, 13, -35, True, 1.0),
    ("ISC_L2C", 154, 13, -35, True, 1.0),
    ("alpha0", 193, 8, -30, True, 1.0),
    ("alpha1", 201, 8, -27, True, 1.0),
    ("alpha2", 209, 8, -24, True, 1.0),
    ("alpha3", 217, 8, -24, True, 1.0),
    ("beta0", 225, 8, 11, True, 1.0),
    ("beta1", 233, 8, 14, True, 1.0),
    ("beta2", 241, 8, 16, True, 1.0),
    ("beta3", 249, 8, 16, True, 1.0),
]
# MT31-37 share the clock block (ephemeris.m:108-134)
_CLOCK_ONLY = [
    ("PRN", 9, 6, 0, False, 1.0),
    ("t_oc", 61, 11, 0, False, 300.0),
    ("a_f0", 72, 26, -35, True, 1.0),
    ("a_f1", 98, 20, -48, True, 1.0),
    ("a_f2", 118, 10, -60, True, 1.0),
]

MESSAGE_FIELDS = {10: _MT10, 11: _MT11, 30: _MT30,
                  31: _CLOCK_ONLY, 32: _CLOCK_ONLY, 33: _CLOCK_ONLY,
                  34: _CLOCK_ONLY, 35: _CLOCK_ONLY, 36: _CLOCK_ONLY,
                  37: _CLOCK_ONLY}


def _get(bits, start, n):
    val = 0
    for b in bits[start - 1:start - 1 + n]:
        val = (val << 1) | int(b)
    return val


def _twos(val, n):
    return val - (1 << n) if val >= (1 << (n - 1)) else val


def decode_message(bits300: np.ndarray, eph: dict,
                   msg_seconds: float = 12.0):
    """Decode one CRC-valid 300-bit CNAV message into ``eph``; returns
    (message_id, tow_of_message_start).

    The TOW field counts from the NEXT message start; ``msg_seconds`` is
    the message duration (12 s at 25 sps on L2C, 6 s at 50 sps on L5 —
    GPS_L2C/include/CNAVdecoding.m vs GPS_L5C variant)."""
    mid = _get(bits300, 15, 6)
    tow = _get(bits300, 21, 17) * 6 - msg_seconds
    fields = MESSAGE_FIELDS.get(mid)
    if fields:
        for name, start, n, exp, signed, factor in fields:
            raw = _get(bits300, start, n)
            if signed:
                raw = _twos(raw, n)
            eph[name] = raw * (2.0 ** exp) * factor
        eph.setdefault("idValid", set()).add(mid)
    return mid, tow


def encode_message(mid: int, eph: dict, tow_next: int,
                   prn: int) -> np.ndarray:
    """Build one 300-bit CNAV message (276 data + CRC-24Q)."""
    bits = np.zeros(276, np.uint8)

    def put(start, n, value):
        v = int(value)
        if v < 0:
            v += (1 << n)
        for k in range(n):
            bits[start - 1 + k] = (v >> (n - 1 - k)) & 1

    put(1, 8, int("".join(map(str, PREAMBLE)), 2))
    put(9, 6, prn)
    put(15, 6, mid)
    put(21, 17, tow_next // 6)
    for name, start, n, exp, signed, factor in MESSAGE_FIELDS[mid]:
        if name == "PRN":
            continue
        raw = int(round(eph.get(name, 0.0) / factor / (2.0 ** exp)))
        put(start, n, raw)
    return crc24q_append(bits)


def encode_symbol_stream(messages, start_state_bits=None) -> np.ndarray:
    """Convolutionally encode a sequence of 300-bit messages into ±1
    symbols (2 per bit, continuous encoder state across messages)."""
    bits = np.concatenate([np.asarray(m, np.uint8) for m in messages])
    coded = conv_encode(bits, tail=True)
    return (1 - 2 * coded.astype(np.int8))


def decode_stream(symbols: np.ndarray, eph: dict | None = None,
                  msg_seconds: float = 12.0):
    """Full CNAVdecoding.m path over ±soft symbols.

    Tries both G1/G2 phases, Viterbi-decodes, searches the preamble with
    polarity resolution, CRC-checks each 300-bit candidate, decodes all
    valid messages.

    Returns (eph, first_symbol_index, tow) — first_symbol_index is the
    symbol offset of the first valid message (CNAVdecoding.m:118-123);
    tow is the TOW at that message start.
    """
    eph = {} if eph is None else eph
    first = None
    tow_first = np.inf
    for phase in (0, 1):
        sym = symbols[phase: len(symbols) - phase]
        n_bits = len(sym) // 2
        decoded = viterbi_decode(sym[:2 * n_bits], n_bits)
        dec_pm = 1 - 2 * decoded.astype(np.int8)
        corr = np.correlate(dec_pm.astype(np.float64),
                            (1 - 2 * PREAMBLE.astype(np.float64)),
                            mode="valid")
        for idx in np.where(np.abs(corr) == 8)[0]:
            if idx + MSG_BITS > n_bits:
                continue
            cand = decoded[idx:idx + MSG_BITS].copy()
            if not np.array_equal(cand[:8], PREAMBLE):
                cand = 1 - cand
            if not crc24q_check(cand):
                continue
            mid, tow = decode_message(cand, eph, msg_seconds)
            if first is None:
                first = idx * 2 + phase
                tow_first = tow
        if first is not None:
            break
    return eph, (np.inf if first is None else first), tow_first


def has_ephemeris(eph: dict) -> bool:
    """MT10 + MT11 + a clock message (CNAVdecoding semantics)."""
    valid = eph.get("idValid", set())
    return 10 in valid and 11 in valid and any(
        m in valid for m in range(30, 38))
