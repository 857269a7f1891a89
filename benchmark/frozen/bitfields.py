"""Shared bit-field extraction/placement for nav-message codecs.

Field tables are tuples (name, start_bit_1based, nbits, scale_exp, signed,
factor) mirroring the reference's bin2dec/twosComp2dec parsers.
"""

from __future__ import annotations

import numpy as np


def get_bits(bits: np.ndarray, start: int, n: int) -> int:
    """MSB-first integer from bits[start-1 : start-1+n] (1-based)."""
    val = 0
    for b in bits[start - 1:start - 1 + n]:
        val = (val << 1) | int(b)
    return val


def twos(val: int, n: int) -> int:
    return val - (1 << n) if val >= (1 << (n - 1)) else val


def put_bits(bits: np.ndarray, start: int, n: int, value: int):
    v = int(value)
    if v < 0:
        v += (1 << n)
    for k in range(n):
        bits[start - 1 + k] = (v >> (n - 1 - k)) & 1


def extract_fields(bits: np.ndarray, table, eph: dict):
    for name, start, n, exp, signed, factor in table:
        raw = get_bits(bits, start, n)
        if signed:
            raw = twos(raw, n)
        eph[name] = raw * (2.0 ** exp) * factor


def place_fields(bits: np.ndarray, table, eph: dict):
    for name, start, n, exp, signed, factor in table:
        raw = int(round(eph.get(name, 0.0) / factor / (2.0 ** exp)))
        put_bits(bits, start, n, raw)
