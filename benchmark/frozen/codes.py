"""Spreading codes: GPS L1 C/A (IS-GPS-200 G1/G2 registers,
generateCAcode.m), Galileo E5a-I/Q (OS SIS ICD register pairs,
generateE5aIcode.m, with their CS20 and CS100 secondary codes; the per-PRN
start values and CS100 codes in data/gal_e5.npz, a copy of
cusdr_tpu_torch's ICD table), and nearest-sample code sampling
(makeCaTable.m)."""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np

_E5_TABLE = Path(__file__).resolve().parent / "data" / "gal_e5.npz"
# feedback tap words (octal) of the two E5a base registers
# (generateE5aIcode.m:55-57)
_E5A_TAPS = (0o40503, 0o50661)

# IS-GPS-200 table 3-I: G2 delay of PRNs 1-32 (generateCAcode.m:42-50)
G2_DELAYS = (5, 6, 7, 8, 17, 18, 139, 140, 141, 251, 252, 254, 255, 256,
             257, 258, 469, 470, 471, 472, 473, 474, 509, 512, 513, 514,
             515, 516, 859, 860, 861, 862)


def _register(taps) -> np.ndarray:
    """1 023 output bits of a 10-cell all-ones register read at cell 10,
    fed back with the XOR of ``taps`` (1-based cells)."""
    reg = np.ones(10, np.uint8)
    out = np.empty(1023, np.uint8)
    t = np.asarray(taps) - 1
    for i in range(1023):
        out[i] = reg[9]
        fb = np.bitwise_xor.reduce(reg[t])
        reg[1:] = reg[:-1]
        reg[0] = fb
    return out


@functools.lru_cache(maxsize=None)
def l1ca(prn: int) -> np.ndarray:
    """1 023 +-1 chips (int8) of PRN 1-32; bit 1 -> +1."""
    g1 = _register((3, 10))
    g2 = _register((2, 3, 6, 8, 9, 10))
    bits = g1 ^ np.roll(g2, G2_DELAYS[prn - 1])
    return 2 * bits.astype(np.int8) - 1


def sample_code(chips: np.ndarray, chip_rate_hz: float, fs: float,
                n: int, code_phase_chips: float = 0.0) -> np.ndarray:
    """The chip under each of ``n`` samples: sample k sits at chip phase
    code_phase + k * chip_rate / fs (one element per chip)."""
    phase = code_phase_chips + np.arange(n, dtype=np.float64) * (
        chip_rate_hz / fs)
    return chips[np.floor(phase).astype(np.int64) % len(chips)]


def _bits(value: int, width: int) -> np.ndarray:
    """MSB-first bits of ``value``."""
    return np.asarray([(value >> (width - 1 - i)) & 1 for i in range(width)],
                      np.uint8)


@functools.lru_cache(maxsize=None)
def _e5_table():
    return dict(np.load(_E5_TABLE))


def _e5a(key: str, prn: int) -> np.ndarray:
    """10 230 chips of a pair of 14-cell left-shifting registers: the first
    from all ones, the second from the PRN's start value; output the XOR
    of their first cells, feedback the XOR of the tapped cells; bit 1 ->
    -1."""
    masks = [_bits(w, w.bit_length())[:14] for w in _E5A_TAPS]
    r1 = np.ones(14, np.uint8)
    r2 = _bits(int(_e5_table()[key][prn - 1]), 14)
    out = np.empty(10_230, np.uint8)
    for i in range(10_230):
        out[i] = r1[0] ^ r2[0]
        f1 = np.bitwise_xor.reduce(r1 & masks[0])
        f2 = np.bitwise_xor.reduce(r2 & masks[1])
        r1[:-1], r2[:-1] = r1[1:].copy(), r2[1:].copy()
        r1[-1], r2[-1] = f1, f2
    return 1 - 2 * out.astype(np.int8)


@functools.lru_cache(maxsize=None)
def e5ai(prn: int) -> np.ndarray:
    """E5a-I (data) primary code, 10 230 +-1 chips."""
    return _e5a("e5ai_init", prn)


@functools.lru_cache(maxsize=None)
def e5aq(prn: int) -> np.ndarray:
    """E5a-Q (pilot) primary code."""
    return _e5a("e5aq_init", prn)


def _hex_chips(hexstr: str, n: int) -> np.ndarray:
    return 1 - 2 * _bits(int(hexstr, 16), n).astype(np.int8)


# E5a-I secondary code CS20 (generateE5aIcode.m tail)
E5AI_SECONDARY = _hex_chips("842E9", 20)


@functools.lru_cache(maxsize=None)
def e5aq_secondary(prn: int) -> np.ndarray:
    """E5a-Q secondary code CS100 of the PRN (OS SIS ICD table 19)."""
    return _hex_chips(str(_e5_table()["e5aq_sec"][prn - 1]), 100)
