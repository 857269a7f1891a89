"""Bit-domain LFSR primitives for GNSS spreading-code generation.

All generators work on 0/1 numpy arrays internally; the per-signal modules
map bits to the chip (±1) conventions used by each ICD.  These run on host
(they are tiny, one-time, and cached); devices only ever see the finished
chip arrays.
"""

from __future__ import annotations

import numpy as np


def fibonacci_lfsr(n_stages: int,
                   taps: tuple,
                   out_stage: int,
                   length: int,
                   init_bits=None,
                   out_taps: tuple | None = None,
                   reset_state=None,
                   advance: int = 0) -> np.ndarray:
    """Simple (Fibonacci) LFSR.

    Register cells are 1-indexed ``reg[1..n]``; each step outputs a bit, then
    computes ``fb = XOR(reg[t] for t in taps)``, shifts right
    (``reg[2:] = reg[:-1]``) and sets ``reg[1] = fb``.

    Args:
      out_stage: cell index whose value is emitted (ignored if ``out_taps``).
      out_taps: if given, output bit is XOR of these cells (BeiDou B1I G2
        phase-assignment style).
      init_bits: iterable of n bits; default all ones.
      reset_state: optional bit tuple; when the register equals it, the next
        state is all-ones instead of shifting (GPS L5 XA / B3I CA short
        cycle).
      advance: clock the register this many times before producing output
        (GPS L5 XB / B3I CB per-PRN code advance).

    Returns: uint8 array of ``length`` bits.
    """
    reg = np.ones(n_stages, dtype=np.uint8) if init_bits is None \
        else np.asarray(init_bits, dtype=np.uint8).copy()
    assert reg.size == n_stages
    taps0 = np.asarray(taps, dtype=np.int64) - 1
    reset = None if reset_state is None else \
        np.asarray(reset_state, dtype=np.uint8)

    def step():
        if reset is not None and np.array_equal(reg, reset):
            reg[:] = 1
        else:
            fb = np.bitwise_xor.reduce(reg[taps0])
            reg[1:] = reg[:-1]
            reg[0] = fb

    for _ in range(advance):
        step()

    out = np.empty(length, dtype=np.uint8)
    if out_taps is not None:
        ot = np.asarray(out_taps, dtype=np.int64) - 1
        for i in range(length):
            out[i] = np.bitwise_xor.reduce(reg[ot])
            step()
    else:
        oi = out_stage - 1
        for i in range(length):
            out[i] = reg[oi]
            step()
    return out


def galois_lfsr(n_stages: int,
                taps: tuple,
                init_bits,
                length: int) -> np.ndarray:
    """Modular (Galois) LFSR as used by GPS L2 CM/CL (IS-GPS-200 fig. 3-13).

    Each step: output = reg[n]; rotate right (reg = [reg[n], reg[1..n-1]]);
    then reg[t] ^= output for each tap t.

    Returns uint8 bit array of ``length``.
    """
    reg = np.asarray(init_bits, dtype=np.uint8).copy()
    assert reg.size == n_stages
    taps0 = np.asarray(taps, dtype=np.int64) - 1
    out = np.empty(length, dtype=np.uint8)
    for i in range(length):
        o = reg[-1]
        out[i] = o
        reg[1:] = reg[:-1]
        reg[0] = o
        if o:
            reg[taps0] ^= 1
    return out


def dual_shift_left_lfsr(n_stages: int,
                         taps1: np.ndarray,
                         taps2: np.ndarray,
                         init2_bits,
                         length: int) -> np.ndarray:
    """Galileo E5 AltBOC base-register pair (OS SIS ICD §3.3).

    Two left-shifting registers; output = reg1[1] XOR reg2[1]; feedback =
    XOR of tapped cells, inserted at the right end.  ``taps*`` are 0/1 masks
    over the 14 cells (MSB first).  Register 1 starts all-ones; register 2
    from ``init2_bits``.

    Returns uint8 bit array (chip bit; map to ±1 as 1-2b).
    """
    r1 = np.ones(n_stages, dtype=np.uint8)
    r2 = np.asarray(init2_bits, dtype=np.uint8).copy()
    m1 = np.asarray(taps1, dtype=np.uint8)
    m2 = np.asarray(taps2, dtype=np.uint8)
    out = np.empty(length, dtype=np.uint8)
    for i in range(length):
        out[i] = r1[0] ^ r2[0]
        fb1 = np.bitwise_xor.reduce(r1 & m1)
        fb2 = np.bitwise_xor.reduce(r2 & m2)
        r1[:-1] = r1[1:]
        r2[:-1] = r2[1:]
        r1[-1] = fb1
        r2[-1] = fb2
    return out


def int_to_bits(value: int, width: int) -> np.ndarray:
    """MSB-first bit vector of ``value`` (uint8)."""
    return np.asarray([(value >> (width - 1 - i)) & 1 for i in range(width)],
                      dtype=np.uint8)


def bits_to_chips(bits: np.ndarray, one_is_plus: bool) -> np.ndarray:
    """Map 0/1 bits to ±1 chips (int8).

    one_is_plus=True: bit 1 -> +1 (GPS L1 C/A convention, generateCAcode.m:90)
    one_is_plus=False: bit 1 -> -1 (register-output convention elsewhere)
    """
    b = bits.astype(np.int8)
    return (2 * b - 1) if one_is_plus else (1 - 2 * b)
