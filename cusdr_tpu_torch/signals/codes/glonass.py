"""GLONASS standard-accuracy ranging code.

All GLONASS satellites share a single 511-chip m-sequence @ 0.511 Mcps
(FDMA separates satellites by carrier frequency).  Behavior matches
GLO/GLO_GL1/include/generateCAcode.m:94-107: 9-stage register, feedback from
cells 5 and 9, output from cell 7, all-ones init, chip = register output in
the bit-1 -> -1 convention.
"""

from __future__ import annotations

import functools

import numpy as np

from .lfsr import fibonacci_lfsr


@functools.lru_cache(maxsize=None)
def glonass_ca() -> np.ndarray:
    """GLONASS m-sequence: 511 ±1 chips (bit 1 -> -1)."""
    bits = fibonacci_lfsr(9, (5, 9), 7, 511)
    return (1 - 2 * bits.astype(np.int8))
