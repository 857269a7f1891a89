"""Measurement formation and navigation solution."""

from .pseudorange import calculate_pseudoranges  # noqa: F401
from .lsq import least_square_pos  # noqa: F401
