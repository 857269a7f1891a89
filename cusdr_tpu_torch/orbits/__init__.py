"""Satellite orbit models: Keplerian broadcast ephemeris and GLONASS
state-vector integration."""

from .kepler import sat_pos_kepler  # noqa: F401
