"""Geodetic transforms and atmospheric corrections."""

from .transforms import (cart2geo, cart2utm, check_t, deg2dms, dms2deg,  # noqa: F401
                         e_r_corr, find_utm_zone, geo2cart, togeod,
                         topocent)
from .tropo import tropo  # noqa: F401
