"""GNSS spreading-code library (host-side, numpy, cached).

Public API: per-signal generators returning ±1 int8 chip arrays in the same
sign conventions as the reference receivers, so correlator outputs are
directly comparable.
"""

from .gps import (G2_DELAYS, l1ca, l2cm, l2cl, l2cm_rz, l2cl_rz, l5i, l5q)
from .galileo import (e1b, e1c, e1b_primary, e1c_primary, e5ai, e5aq, e5bi,
                      e5bq, e5aq_secondary, e5bq_secondary, E5AI_SECONDARY,
                      E5BI_SECONDARY, E1C_SECONDARY, boc11)
from .beidou import (b1i, b3i, b2a_data, b2a_pilot, b1c_data_primary,
                     b1c_pilot_primary, b1c_secondary, b1c_data_boc11,
                     b1c_pilot_boc11, b1c_pilot_boc61, NH20, NH10, NH5)
from .glonass import glonass_ca

__all__ = [
    "G2_DELAYS", "l1ca", "l2cm", "l2cl", "l2cm_rz", "l2cl_rz", "l5i", "l5q",
    "e1b", "e1c", "e1b_primary", "e1c_primary", "e5ai", "e5aq", "e5bi",
    "e5bq", "e5aq_secondary", "e5bq_secondary", "E5AI_SECONDARY",
    "E5BI_SECONDARY", "E1C_SECONDARY", "boc11",
    "b1i", "b3i", "b2a_data", "b2a_pilot", "b1c_data_primary",
    "b1c_pilot_primary", "b1c_secondary", "b1c_data_boc11",
    "b1c_pilot_boc11", "b1c_pilot_boc61", "NH20", "NH10", "NH5",
    "glonass_ca",
]
