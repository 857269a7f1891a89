"""Galileo E5a: 10 230-chip E5a-I (data, CS20 secondary, F/NAV symbols at
50 sps) and E5a-Q (pilot, CS100 secondary)."""

from ...frozen.codes import E5AI_SECONDARY, e5ai, e5aq, e5aq_secondary
from ..synth import Signal


def signal(g: dict) -> Signal:
    return Signal(carrier_freq_hz=g["carrier_freq_hz"],
                  chip_rate_hz=g["chip_rate_hz"],
                  code_length_chips=g["code_length_chips"],
                  nav_symbol_ms=g["nav_symbol_ms"], data_code=e5ai,
                  data_secondary=lambda prn: E5AI_SECONDARY,
                  pilot_code=e5aq, pilot_secondary=e5aq_secondary)
