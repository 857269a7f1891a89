"""GPS L1 C/A: data only, 1 023 chips, LNAV at 50 bps."""

from ...frozen.codes import l1ca
from ..synth import Signal


def signal(g: dict) -> Signal:
    return Signal(carrier_freq_hz=g["carrier_freq_hz"],
                  chip_rate_hz=g["chip_rate_hz"],
                  code_length_chips=g["code_length_chips"],
                  nav_symbol_ms=g["nav_symbol_ms"], data_code=l1ca)
