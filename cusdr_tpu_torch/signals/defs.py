"""Signal-definition registry: the 12 receivers collapse into data.

Each reference receiver directory (GPS/GPS_L1CA, BDS/B1C, ...) becomes one
``SignalDef`` entry: code generators + numerology + nav-codec key.  The
acquisition/tracking/nav engines are parameterized by these entries instead
of being copied per signal (reference duplicates ~5k LoC per receiver).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional, Tuple

import numpy as np

from .codes import beidou, galileo, glonass, gps


@dataclass(frozen=True)
class SignalDef:
    """Static description of one GNSS signal.

    ``*_code`` return ±1 int8 arrays of *code elements*; for BOC signals an
    element is a half-chip (or 1/12 chip for BOC(6,1)) and
    ``elements_per_chip`` > 1.  Replica tables sample elements at
    fs * elements_per_chip * chip_rate.
    """

    name: str
    constellation: str
    carrier_freq_hz: float          # nominal RF carrier (for code Doppler)
    chip_rate_hz: float
    code_length_chips: int
    data_code: Callable[[int], np.ndarray]
    pilot_code: Optional[Callable[[int], np.ndarray]] = None
    elements_per_chip: int = 1
    # acquisition components: (code_fn, weight); envelope-summed
    # (GAL_E1C/include/acquisition.m:195, B1C acquisition.m:213-214)
    acq_components: Tuple = ()
    acq_weights: Tuple[float, ...] = (1.0,)
    data_secondary: Optional[np.ndarray] = None
    pilot_secondary: Optional[Callable[[int], np.ndarray]] = None
    nav_codec: str = "lnav"
    nav_symbol_ms: float = 20.0     # nav symbol duration in ms
    fdma: bool = False
    fdma_spacing_hz: float = 0.0
    # pilot primary spans N data-code periods: acquisition resolves the
    # pilot phase among N hypotheses (L2C CL: 75,
    # GPS_L2C/include/acquisition.m:127-167)
    pilot_phase_hypotheses: int = 0
    # pilot time-multiplexed on the SAME carrier phase as data (L2C TMRZ
    # chip interleave) rather than in quadrature (L5/E1/E5/B1C/B2a)
    pilot_in_phase: bool = False
    # wideband pilot replica (B1C QMBOC BOC(6,1)) + its elements/chip
    pilot_code_wb: Optional[Callable[[int], np.ndarray]] = None
    pilot_wb_elements_per_chip: int = 0
    # carrier phase of the WB pilot component in quarter turns relative
    # to the data component (B1C ICD: data on +I, pilot BOC(1,1) on +Q,
    # pilot BOC(6,1) on -I — the reference's -sqrt(4/33)*p61_I signs,
    # WB_tracking.m:364-369)
    pilot_wb_rot: int = 1

    @property
    def code_period_ms(self) -> float:
        return 1e3 * self.code_length_chips / self.chip_rate_hz

    def acq_code_fns(self):
        return self.acq_components if self.acq_components \
            else (self.data_code,)


def _const(arr):
    return lambda prn: arr


REGISTRY = {
    "gps_l1ca": SignalDef(
        name="gps_l1ca", constellation="gps",
        carrier_freq_hz=1575.42e6, chip_rate_hz=1.023e6,
        code_length_chips=1023, data_code=gps.l1ca,
        nav_codec="lnav", nav_symbol_ms=20.0),

    "gps_l2c": SignalDef(
        name="gps_l2c", constellation="gps",
        carrier_freq_hz=1227.60e6, chip_rate_hz=0.5115e6,
        code_length_chips=10230,
        # TMRZ chip slots at 1.023 MHz: CM on even, CL on odd
        # (generateCMcode.m / generateCLcode.m tails)
        data_code=gps.l2cm_rz, pilot_code=gps.l2cl_rz,
        elements_per_chip=2,
        nav_codec="cnav", nav_symbol_ms=20.0,
        pilot_phase_hypotheses=75, pilot_in_phase=True),

    "gps_l5c": SignalDef(
        name="gps_l5c", constellation="gps",
        carrier_freq_hz=1176.45e6, chip_rate_hz=10.23e6,
        code_length_chips=10230, data_code=gps.l5i, pilot_code=gps.l5q,
        data_secondary=beidou.NH10,
        pilot_secondary=_const(beidou.NH20),
        nav_codec="cnav2_l5", nav_symbol_ms=10.0),

    "gal_e1c": SignalDef(
        name="gal_e1c", constellation="galileo",
        carrier_freq_hz=1575.42e6, chip_rate_hz=1.023e6,
        code_length_chips=4092,
        data_code=galileo.e1b, pilot_code=galileo.e1c,
        elements_per_chip=2,
        acq_components=(galileo.e1b, galileo.e1c),
        acq_weights=(1.0, 1.0),
        pilot_secondary=_const(galileo.E1C_SECONDARY),
        nav_codec="inav", nav_symbol_ms=4.0),

    "gal_e5a": SignalDef(
        name="gal_e5a", constellation="galileo",
        carrier_freq_hz=1176.45e6, chip_rate_hz=10.23e6,
        code_length_chips=10230,
        data_code=galileo.e5ai, pilot_code=galileo.e5aq,
        data_secondary=galileo.E5AI_SECONDARY,
        pilot_secondary=galileo.e5aq_secondary,
        nav_codec="fnav", nav_symbol_ms=20.0),

    "gal_e5b": SignalDef(
        name="gal_e5b", constellation="galileo",
        carrier_freq_hz=1207.14e6, chip_rate_hz=10.23e6,
        code_length_chips=10230,
        data_code=galileo.e5bi, pilot_code=galileo.e5bq,
        data_secondary=galileo.E5BI_SECONDARY,
        pilot_secondary=galileo.e5bq_secondary,
        nav_codec="inav", nav_symbol_ms=4.0),

    "glo_l1": SignalDef(
        name="glo_l1", constellation="glonass",
        carrier_freq_hz=1602.0e6, chip_rate_hz=0.511e6,
        code_length_chips=511,
        data_code=lambda prn: glonass.glonass_ca(),
        nav_codec="glonass", nav_symbol_ms=10.0,
        fdma=True, fdma_spacing_hz=562.5e3),

    "glo_l2": SignalDef(
        name="glo_l2", constellation="glonass",
        carrier_freq_hz=1246.0e6, chip_rate_hz=0.511e6,
        code_length_chips=511,
        data_code=lambda prn: glonass.glonass_ca(),
        nav_codec="glonass", nav_symbol_ms=10.0,
        fdma=True, fdma_spacing_hz=437.5e3),

    "bds_b1c": SignalDef(
        name="bds_b1c", constellation="beidou",
        carrier_freq_hz=1575.42e6, chip_rate_hz=1.023e6,
        code_length_chips=10230,
        data_code=beidou.b1c_data_boc11,
        pilot_code=beidou.b1c_pilot_boc11,
        elements_per_chip=2,
        acq_components=(beidou.b1c_data_boc11, beidou.b1c_pilot_boc11),
        # sqrt(11)/sqrt(29) data:pilot power split
        # (BDS/B1C/include/acquisition.m:213-214)
        acq_weights=(np.sqrt(11.0), np.sqrt(29.0)),
        pilot_secondary=beidou.b1c_secondary,
        pilot_code_wb=beidou.b1c_pilot_boc61,
        pilot_wb_elements_per_chip=12, pilot_wb_rot=2,
        nav_codec="bcnav1", nav_symbol_ms=10.0),

    "bds_b1i": SignalDef(
        name="bds_b1i", constellation="beidou",
        carrier_freq_hz=1561.098e6, chip_rate_hz=2.046e6,
        code_length_chips=2046, data_code=beidou.b1i,
        data_secondary=beidou.NH20,
        nav_codec="bds_d1", nav_symbol_ms=20.0),

    "bds_b2a": SignalDef(
        name="bds_b2a", constellation="beidou",
        carrier_freq_hz=1176.45e6, chip_rate_hz=10.23e6,
        code_length_chips=10230,
        data_code=beidou.b2a_data, pilot_code=beidou.b2a_pilot,
        data_secondary=beidou.NH5,
        nav_codec="bcnav2", nav_symbol_ms=5.0),

    "bds_b3i": SignalDef(
        name="bds_b3i", constellation="beidou",
        carrier_freq_hz=1268.52e6, chip_rate_hz=10.23e6,
        code_length_chips=10230, data_code=beidou.b3i,
        data_secondary=beidou.NH20,
        nav_codec="bds_d1", nav_symbol_ms=20.0),
}


def get_signal(name: str) -> SignalDef:
    return REGISTRY[name]


def sample_code(code_elements: np.ndarray,
                elements_per_chip: int,
                chip_rate_hz: float,
                sampling_freq: float,
                num_samples: int,
                code_phase_chips: float = 0.0,
                code_freq_hz: Optional[float] = None) -> np.ndarray:
    """Nearest-sample upsampling of a code-element array (makeCaTable.m:60-74).

    Element k covers chip time [k, k+1)/elements_per_chip; sample n sits at
    chip phase ``code_phase + n * code_freq/fs``.
    """
    code_freq = chip_rate_hz if code_freq_hz is None else code_freq_hz
    n = np.arange(num_samples, dtype=np.float64)
    phase = code_phase_chips + n * (code_freq / sampling_freq)
    idx = np.floor(phase * elements_per_chip).astype(np.int64) \
        % len(code_elements)
    return code_elements[idx]
