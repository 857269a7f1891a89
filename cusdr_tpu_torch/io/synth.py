"""Synthetic IF signal generator — the test backbone the reference lacks.

Generates IF sample streams with known code phases, Dopplers, C/N0 and nav
bits for any registered signal, so acquisition/tracking/decoding/PVT can be
validated end-to-end against ground truth (SURVEY.md §4).

Conventions match the reference receivers' front-end model
(GPS/GPS_L1CA/include/postProcessing.m:88-96): interleaved I/Q schar files,
signal at +IF with positive Doppler adding to carrier frequency, code
Doppler scaled by chip_rate/carrier_freq.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

from ..signals.defs import SignalDef


@dataclass
class SynthSV:
    """One simulated satellite signal."""
    prn: int
    code_phase: float = 0.0     # delay of code start, in samples at t=0
    doppler_hz: float = 0.0     # carrier Doppler [Hz]
    doppler_rate: float = 0.0   # carrier Doppler rate [Hz/s] (geometry)
    cn0_dbhz: float = 45.0
    carrier_phase: float = 0.0  # initial carrier phase [rad]
    nav_bits: Optional[np.ndarray] = None   # ±1 at nav_symbol_ms rate
    fdma_channel: int = 0       # GLONASS frequency channel number
    stop_ms: Optional[float] = None  # signal disappears after this time
                                     # (setting/blockage — exercises the
                                     # channel loss-of-lock lifecycle)


def _component(sig: SignalDef, sv: SynthSV, chip_phase: np.ndarray,
               code_elements: np.ndarray, secondary: Optional[np.ndarray],
               nav_symbol_chips: float, periods: int = 1) -> np.ndarray:
    """Evaluate code*secondary*data at given (fractional) chip phases.

    The element grid is derived from the array length so mixed-rate
    components (e.g. B1C BOC(1,1) data + BOC(6,1) pilot) coexist.
    ``periods`` is the number of primary-code periods the array spans —
    1 for every code except long pilots (GPS L2 CL: 75 periods,
    generateCLcode.m), which advance across code periods instead of
    repeating each one."""
    epc = len(code_elements) // (sig.code_length_chips * periods)
    n_elem = len(code_elements)
    total_elem = np.floor(chip_phase * epc).astype(np.int64)
    vals = code_elements[total_elem % n_elem].astype(np.float32)
    code_periods = np.floor_divide(total_elem,
                                   epc * sig.code_length_chips)
    if secondary is not None:
        vals = vals * secondary[code_periods % len(secondary)]
    if sv.nav_bits is not None:
        bit_idx = np.floor(chip_phase / nav_symbol_chips).astype(np.int64)
        bit_idx = np.clip(bit_idx, 0, len(sv.nav_bits) - 1)
        vals = vals * sv.nav_bits[bit_idx]
    return vals


def synthesize_if(cfg, sig: SignalDef, svs: Sequence[SynthSV],
                  num_ms: int, noise_std: float = 4.0, seed: int = 1,
                  pilot_power_frac: float = 0.5,
                  chunk_ms: int = 200) -> np.ndarray:
    """Generate complex IF samples (float32 I + jQ, unquantized).

    C/N0 definition: complex white noise with per-component std
    ``noise_std`` has power 2σ² over bandwidth fs, so N0 = 2σ²/fs and the
    SV amplitude is A = sqrt(10^(cn0/10) · 2σ²/fs).

    Data/pilot signals put the data component on I and the pilot on Q
    (π/2 rotated), splitting power by ``pilot_power_frac``.
    """
    fs = cfg.sampling_freq
    n_total = int(round(num_ms * fs * 1e-3))
    rng = np.random.default_rng(seed)
    out = np.empty(n_total, dtype=np.complex64)

    nav_symbol_chips = sig.nav_symbol_ms * 1e-3 * sig.chip_rate_hz

    chunk = int(round(chunk_ms * fs * 1e-3))
    for start in range(0, n_total, chunk):
        stop = min(start + chunk, n_total)
        n = np.arange(start, stop, dtype=np.float64)
        t = n / fs
        acc = (rng.standard_normal(stop - start)
               + 1j * rng.standard_normal(stop - start)) * noise_std
        acc = acc.astype(np.complex64)
        for sv in svs:
            amp = np.sqrt(10 ** (sv.cn0_dbhz / 10.0) * 2 * noise_std ** 2
                          / fs)
            # code Doppler: chip rate scales with carrier Doppler (+rate)
            code_freq = sig.chip_rate_hz * (
                1.0 + sv.doppler_hz / sig.carrier_freq_hz)
            chip_phase = (n - sv.code_phase) * (code_freq / fs)
            if sv.doppler_rate != 0.0:
                chip_phase = chip_phase + (0.5 * sig.chip_rate_hz
                                           * sv.doppler_rate
                                           / sig.carrier_freq_hz) * t * t
            # clamp the pre-start region to chip 0 so it holds the first chip
            chip_phase = np.maximum(chip_phase, 0.0)

            carrier_hz = cfg.if_freq + sv.doppler_hz
            if sig.fdma:
                carrier_hz += sig.fdma_spacing_hz * sv.fdma_channel
            theta = (2 * np.pi * carrier_hz) * t + sv.carrier_phase
            if sv.doppler_rate != 0.0:
                theta = theta + (np.pi * sv.doppler_rate) * t * t
            theta32 = np.mod(theta, 2 * np.pi).astype(np.float32)
            carrier = (np.cos(theta32)
                       + 1j * np.sin(theta32)).astype(np.complex64)

            data_elems = sig.data_code(sv.prn)
            data_vals = _component(sig, sv, chip_phase, data_elems,
                                   sig.data_secondary, nav_symbol_chips)
            if sig.pilot_code is not None:
                a_d = amp * np.sqrt(1.0 - pilot_power_frac)
                a_p = amp * np.sqrt(pilot_power_frac)
                psec = (sig.pilot_secondary(sv.prn)
                        if sig.pilot_secondary is not None else None)
                pilot_sv = SynthSV(**{**sv.__dict__, "nav_bits": None})
                pilot_vals = _component(sig, pilot_sv, chip_phase,
                                        sig.pilot_code(sv.prn), psec,
                                        nav_symbol_chips,
                                        periods=max(
                                            sig.pilot_phase_hypotheses, 1))
                if sig.pilot_code_wb is not None:
                    # full QMBOC (B1C): of 44 power units — data BOC(1,1)
                    # 11 on +I, pilot BOC(1,1) 29 on +Q, pilot BOC(6,1)
                    # 4 at j^pilot_wb_rot (ICD split; the reference's
                    # 11/29/40 acquisition weights exclude the 4,
                    # acquisition.m:213-214, WB_tracking.m:364-369)
                    wb_vals = _component(sig, pilot_sv, chip_phase,
                                         sig.pilot_code_wb(sv.prn), psec,
                                         nav_symbol_chips)
                    rot = 1j ** sig.pilot_wb_rot
                    base = (amp * np.sqrt(11.0 / 44.0) * data_vals
                            + 1j * amp * np.sqrt(29.0 / 44.0) * pilot_vals
                            + rot * amp * np.sqrt(4.0 / 44.0) * wb_vals)
                elif sig.pilot_in_phase:
                    # time-multiplexed pilot on the data carrier: the RZ
                    # chip slots interleave CM/CL on one phase (L2C TMRZ,
                    # generateL2Ccode.m chip multiplex)
                    base = a_d * data_vals + a_p * pilot_vals
                else:
                    base = (a_d * data_vals + 1j * a_p * pilot_vals)
            else:
                base = amp * data_vals
            if sv.stop_ms is not None:
                base = base * (t < sv.stop_ms * 1e-3)
            acc = acc + (base * carrier).astype(np.complex64)
        out[start:stop] = acc
    return out


def quantize_iq_int8(samples: np.ndarray) -> np.ndarray:
    """Round complex float samples to interleaved int8 I/Q (schar file
    layout, initSettings.m:60-65)."""
    out = np.empty(samples.size * 2, dtype=np.int8)
    out[0::2] = np.clip(np.round(samples.real), -127, 127).astype(np.int8)
    out[1::2] = np.clip(np.round(samples.imag), -127, 127).astype(np.int8)
    return out


def write_if_file(path: str, cfg, sig: SignalDef, svs: Sequence[SynthSV],
                  num_ms: int, noise_std: float = 4.0, seed: int = 1):
    """Synthesize and write an interleaved I/Q schar file."""
    samples = synthesize_if(cfg, sig, svs, num_ms, noise_std, seed)
    quantize_iq_int8(samples).tofile(path)
    return path
