"""The card synthesizer: interleaved I/Q records (int8, or another sample
type of ``traffic/samples/``) made by torch on the device from a list of
SVs.

The signal model is cusdr_tpu_torch/io/synth.py's ``synthesize_if`` (and
the card synthesizer of chip_smoke.py that restates it in torch),
extended to data plus pilot: each SV's code (times its secondary code and
nav symbols) on I, and for a signal with a pilot the pilot code (times its
secondary code) on Q, the power split evenly; sample times, code and
carrier phases in f64, the carrier phase reduced mod 2 pi before its f32
cos and sin, amplitudes from C/N0 against complex noise of
``NOISE_STD`` per component, drawn from a torch generator on the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

NOISE_STD = 4.0
CHUNK = 1 << 24          # samples per chunk


@dataclass
class SV:
    """One SV of a sky: its code timing (``code_phase``: the sample at which
    chip 0 of its nav stream would arrive, far before sample 0 for a
    geometric sky), carrier, C/N0 and nav symbols (+-1)."""
    prn: int
    code_phase: float
    doppler_hz: float
    cn0_dbhz: float
    doppler_rate: float = 0.0
    carrier_phase: float = 0.0
    nav_bits: Optional[np.ndarray] = None


@dataclass(frozen=True)
class Signal:
    """What the synthesizer needs of a signal: carrier and chip rate, code
    length, nav symbol length, and per PRN the data code, its secondary
    code, and the pilot code and its secondary code (``None`` where the
    signal has none)."""
    carrier_freq_hz: float
    chip_rate_hz: float
    code_length_chips: int
    nav_symbol_ms: float
    data_code: object
    data_secondary: object = None
    pilot_code: object = None
    pilot_secondary: object = None


def _component(idx, chip, code, secondary, bits, code_len, symbol_chips):
    """Code (times secondary and nav symbols) at the chip phases ``chip``
    (f64, >= 0), as synthesize_if's ``_component`` evaluates it."""
    elem = torch.floor(chip).long()
    vals = code[elem % code.shape[0]]
    if secondary is not None:
        vals = vals * secondary[(elem // code_len) % secondary.shape[0]]
    if bits is not None:
        bit = torch.floor(chip / symbol_chips).long().clamp(
            0, bits.shape[0] - 1)
        vals = vals * bits[bit]
    return vals


def record_chunks(sig: Signal, svs, fs: float, if_freq: float, n0: int,
                  n: int, device, generator=None, chunk: int = CHUNK):
    """Samples [n0, n0 + n) of the sky, ``chunk`` at a time.  Yields
    (first sample, I, Q) f32 tensors; without a generator there is no
    noise, at the same amplitudes."""
    dev = torch.device(device)
    two_pi = 2 * np.pi
    symbol_chips = sig.nav_symbol_ms * 1e-3 * sig.chip_rate_hz

    def t32(x):
        return None if x is None else torch.as_tensor(
            np.asarray(x), device=dev).float()

    models = []
    for sv in svs:
        amp = float(np.sqrt(10 ** (sv.cn0_dbhz / 10.0) * 2
                            * NOISE_STD ** 2 / fs))
        pilot = sig.pilot_code is not None
        models.append(dict(
            sv=sv, step=sig.chip_rate_hz * (1.0 + sv.doppler_hz
                                            / sig.carrier_freq_hz) / fs,
            carrier_hz=if_freq + sv.doppler_hz,
            a_d=amp * np.sqrt(0.5) if pilot else amp,
            a_p=amp * np.sqrt(0.5) if pilot else 0.0,
            data=t32(sig.data_code(sv.prn)),
            dsec=t32(None if sig.data_secondary is None
                     else sig.data_secondary(sv.prn)),
            pilot=t32(sig.pilot_code(sv.prn)) if pilot else None,
            psec=t32(None if sig.pilot_secondary is None
                     else sig.pilot_secondary(sv.prn)),
            bits=t32(sv.nav_bits)))
    for a in range(n0, n0 + n, chunk):
        b = min(a + chunk, n0 + n)
        idx = torch.arange(a, b, dtype=torch.float64, device=dev)
        t = idx / fs
        if generator is None:
            acc_i = torch.zeros(b - a, dtype=torch.float32, device=dev)
            acc_q = torch.zeros_like(acc_i)
        else:
            acc_i, acc_q = NOISE_STD * torch.randn(
                (2, b - a), generator=generator, device=dev)
        for m in models:
            sv = m["sv"]
            chip = (idx - sv.code_phase) * m["step"]
            theta = (two_pi * m["carrier_hz"]) * t + sv.carrier_phase
            if sv.doppler_rate != 0.0:
                chip = chip + (0.5 * sig.chip_rate_hz * sv.doppler_rate
                               / sig.carrier_freq_hz) * t * t
                theta = theta + (np.pi * sv.doppler_rate) * t * t
            chip = chip.clamp_min(0.0)
            theta = torch.fmod(theta, two_pi)
            theta32 = torch.where(theta < 0, theta + two_pi, theta).float()
            cos = torch.cos(theta32).double()
            sin = torch.sin(theta32).double()
            data = _component(idx, chip, m["data"], m["dsec"], m["bits"],
                              sig.code_length_chips, symbol_chips)
            base_i = data.double() * m["a_d"]
            if m["pilot"] is None:
                acc_i += (base_i * cos).float()
                acc_q += (base_i * sin).float()
                continue
            pil = _component(idx, chip, m["pilot"], m["psec"], None,
                             sig.code_length_chips, symbol_chips)
            base_q = pil.double() * m["a_p"]
            acc_i += (base_i * cos - base_q * sin).float()
            acc_q += (base_i * sin + base_q * cos).float()
        yield a, acc_i, acc_q


def make_record(sig: Signal, svs, fs: float, if_freq: float, n: int,
                seed: int, device, samples=None) -> np.ndarray:
    """``n`` samples of the sky as an interleaved host array of the sample
    type ``samples`` (a ``traffic.samples`` module; int8 by default),
    noise from a generator on ``device`` seeded with ``seed``."""
    if samples is None:
        from .samples import schar as samples
    out = np.empty(2 * n, samples.DTYPE)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    for a, i, q in record_chunks(sig, svs, fs, if_freq, 0, n, device, gen):
        out[2 * a:2 * (a + len(i))] = samples.quantize(i, q).cpu().numpy()
    return out
