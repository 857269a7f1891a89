"""QMBOC (B1C wideband) RMS-bandwidth weighting factor.

Equivalent of BDS/B1C/include/CalcWeighingFactor.m: PSD integrals of the
BOC(1,1) and composite pilot (29/33 BOC(1,1) + 4/33 BOC(6,1)) spectra over
the front-end bandwidth, combined into the data/pilot DLL weighting factor.
Uses fixed-grid trapezoid quadrature (no symbolic integral)."""

from __future__ import annotations

import functools

import numpy as np


def _boc_psd(f, fc, m):
    """BOC(m,1) PSD shape sin^2(pi f/(2 m fc)) ... (CalcWeighingFactor.m
    formulas with the subcarrier ratio folded into the 1/(2m) factor)."""
    tc = 1.0 / fc
    x = np.sin(np.pi / (2 * m) * f / fc) * np.sin(np.pi * f / fc) \
        / np.cos(np.pi / (2 * m) * f / fc) * fc / f / np.pi
    return tc * x ** 2


@functools.lru_cache(maxsize=None)
def calc_weighing_factor(code_freq_basis: float, febw: float) -> float:
    """DLL combining factor for NB(BOC11 data) vs WB(QMBOC pilot)
    (CalcWeighingFactor.m:28-31)."""
    fc = code_freq_basis
    br = febw
    # grid avoiding f=0 and subcarrier singularities
    f = np.linspace(-br / 2, br / 2, 2_000_001)
    f = f + 0.251 * (f[1] - f[0])
    g11 = _boc_psd(f, fc, 1.0)
    gp = 29.0 / 33.0 * _boc_psd(f, fc, 1.0) + \
        4.0 / 33.0 * _boc_psd(f, fc, 6.0)
    df = f[1] - f[0]
    p11 = np.trapezoid(g11, dx=df)
    p11_2 = np.trapezoid(g11 * f ** 2, dx=df)
    pp = np.trapezoid(gp, dx=df)
    pp_2 = np.trapezoid(gp * f ** 2, dx=df)
    rem11 = np.sqrt(p11_2 / p11)
    remp = np.sqrt(pp_2 / pp)
    t1 = 11.0 * p11 * rem11 ** 2
    t2 = 33.0 * pp * remp ** 2
    return float(t1 / (t1 + t2))
