"""Tropospheric delay — Goad & Goodman (1974) two-layer refractivity model.

Behavioral equivalent of Common/tropo.m (same inputs/outputs: sin(elevation),
station height [km], pressure [mb], temperature [K], humidity [%], heights
of measurements [km]; returns delay in meters).
"""

from __future__ import annotations

import numpy as np


def tropo(sinel: float, hsta: float, p: float, tkel: float, hum: float,
          hp: float, htkel: float, hhum: float) -> float:
    a_e = 6378.137
    b0 = 7.839257e-5
    tlapse = -6.5
    tkhum = tkel + tlapse * (hhum - htkel)
    atkel = 7.5 * (tkhum - 273.15) / (237.3 + tkhum - 273.15)
    e0 = 0.0611 * hum * 10.0 ** atkel
    tksea = tkel - tlapse * htkel
    em = -978.77 / (2.8704e6 * tlapse * 1.0e-5)
    tkelh = tksea + tlapse * hhum
    e0sea = e0 * (tksea / tkelh) ** (4.0 * em)
    tkelp = tksea + tlapse * hp
    psea = p * (tksea / tkelp) ** em

    sinel = max(sinel, 0.0)
    result = 0.0
    refsea = 77.624e-6 / tksea
    htop = 1.1385e-5 / refsea
    refsea = refsea * psea
    ref = refsea * ((htop - hsta) / htop) ** 4

    for pass_no in (0, 1):   # dry then wet component (tropo.m while loop)
        rtop = (a_e + htop) ** 2 - (a_e + hsta) ** 2 * (1.0 - sinel ** 2)
        rtop = np.sqrt(max(rtop, 0.0)) - (a_e + hsta) * sinel
        a = -sinel / (htop - hsta)
        b = -b0 * (1.0 - sinel ** 2) / (htop - hsta)
        rn = np.asarray([rtop ** (i + 2) for i in range(8)])
        alpha = np.asarray([
            2 * a, 2 * a ** 2 + 4 * b / 3, a * (a ** 2 + 3 * b),
            a ** 4 / 5 + 2.4 * a ** 2 * b + 1.2 * b ** 2,
            2 * a * b * (a ** 2 + 3 * b) / 3,
            b ** 2 * (6 * a ** 2 + 4 * b) * 1.428571e-1, 0.0, 0.0])
        if b ** 2 > 1.0e-35:
            alpha[6] = a * b ** 3 / 2
            alpha[7] = b ** 4 / 9
        dr = rtop + alpha @ rn
        result += dr * ref * 1000.0
        if pass_no == 0:
            refsea = (371900.0e-6 / tksea - 12.92e-6) / tksea
            htop = 1.1385e-5 * (1255.0 / tksea + 0.05) / refsea
            ref = refsea * e0sea * ((htop - hsta) / htop) ** 4
    return float(result)
