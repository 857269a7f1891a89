"""Second-order loop-filter coefficients (calcLoopCoef.m:41-45)."""


def calc_loop_coef(lbw: float, zeta: float, k: float):
    """(tau1, tau2) with Wn = LBW * 8 zeta / (4 zeta^2 + 1), tau1 = k /
    Wn^2, tau2 = 2 zeta / Wn."""
    wn = lbw * 8.0 * zeta / (4.0 * zeta * zeta + 1.0)
    return k / (wn * wn), 2.0 * zeta / wn
