"""A data+pilot receiver end to end against the JAX reference: the Galileo
E1C scene of tests/test_e2e_e1c.py (16.5 s, 4.096 Msps, one SV, I/NAV
pages) through the reference's ``Receiver(cfg).run`` and the port's
``Receiver(cfg, "cpu").run`` (the plain correlator with its pilot bank).

Checks: the same channels, ``abs_sample`` equal, ``i_p`` and ``pilot_ip``
within ``2e-4·(max|ref| + 1)`` (f32 summation order), ``carr_freq`` within
1e-3 Hz, and the port's I/NAV decode gives the broadcast ephemeris.
"""

import numpy as np
import pytest

from cusdr_tpu import get_config
from cusdr_tpu.io.synth import SynthSV, quantize_iq_int8, synthesize_if
from cusdr_tpu.nav import galileo_nav as gal
from cusdr_tpu.receiver import Receiver as JReceiver
from cusdr_tpu.signals.defs import get_signal
from cusdr_tpu_torch import get_config as t_get_config
from cusdr_tpu_torch.signals.defs import get_signal as t_get_signal
from cusdr_tpu_torch.nav.dispatch import decode_channel
from cusdr_tpu_torch.receiver import Receiver as TReceiver

from test_torch_threads import few_torch_threads  # noqa: F401 (autouse)

OVER = dict(sampling_freq=4.096e6, if_freq=7000.0,
            acq_satellite_list=(2, 4, 6), acq_search_band=2000.0,
            acq_search_step=125.0, acq_non_coh_time=2, acq_threshold=2.5)
N_EPOCHS = 4000
EPH = dict(IODnav1=57, IODnav2=57, IODnav3=57, IODnav4=57,
           t_oe=345600, M_0=1.19731, e=0.0096785, sqrtA=5440.602,
           Omega_0=2.46209, i_0=0.98, omega=0.97187, iDot=-4.893e-10,
           OmegaDot=-8.083e-09, deltan=4.2487e-09, CUC=-6.033e-06,
           CUS=5.115e-06, CRC=255.34, CRS=-115.40, CIC=-9.872e-08,
           CIS=1.3226e-07, SVID=4, t_oc=345600, a_f0=-4.69238e-04,
           a_f1=-3.18323e-12, a_f2=0.0, a_i0=30.0, a_i1=0.1, a_i2=0.001,
           BGD_E1E5a=2e-9, BGD_E1E5b=3e-9, E5b_HS=0, E1b_HS=0, WN=120)
TOW0 = 123456


@pytest.fixture(scope="module")
def runs():
    cfg = get_config("gal_e1c", **OVER)
    sig = get_signal("gal_e1c")
    syms = []
    for rep in range(4):
        for i, wt in enumerate([1, 2, 3, 4, 5]):
            w = gal.inav_word(wt, EPH, tow_raw=TOW0 + 10 * rep + 2 * i)
            syms.append(gal.inav_encode_page_pair(w))
    nav = (1 - 2 * np.concatenate(syms).astype(np.int8))
    sv = SynthSV(prn=4, code_phase=2233.0, doppler_hz=800.0, cn0_dbhz=48,
                 nav_bits=nav)
    iq = quantize_iq_int8(synthesize_if(cfg, sig, [sv], num_ms=16_500,
                                        seed=5))
    ref = JReceiver(cfg).run(iq, n_epochs=N_EPOCHS)
    port = TReceiver(t_get_config("gal_e1c", **OVER), "cpu").run(
        iq, n_epochs=N_EPOCHS)
    return ref, port


def test_same_channels(runs):
    ref, port = runs
    assert [c[0] for c in port.channels] == [c[0] for c in ref.channels] \
        == [4]
    assert [c[2] for c in port.channels] == [c[2] for c in ref.channels]
    for a, b in zip(port.channels, ref.channels):
        assert abs(a[1] - b[1]) <= 25.0        # one fine step
    assert port.track.status == ref.track.status == ["T"]


def test_tracking_outputs_agree(runs):
    ref, port = runs
    assert port.track.i_p.shape == ref.track.i_p.shape == (1, N_EPOCHS)
    assert np.array_equal(port.track.abs_sample, ref.track.abs_sample)
    for name in ("i_p", "pilot_ip"):
        a, b = getattr(ref.track, name), getattr(port.track, name)
        scale = np.abs(a).max() + 1.0
        assert np.abs(b - a).max() <= 2e-4 * scale, name
    assert np.allclose(port.track.carr_freq, ref.track.carr_freq, rtol=0,
                       atol=1e-3)
    # data and pilot prompts both locked
    for i, q in (("i_p", "q_p"), ("pilot_ip", "pilot_qp")):
        ip = np.abs(getattr(port.track, i)[0, -1000:]).mean()
        qp = np.abs(getattr(port.track, q)[0, -1000:]).mean()
        assert ip > 3 * qp, (i, ip, qp)


def test_inav_decode_through_port(runs):
    ref, port = runs
    cfg = t_get_config("gal_e1c", **OVER)
    eph, start, tow = decode_channel(port.track, 0, cfg,
                                     t_get_signal("gal_e1c"))
    assert eph is not None and gal.inav_has_ephemeris(eph)
    for k in ("M_0", "e", "sqrtA", "omega_0", "i_0", "omega", "t_oe",
              "a_f0"):
        truth = EPH["Omega_0"] if k == "omega_0" else EPH[k]
        assert eph[k] == pytest.approx(truth, rel=1e-6,
                                       abs=abs(truth) * 1e-6 + 1e-9), k
    assert tow % 2 == 0 and abs(tow - TOW0) <= 40
