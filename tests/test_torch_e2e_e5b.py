"""The Galileo E5b tracked-IF chain of tests/test_e2e_e5b.py through the
port (on the CPU, the plain correlator with its pilot bank), against the
JAX reference on the same samples and against the scene's truth.

The scene is the reference test's, built from its own constants (``EPH``)
and the same encoder, SV, seed and lengths: one SV at 48 dB-Hz, 13.5 s at
12.288 Msps, I/NAV words 1-5, 1, 2 from TOW 123 456 (the CS4 data
secondary); acquisition on the first two seconds.

Against the reference: the same PRNs detected, code phases and carriers
equal; tracking from the reference's acquisition over the first
``N_REF`` epochs with ``abs_sample`` equal and the prompt sums (data and
pilot) within 2e-4·(max|ref| + 1) (the f32 sums are added in other
orders, the loops are the same f64 arithmetic).  The port alone, through
the whole scene: the reference test's assertions unchanged (code phase
within 3 samples, carrier within 15 Hz, |I_P| > 3|Q_P| over the last
3 000 epochs, words 1-5 decoded within rel 1e-6 of the broadcast
ephemeris, TOW equal).
"""

import numpy as np
import pytest

from cusdr_tpu import get_config
from cusdr_tpu.acquisition import acquire as j_acquire
from cusdr_tpu.io.synth import SynthSV, quantize_iq_int8, synthesize_if
from cusdr_tpu.nav import galileo_nav as gal
from cusdr_tpu.signals.defs import get_signal
from cusdr_tpu.tracking import track as j_track
from cusdr_tpu_torch import get_config as t_get_config
from cusdr_tpu_torch.acquisition.pcps import acquire as t_acquire
from cusdr_tpu_torch.nav import galileo_nav as t_gal
from cusdr_tpu_torch.nav.dispatch import decode_channel
from cusdr_tpu_torch.signals.defs import get_signal as t_get_signal
from cusdr_tpu_torch.tracking.engine import track as t_track

from test_e2e_e5b import EPH
from test_torch_multisignal import (assert_acquisition_as_reference,
                                    assert_sums_close)
from test_torch_threads import few_torch_threads  # noqa: F401 (autouse)

OVER = dict(sampling_freq=12.288e6, if_freq=7000.0,
            acq_satellite_list=(2, 4), acq_search_band=2000.0,
            acq_search_step=250.0, acq_non_coh_time=6, acq_threshold=2.5)
TOW0 = 123456
N_EPOCHS = 13_000
N_REF = 2000            # two superblocks against the reference


@pytest.fixture(scope="module")
def chain():
    cfg, sig = get_config("gal_e5b", **OVER), get_signal("gal_e5b")
    # I/NAV word every 2 s (even/odd page pair); 1..5 carry the
    # ephemeris, word 1 repeated for margin
    syms = [gal.inav_encode_page_pair(
        gal.inav_word(wt, EPH, tow_raw=TOW0 + 2 * i))
        for i, wt in enumerate([1, 2, 3, 4, 5, 1, 2])]
    nav = (1 - 2 * np.concatenate(syms)).astype(np.int8)
    sv = SynthSV(prn=4, code_phase=5233.0, doppler_hz=-900.0,
                 cn0_dbhz=48, nav_bits=nav)
    samples = synthesize_if(cfg, sig, [sv], num_ms=13_500, seed=21)
    head = samples[:int(2.0 * cfg.sampling_freq)]
    tcfg, tsig = t_get_config("gal_e5b", **OVER), t_get_signal("gal_e5b")
    ref_acq = j_acquire(cfg, sig, head)
    acq = t_acquire(tcfg, tsig, head, "cpu")
    iq = quantize_iq_int8(samples)
    del samples, head
    i = list(ref_acq.prns).index(4)
    ref_chans = [(4, float(ref_acq.carr_freq[i]), int(ref_acq.code_phase[i]))]
    ref_trk = j_track(cfg, sig, iq, ref_chans, n_epochs=N_REF)
    i = list(acq.prns).index(4)
    chans = [(4, float(acq.carr_freq[i]), int(acq.code_phase[i]))]
    trk = t_track(tcfg, tsig, iq, chans, "cpu", n_epochs=N_EPOCHS)
    return tcfg, tsig, sv, ref_acq, acq, ref_trk, trk


def test_acquisition_as_reference(chain):
    cfg, sig, sv, ref_acq, acq, ref_trk, trk = chain
    assert_acquisition_as_reference(acq, ref_acq)


def test_tracking_as_reference(chain):
    cfg, sig, sv, ref_acq, acq, ref_trk, trk = chain
    assert ref_trk.i_p.shape == (1, N_REF)
    assert_sums_close(trk, ref_trk, ("i_p", "q_p", "pilot_ip", "pilot_qp"),
                      n_epochs=N_REF)


def test_acquisition(chain):
    cfg, sig, sv, ref_acq, acq, ref_trk, trk = chain
    i = list(acq.prns).index(4)
    assert acq.detected[i]
    spc = cfg.samples_per_code
    err = abs(int(acq.code_phase[i]) - sv.code_phase) % spc
    assert min(err, spc - err) <= 3
    assert abs(acq.carr_freq[i] - (7000.0 - 900.0)) < 15.0


def test_tracking_lock_pilot(chain):
    cfg, sig, sv, ref_acq, acq, ref_trk, trk = chain
    assert trk.i_p.shape == (1, N_EPOCHS)
    ip = np.abs(trk.i_p[0, -3000:]).mean()
    qp = np.abs(trk.q_p[0, -3000:]).mean()
    assert ip > 3 * qp


def test_inav_decode_through_pipeline(chain):
    """Tracked-IF I/NAV via the CS4 data secondary: words 1-5 decoded
    off the air match the broadcast ephemeris."""
    cfg, sig, sv, ref_acq, acq, ref_trk, trk = chain
    eph, start, tow = decode_channel(trk, 0, cfg, sig)
    assert eph is not None
    assert t_gal.inav_has_ephemeris(eph)
    for k in ("M_0", "e", "i_0", "omega", "t_oe", "a_f0", "sqrtA"):
        truth = EPH[k]
        assert eph[k] == pytest.approx(
            truth, rel=1e-6, abs=abs(truth) * 1e-6 + 1e-9), k
    assert eph["omega_0"] == pytest.approx(EPH["Omega_0"], rel=1e-6)
    assert tow == TOW0
