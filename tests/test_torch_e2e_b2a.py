"""The BeiDou B2a tracked-IF chain of tests/test_e2e_b2a.py through the port
(on the CPU, the plain correlator with its pilot bank), against the JAX
reference on the same samples and against the scene's truth.

The scene is the reference test's, built from its own constants (``EPH``)
and the same encoder, SV, seed and lengths: one SV at 48 dB-Hz, 11 s at
12.288 Msps, B-CNAV2 frames 10, 11, 30, 34 from SOW 345 600.

Against the reference: acquisition on the same first second detects the
same PRNs with the same code phases and carriers (equal); tracking from
the reference's acquisition over the first ``N_REF`` epochs has
``abs_sample`` equal and the prompt sums (data and pilot) within
2e-4·(max|ref| + 1) (the f32 sums are added in other orders, the loops
are the same f64 arithmetic).  The port alone, through the whole scene:
the reference test's assertions unchanged (code phase within 3 samples,
PRN 23 quiet, |I_P| > 3|Q_P| over the last 2 000 epochs, the decoded
ephemeris within rel 1e-6 of the broadcast one, SOW equal).
"""

import numpy as np
import pytest

from cusdr_tpu import get_config
from cusdr_tpu.acquisition import acquire as j_acquire
from cusdr_tpu.io.synth import SynthSV, quantize_iq_int8, synthesize_if
from cusdr_tpu.nav import bcnav
from cusdr_tpu.signals.defs import get_signal
from cusdr_tpu.tracking import track as j_track
from cusdr_tpu_torch import get_config as t_get_config
from cusdr_tpu_torch.acquisition.pcps import acquire as t_acquire
from cusdr_tpu_torch.nav import bcnav as t_bcnav
from cusdr_tpu_torch.nav.dispatch import decode_channel
from cusdr_tpu_torch.signals.defs import get_signal as t_get_signal
from cusdr_tpu_torch.tracking.engine import track as t_track

from test_e2e_b2a import EPH
from test_torch_multisignal import (assert_acquisition_as_reference,
                                    assert_sums_close)
from test_torch_threads import few_torch_threads  # noqa: F401 (autouse)

OVER = dict(sampling_freq=12.288e6, if_freq=7000.0,
            acq_satellite_list=(19, 23), acq_search_band=2000.0,
            acq_non_coh_time=6, acq_threshold=2.5, pilot_trk_flag=1)
SOW0 = 345600
N_EPOCHS = 10_500
N_REF = 2000            # two superblocks against the reference


@pytest.fixture(scope="module")
def chain():
    cfg, sig = get_config("bds_b2a", **OVER), get_signal("bds_b2a")
    frames = [bcnav.bcnav2_encode_frame(mid, 19, SOW0 + 3 * i, EPH)
              for i, mid in enumerate([10, 11, 30, 34])]
    nav = (1 - 2 * np.concatenate(frames).astype(np.int8))
    sv = SynthSV(prn=19, code_phase=3000.0, doppler_hz=-1500.0,
                 cn0_dbhz=48, nav_bits=nav)
    samples = synthesize_if(cfg, sig, [sv], num_ms=11_000, seed=21)
    head = samples[:int(1.0 * cfg.sampling_freq)]
    tcfg, tsig = t_get_config("bds_b2a", **OVER), t_get_signal("bds_b2a")
    ref_acq = j_acquire(cfg, sig, head)
    acq = t_acquire(tcfg, tsig, head, "cpu")
    iq = quantize_iq_int8(samples)
    del samples, head
    i = list(ref_acq.prns).index(19)
    ref_chans = [(19, float(ref_acq.carr_freq[i]),
                  int(ref_acq.code_phase[i]))]
    ref_trk = j_track(cfg, sig, iq, ref_chans, n_epochs=N_REF)
    i = list(acq.prns).index(19)
    chans = [(19, float(acq.carr_freq[i]), int(acq.code_phase[i]))]
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
    i = list(acq.prns).index(19)
    assert acq.detected[i]
    spc = cfg.samples_per_code
    err = abs(int(acq.code_phase[i]) - sv.code_phase) % spc
    assert min(err, spc - err) <= 3
    # the non-target PRN stays quiet
    j = list(acq.prns).index(23)
    assert not acq.detected[j]


def test_tracking_lock(chain):
    cfg, sig, sv, ref_acq, acq, ref_trk, trk = chain
    assert trk.i_p.shape == (1, N_EPOCHS)
    ip = np.abs(trk.i_p[0, -2000:]).mean()
    qp = np.abs(trk.q_p[0, -2000:]).mean()
    assert ip > 3 * qp


def test_bcnav2_decode_through_pipeline(chain):
    cfg, sig, sv, ref_acq, acq, ref_trk, trk = chain
    eph, start, sow = decode_channel(trk, 0, cfg, sig)
    assert eph is not None
    assert t_bcnav.bcnav2_has_ephemeris(eph)
    for k in ("M_0", "e", "i_0", "omega", "t_oe", "a_f0", "deltaA"):
        truth = EPH[k]
        assert eph[k] == pytest.approx(
            truth, rel=1e-6, abs=abs(truth) * 1e-6 + 1e-9), k
    assert sow == SOW0
