"""The GPS L5C golden end-to-end scene of tests/test_e2e_l5c.py through the
port's ``Receiver(cfg, "cpu").run`` (the plain correlator with its pilot
bank), against the JAX reference on the same samples and against the
scene's truth: the NH-hypothesis fine stage, data+pilot tracking, NH10
despread, Viterbi+CRC CNAV decode, quasi-Keplerian orbits, least squares.

The scene is the reference test's, built from its own helpers
(``_cnav_eph``, ``_nav_stream``, ``MSG_S``) with the same configuration,
seed and lengths: 4 SVs at 50 dB-Hz, 26 s at 12.288 Msps.

Against the reference: acquisition on the same leading samples
(``_acquire_record``) detects the same PRNs with the same code phases and
carriers (equal) and gives the same channels; the reference tracks those
channels over the first ``N_REF`` epochs, and the port's run has
``abs_sample`` equal there and the prompt sums (data and pilot) within
2e-4·(max|ref| + 1) (the f32 sums are added in other orders, the loops are
the same f64 arithmetic).  The port alone, through the whole scene: the
reference test's assertions unchanged (every SV acquired, |I_P| >
2.5|Q_P| over the last 2 000 epochs of every channel, MT10/11/30 decoded
within rel 1e-6 of the broadcast values on at least 4 channels with the
TOW on the 6 s message grid, at least 5 fixes with 3-D error mean < 20 m
and max < 60 m).
"""

import numpy as np
import pytest

from cusdr_tpu import get_config
from cusdr_tpu.io.scenario import make_generic_scenario
from cusdr_tpu.io.synth import quantize_iq_int8, synthesize_if
from cusdr_tpu.orbits.cnav_kepler import sat_pos_cnav
from cusdr_tpu.receiver import _acquire_record
from cusdr_tpu.signals.defs import get_signal
from cusdr_tpu.tracking import track as j_track
from cusdr_tpu_torch import get_config as t_get_config
from cusdr_tpu_torch.nav.dispatch import decode_channel
from cusdr_tpu_torch.receiver import Receiver as TReceiver
from cusdr_tpu_torch.signals.defs import get_signal as t_get_signal

from test_e2e_l5c import MSG_S, _cnav_eph, _nav_stream
from test_torch_multisignal import (assert_acquisition_as_reference,
                                    assert_sums_close)
from test_torch_threads import few_torch_threads  # noqa: F401 (autouse)

OVER = dict(sampling_freq=12.288e6, if_freq=7000.0,
            acq_satellite_list=tuple(range(1, 13)),
            acq_non_coh_time=10, pilot_trk_flag=1,
            use_trop_corr=False, ms_to_process=26_000)
N_REF = 1000            # one superblock against the reference


@pytest.fixture(scope="module")
def e2e():
    cfg, sig = get_config("gps_l5c", **OVER), get_signal("gps_l5c")
    scn = make_generic_scenario(
        cfg, sig, eph_factory=_cnav_eph, satpos_fn=sat_pos_cnav,
        nav_stream_fn=_nav_stream, frame_period_s=MSG_S,
        n_svs=4, duration_s=26.0, cn0_dbhz=50.0,
        prn_pool=range(1, 13))
    samples = quantize_iq_int8(
        synthesize_if(cfg, sig, scn.svs, num_ms=26_400, seed=11))
    iq, ref_acq = _acquire_record(cfg, sig, samples)
    ref_chans = ref_acq.best_channels(cfg.num_channels)
    ref_trk = j_track(cfg, sig, iq, ref_chans, n_epochs=N_REF)
    tcfg, tsig = t_get_config("gps_l5c", **OVER), t_get_signal("gps_l5c")
    res = TReceiver(tcfg, "cpu").run(samples)
    return tcfg, tsig, scn, ref_acq, ref_chans, ref_trk, res


def test_acquisition_as_reference(e2e):
    cfg, sig, scn, ref_acq, ref_chans, ref_trk, res = e2e
    assert_acquisition_as_reference(res.acq, ref_acq)
    assert res.channels == ref_chans


def test_tracking_as_reference(e2e):
    cfg, sig, scn, ref_acq, ref_chans, ref_trk, res = e2e
    assert ref_trk.i_p.shape == (len(ref_chans), N_REF)
    assert_sums_close(res.track, ref_trk,
                      ("i_p", "q_p", "pilot_ip", "pilot_qp"), n_epochs=N_REF)


def test_acquires_all_svs(e2e):
    cfg, sig, scn, ref_acq, ref_chans, ref_trk, res = e2e
    acquired = {p for p, *_ in res.channels}
    assert {sv.prn for sv in scn.svs} <= acquired


def test_tracking_locks(e2e):
    cfg, sig, scn, ref_acq, ref_chans, ref_trk, res = e2e
    for c in range(len(res.track.prns)):
        ip = np.abs(res.track.i_p[c, -2000:]).mean()
        qp = np.abs(res.track.q_p[c, -2000:]).mean()
        assert ip > 2.5 * qp, (c, ip, qp)


def test_cnav_decode_through_pipeline(e2e):
    """Tracked-IF CNAV: MT10+11+30 decoded off the air match the
    broadcast values."""
    cfg, sig, scn, ref_acq, ref_chans, ref_trk, res = e2e
    decoded = 0
    for ch in range(len(res.track.prns)):
        eph, start, tow = decode_channel(res.track, ch, cfg, sig)
        if eph is None:
            continue
        decoded += 1
        truth = scn.eph_by_prn[res.track.prns[ch]]
        for k in ("e", "M_0", "omega_0", "i_0", "omega", "t_oe",
                  "deltaA", "a_f0"):
            # deltaA is broadcast at ICD scale 2^-9 m: the decode can only
            # be right to half that quantization step
            q = 2.0 ** -9 if k == "deltaA" else 0.0
            assert eph[k] == pytest.approx(
                truth[k], rel=1e-6,
                abs=abs(truth[k]) * 1e-6 + 1e-9 + q), k
        assert tow % MSG_S == 0
    assert decoded >= 4


def test_nav_solution_and_accuracy(e2e):
    cfg, sig, scn, ref_acq, ref_chans, ref_trk, res = e2e
    assert res.nav is not None
    assert len(res.nav.X) >= 5
    err = np.sqrt((np.asarray(res.nav.X) - scn.rx_ecef[0]) ** 2
                  + (np.asarray(res.nav.Y) - scn.rx_ecef[1]) ** 2
                  + (np.asarray(res.nav.Z) - scn.rx_ecef[2]) ** 2)
    assert err.mean() < 20.0, err.mean()
    assert err.max() < 60.0, err.max()
