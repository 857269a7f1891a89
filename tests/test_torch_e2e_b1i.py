"""The BeiDou B1I golden end-to-end scene of tests/test_e2e_b1i.py through
the port's ``Receiver(cfg, "cpu").run`` (the plain correlator), against the
JAX reference on the same samples and against the scene's truth: D1
(BCH(15,11) interleaved words) under the NH20 secondary, BDS Keplerian
orbits, least squares against the known receiver position.

The scene is the reference test's, built from its own helpers
(``_bds_eph``, ``_satpos``, ``_nav_stream``) with the same configuration,
seed and lengths: 6 MEO SVs at 46 dB-Hz, 40 s at 4.096 Msps.

Against the reference: acquisition on the same leading samples
(``_acquire_record``) detects the same PRNs with the same code phases and
carriers (equal) and gives the same channels; the reference tracks those
channels over the first ``N_REF`` epochs, and the port's run has
``abs_sample`` equal there and the prompt sums within 2e-4·(max|ref| + 1)
(the f32 sums are added in other orders, the loops are the same f64
arithmetic).  The port alone, through the whole scene: the reference
test's assertions unchanged (every SV acquired, at least 5 fixes, 3-D
error mean < 20 m and max < 60 m, channel 0's decoded ephemeris within rel
1e-6 of the broadcast one).
"""

import numpy as np
import pytest

from cusdr_tpu import get_config
from cusdr_tpu.io.scenario import make_generic_scenario
from cusdr_tpu.io.synth import quantize_iq_int8, synthesize_if
from cusdr_tpu.receiver import _acquire_record
from cusdr_tpu.signals.defs import get_signal
from cusdr_tpu.tracking import track as j_track
from cusdr_tpu_torch import get_config as t_get_config
from cusdr_tpu_torch.nav.dispatch import decode_channel
from cusdr_tpu_torch.receiver import Receiver as TReceiver
from cusdr_tpu_torch.signals.defs import get_signal as t_get_signal

from test_e2e_b1i import _bds_eph, _nav_stream, _satpos
from test_torch_multisignal import (assert_acquisition_as_reference,
                                    assert_sums_close)
from test_torch_threads import few_torch_threads  # noqa: F401 (autouse)

OVER = dict(sampling_freq=4.096e6, if_freq=7000.0,
            acq_satellite_list=tuple(range(6, 38)),
            acq_search_step=250.0, acq_non_coh_time=8,
            use_trop_corr=False, ms_to_process=40_000)
N_REF = 1000            # one superblock against the reference


@pytest.fixture(scope="module")
def e2e():
    cfg, sig = get_config("bds_b1i", **OVER), get_signal("bds_b1i")
    scn = make_generic_scenario(
        cfg, sig, eph_factory=_bds_eph, satpos_fn=_satpos,
        nav_stream_fn=_nav_stream, frame_period_s=30.0,
        n_svs=6, duration_s=40.0, cn0_dbhz=46.0,
        prn_pool=range(6, 38))
    samples = quantize_iq_int8(
        synthesize_if(cfg, sig, scn.svs, num_ms=40_500, seed=9))
    iq, ref_acq = _acquire_record(cfg, sig, samples)
    ref_chans = ref_acq.best_channels(cfg.num_channels)
    ref_trk = j_track(cfg, sig, iq, ref_chans, n_epochs=N_REF)
    tcfg, tsig = t_get_config("bds_b1i", **OVER), t_get_signal("bds_b1i")
    res = TReceiver(tcfg, "cpu").run(samples)
    return tcfg, tsig, scn, ref_acq, ref_chans, ref_trk, res


def test_acquisition_as_reference(e2e):
    cfg, sig, scn, ref_acq, ref_chans, ref_trk, res = e2e
    assert_acquisition_as_reference(res.acq, ref_acq)
    assert res.channels == ref_chans


def test_tracking_as_reference(e2e):
    cfg, sig, scn, ref_acq, ref_chans, ref_trk, res = e2e
    assert ref_trk.i_p.shape == (len(ref_chans), N_REF)
    assert_sums_close(res.track, ref_trk, ("i_p", "q_p"), n_epochs=N_REF)


def test_acquires_all_svs(e2e):
    cfg, sig, scn, ref_acq, ref_chans, ref_trk, res = e2e
    acquired = {p for p, *_ in res.channels}
    assert {sv.prn for sv in scn.svs} <= acquired


def test_nav_solution(e2e):
    cfg, sig, scn, ref_acq, ref_chans, ref_trk, res = e2e
    assert res.nav is not None
    assert len(res.nav.X) >= 5


def test_position_accuracy(e2e):
    cfg, sig, scn, ref_acq, ref_chans, ref_trk, res = e2e
    err = np.sqrt((np.asarray(res.nav.X) - scn.rx_ecef[0]) ** 2
                  + (np.asarray(res.nav.Y) - scn.rx_ecef[1]) ** 2
                  + (np.asarray(res.nav.Z) - scn.rx_ecef[2]) ** 2)
    assert err.mean() < 20.0, err.mean()
    assert err.max() < 60.0, err.max()


def test_decoded_ephemeris(e2e):
    cfg, sig, scn, ref_acq, ref_chans, ref_trk, res = e2e
    eph, start, sow = decode_channel(res.track, 0, cfg, sig)
    assert eph is not None
    prn = res.track.prns[0]
    truth = scn.eph_by_prn[prn]
    for k in ("e", "sqrtA", "M_0", "omega_0", "i_0", "omega", "t_oe"):
        assert eph[k] == pytest.approx(truth[k], rel=1e-6,
                                       abs=abs(truth[k]) * 1e-6 + 1e-9), k
