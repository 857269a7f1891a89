"""The channel lifecycle through the port (the mirror of
tests/test_channel_lifecycle.py, same scene): one SV of six stops
transmitting 20 s into a 40 s record; the port's ``track`` must drop that
channel at its lock gate (the PLL lock detector and the prompt-power gate,
two failing superblocks in a row, read one superblock late) and keep
fixing on the others.  Both packages run ``Receiver.run`` on the CPU on
the same record: the port drops the same channel at the same epoch as the
reference, every other channel runs to the end in both, and the
reference test's bounds hold for the port's fixes.
"""

import numpy as np
import pytest

from cusdr_tpu import get_config
from cusdr_tpu.io.scenario import make_gps_scenario
from cusdr_tpu.io.synth import quantize_iq_int8, synthesize_if
from cusdr_tpu.receiver import Receiver as JReceiver
from cusdr_tpu.signals.defs import get_signal
from cusdr_tpu_torch import get_config as t_get_config
from cusdr_tpu_torch.receiver import Receiver as TReceiver

from test_torch_threads import few_torch_threads  # noqa: F401 (autouse)

STOP_MS = 20_000.0
OVER = dict(sampling_freq=2.048e6, if_freq=7000.0,
            acq_satellite_list=tuple(range(1, 33)), acq_non_coh_time=12,
            use_trop_corr=False, ms_to_process=40_000, lock_detect=True)


@pytest.fixture(scope="module")
def scene():
    cfg = get_config("gps_l1ca", **OVER)
    sig = get_signal("gps_l1ca")
    scn = make_gps_scenario(cfg, sig, n_svs=6, duration_s=40.0,
                            cn0_dbhz=46.0)
    dead = scn.svs[2]
    dead.stop_ms = STOP_MS
    samples = quantize_iq_int8(
        synthesize_if(cfg, sig, scn.svs, num_ms=40_500, seed=7))
    ref = JReceiver(cfg).run(samples)
    tcfg = t_get_config("gps_l1ca", **OVER)
    res = TReceiver(tcfg, "cpu").run(samples)
    return tcfg, scn, dead.prn, ref, res


def test_dead_channel_dropped(scene):
    cfg, scn, dead_prn, ref, res = scene
    trk = res.track
    ci = list(trk.prns).index(dead_prn)
    # dropped within a few lock-detector superblocks of the blackout, at
    # the reference's epoch
    assert trk.status[ci] == '-'
    assert STOP_MS < trk.active_until[ci] < STOP_MS + 5_000
    assert list(trk.prns) == list(ref.track.prns)
    assert trk.status == ref.track.status
    assert np.array_equal(trk.active_until, ref.track.active_until)
    # outputs are zeroed past the drop (frozen state, masked epochs)
    assert np.all(trk.blksize[ci, int(trk.active_until[ci]):] == 0)
    assert np.all(trk.i_p[ci, int(trk.active_until[ci]):] == 0)


def test_live_channels_keep_tracking(scene):
    cfg, scn, dead_prn, ref, res = scene
    trk = res.track
    n_epochs = trk.i_p.shape[1]
    for c, prn in enumerate(trk.prns):
        if prn == dead_prn:
            continue
        assert trk.status[c] == 'T'
        assert trk.active_until[c] == n_epochs


def test_fix_continues_after_blackout(scene):
    cfg, scn, dead_prn, ref, res = scene
    assert res.nav is not None
    assert res.nav.curr_meas_sample == ref.nav.curr_meas_sample
    ms = np.asarray(res.nav.curr_meas_sample) / cfg.sampling_freq * 1e3
    after = ms > STOP_MS + 6_000
    assert after.sum() >= 15, "no fixes after the blackout"
    err = np.sqrt((np.asarray(res.nav.X) - scn.rx_ecef[0]) ** 2
                  + (np.asarray(res.nav.Y) - scn.rx_ecef[1]) ** 2
                  + (np.asarray(res.nav.Z) - scn.rx_ecef[2]) ** 2)
    assert err[after].mean() < 20.0, err[after].mean()
    # the dead SV contributes no measurements after its drop
    for m in np.nonzero(after)[0]:
        assert np.sum(np.isfinite(res.nav.el[m])) <= 5
