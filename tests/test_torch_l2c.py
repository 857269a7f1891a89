"""The GPS L2C chain through the port against the JAX reference (the
mirror of tests/test_e2e_l2c.py, same scenes and bounds): the
circular-shift acquisition over the preset's full ±10 kHz band at 12.5 Hz
with the CL period search, 20 ms-epoch tracking with and without the CL
pilot, and CNAV decode through the port's pipeline.

Acquisition: the port and the reference on the same scene detect the same
PRN with the same code phase, coarse carrier, fine carrier and CL period
(37, the scene's), the peak metrics within 1e-5 relative (f32 FFT and
summation order).  Tracking: both packages track the chain's channel for
1 860 epochs from the same acquisition; ``abs_sample`` equal, prompt sums
within 2e-4·(max + 1) and carrier within 1e-3 Hz (the f32 sums are added in
other orders; the f64 loops are the same).  The file runs in about 120 s
on one CPU core pair.
"""

import numpy as np
import pytest

from cusdr_tpu import get_config
from cusdr_tpu.acquisition import acquire as j_acquire
from cusdr_tpu.io.synth import SynthSV, quantize_iq_int8, synthesize_if
from cusdr_tpu.signals.defs import get_signal
from cusdr_tpu.tracking import track as j_track
from cusdr_tpu_torch import get_config as t_get_config
from cusdr_tpu_torch.acquisition.pcps import acquire as t_acquire
from cusdr_tpu_torch.nav import cnav
from cusdr_tpu_torch.nav.dispatch import decode_channel
from cusdr_tpu_torch.signals.defs import get_signal as t_get_signal
from cusdr_tpu_torch.tracking.engine import track as t_track

from test_e2e_l2c import EPH, FS, IF
from test_torch_threads import few_torch_threads  # noqa: F401 (autouse)

OVER = dict(sampling_freq=FS, if_freq=IF, acq_satellite_list=(3, 7, 9),
            fine_search_step=5.0, acq_threshold=3.0)
N_EPOCHS = 1860


def _cfgs():
    return get_config("gps_l2c", **OVER), t_get_config("gps_l2c", **OVER)


def test_cl_phase_search_resolves_period():
    """One coherent code period pinpoints which of the 75 CM periods of
    the CL cycle the acquisition landed on, in both packages."""
    cfg, tcfg = _cfgs()
    sig = get_signal("gps_l2c")
    spc = cfg.samples_per_code
    h_true = 37
    sv = SynthSV(prn=7, code_phase=7000.0 - h_true * spc,
                 doppler_hz=90.0, cn0_dbhz=50)
    samples = synthesize_if(cfg, sig, [sv], num_ms=100, seed=3)
    ref = j_acquire(cfg, sig, samples)
    port = t_acquire(tcfg, t_get_signal("gps_l2c"), samples, "cpu")
    assert np.array_equal(port.detected, ref.detected)
    det = ref.detected
    assert det.tolist() == [False, True, False]
    for name in ("code_phase", "coarse_freq", "carr_freq", "pilot_phase"):
        assert np.array_equal(getattr(port, name)[det],
                              getattr(ref, name)[det]), name
    assert np.allclose(port.peak_metric, ref.peak_metric, rtol=1e-5)
    i = list(port.prns).index(7)
    err = abs(int(port.code_phase[i]) - 7000) % spc
    assert min(err, spc - err) <= 2
    assert abs(port.carr_freq[i] - (IF + 90.0)) < 5.0
    assert int(port.pilot_phase[i]) == h_true
    assert set(port.timings) == {"coarse_s", "pilot_phase_s", "fine_s"}


@pytest.fixture(scope="module")
def chain():
    cfg, tcfg = _cfgs()
    sig = get_signal("gps_l2c")
    tsig = t_get_signal("gps_l2c")
    tow0 = 345600
    msgs = [cnav.encode_message(mid, EPH, tow0 + 12 * (i + 1), prn=7)
            for i, mid in enumerate([10, 11, 30, 10])]
    nav = cnav.encode_symbol_stream(msgs).astype(np.int8)
    sv = SynthSV(prn=7, code_phase=7000.0, doppler_hz=90.0,
                 cn0_dbhz=48, nav_bits=nav)
    samples = synthesize_if(cfg, sig, [sv], num_ms=38_000, seed=4)
    # the full-band search is held to the reference's on the CL scene
    # above; here the port's acquisition seeds both packages' tracking
    acq = t_acquire(tcfg, tsig, samples[:cfg.samples_per_code * 60], "cpu")
    iq = quantize_iq_int8(samples)
    del samples
    i = list(acq.prns).index(7)
    chans = [(7, float(acq.carr_freq[i]), int(acq.code_phase[i]))]
    ref = j_track(cfg, sig, iq, chans, n_epochs=N_EPOCHS)
    port = t_track(tcfg, tsig, iq, chans, "cpu", n_epochs=N_EPOCHS)
    return tcfg, tsig, acq, ref, port, tow0, iq


def test_acquisition_20ms_coherent(chain):
    cfg, sig, acq, ref, trk, tow0, iq = chain
    i = list(acq.prns).index(7)
    assert acq.detected[i]
    err = abs(int(acq.code_phase[i]) - 7000) % cfg.samples_per_code
    assert min(err, cfg.samples_per_code - err) <= 2
    assert abs(acq.carr_freq[i] - (IF + 90.0)) < 5.0
    for j, p in enumerate(acq.prns):
        if p != 7:
            assert not acq.detected[j]


def test_tracking_lock_20ms_epochs(chain):
    cfg, sig, acq, ref, trk, tow0, iq = chain
    assert trk.i_p.shape == ref.i_p.shape == (1, N_EPOCHS)
    assert np.array_equal(trk.abs_sample, ref.abs_sample)
    scale = np.abs(ref.i_p).max() + 1.0
    assert np.abs(trk.i_p - ref.i_p).max() <= 2e-4 * scale
    assert np.allclose(trk.carr_freq, ref.carr_freq, rtol=0, atol=1e-3)
    ip = np.abs(trk.i_p[0, -500:]).mean()
    qp = np.abs(trk.q_p[0, -500:]).mean()
    assert ip > 3 * qp
    # mean code rate matches the Doppler-aided basis
    basis = sig.chip_rate_hz * (1.0 + 90.0 / sig.carrier_freq_hz)
    assert abs(trk.code_freq[0, -800:].mean() - basis) < 1.0


def test_cnav_decode_through_pipeline(chain):
    cfg, sig, acq, ref, trk, tow0, iq = chain
    eph, start, tow = decode_channel(trk, 0, cfg, sig)
    assert eph is not None
    assert cnav.has_ephemeris(eph)
    for k in ("M_0", "e", "omega", "omega_0", "i_0", "t_oe", "a_f0",
              "deltaA"):
        assert eph[k] == pytest.approx(EPH[k], rel=1e-6,
                                       abs=abs(EPH[k]) * 1e-6 + 1e-12), k
    assert eph["ADot"] == pytest.approx(
        round(EPH["ADot"] * 2 ** 21) * 2.0 ** -21, abs=1e-12)
    assert tow == tow0


def test_cl_pilot_tracking_improves(chain):
    """The resolved CL period seeds the 75-period pilot counter: the pilot
    prompt locks through the full-period CL table and the averaged
    data+pilot discriminators cut the carrier jitter of CM alone."""
    cfg, sig, acq, ref, trk, tow0, iq = chain
    i = list(acq.prns).index(7)
    chans = [(7, float(acq.carr_freq[i]), int(acq.code_phase[i]),
              int(acq.pilot_phase[i]))]
    trkp = t_track(cfg.replace(pilot_trk_flag=1), sig, iq, chans, "cpu",
                   n_epochs=900)
    pe = np.hypot(trkp.pilot_ip[0, 100:], trkp.pilot_qp[0, 100:]).mean()
    de = np.hypot(trkp.i_p[0, 100:], trkp.q_p[0, 100:]).mean()
    assert pe > 0.6 * de, (pe, de)
    sl = slice(100, 900)
    assert np.std(trkp.pll_discr[0, sl]) < 0.85 * np.std(trk.pll_discr[0, sl])


def test_cl_pilot_wrong_phase_no_lock(chain):
    """A wrong CL period hypothesis decorrelates the pilot."""
    cfg, sig, acq, ref, trk, tow0, iq = chain
    i = list(acq.prns).index(7)
    wrong = (int(acq.pilot_phase[i]) + 30) % 75
    chans = [(7, float(acq.carr_freq[i]), int(acq.code_phase[i]), wrong)]
    trkp = t_track(cfg.replace(pilot_trk_flag=1), sig, iq, chans, "cpu",
                   n_epochs=200)
    pe = np.hypot(trkp.pilot_ip[0, 50:], trkp.pilot_qp[0, 50:]).mean()
    de = np.hypot(trkp.i_p[0, 50:], trkp.q_p[0, 50:]).mean()
    assert pe < 0.3 * de, (pe, de)


def test_shipped_fine_step_pulls_in_as_the_reference():
    """At the preset's own 25 Hz fine step, twice its 12.5 Hz coarse step,
    the fine stage has a single bin, 6.25 Hz above the coarse pick, which
    leaves up to ~11 Hz of carrier error; the 10 Hz, 20 ms PLL settles
    12.5 Hz off on such channels.  The port reproduces the reference here
    too: the same acquired carriers, and tracking that settles on the same
    frequencies (the reason the scenes above, and chip_smoke.py's phase 11,
    give the preset the reference tests' 5 Hz fine step)."""
    over = dict(sampling_freq=FS, if_freq=IF, acq_search_band=1000.0,
                acq_satellite_list=(1, 3, 6, 8, 11, 13))
    cfg, sig = get_config("gps_l2c", **over), get_signal("gps_l2c")
    tcfg, tsig = t_get_config("gps_l2c", **over), t_get_signal("gps_l2c")
    assert tcfg.fine_search_step == 2 * tcfg.acq_search_step
    rng = np.random.default_rng(21)
    dops = np.linspace(-800.0, 800.0, 6)
    svs = [SynthSV(prn=p, code_phase=float(rng.uniform(0, 40959)),
                   doppler_hz=float(d), cn0_dbhz=46.0,
                   nav_bits=rng.choice([-1.0, 1.0], 110))
           for p, d in zip(over["acq_satellite_list"], dops)]
    # one chunk: the CL code generator caches four PRNs' codes, and the
    # synthesizer asks for every SV's code again in every chunk
    samples = synthesize_if(cfg, sig, svs, num_ms=2000, seed=21,
                            chunk_ms=2000)
    ref = j_acquire(cfg, sig, samples)
    port = t_acquire(tcfg, tsig, samples, "cpu")
    assert np.array_equal(port.carr_freq, ref.carr_freq)
    assert np.array_equal(port.code_phase, ref.code_phase)
    iq = quantize_iq_int8(samples)
    chans = ref.best_channels(12)
    a = j_track(cfg, sig, iq, chans)
    b = t_track(tcfg, tsig, iq, chans, "cpu")
    truth = {sv.prn: IF + sv.doppler_hz for sv in svs}
    err_a = [a.carr_freq[c, -25:].mean() - truth[p]
             for c, p in enumerate(a.prns)]
    err_b = [b.carr_freq[c, -25:].mean() - truth[p]
             for c, p in enumerate(b.prns)]
    assert np.allclose(err_b, err_a, rtol=0, atol=1e-2)
    # some channels settle half a 25 Hz step off, some on the carrier
    off = np.abs(err_b) > 10.0
    assert off.any() and not off.all()
    assert np.allclose(np.abs(np.asarray(err_b)[off]), 12.5, atol=0.5)
