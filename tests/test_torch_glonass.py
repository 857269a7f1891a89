"""The GLONASS chain through the port against the JAX reference (the
mirror of tests/test_e2e_glonass.py, same geometric scene, both FDMA
receivers): frequency-channel acquisition on the shared m-sequence,
tracking on the channel's carrier (its IF offset ``k·fdma_spacing_hz``
left out of the code-rate aiding), string decode and the RK4 orbit, all
through the port.

Acquisition: the same detections, code phase, coarse and fine carrier as
the reference's, the peak metrics within 1e-5 relative.  Tracking: the
port tracks the full 39 000 epochs; the reference tracks the first 1 000
from the same acquisition, against which the port's first 1 000 hold
``abs_sample`` equal, prompt sums within 2e-4·(max + 1) and carrier within
1e-2 Hz (measured: 1.5e-3 Hz on this CPU; the f32 sums are added in other
orders and the loops at a 25 Hz bandwidth feed that back).  The file runs
in about 200 s.
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
from cusdr_tpu_torch.constants import SPEED_OF_LIGHT
from cusdr_tpu_torch.geodesy.transforms import e_r_corr, geo2cart, topocent
from cusdr_tpu_torch.nav import glonass_nav
from cusdr_tpu_torch.nav.dispatch import decode_channel
from cusdr_tpu_torch.orbits.glonass import sat_pos_glonass
from cusdr_tpu_torch.signals.defs import get_signal as t_get_signal
from cusdr_tpu_torch.tracking.engine import track as t_track

from test_e2e_glonass import _glo_eph
from test_torch_threads import few_torch_threads  # noqa: F401 (autouse)

N_EPOCHS = 39_000
N_PARITY = 1_000
K = 2                                 # the SV's frequency channel


def _scene(name):
    """The reference test's scene: one SV on channel K on a circular
    orbit, Sagnac-consistent delay, Doppler and Doppler rate, 40 s of
    strings.  Returns (overrides, sv, eph, frame_t0, rx, tod0)."""
    over = dict(sampling_freq=4.096e6, if_freq=7000.0,
                acq_satellite_list=tuple(range(-3, 4)),
                acq_search_band=2000.0, acq_search_step=250.0,
                acq_non_coh_time=8, use_trop_corr=False)
    sig = t_get_signal(name)
    tod0 = 41220.0 + 2.0
    rx = np.asarray(geo2cart(40.0, -105.26, 1610.0, 5))
    eph = _glo_eph(K, t_b=40500.0)
    ts = np.asarray([0.0, 18.0, 36.0])
    g = np.empty(3)
    frame_t0 = 30.0 * np.floor(tod0 / 30.0) - 30.0
    for i, dt in enumerate(ts):
        tau, clk = 0.075, 0.0
        for _ in range(5):
            pos, clk = sat_pos_glonass(tod0 + dt - tau, eph, tau_c=0.0)
            tau = np.linalg.norm(e_r_corr(tau, pos) - rx) / SPEED_OF_LIGHT
        g[i] = dt + (tod0 - frame_t0) - tau + clk
    g2 = (g[0] - 2 * g[1] + g[2]) / (2 * 18.0 ** 2)
    g1 = (g[2] - g[0]) / 36.0 - g2 * 36.0
    fc = sig.carrier_freq_hz + K * sig.fdma_spacing_hz
    strings = []
    for rep in range(40):
        sid = 1 + (rep % 15)
        e = dict(eph)
        if sid == 1:
            e["TOD"] = frame_t0 + 30.0 * (rep // 15)
        strings.append(glonass_nav.encode_string(sid, e))
    sym10 = glonass_nav.encode_symbol_stream(strings)
    doppler = float((g1 - 1.0) * fc)
    band = max(2000.0, abs(doppler) + 1000.0)
    over.update(acq_search_band=band,
                acq_search_step=250.0 if band < 4000 else 500.0)
    sv = SynthSV(prn=K, fdma_channel=K,
                 code_phase=float(-g[0] * over["sampling_freq"] / g1),
                 doppler_hz=doppler, doppler_rate=float(2.0 * g2 * fc),
                 cn0_dbhz=48.0, nav_bits=sym10)
    return over, sv, eph, frame_t0, rx, tod0


@pytest.fixture(scope="module", params=["glo_l1", "glo_l2"])
def chain(request):
    name = request.param
    over, sv, eph, frame_t0, rx, tod0 = _scene(name)
    cfg, sig = get_config(name, **over), get_signal(name)
    tcfg, tsig = t_get_config(name, **over), t_get_signal(name)
    samples = synthesize_if(cfg, sig, [sv], num_ms=40_000, seed=13)
    # both searches on the record's first 100 ms (all they read)
    head = samples[:100 * cfg.samples_per_code]
    ref_acq = j_acquire(cfg, sig, head)
    acq = t_acquire(tcfg, tsig, head, "cpu")
    iq = quantize_iq_int8(samples)
    del samples, head
    i = list(ref_acq.prns).index(K)
    chans = [(K, float(ref_acq.carr_freq[i]), int(ref_acq.code_phase[i]))]
    ref = j_track(cfg, sig, iq, chans, n_epochs=N_PARITY)
    trk = t_track(tcfg, tsig, iq, chans, "cpu", n_epochs=N_EPOCHS)
    return tcfg, tsig, sv, eph, ref_acq, acq, ref, trk, frame_t0, rx, tod0


def test_fdma_acquisition(chain):
    cfg, sig, sv, eph, ref_acq, acq, ref, trk, frame_t0, rx, tod0 = chain
    assert np.array_equal(acq.prns, ref_acq.prns)
    assert np.array_equal(acq.detected, ref_acq.detected)
    det = acq.detected
    assert acq.prns[det].tolist() == [K]
    for name in ("code_phase", "carr_freq", "coarse_freq"):
        assert np.array_equal(getattr(acq, name)[det],
                              getattr(ref_acq, name)[det]), name
    assert np.allclose(acq.peak_metric, ref_acq.peak_metric, rtol=1e-5)
    truth = cfg.if_freq + K * sig.fdma_spacing_hz + sv.doppler_hz
    assert abs(acq.carr_freq[det][0] - truth) <= 2 * cfg.fine_search_step


def test_tracking_locks(chain):
    cfg, sig, sv, eph, ref_acq, acq, ref, trk, frame_t0, rx, tod0 = chain
    assert trk.i_p.shape == (1, N_EPOCHS) and trk.status == ["T"]
    head = slice(0, N_PARITY)
    assert np.array_equal(trk.abs_sample[:, head], ref.abs_sample)
    scale = np.abs(ref.i_p).max() + 1.0
    assert np.abs(trk.i_p[:, head] - ref.i_p).max() <= 2e-4 * scale
    assert np.abs(trk.carr_freq[:, head] - ref.carr_freq).max() <= 1e-2
    ip = np.abs(trk.i_p[0, -5000:]).mean()
    qp = np.abs(trk.q_p[0, -5000:]).mean()
    assert ip > 3 * qp


def test_string_decode_through_pipeline(chain):
    cfg, sig, sv, eph, ref_acq, acq, ref, trk, frame_t0, rx, tod0 = chain
    dec, start, tod = decode_channel(trk, 0, cfg, sig)
    assert dec is not None
    assert glonass_nav.has_ephemeris(dec)
    for k_ in ("x", "y", "z", "vx", "vy", "vz", "tau_n", "t_b"):
        assert dec[k_] == pytest.approx(eph[k_], rel=1e-4, abs=1e-9), k_
    assert np.isfinite(tod)
    assert (tod - frame_t0) % 2.0 == pytest.approx(0.0, abs=1e-9)
    assert frame_t0 <= tod <= frame_t0 + 40.0


def test_rk4_orbit_against_truth(chain):
    """The port's RK4 integration from t_b lands on the geometry."""
    cfg, sig, sv, eph, ref_acq, acq, ref, trk, frame_t0, rx, tod0 = chain
    pos, clk = sat_pos_glonass(tod0, eph, tau_c=0.0)
    assert 2.45e7 < np.linalg.norm(pos) < 2.65e7
    _, elev, _ = topocent(rx, pos - rx)
    assert elev > -5.0
