"""All twelve presets through the port against the JAX reference (the
mirror of tests/test_multisignal.py, same scenes): for every registered
signal both packages acquire the same synthesized SVs (CDMA 'pcps', the
circular-shift search with the CL period search at gps_l2c, the FDMA
search at glo_l1 and glo_l2) and track them from the reference's
acquisition; and the bds_b1c wideband QMBOC dual pilot bank.

Per preset: the port detects what the reference detects (every SV, no
false alarm), with the same code phase and the same carrier, within the
reference test's bound of the truth; the port's tracking locks as the
reference test demands, and its prompt sums are within 2e-4·(max + 1) of
the reference's (the f32 sums are added in other orders; the loops are
the same f64 arithmetic), ``abs_sample`` equal.

One preset's scene takes the per-epoch gather path: bds_b1c at 4.096 Msps
puts the 0.06-chip correlator spacing at 0.24 samples, under half a
sample.  There the chips of every sample are gathered by an f32
ceil-index, and the loops carry the last-bit differences of each step's
sums into the next epoch's state until the two packages' f32 index grids
part and some samples' chips flip.  That case is held by
tests/test_torch_gather.py's closed-loop comparison
(``assert_loop_close``: every data and pilot sum, the frequencies, and
the step tolerances until the grids part), ``abs_sample`` equal.
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
from cusdr_tpu_torch.config import PRESETS
from cusdr_tpu_torch.signals.defs import get_signal as t_get_signal
from cusdr_tpu_torch.tracking.engine import track as t_track

from test_multisignal import CASES, _setup
from test_torch_gather import assert_loop_close
from test_torch_threads import few_torch_threads  # noqa: F401 (autouse)

SUM_RTOL = 2e-4


def _overrides(name):
    """The overrides ``_setup`` gives the reference's preset."""
    case = CASES[name]
    over = dict(case.get("overrides", {}))
    over.update(sampling_freq=case["fs"], if_freq=7000.0,
                acq_search_band=case.get("band", 2000.0),
                acq_satellite_list=tuple(case["search"]))
    over.setdefault("acq_search_step", 250.0)
    return over


def test_every_preset_is_mirrored():
    assert sorted(CASES) == sorted(PRESETS)


@pytest.fixture(scope="module", params=sorted(CASES), name="scene")
def scene_fixture(request):
    name = request.param
    cfg, sig, case, svs, samples = _setup(name)
    tcfg, tsig = t_get_config(name, **_overrides(name)), t_get_signal(name)
    assert tcfg.sampling_freq == cfg.sampling_freq
    ref = j_acquire(cfg, sig, samples)
    port = t_acquire(tcfg, tsig, samples, "cpu")
    iq = quantize_iq_int8(samples)
    channels = []
    for sv in svs:
        i = list(ref.prns).index(sv.prn)
        channels.append((sv.prn, float(ref.carr_freq[i]),
                         int(ref.code_phase[i])))
    ref_trk = j_track(cfg, sig, iq, channels, n_epochs=case["epochs"])
    port_trk = t_track(tcfg, tsig, iq, channels, "cpu",
                       n_epochs=case["epochs"])
    return (name, tcfg, tsig, case, svs, ref, port, ref_trk, port_trk)


def _gather_path(cfg, sig):
    """Whether the correlator spacing falls under half a sample."""
    return (cfg.dll_correlator_spacing * cfg.sampling_freq
            / sig.chip_rate_hz) < 0.5


def _truth(cfg, sig, sv):
    truth = cfg.if_freq + sv.doppler_hz
    if sig.fdma:
        truth += sig.fdma_spacing_hz * sv.fdma_channel
    return truth


def test_acquisition_detects_as_reference(scene):
    name, cfg, sig, case, svs, ref, port, ref_trk, port_trk = scene
    assert np.array_equal(port.prns, ref.prns)
    assert np.array_equal(port.detected, ref.detected), name
    detected = {int(p) for p in port.prns[port.detected]}
    assert detected == {sv.prn for sv in svs}, name


def test_acquisition_code_phase_exact(scene):
    name, cfg, sig, case, svs, ref, port, ref_trk, port_trk = scene
    spc = cfg.samples_per_code
    det = ref.detected
    assert np.array_equal(port.code_phase[det], ref.code_phase[det]), name
    for sv in svs:
        i = list(port.prns).index(sv.prn)
        err = (int(port.code_phase[i]) - sv.code_phase) % spc
        assert min(err, spc - err) <= 2.0, (name, sv.prn)


def test_fine_frequency(scene):
    name, cfg, sig, case, svs, ref, port, ref_trk, port_trk = scene
    det = ref.detected
    assert np.array_equal(port.carr_freq[det], ref.carr_freq[det]), name
    assert np.array_equal(port.pilot_phase[det], ref.pilot_phase[det])
    tol = max(cfg.fine_search_step * 1.5, 40.0)
    for sv in svs:
        i = list(port.prns).index(sv.prn)
        assert abs(port.carr_freq[i] - _truth(cfg, sig, sv)) <= tol, \
            (name, sv.prn)


def test_tracking_locks(scene):
    name, cfg, sig, case, svs, ref, port, ref_trk, port_trk = scene
    gather = _gather_path(cfg, sig)
    assert gather == (name == "bds_b1c")
    assert np.array_equal(port_trk.abs_sample, ref_trk.abs_sample), name
    if gather:
        assert_loop_close(port_trk, ref_trk, cfg.sampling_freq)
    else:
        scale = np.abs(ref_trk.i_p).max() + 1.0
        assert np.abs(port_trk.i_p - ref_trk.i_p).max() <= SUM_RTOL * scale
    tail = case["epochs"] // 2
    for c, sv in enumerate(svs):
        ip = np.abs(port_trk.i_p[c, -tail:]).mean()
        qp = np.abs(port_trk.q_p[c, -tail:]).mean()
        assert ip > 2.5 * qp, (name, c, ip, qp)
        got = port_trk.carr_freq[c, -tail:].mean()
        assert abs(got - _truth(cfg, sig, sv)) < 20.0, (name, c, got)
        code_truth = sig.chip_rate_hz * (
            1 + sv.doppler_hz / sig.carrier_freq_hz)
        code_got = port_trk.code_freq[c, -tail:].mean()
        assert abs(code_got - code_truth) < 2.0 * sig.chip_rate_hz / 1e6, \
            (name, c, code_got, code_truth)


def test_b1c_wideband_qmboc_tracking():
    """pilot_trk_flag=2: the dual BOC(1,1) + BOC(6,1) pilot bank on a
    full-QMBOC scene, through both packages: the port's sums within
    2e-4·(max + 1) of the reference's, and the reference test's lock and
    pilot-to-data amplitude bounds."""
    over = dict(sampling_freq=16.384e6, if_freq=7000.0, pilot_trk_flag=2)
    cfg, sig = get_config("bds_b1c", **over), get_signal("bds_b1c")
    rng = np.random.default_rng(1)
    sv = SynthSV(prn=19, code_phase=977.0, doppler_hz=300.0, cn0_dbhz=50,
                 nav_bits=rng.choice(np.asarray([-1, 1], np.int8), 100))
    iq = quantize_iq_int8(synthesize_if(cfg, sig, [sv], num_ms=450,
                                        seed=4))
    chans = [(19, 7300.0, 977)]
    ref = j_track(cfg, sig, iq, chans, n_epochs=40)
    res = t_track(t_get_config("bds_b1c", **over), t_get_signal("bds_b1c"),
                  iq, chans, "cpu", n_epochs=40)
    assert np.array_equal(res.abs_sample, ref.abs_sample)
    for name in ("i_p", "pilot_ip"):
        a, b = getattr(ref, name), getattr(res, name)
        assert np.abs(b - a).max() <= SUM_RTOL * (np.abs(a).max() + 1.0)
    ip = np.abs(res.i_p[0, -15:]).mean()
    qp = np.abs(res.q_p[0, -15:]).mean()
    assert ip > 3 * qp
    pip = np.abs(res.pilot_ip[0, -15:]).mean()
    pqp = np.abs(res.pilot_qp[0, -15:]).mean()
    assert pip > 3 * pqp
    assert 1.3 < pip / ip < 2.2
    assert abs(res.carr_freq[0, -10:].mean() - 7300.0) < 10.0
