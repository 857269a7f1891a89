"""Parity of the ported PCPS acquisition with the JAX reference on
synthetic scenes: the same detected PRNs, the exact code phase, the
carrier within one fine step (the coarse and fine searches pick grid
points, and an f32 summation-order tie may move the pick by one), the same
coarse bins.  Peak metrics agree to 1e-3 relative (f32 FFT and sum order
between XLA and PyTorch).

Three fine-stage modes: gps_l1ca (nav-bit-edge windows), bds_b1i (NH20
data secondary) and gal_e1c (two jointly weighted components, CS25 pilot
secondary), at the reduced rates of the reference's own tests."""

import numpy as np
import pytest

from cusdr_tpu import get_config
from cusdr_tpu.acquisition import acquire as j_acquire
from cusdr_tpu.io.synth import SynthSV, quantize_iq_int8, synthesize_if
from cusdr_tpu.signals.defs import get_signal
from cusdr_tpu_torch import get_config as t_get_config
from cusdr_tpu_torch.acquisition.pcps import acquire as t_acquire
from cusdr_tpu_torch.signals.defs import get_signal as t_get_signal

from test_torch_threads import few_torch_threads  # noqa: F401 (autouse)

SCENES = {
    "gps_l1ca": (dict(sampling_freq=2.048e6, if_freq=7000.0,
                      acq_satellite_list=tuple(range(1, 33))),
                 [SynthSV(prn=3, code_phase=101.0, doppler_hz=2750.0,
                          cn0_dbhz=47),
                  SynthSV(prn=11, code_phase=1500.0, doppler_hz=-3300.0,
                          cn0_dbhz=45),
                  SynthSV(prn=19, code_phase=777.0, doppler_hz=400.0,
                          cn0_dbhz=44),
                  SynthSV(prn=27, code_phase=2000.0, doppler_hz=-150.0,
                          cn0_dbhz=49)], 80),
    "bds_b1i": (dict(sampling_freq=4.096e6, if_freq=7000.0,
                     acq_satellite_list=tuple(range(6, 38)),
                     acq_search_step=250.0, acq_non_coh_time=8),
                [SynthSV(prn=9, code_phase=3000.0, doppler_hz=-1800.0,
                         cn0_dbhz=47),
                 SynthSV(prn=21, code_phase=512.0, doppler_hz=2600.0,
                         cn0_dbhz=48)], 70),
    "gal_e1c": (dict(sampling_freq=4.096e6, if_freq=7000.0,
                     acq_satellite_list=(2, 4, 6), acq_search_band=2000.0,
                     acq_search_step=125.0, acq_non_coh_time=2,
                     acq_threshold=2.5),
                [SynthSV(prn=4, code_phase=2233.0, doppler_hz=800.0,
                         cn0_dbhz=48)], 120),
}


@pytest.fixture(scope="module", params=sorted(SCENES))
def both(request):
    name = request.param
    over, svs, num_ms = SCENES[name]
    cfg = get_config(name, **over)
    sig = get_signal(name)
    iq = quantize_iq_int8(synthesize_if(cfg, sig, svs, num_ms=num_ms,
                                        seed=3))
    x = iq[0::2].astype(np.float32) + 1j * iq[1::2].astype(np.float32)
    ref = j_acquire(cfg, sig, x)
    port = t_acquire(t_get_config(name, **over), t_get_signal(name), x,
                     "cpu")
    return cfg, svs, ref, port


def test_same_detections_as_reference(both):
    cfg, svs, ref, port = both
    assert np.array_equal(port.prns, ref.prns)
    assert np.array_equal(port.detected, ref.detected)
    assert {sv.prn for sv in svs} <= set(port.prns[port.detected].tolist())
    assert np.allclose(port.peak_metric, ref.peak_metric, rtol=1e-3)


def test_code_phase_exact_and_carrier_within_a_fine_step(both):
    cfg, svs, ref, port = both
    det = ref.detected
    assert np.array_equal(port.code_phase[det], ref.code_phase[det])
    assert np.all(np.abs(port.carr_freq[det] - ref.carr_freq[det])
                  <= cfg.fine_search_step)
    assert np.array_equal(port.coarse_freq, ref.coarse_freq)


def test_best_channels_match_reference_and_truth(both):
    cfg, svs, ref, port = both
    assert [c[0] for c in port.best_channels(12)] == \
        [c[0] for c in ref.best_channels(12)]
    chans = {c[0]: c for c in port.best_channels(12)}
    for sv in svs:
        _, carr, cp, _ = chans[sv.prn]
        assert abs(cp - sv.code_phase) <= 1
        assert abs(carr - (cfg.if_freq + sv.doppler_hz)) <= \
            2 * cfg.fine_search_step


def test_unported_modes_raise():
    sig = t_get_signal("gps_l1ca")
    x = np.zeros(100_000, np.complex64)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_acquire(t_get_config("gps_l1ca", acq_method="circshift"), sig, x,
                  "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_acquire(t_get_config("glo_l1"), t_get_signal("glo_l1"), x, "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_acquire(t_get_config("gps_l2c"), t_get_signal("gps_l2c"), x,
                  "cpu")
