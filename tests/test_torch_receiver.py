"""The ported slice end to end against the JAX reference: one module fixture
runs both ``Receiver.run`` on the 40 s, 2.048 Msps, 6-SV scene of
tests/test_e2e_l1ca.py (the port on the CPU, through the plain correlator).

Checks: the same channels (PRN, code phase, carrier), the same tracking
outputs and fixes one by one, and the e2e test's truth bounds.  The two
packages carry the same f64 loop state but sum the f32 correlators in
different orders.  Measured on an x86 CPU: rem_code_phase differs by at
most 9e-8 chips (~3e-5 m of range), I_P by 5e-3 of a 2 485 maximum,
carr_freq by 1.3e-4 Hz, and the fixes came out identical.  Tolerances:
fixes 0.01 m per axis (300 times the code-phase difference; a one-sample
code slip is ~146 m), I_P 2e-4·scale, carr_freq 1e-3 Hz.  The file runs
in about 130 s on an 8-core CPU.
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

FIX_TOL_M = 0.01

OVER = dict(sampling_freq=2.048e6, if_freq=7000.0,
            acq_satellite_list=tuple(range(1, 33)),
            acq_non_coh_time=12, use_trop_corr=False,
            ms_to_process=40_000)


@pytest.fixture(scope="module")
def runs():
    cfg = get_config("gps_l1ca", **OVER)
    sig = get_signal("gps_l1ca")
    scn = make_gps_scenario(cfg, sig, n_svs=6, duration_s=40.0,
                            cn0_dbhz=46.0)
    samples = quantize_iq_int8(
        synthesize_if(cfg, sig, scn.svs, num_ms=40_500, seed=7))
    ref = JReceiver(cfg).run(samples)
    port = TReceiver(t_get_config("gps_l1ca", **OVER), "cpu").run(samples)
    return scn, ref, port


def _err(nav, scn):
    return np.sqrt((np.asarray(nav.X) - scn.rx_ecef[0]) ** 2
                   + (np.asarray(nav.Y) - scn.rx_ecef[1]) ** 2
                   + (np.asarray(nav.Z) - scn.rx_ecef[2]) ** 2)


def test_same_channels(runs):
    scn, ref, port = runs
    assert [c[0] for c in port.channels] == [c[0] for c in ref.channels]
    assert [c[2] for c in port.channels] == [c[2] for c in ref.channels]
    for a, b in zip(port.channels, ref.channels):
        assert abs(a[1] - b[1]) <= 25.0        # one fine step
    assert {sv.prn for sv in scn.svs} <= {c[0] for c in port.channels}
    assert port.track.status == ref.track.status


def test_tracking_outputs_agree(runs):
    scn, ref, port = runs
    assert port.track.i_p.shape == ref.track.i_p.shape
    assert np.array_equal(port.track.abs_sample, ref.track.abs_sample)
    scale = np.abs(ref.track.i_p).max() + 1.0
    assert np.abs(port.track.i_p - ref.track.i_p).max() <= 2e-4 * scale
    assert np.allclose(port.track.carr_freq, ref.track.carr_freq,
                       rtol=0, atol=1e-3)


def test_fixes_match_reference_one_by_one(runs):
    scn, ref, port = runs
    assert port.nav is not None and ref.nav is not None
    assert port.nav.curr_meas_sample == ref.nav.curr_meas_sample
    for axis in ("X", "Y", "Z"):
        d = np.abs(np.asarray(getattr(port.nav, axis))
                   - np.asarray(getattr(ref.nav, axis)))
        assert d.max() <= FIX_TOL_M, (axis, d.max())


def test_fixes_within_e2e_bounds(runs):
    scn, ref, port = runs
    err = _err(port.nav, scn)
    assert len(err) >= 60
    assert err.mean() < 15.0, err.mean()
    assert err.max() < 50.0, err.max()
