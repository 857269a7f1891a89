"""``Receiver.run`` with ``cfg.time_blocks > 1`` end to end against the JAX
reference, on the 40 s, 2.048 Msps, 6-SV scene of
tests/test_e2e_timeparallel.py, in both modes:

  * state handoff (``time_blocks=8, handoff_iters=1``, the shipped
    default): stitched exactly, measurements usable everywhere;
  * predict only (``time_blocks=4, handoff_iters=0, settle_epochs=300``):
    ``nav_solve`` masks each block's re-convergence transient.

Each case holds the port's fixes to that file's truth bounds (>= 60 / >= 40
fixes, mean < 15 m, max < 50 m) and to the reference's fixes one by one.
The two packages carry the same f64 loop state and sum the f32 correlators
in other orders (tests/test_torch_receiver.py measured 9e-8 chips of code
phase, ~3e-5 m of range, on the sequential path), so the fixes are held to
1 mm per axis.  One module fixture makes the scene once; every case runs
the port on the CPU through the plain correlator.
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

FIX_TOL_M = 1e-3

OVER = dict(sampling_freq=2.048e6, if_freq=7000.0,
            acq_satellite_list=tuple(range(1, 33)),
            acq_non_coh_time=12, use_trop_corr=False,
            ms_to_process=40_000)
MODES = {"handoff": dict(time_blocks=8, handoff_iters=1),
         "predict": dict(time_blocks=4, handoff_iters=0,
                         settle_epochs=300)}


@pytest.fixture(scope="module")
def scene():
    cfg = get_config("gps_l1ca", **OVER)
    sig = get_signal("gps_l1ca")
    scn = make_gps_scenario(cfg, sig, n_svs=6, duration_s=40.0,
                            cn0_dbhz=46.0)
    samples = quantize_iq_int8(
        synthesize_if(cfg, sig, scn.svs, num_ms=40_500, seed=7))
    return scn, samples


@pytest.fixture(scope="module", params=list(MODES))
def runs(request, scene):
    scn, samples = scene
    mode = MODES[request.param]
    ref = JReceiver(get_config("gps_l1ca", **OVER, **mode)).run(samples)
    port = TReceiver(t_get_config("gps_l1ca", **OVER, **mode),
                     "cpu").run(samples)
    return request.param, scn, ref, port


def test_blocks_and_settle_mask(runs):
    mode, scn, ref, port = runs
    want = MODES[mode]
    assert port.track.n_blocks == ref.track.n_blocks == want["time_blocks"]
    assert port.track.epochs_per_block == ref.track.epochs_per_block
    assert port.track.settle_epochs == ref.track.settle_epochs == (
        0 if mode == "handoff" else 300)
    assert port.track.i_p.shape == ref.track.i_p.shape
    assert port.track.i_p.shape[1] % want["time_blocks"] == 0
    assert [c[0] for c in port.channels] == [c[0] for c in ref.channels]
    assert port.track.status == ref.track.status
    assert "tracking_s" in port.timings


def test_tracking_outputs_agree(runs):
    _, scn, ref, port = runs
    assert np.array_equal(port.track.abs_sample, ref.track.abs_sample)
    scale = np.abs(ref.track.i_p).max() + 1.0
    assert np.abs(port.track.i_p - ref.track.i_p).max() <= 2e-4 * scale
    assert np.allclose(port.track.carr_freq, ref.track.carr_freq,
                       rtol=0, atol=1e-3)


def test_fixes_match_reference_one_by_one(runs):
    _, scn, ref, port = runs
    assert port.nav is not None and ref.nav is not None
    assert port.nav.curr_meas_sample == ref.nav.curr_meas_sample
    for axis in ("X", "Y", "Z"):
        d = np.abs(np.asarray(getattr(port.nav, axis))
                   - np.asarray(getattr(ref.nav, axis)))
        assert d.max() <= FIX_TOL_M, (axis, d.max())


def test_fixes_within_e2e_bounds(runs):
    mode, scn, ref, port = runs
    err = np.sqrt((np.asarray(port.nav.X) - scn.rx_ecef[0]) ** 2
                  + (np.asarray(port.nav.Y) - scn.rx_ecef[1]) ** 2
                  + (np.asarray(port.nav.Z) - scn.rx_ecef[2]) ** 2)
    assert len(err) >= (60 if mode == "handoff" else 40)
    assert err.mean() < 15.0, err.mean()
    assert err.max() < 50.0, err.max()
    if mode == "predict":
        # some measurement epochs were masked: fewer fixes than the
        # sequential run's 72, but ~30 s worth remain
        assert len(err) < 72
