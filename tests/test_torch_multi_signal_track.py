"""Concurrent multi-signal tracking through the port against the JAX
reference: the mirror of tests/test_multi_signal_track.py (its scenes,
L1CA 1 ms + E1C 4 ms on a 4 ms hyperepoch) without its mesh case, plus a
bank on the per-epoch gather path (bds_b1c at 4.096 Msps beside gps_l1ca
at 2.048 Msps on a 10 ms hyperepoch).

- The port's ``track_multi`` equals the port's own standalone ``track``
  (with ``lock_detect`` off: ``track_multi`` has no lock gate, as in the
  reference) within the reference test's tolerances (``abs_sample``
  equal, ``carr_freq`` atol 1e-9, ``i_p``/``q_p`` rtol 1e-6 atol 1e-3);
  it is in fact equal element for element, and the test holds that too.
- Against the reference's ``track_multi``: the banks' f32 sums are added
  in another order, and the loops feed that back, so a fast bank is held
  as the port's other closed-loop parity tests hold it (``abs_sample``
  equal, sums within 2e-4 of the largest, loop frequencies rtol 1e-6 atol
  1e-4 Hz; on the E1C bank's channel on noise, which no lock holds,
  ``abs_sample`` only) and a gather bank to the closed-loop tolerances of
  tests/test_torch_gather.py.
- Both signals lock; ``run_multi`` runs from IF files on disk.
"""

import warnings

import numpy as np
import pytest

from cusdr_tpu import get_config
from cusdr_tpu.io.synth import SynthSV, quantize_iq_int8, synthesize_if
from cusdr_tpu.signals.defs import get_signal
from cusdr_tpu.tracking import track_multi as j_track_multi
from cusdr_tpu_torch import get_config as t_get_config
from cusdr_tpu_torch.signals.defs import get_signal as t_get_signal
from cusdr_tpu_torch.tracking.engine import track as t_track
from cusdr_tpu_torch.tracking.multi import _hyper_grid, track_multi

from test_multi_signal_track import scenes  # noqa: F401 (fixture)
from test_torch_gather import LOOP_FREQ_HZ, LOOP_RTOL
from test_torch_threads import few_torch_threads  # noqa: F401 (autouse)

N_MS = 800
SUM_RTOL = 2e-4
FIELDS = ("i_e", "q_e", "i_p", "q_p", "i_l", "q_l", "pilot_ip", "pilot_qp",
          "carr_freq", "code_freq", "dll_discr", "dll_filt", "pll_discr",
          "pll_filt", "rem_code_phase", "rem_carr_phase", "abs_sample",
          "blksize")


def _port_spec(spec, **over):
    """The reference test's (cfg, sig, iq, channels) for the port."""
    cfg, sig, iq, chans = spec
    over = dict(sampling_freq=cfg.sampling_freq, if_freq=cfg.if_freq,
                **over)
    return (t_get_config(cfg.signal, **over), t_get_signal(cfg.signal), iq,
            chans)


def _solo(spec, n_epochs):
    cfg, sig, iq, chans = spec
    return t_track(cfg.replace(lock_detect=False), sig, iq, chans, "cpu",
                   n_epochs=n_epochs)


def _assert_as_solo(got, solo):
    """The reference test's tolerances, then every field equal."""
    np.testing.assert_array_equal(got.abs_sample, solo.abs_sample)
    np.testing.assert_allclose(got.carr_freq, solo.carr_freq, rtol=0,
                               atol=1e-9)
    for f in ("i_p", "q_p"):
        np.testing.assert_allclose(getattr(got, f), getattr(solo, f),
                                   rtol=1e-6, atol=1e-3)
    for f in FIELDS:
        assert np.array_equal(getattr(got, f), getattr(solo, f)), f
    assert got.status == solo.status


def _assert_fast_as_reference(got, ref, rows=slice(None)):
    """``abs_sample`` equal on every row; sums and loop frequencies on the
    ``rows`` that track a signal (a row on noise has no lock to hold its
    loop, and the packages' last-bit differences walk it apart)."""
    np.testing.assert_array_equal(got.abs_sample, ref.abs_sample)
    for f in ("i_p", "q_p", "pilot_ip"):
        a, b = getattr(ref, f)[rows], getattr(got, f)[rows]
        assert np.abs(b - a).max() <= SUM_RTOL * (np.abs(a).max() + 1.0), f
    for f in ("carr_freq", "code_freq"):
        np.testing.assert_allclose(getattr(got, f)[rows],
                                   getattr(ref, f)[rows], rtol=1e-6,
                                   atol=1e-4, err_msg=f)


@pytest.fixture(scope="module")
def port_multi(scenes):  # noqa: F811
    spec_a, spec_b = scenes
    return track_multi([_port_spec(spec_a), _port_spec(spec_b)], n_ms=N_MS,
                       device="cpu")


def test_hyper_grid_as_reference(scenes):  # noqa: F811
    from cusdr_tpu.tracking.multi import _hyper_grid as j_grid
    sigs = [get_signal(s) for s in ("gps_l1ca", "gal_e1c", "bds_b1c")]
    tsigs = [t_get_signal(s) for s in ("gps_l1ca", "gal_e1c", "bds_b1c")]
    assert _hyper_grid(tsigs) == j_grid(sigs) == (20, (20, 5, 2))


def test_mixed_period_parity_with_single_signal_runs(
        scenes, port_multi):  # noqa: F811
    """L1CA (1 ms) + E1C (4 ms) on a 4 ms hyperepoch: each bank equals the
    port's standalone run, and is held to the reference's concurrent
    run."""
    spec_a, spec_b = scenes
    solo_a = _solo(_port_spec(spec_a), N_MS)
    solo_b = _solo(_port_spec(spec_b), N_MS // 4)
    assert port_multi[0].i_p.shape == (2, N_MS)
    assert port_multi[1].i_p.shape == (2, N_MS // 4)
    ref = j_track_multi([spec_a, spec_b], n_ms=N_MS)
    # E1C's second channel tracks noise (the reference test's note)
    for solo, got, want, rows in (
            (solo_a, port_multi[0], ref[0], slice(None)),
            (solo_b, port_multi[1], ref[1], slice(0, 1))):
        _assert_as_solo(got, solo)
        _assert_fast_as_reference(got, want, rows)


def test_locks_both_signals(port_multi):
    ca = port_multi[0]
    assert abs(ca.carr_freq[0, -100:].mean() - 9500.0) < 15.0
    ip = np.abs(ca.i_p[0, -200:]).mean()
    qp = np.abs(ca.q_p[0, -200:]).mean()
    assert ip > 3 * qp
    e1 = port_multi[1]
    assert abs(e1.carr_freq[0, -25:].mean() - 7800.0) < 10.0


def test_gather_bank_beside_a_fast_bank():
    """bds_b1c at 4.096 Msps (the gather path) and gps_l1ca at 2.048 Msps
    on a 10 ms hyperepoch: each bank equals its standalone run; against
    the reference, the fast bank to the fast tolerances and the gather
    bank to the gather path's closed-loop ones."""
    rng = np.random.default_rng(2)
    over_a = dict(sampling_freq=2.048e6, if_freq=7000.0)
    over_b = dict(sampling_freq=4.096e6, if_freq=7000.0)
    sig_a, sig_b = get_signal("gps_l1ca"), get_signal("bds_b1c")
    cfg_a = get_config("gps_l1ca", **over_a)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cfg_b = get_config("bds_b1c", **over_b)
    iq_a = quantize_iq_int8(synthesize_if(cfg_a, sig_a, [
        SynthSV(prn=7, code_phase=1234.0, doppler_hz=2500.0, cn0_dbhz=47,
                nav_bits=rng.choice(np.asarray([-1, 1], np.int8), 30))],
        num_ms=560, seed=3))
    iq_b = quantize_iq_int8(synthesize_if(cfg_b, sig_b, [
        SynthSV(prn=19, code_phase=5120.0, doppler_hz=150.0, cn0_dbhz=47,
                nav_bits=rng.choice(np.asarray([-1, 1], np.int8), 60))],
        num_ms=560, seed=9, pilot_power_frac=29.0 / 40.0))
    spec_a = (cfg_a, sig_a, iq_a, [(7, 9503.0, 1234)])
    spec_b = (cfg_b, sig_b, iq_b, [(19, 7153.0, 5120)])
    n_ms = 500
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = track_multi([_port_spec(spec_a), _port_spec(spec_b)],
                          n_ms=n_ms, device="cpu")
        ref = j_track_multi([spec_a, spec_b], n_ms=n_ms)
        solo_b = _solo(_port_spec(spec_b), n_ms // 10)
    solo_a = _solo(_port_spec(spec_a), n_ms)
    _assert_as_solo(got[0], solo_a)
    _assert_as_solo(got[1], solo_b)
    _assert_fast_as_reference(got[0], ref[0])
    assert np.array_equal(got[1].abs_sample, ref[1].abs_sample)
    for f in ("i_p", "q_p", "pilot_ip", "pilot_qp"):
        a, b = getattr(ref[1], f), getattr(got[1], f)
        assert np.abs(b - a).max() <= LOOP_RTOL * (np.abs(a).max() + 1.0), f
    np.testing.assert_allclose(got[1].carr_freq, ref[1].carr_freq, rtol=0,
                               atol=LOOP_FREQ_HZ)
    ip = np.abs(got[1].pilot_ip[0, -20:]).mean()
    qp = np.abs(got[1].pilot_qp[0, -20:]).mean()
    assert ip > 3 * qp


def test_run_multi_receiver_level(tmp_path, scenes):  # noqa: F811
    """receiver.run_multi from IF files on disk (None samples): each
    signal acquired on its own, both banks tracked at once, per-signal
    results and stage timings."""
    from cusdr_tpu_torch.receiver import run_multi

    spec_a, spec_b = scenes
    cfg_a = _port_spec(spec_a)[0].replace(
        file_name=str(tmp_path / "l1.bin"), ms_to_process=N_MS,
        acq_satellite_list=(7, 13, 20), acq_non_coh_time=4,
        acq_threshold=2.5)
    spec_a[2].tofile(cfg_a.file_name)
    cfg_b = _port_spec(spec_b)[0].replace(
        file_name=str(tmp_path / "e1.bin"), ms_to_process=N_MS,
        acq_satellite_list=(2, 4), acq_non_coh_time=2, acq_threshold=2.5)
    spec_b[2].tofile(cfg_b.file_name)

    results = run_multi([(cfg_a, None), (cfg_b, None)], device="cpu")
    assert len(results) == 2
    ra, rb = results
    assert {7, 13} <= {p for p, *_ in ra.channels}
    assert 4 in {p for p, *_ in rb.channels}
    assert ra.track.i_p.shape[1] == N_MS
    assert rb.track.i_p.shape[1] == N_MS // 4
    ia = [p for p, *_ in ra.channels].index(7)
    ip = np.abs(ra.track.i_p[ia, -200:]).mean()
    qp = np.abs(ra.track.q_p[ia, -200:]).mean()
    assert ip > 3 * qp
    ib = [p for p, *_ in rb.channels].index(4)
    ipb = np.abs(rb.track.i_p[ib, -50:]).mean()
    qpb = np.abs(rb.track.q_p[ib, -50:]).mean()
    assert ipb > 2 * qpb
    for res in results:
        assert set(res.timings) == {"acquisition_s", "tracking_s",
                                    "navigation_s"}
    assert ra.timings["tracking_s"] == rb.timings["tracking_s"] > 0
