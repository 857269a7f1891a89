"""The port's batched fix epochs (``pvt/batch.py``, ``receiver.nav_solve``)
against one scalar solve per epoch.

- ``least_square_pos_batch`` against the port's verbatim
  ``pvt.lsq.least_square_pos``, epoch by epoch: 4, 5, 8 and 12 SVs, the
  troposphere on and off, each batch 16 epochs of different skies; and a
  rank-deficient epoch (one SV given twice, three distinct SVs), and one
  with a NaN pseudorange, each inside a batch whose other epochs stay
  correct.
- ``nav_solve`` against the JAX package's per-epoch loop
  (``cusdr_tpu.receiver.nav_solve``) fed the same tracking results: a
  40 s gps_l1ca record of the 8-SV scene tests/test_torch_receiver.py
  synthesizes (``make_gps_scenario``), tracked ideally, that is the code
  timing, code frequency and LNAV bit signs of each SV's signal as the
  scene defines them, built in numpy without synthesizing samples.  Cases:
  the whole record; two channels that end early (``active_until``); the
  elevation mask raised to 40 degrees, so that three SVs drop out after
  the first fix and the epochs from there are solved again (at least 2
  passes); the time blocks' settle mask, with one epoch whose channels
  straddle a block's transient.  Under ``torch.profiler`` the span
  ``nav.pvt_pass`` counts the batched passes.

Tolerances (the scalar and the batch sum a few terms in other orders; the
loop forms its pseudoranges at a local time ~0.5 s behind the provisional
one the batch uses, ~1.5e8 m that only the clock term absorbs): positions,
clock, height, E, N, U 1e-6 m; el, az, latitude, longitude 1e-9 degrees;
DOP 1e-9 relative; local time 1e-9 s.  Measured on an x86 CPU: 6e-8 m,
3e-13 degrees, local time equal.
"""

import numpy as np
import pytest
from types import SimpleNamespace
from torch.profiler import ProfilerActivity, profile

from cusdr_tpu import get_config as ref_get_config
from cusdr_tpu.receiver import nav_solve as ref_nav_solve
from cusdr_tpu.signals.defs import get_signal as ref_get_signal
from cusdr_tpu_torch import get_config
from cusdr_tpu_torch.constants import SPEED_OF_LIGHT
from cusdr_tpu_torch.geodesy.transforms import e_r_corr, geo2cart
from cusdr_tpu_torch.io.scenario import make_gps_scenario
from cusdr_tpu_torch.pvt.batch import least_square_pos_batch
from cusdr_tpu_torch.pvt.lsq import least_square_pos
from cusdr_tpu_torch.receiver import nav_solve
from cusdr_tpu_torch.signals.defs import get_signal

POS_TOL_M = 1e-6
DEG_TOL = 1e-9
DOP_RTOL = 1e-9
TIME_TOL_S = 1e-9

RX = np.asarray(geo2cart(40.0, -105.26, 1610.0, 5))
ORBIT_R = 26_560e3


def _sky(rng, n_sats):
    """[3, N] SV positions on a GPS orbit radius seen from RX, as a
    receiver's sky holds them: one SV high (60-85 degrees), the others
    spread in azimuth lower down (10-60 degrees)."""
    lat, lon = np.radians(40.0), np.radians(-105.26)
    east = np.array([-np.sin(lon), np.cos(lon), 0.0])
    north = np.array([-np.sin(lat) * np.cos(lon),
                      -np.sin(lat) * np.sin(lon), np.cos(lat)])
    up = np.cross(east, north)
    az = (np.arange(n_sats) + rng.uniform(0, 1, n_sats)) * 2 * np.pi / n_sats
    el = np.radians(np.concatenate([rng.uniform(60.0, 85.0, 1),
                                    rng.uniform(10.0, 60.0, n_sats - 1)]))
    r = np.linalg.norm(RX)
    slant = (-r * np.sin(el)
             + np.sqrt(r * r * np.sin(el) ** 2 - r * r + ORBIT_R ** 2))
    los = (np.cos(el) * np.sin(az))[:, None] * east \
        + (np.cos(el) * np.cos(az))[:, None] * north \
        + np.sin(el)[:, None] * up
    return (RX + slant[:, None] * los).T


def _pseudoranges(rng, sat_pos):
    """Ranges from RX with the solver's earth-rotation model, a clock bias
    and 3 m of noise."""
    obs = np.empty(sat_pos.shape[1])
    for i in range(sat_pos.shape[1]):
        tau = 0.075
        for _ in range(3):
            tau = np.linalg.norm(e_r_corr(tau, sat_pos[:, i]) - RX) \
                / SPEED_OF_LIGHT
        obs[i] = tau * SPEED_OF_LIGHT
    return obs + rng.uniform(-1e5, 1e5) + rng.normal(0.0, 3.0, len(obs))


def _batch(seed, n_sats, n_epochs=16):
    rng = np.random.default_rng(seed)
    sat_pos = np.stack([_sky(rng, n_sats) for _ in range(n_epochs)])
    obs = np.stack([_pseudoranges(rng, s) for s in sat_pos])
    return sat_pos, obs


def _assert_rows_equal_the_scalar(sat_pos, obs, use_trop):
    pos, el, az, dop = least_square_pos_batch(sat_pos, obs, use_trop)
    assert pos.shape == (len(obs), 4) and dop.shape == (len(obs), 5)
    assert el.shape == az.shape == obs.shape
    for e in range(len(obs)):
        p, el_e, az_e, dop_e = least_square_pos(sat_pos[e], obs[e],
                                                use_trop)
        np.testing.assert_allclose(pos[e], p, rtol=0, atol=POS_TOL_M)
        np.testing.assert_allclose(el[e], el_e, rtol=0, atol=DEG_TOL)
        np.testing.assert_allclose(az[e], az_e, rtol=0, atol=DEG_TOL)
        if np.all(np.isfinite(dop_e)):
            np.testing.assert_allclose(dop[e], dop_e, rtol=DOP_RTOL, atol=0)
        else:
            assert np.all(np.isinf(dop[e])) and np.all(np.isinf(dop_e))
    return pos, dop


@pytest.mark.parametrize("use_trop", [True, False], ids=["trop", "no_trop"])
@pytest.mark.parametrize("n_sats", [4, 5, 8, 12])
def test_batch_equals_the_scalar_solve(n_sats, use_trop):
    sat_pos, obs = _batch(100 + n_sats, n_sats)
    pos, dop = _assert_rows_equal_the_scalar(sat_pos, obs, use_trop)
    assert np.all(np.isfinite(dop))
    # a real solve: every fix lands near the receiver
    assert np.linalg.norm(pos[:, :3] - RX, axis=1).max() < 1e3


@pytest.mark.parametrize("n_sats", [4, 5])
def test_rank_deficient_epoch_fails_alone(n_sats):
    sat_pos, obs = _batch(7, n_sats, n_epochs=6)
    # epoch 3 sees its first SV again in place of its second (and of its
    # third with 5 SVs): three distinct lines of sight, rank 3
    for i in range(1, n_sats - 2):
        sat_pos[3, :, i] = sat_pos[3, :, 0]
        obs[3, i] = obs[3, 0]
    pos, dop = _assert_rows_equal_the_scalar(sat_pos, obs, True)
    assert np.all(pos[3] == 0.0) and np.all(np.isinf(dop[3]))
    others = np.arange(6) != 3
    assert np.all(np.isfinite(dop[others]))
    assert np.linalg.norm(pos[others, :3] - RX, axis=1).max() < 1e3


def test_non_finite_epoch_ends_alone():
    # where the scalar's SVD would raise, the batch ends that epoch with
    # pos NaN (``nav_solve`` skips it) and solves the others
    sat_pos, obs = _batch(9, 8, n_epochs=5)
    obs[2, 4] = np.nan
    pos, el, az, dop = least_square_pos_batch(sat_pos, obs, True)
    assert np.all(np.isnan(pos[2])) and np.all(np.isinf(dop[2]))
    keep = [0, 1, 3, 4]
    ref_pos, _ = _assert_rows_equal_the_scalar(sat_pos[keep], obs[keep],
                                               True)
    np.testing.assert_array_equal(pos[keep], ref_pos)


# ---- nav_solve against the reference's per-epoch loop -------------------

RECORD_EPOCHS = 40_000           # 40 s of 1 ms code periods
MASK_DEG = 40.0                  # between the scene's 39.5 and 45.2 degrees


def _ideal_track(cfg, sig, scn, n_epochs):
    """Tracking results that follow each SV's signal exactly: epoch k of a
    channel is the k-th whole code period after sample 0, its samples and
    code phase read from the scene's code-time model (signal time since
    the frame's start g0 + g1 t + g2 t^2 at receiver time t, the model the
    scene's SynthSV parameters encode), its prompt sum the LNAV bit's
    sign."""
    fs, fc = cfg.sampling_freq, sig.carrier_freq_hz
    period = sig.code_period_ms / 1000.0
    fields = {k: [] for k in ("i_p", "abs_sample", "blksize", "code_freq",
                              "rem_code_phase")}
    for sv in scn.svs:
        g1 = 1.0 + sv.doppler_hz / fc
        g2 = sv.doppler_rate / (2.0 * fc)
        g0 = -sv.code_phase * g1 / fs
        n = np.ceil(g0 / period) + np.arange(n_epochs + 1)
        t = (n * period - g0) / g1
        for _ in range(3):          # Newton on g(t) = n * period
            t -= (g0 + g1 * t + g2 * t * t - n * period) / (g1 + 2 * g2 * t)
        starts = np.ceil(t * fs).astype(np.int64)
        ts = starts[:-1] / fs
        fields["abs_sample"].append(starts[:-1])
        fields["blksize"].append(np.diff(starts))
        fields["rem_code_phase"].append(
            (g0 + g1 * ts + g2 * ts * ts - n[:-1] * period) / period
            * sig.code_length_chips)
        fields["code_freq"].append(sig.chip_rate_hz * (g1 + 2 * g2 * ts))
        bit = (n[:-1] // sig.nav_symbol_ms).astype(np.int64)
        fields["i_p"].append(1000.0 * sv.nav_bits[bit])
    out = SimpleNamespace(prns=[sv.prn for sv in scn.svs],
                          **{k: np.stack(v) for k, v in fields.items()})
    out.active_until = np.full(len(scn.svs), n_epochs, np.int64)
    return out


def _settle_straddling(track, meas_samples):
    """(epochs_per_block, settle_epochs) with one measurement epoch where
    4 to 7 channels are out of a block's transient and the others in it.
    The channels' epoch grids are offset by under a code period, so at a
    measurement sample their epoch indices differ by at most one: either
    the later ones have just passed the settle boundary, or they have just
    begun a block that the earlier ones are ending."""
    for meas in meas_samples:
        idx = np.array([np.searchsorted(row, meas, "right") - 1
                        for row in track.abs_sample])
        late = np.count_nonzero(idx == idx.max())
        for epb in range(2000, 6000):
            if 4 <= late < len(idx) and 100 <= idx.max() % epb <= 400:
                return epb, int(idx.max() % epb)
            if 4 <= len(idx) - late < len(idx) and idx.max() % epb == 0:
                return epb, 200
    raise AssertionError("no measurement epoch straddles the channels")


def _case_track(case, track, meas_samples):
    out = SimpleNamespace(**vars(track))
    if case == "ends_early":
        out.active_until = track.active_until.copy()
        out.blksize = track.blksize.copy()
        for ch, end in ((2, 36_000), (5, 38_500)):
            out.active_until[ch] = end
            out.blksize[ch, end:] = 0
    if case == "settle":
        out.epochs_per_block, out.settle_epochs = _settle_straddling(
            track, meas_samples)
    return out


@pytest.fixture(scope="module")
def scene():
    cfg = get_config("gps_l1ca")
    sig = get_signal("gps_l1ca")
    scn = make_gps_scenario(cfg, sig, n_svs=8, duration_s=40.0)
    els = sorted(scn.elevations.values())
    assert els[2] < MASK_DEG < els[3]
    return scn, _ideal_track(cfg, sig, scn, RECORD_EPOCHS)


CASES = ["whole", "ends_early", "mask", "settle"]


@pytest.fixture(scope="module")
def solved(scene):
    """{case: (port NavSolutions, reference NavSolutions, port's
    nav.pvt_pass calls, tracking results)}."""
    _, track = scene
    out = {}
    for case in CASES:
        over = ({"elevation_mask_deg": MASK_DEG} if case == "mask" else {})
        cfg = get_config("gps_l1ca", **over)
        # the whole record's fixes give the measurement grid
        trk = _case_track(case, track, out["whole"][0].curr_meas_sample
                          if out else None)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            port = nav_solve(cfg, get_signal("gps_l1ca"), trk)
        passes = sum(ev.name == "nav.pvt_pass" for ev in prof.events())
        ref = ref_nav_solve(ref_get_config("gps_l1ca", **over),
                            ref_get_signal("gps_l1ca"), trk)
        out[case] = port, ref, passes, trk
    return out


@pytest.mark.parametrize("case", CASES)
def test_nav_solve_equals_the_per_epoch_loop(solved, case):
    port, ref, _, trk = solved[case]
    assert port is not None and ref is not None
    assert len(port.X) == len(ref.X) >= 40
    assert port.curr_meas_sample == ref.curr_meas_sample
    assert port.utm_zone == ref.utm_zone
    for name, tol in (("X", POS_TOL_M), ("Y", POS_TOL_M), ("Z", POS_TOL_M),
                      ("dt", POS_TOL_M), ("height", POS_TOL_M),
                      ("E", POS_TOL_M), ("N", POS_TOL_M), ("U", POS_TOL_M),
                      ("latitude", DEG_TOL), ("longitude", DEG_TOL),
                      ("local_time", TIME_TOL_S)):
        np.testing.assert_allclose(getattr(port, name), getattr(ref, name),
                                   rtol=0, atol=tol, err_msg=name)
    for name in ("el", "az"):
        a, b = np.asarray(getattr(port, name)), np.asarray(getattr(ref,
                                                                   name))
        assert np.array_equal(np.isnan(a), np.isnan(b)), name
        np.testing.assert_allclose(a, b, rtol=0, atol=DEG_TOL,
                                   err_msg=name)
    np.testing.assert_allclose(port.dop, ref.dop, rtol=DOP_RTOL, atol=0)
    used = ~np.isnan(np.asarray(port.el))
    if case == "whole":
        assert used.all()
    if case == "ends_early":
        assert not used[-1, 2] and not used[-1, 5] and used[0].all()
    if case == "mask":
        assert used[0].all() and used[1:].sum(axis=1).max() == 5
    if case == "settle":
        counts = set(used.sum(axis=1))
        assert 8 in counts and len(counts) > 1
        assert len(port.X) < len(solved["whole"][0].X)


@pytest.mark.parametrize("case", CASES)
def test_passes_engage_only_where_the_mask_drops(solved, case):
    _, _, passes, _ = solved[case]
    if case == "mask":
        assert passes >= 2
    else:
        assert passes == 1
