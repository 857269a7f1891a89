"""The per-epoch gather path (``fast_code`` False) against the JAX
reference: correlator spacing under half a sample, where the engine gathers
every sample's E/P/L chips by ceil-index from chip-grid element tables.

Scenes: gps_l1ca at 1.0 Msps (0.5-chip spacing = 0.49 samples, data only),
gps_l2c at 1.0 Msps (0.25 chips = 0.49 samples; the CL long pilot, its
period counter rolling over from 73 and 74) and bds_b1c at 4.096 Msps
(0.06 chips = 0.24 samples) in NB mode (pilot bank) and WB mode (the
BOC(1,1) and BOC(6,1) pilot banks concatenated in one element table).

- Tables and parameters: ``build_element_tables`` equals the reference's
  byte for byte, and ``make_track_params`` gives the same gather fields
  and the same warning.
- The step: 20 epochs, each run by both packages from the same state (the
  reference's, converted): ``abs_sample`` and ``blksize`` equal, the
  outputs' f64 loop state (``carr_freq`` ...) equal to 1e-9, the f32 sums
  within ``STEP_RTOL`` of the largest (the two add up to 41 000 f32
  products in other orders, with other f32 cos/sin), the discriminators
  within 1e-4 and the loop filters within ``FILTER_ATOL``.
- Closed loop (``track``, ``track_time_parallel`` with two blocks): the
  sums of one step differ in their last bits, and the loop filters carry
  that into the next epoch's f64 state (on the B1C chain the carrier is
  1.5e-5 Hz apart from epoch 1).  From the first epoch at which the two
  packages' f32 index grids differ (their f32 ``rem_code_phase`` or f32
  code step, the operands of the gather's code phase; on the chain epoch 2
  by the remainder, while the code step first differs at epoch 213 in WB
  and not within 300 NB epochs) some samples' chips flip and the sums part
  further.  So the comparison holds epoch 0 (one state) at the step
  tolerances, the epochs before the grids part at ``STEP_RTOL`` on the
  sums and ``FILTER_ATOL`` on the frequencies, and every epoch at
  ``LOOP_RTOL`` of the largest sum and ``LOOP_FREQ_HZ``, with
  ``abs_sample`` equal (over the chain's 300 epochs the sums stay within
  2e-3 of the largest and the carriers within 0.02 Hz).  Along
  the chain's first 300 epochs each step, taken by both packages from the
  reference's state, stays within the step tolerances: the closed-loop
  difference is the loops' carry of those steps, not a fault of a step.
- The B1C chain, as tests/test_e2e_b1c.py runs it at 4.096 Msps, through
  the port: acquisition, 1 900 epochs of NB and of WB tracking, pilot lock
  and the B-CNAV1 ephemeris through the port's nav copy.
"""

import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cusdr_tpu import get_config
from cusdr_tpu.io.synth import SynthSV, quantize_iq_int8, synthesize_if
from cusdr_tpu.nav import bcnav
from cusdr_tpu.parallel.timeblocks import track_time_parallel as j_ttp
from cusdr_tpu.signals.defs import get_signal
from cusdr_tpu.tracking import engine as jeng
from cusdr_tpu.tracking import track as j_track
from cusdr_tpu_torch import get_config as t_get_config
from cusdr_tpu_torch.acquisition.pcps import acquire as t_acquire
from cusdr_tpu_torch.nav.dispatch import decode_channel as t_decode
from cusdr_tpu_torch.parallel.timeblocks import track_time_parallel as t_ttp
from cusdr_tpu_torch.signals.defs import get_signal as t_get_signal
from cusdr_tpu_torch.tracking import engine as teng

from test_e2e_b1c import EPH, PRN, SOH
from test_torch_convert import torch_params, torch_state
from test_torch_threads import few_torch_threads  # noqa: F401 (autouse)

STEP_RTOL = 1e-5
FILTER_ATOL = 2e-3      # Hz, as chip_smoke.py's FREQ_ATOL
LOOP_RTOL = 3e-2
LOOP_FREQ_HZ = 0.1
SUMS = ("i_e", "q_e", "i_p", "q_p", "i_l", "q_l", "pilot_ip", "pilot_qp")
GATHER = "falling back to the slow per-epoch gather path"

# (signal, overrides, (prn, code phase, Doppler[, CL period]) per SV)
CASES = {
    "gps_l1ca": ("gps_l1ca", dict(sampling_freq=1.0e6, if_freq=7000.0),
                 [(3, 123.0, 1200.0), (11, 611.0, -2100.0),
                  (24, 904.0, 300.0)]),
    "gps_l2c": ("gps_l2c", dict(sampling_freq=1.0e6, if_freq=7000.0,
                                pilot_trk_flag=1),
                [(1, 5000.0, 300.0, 73), (2, 14000.0, -700.0, 74)]),
    "b1c_nb": ("bds_b1c", dict(sampling_freq=4.096e6, if_freq=7000.0,
                               pilot_trk_flag=1),
               [(19, 5120.0, 150.0), (23, 20011.0, -80.0)]),
    "b1c_wb": ("bds_b1c", dict(sampling_freq=4.096e6, if_freq=7000.0,
                               pilot_trk_flag=2),
               [(19, 5120.0, 150.0), (23, 20011.0, -80.0)]),
}


def _configs(name):
    signal, over, _ = CASES[name]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return (get_config(signal, **over), get_signal(signal),
                t_get_config(signal, **over), t_get_signal(signal))


@pytest.fixture(scope="module")
def records():
    """One short record per signal (the B1C one serves NB and WB)."""
    out = {}
    for key, name, ms in (("gps_l1ca", "gps_l1ca", 120),
                          ("gps_l2c", "gps_l2c", 500),
                          ("bds_b1c", "b1c_nb", 700)):
        cfg, sig, _, _ = _configs(name)
        rng = np.random.default_rng(5)
        svs = [SynthSV(prn=sv[0], code_phase=sv[1], doppler_hz=sv[2],
                       cn0_dbhz=47,
                       nav_bits=rng.choice(np.asarray([-1, 1], np.int8), 40))
               for sv in CASES[name][2]]
        out[key] = quantize_iq_int8(synthesize_if(cfg, sig, svs, num_ms=ms,
                                                  seed=9))
    return out


def _channels(name):
    cfg = _configs(name)[0]
    # carriers 3 Hz off the truth, so that the loops have work to do
    return [(sv[0], cfg.if_freq + sv[2] + 3.0, int(round(sv[1])), *sv[3:])
            for sv in CASES[name][2]]


@pytest.mark.parametrize("name", sorted(CASES))
def test_tables_and_params_as_reference(name):
    cfg, sig, tcfg, tsig = _configs(name)
    with pytest.warns(UserWarning, match=GATHER):
        jp = jeng.make_track_params(cfg, sig)
    with pytest.warns(UserWarning, match=GATHER) as got:
        tp = teng.make_track_params(tcfg, tsig)
    assert str(got[0].message).startswith(f"{sig.name}: correlator spacing")
    assert not jp.fast_code and not tp.fast_code
    for field in ("fast_code", "elements_per_chip", "spacing",
                  "code_freq_basis", "pilot_epc", "pilot2_epc", "code_len",
                  "blk", "has_pilot", "has_pilot2", "pilot_period_mod"):
        assert getattr(tp, field) == getattr(jp, field), field
    assert torch_params(jp) == dataclasses.replace(tp, fetch_in_kernel=False)
    chans = _channels(name)
    jct, jpt = jeng.build_element_tables(cfg, sig, jp, chans)
    tct, tpt = teng.build_element_tables(tcfg, tsig, tp, chans)
    assert tct.dtype == jct.dtype and tct.tobytes() == jct.tobytes()
    if tp.has_pilot:
        assert tpt.dtype == jpt.dtype and tpt.tobytes() == jpt.tobytes()
        if tp.has_pilot2:
            assert tpt.shape[1] == sig.code_length_chips * (
                sig.elements_per_chip + sig.pilot_wb_elements_per_chip)
    else:
        assert tpt is None and not jpt.any()


def _bank_of(signal, over, chans, iq):
    """Both packages' params, tables, initial state and record."""
    cfg, sig = get_config(signal, **over), get_signal(signal)
    tcfg, tsig = t_get_config(signal, **over), t_get_signal(signal)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jp = jeng.make_track_params(cfg, sig)
        tp = teng.make_track_params(tcfg, tsig)
    jct, jpt = jeng.build_element_tables(cfg, sig, jp, chans)
    tct, tpt = teng.build_element_tables(tcfg, tsig, tp, chans)
    dops = teng.code_dopplers(tcfg, tsig, chans)
    jst = jeng.init_channel_state(chans, sig.chip_rate_hz, dopplers=dops,
                                  carrier_freq_hz=sig.carrier_freq_hz)
    return (jp, jnp.asarray(jct), jnp.asarray(jpt), jst, tp,
            torch.from_numpy(tct),
            None if tpt is None else torch.from_numpy(tpt), iq)


def _bank(name, records):
    signal, over, _ = CASES[name]
    return _bank_of(signal, over, _channels(name), records[signal])


def _steps_as_reference(bank, n_epochs):
    """``n_epochs`` gather steps along the reference's trajectory, each
    run by both packages from the reference's state (converted), held to
    the step tolerances."""
    jp, jct, jpt, jst, tp, tct, tpt, iq = bank
    jiq, tiq = jnp.asarray(iq), torch.from_numpy(iq)
    end = len(iq) // 2
    for epoch in range(n_epochs):
        t_new, t_out = teng.track_superblock(tiq, 0, tct, tpt,
                                             torch_state(jst), tp, 1, end)
        jst, j_out = jeng.track_superblock(jiq, jnp.int64(0), jct, jpt, jst,
                                           jp, 1, jnp.int64(end))
        for f in ("abs_sample", "blksize"):
            assert np.array_equal(getattr(t_out, f).numpy(),
                                  np.asarray(getattr(j_out, f))), (epoch, f)
        assert np.array_equal(t_new.abs_sample.numpy(),
                              np.asarray(jst.abs_sample))
        for f in ("carr_freq", "code_freq", "rem_code_phase",
                  "rem_carr_phase"):
            np.testing.assert_allclose(getattr(t_out, f).numpy(),
                                       np.asarray(getattr(j_out, f)),
                                       rtol=0, atol=1e-9, err_msg=f)
        ref = np.stack([np.asarray(getattr(j_out, f)) for f in SUMS])
        got = np.stack([getattr(t_out, f).numpy() for f in SUMS])
        scale = np.abs(ref).max()
        assert scale > 0
        assert np.abs(got - ref).max() <= STEP_RTOL * scale, epoch
        # the discriminators [cycles, chips] and the filters [Hz] follow
        # from those sums: on a weak prompt a last-bit sum difference
        # moves the discriminator by ~1e-5, which the filter's gain of tens
        # to hundreds of Hz a cycle turns into ~1e-3 Hz
        for f, atol in (("dll_discr", 1e-4), ("pll_discr", 1e-4),
                        ("dll_filt", FILTER_ATOL), ("pll_filt", FILTER_ATOL)):
            np.testing.assert_allclose(getattr(t_out, f).numpy(),
                                       np.asarray(getattr(j_out, f)),
                                       rtol=1e-3, atol=atol,
                                       err_msg=f"{f}, epoch {epoch}")


@pytest.mark.parametrize("name", sorted(CASES))
def test_gather_step_as_reference(name, records):
    """20 epochs; each starts both packages from the reference's state."""
    _steps_as_reference(_bank(name, records), 20)


def grid_split(got, ref, fs):
    """The first epoch at which the two packages' f32 index grids differ
    (the f32 ``rem_code_phase`` or f32 code step of any channel; the
    outputs hold each epoch's starting state), or the epoch count."""
    def grid(o):
        return (np.asarray(o.rem_code_phase).astype(np.float32),
                (np.asarray(o.code_freq) / fs).astype(np.float32))
    (g_rem, g_step), (r_rem, r_step) = grid(got), grid(ref)
    differ = ((g_rem != r_rem) | (g_step != r_step)).any(axis=0)
    return int(np.argmax(differ)) if differ.any() else differ.size


def assert_loop_close(got, ref, fs):
    """The closed-loop comparison (module docstring): epoch 0 at the step
    tolerances, the epochs before the f32 index grids part at
    ``STEP_RTOL`` and ``FILTER_ATOL``, every epoch at ``LOOP_RTOL`` and
    ``LOOP_FREQ_HZ``.  Returns the epoch at which the grids part."""
    assert np.array_equal(got.abs_sample, ref.abs_sample)
    split = grid_split(got, ref, fs)
    assert split >= 1       # epoch 0 starts both from one state
    for f in ("carr_freq", "code_freq", "rem_code_phase", "rem_carr_phase"):
        np.testing.assert_allclose(getattr(got, f)[:, 0],
                                   getattr(ref, f)[:, 0], rtol=0, atol=1e-9,
                                   err_msg=f)
    ref_s = np.stack([getattr(ref, f) for f in SUMS])
    got_s = np.stack([getattr(got, f) for f in SUMS])
    head = np.abs(got_s - ref_s)[:, :, :split].max(axis=(0, 1))
    scale = np.abs(ref_s)[:, :, :split].max(axis=(0, 1))
    assert (head <= STEP_RTOL * scale).all(), (split, head / scale)
    for f in ("carr_freq", "code_freq"):
        np.testing.assert_allclose(getattr(got, f)[:, :split],
                                   getattr(ref, f)[:, :split], rtol=0,
                                   atol=FILTER_ATOL, err_msg=f)
    for f in SUMS:
        a, b = getattr(ref, f), getattr(got, f)
        assert np.abs(b - a).max() <= LOOP_RTOL * (np.abs(a).max() + 1.0), f
    for f in ("carr_freq", "code_freq"):
        np.testing.assert_allclose(getattr(got, f), getattr(ref, f),
                                   rtol=0, atol=LOOP_FREQ_HZ, err_msg=f)
    return split


@pytest.mark.parametrize("name", ["b1c_nb", "b1c_wb"])
def test_time_parallel_gather_as_reference(name, records):
    """Two blocks of 30 epochs on the per-block gather path, both
    packages: the closed-loop tolerances, every channel locked at the end
    of each block."""
    cfg, sig, tcfg, tsig = _configs(name)
    iq = records["bds_b1c"]
    chans = _channels(name)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = j_ttp(cfg, sig, iq, chans, 60, 2, handoff_iters=1)
        got = t_ttp(tcfg, tsig, iq, chans, 60, 2, handoff_iters=1,
                    device="cpu")
    assert_loop_close(got, ref, cfg.sampling_freq)
    for b in range(2):
        tail = slice(30 * b + 20, 30 * (b + 1))
        ip = np.abs(got.i_p[:, tail]).mean(axis=1)
        qp = np.abs(got.q_p[:, tail]).mean(axis=1)
        assert (ip > 2.5 * qp).all(), (b, ip, qp)


# ---- the B1C chain (tests/test_e2e_b1c.py at 4.096 Msps) -----------------

CHAIN_OVER = dict(sampling_freq=4.096e6, if_freq=7000.0,
                  acq_satellite_list=(17, 19, 23), acq_search_band=500.0,
                  acq_search_step=50.0, fine_search_step=10.0,
                  acq_threshold=3.5, acq_non_coh_time=2)
CHAIN_EPOCHS = 1900
CHAIN_PARITY_EPOCHS = 300


@pytest.fixture(scope="module")
def chain():
    """The reference test's NB scene (two B-CNAV1 frames, 47 dB-Hz, 29/40
    of the power in the pilot; the synthesis also carries the BOC(6,1)
    pilot, so WB mode tracks the same record), acquired by the port."""
    cfg = get_config("bds_b1c", **CHAIN_OVER)
    sig = get_signal("bds_b1c")
    frames = [bcnav.bcnav1_encode_frame(PRN, SOH + i, EPH)
              for i in range(2)]
    nav = (1 - 2 * np.concatenate(frames)).astype(np.int8)
    sv = SynthSV(prn=PRN, code_phase=5120.0, doppler_hz=150.0, cn0_dbhz=47,
                 nav_bits=nav)
    samples = synthesize_if(cfg, sig, [sv], num_ms=20_000, seed=9,
                            pilot_power_frac=29.0 / 40.0)
    tcfg, tsig = t_get_config("bds_b1c", **CHAIN_OVER), t_get_signal(
        "bds_b1c")
    acq = t_acquire(tcfg, tsig, samples, "cpu")
    iq = quantize_iq_int8(samples)
    del samples
    i = list(acq.prns).index(PRN)
    assert acq.detected[i] and acq.detected.sum() == 1
    chans = [(PRN, float(acq.carr_freq[i]), int(acq.code_phase[i]))]
    return iq, chans


@pytest.fixture(scope="module", params=[1, 2], ids=["nb", "wb"])
def chain_run(request, chain):
    iq, chans = chain
    over = dict(CHAIN_OVER, pilot_trk_flag=request.param)
    cfg, sig = get_config("bds_b1c", **over), get_signal("bds_b1c")
    tcfg, tsig = t_get_config("bds_b1c", **over), t_get_signal("bds_b1c")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        trk = teng.track(tcfg, tsig, iq, chans, "cpu",
                         n_epochs=CHAIN_EPOCHS)
        ref = j_track(cfg, sig, iq, chans, n_epochs=CHAIN_PARITY_EPOCHS)
    return request.param, tcfg, tsig, trk, ref


def test_chain_tracking_as_reference(chain_run):
    _, tcfg, _, trk, ref = chain_run
    n = CHAIN_PARITY_EPOCHS
    head = type("Head", (), {f: getattr(trk, f)[:, :n]
                             for f in SUMS + ("abs_sample", "carr_freq",
                                              "code_freq", "rem_code_phase",
                                              "rem_carr_phase")})
    assert_loop_close(head, ref, tcfg.sampling_freq)


@pytest.mark.parametrize("mode", [1, 2], ids=["nb", "wb"])
def test_chain_steps_as_reference(mode, chain):
    """The chain's first 300 epochs, each step taken by both packages from
    the reference's state: within the step tolerances at every epoch."""
    iq, chans = chain
    fs = CHAIN_OVER["sampling_freq"]
    iq = iq[:2 * int(fs * (CHAIN_PARITY_EPOCHS + 3) * 0.01)]
    _steps_as_reference(_bank_of("bds_b1c", dict(CHAIN_OVER,
                                                 pilot_trk_flag=mode),
                                 chans, iq), CHAIN_PARITY_EPOCHS)


def test_chain_pilot_lock(chain_run):
    """The bounds of tests/test_e2e_b1c.py: NB's data and pilot prompts,
    WB's composite QMBOC pilot (BOC(1,1) and BOC(6,1) rotated onto I)."""
    mode, _, _, trk, _ = chain_run
    assert trk.status == ["T"]
    tail = slice(-500, None) if mode == 1 else slice(-800, None)
    pip = np.abs(trk.pilot_ip[0, tail]).mean()
    pqp = np.abs(trk.pilot_qp[0, tail]).mean()
    ip = np.abs(trk.i_p[0, tail]).mean()
    qp = np.abs(trk.q_p[0, tail]).mean()
    assert ip > 3 * qp
    if mode == 1:
        assert pip > 3 * pqp
        assert 1.1 < pip / ip < 2.6
    else:
        assert pip > 2.5 * pqp
        assert 1.3 < pip / ip < 2.2, pip / ip


def test_chain_bcnav1_decode(chain_run):
    _, tcfg, tsig, trk, _ = chain_run
    eph, start, tow = t_decode(trk, 0, tcfg, tsig)
    assert eph is not None
    for k in ("M_0", "e", "omega", "omega_0", "i_0", "t_oe", "a_f0"):
        assert eph[k] == pytest.approx(EPH[k], rel=1e-6,
                                       abs=abs(EPH[k]) * 1e-6 + 1e-12), k
    assert eph["PRN"] == PRN
    assert tow == EPH["HOW"] * 3600.0 + SOH * 18.0
    assert start % 1800 == 0
