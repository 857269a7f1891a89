"""Parity of the port's pilot and dual-pilot correlator and data+pilot
tracking with the JAX reference.

- The plain PyTorch correlator with a pilot bank (``ptable``) is held
  against the reference's TPU kernel ``correlate_bank_hbm`` with ``wp4``
  (and ``wp24`` for the B1C WB dual bank), in interpret mode, for every
  pilot rotation, both tap modes, k in {1, 5}, and a pilot window whose
  start, fraction and table length differ from the data's.
- ``make_track_params``: the port's pilot fields equal the reference's for
  every preset whose pilot bank the port runs.
- ``track_superblock``: 12 epochs x 3 channels on random int8 samples for
  gal_e5a, gal_e5b (3rd-order PLL), bds_b1c WB (dual bank) and gps_l2c
  with its 75-period CL pilot from nonzero starting periods; replica and
  pilot tables bit-identical.  gal_e5a, gal_e5b and B1C WB run on random
  int8 samples.  gps_l2c runs on a synthesized 3-SV scene whose CL codes
  sit at the channels' starting periods: on pure noise its 20 ms PLL
  amplifies the f32 rounding of the noise sums past the state tolerance
  within 12 epochs (1.5e-4 rad of carrier phase), and a scene also shows
  the pilot window following the CL period by period.  The reference runs
  its Pallas fetch path (``correlate_bank_hbm``) in interpret mode in every
  case, under 20 s each on the CPU.

Tolerances, as in tests/test_torch_correlator.py: sums ``atol
2e-4·(max|ref| + 1)`` (f32 summation order), loop state ``rtol 1e-6, atol
1e-4``, ``abs_sample`` and the long-pilot period counter exact.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cusdr_tpu import get_config
from cusdr_tpu.ops.correlator import ALIGN, correlate_bank_hbm, hbm_geometry
from cusdr_tpu.signals.defs import get_signal
from cusdr_tpu.tracking import engine as jeng
from cusdr_tpu_torch import get_config as t_get_config
from cusdr_tpu_torch.signals.defs import get_signal as t_get_signal
from cusdr_tpu_torch.ops.correlator import correlate_bank_plain
from cusdr_tpu_torch.tracking import engine as teng

from test_torch_threads import few_torch_threads  # noqa: F401 (autouse)

W1, W2 = float(np.sqrt(29.0 / 33.0)), float(np.sqrt(4.0 / 33.0))
# (pilot_rot, dual bank?, pilot2_rot, w1, w2)
VARIANTS = {"rot0": (0, False, 2, 1.0, 0.0), "rot1": (1, False, 2, 1.0, 0.0),
            "rot2": (2, False, 2, 1.0, 0.0), "rot3": (3, False, 2, 1.0, 0.0),
            "dual": (3, True, 2, W1, W2)}


def _inputs(seed, n_ch, blk, k, n_samples, dual):
    """Random bank inputs (numpy): a data table of blk + 2048 and a longer
    pilot table of blk + 4096 (two banks for ``dual``), each window at its
    own start and fraction."""
    rng = np.random.default_rng(seed)
    pm = np.array([-1, 1], np.int8)
    t_len, p_len = blk + 2048, blk + 4096
    inc_c = (7000.0 + rng.uniform(-5000, 5000, n_ch)) / 2.048e6
    return dict(
        iq=rng.integers(-16, 17, 2 * n_samples).astype(np.int8),
        table=rng.choice(pm, (n_ch, t_len)),
        ptable=rng.choice(pm, (n_ch, 2, p_len) if dual else (n_ch, p_len)),
        off=rng.integers(0, n_samples - blk, n_ch).astype(np.int64),
        start=rng.integers(ALIGN + 8, t_len - blk - 2 * k - 2,
                           n_ch).astype(np.int64),
        pstart=rng.integers(ALIGN + 8, p_len - blk - 2 * k - 2,
                            n_ch).astype(np.int64),
        inc_c=inc_c, remc64=rng.uniform(0, 1, n_ch),
        alpha=rng.uniform(0, 1, n_ch).astype(np.float32),
        palpha=rng.uniform(0, 1, n_ch).astype(np.float32),
        bsz=(blk - rng.integers(0, 9, n_ch)).astype(np.int64))


def _reference(d, k, blk, interp_taps, rot, rot2, w1, w2):
    """The reference kernel on the same inputs, staged as its engine
    stages them (512-sample rows, residual folded into the carrier, each
    table's window row and flat residual from its own start)."""
    blk_pad = -(-blk // 128) * 128
    _, tq_s, tq_w = hbm_geometry(blk_pad, k)

    def to_rows(x, tq_min):
        n = x.shape[-1]
        nr = max(-(-n // ALIGN), tq_min) + tq_min
        pad = [(0, 0)] * (x.ndim - 1) + [(0, nr * ALIGN - n)]
        return jnp.pad(jnp.asarray(x), pad).reshape(
            x.shape[:-1] + (nr, 4, 128))

    i32 = lambda x: jnp.asarray(x, jnp.int32)
    f32 = lambda x: jnp.asarray(np.asarray(x, np.float32))
    off = d["off"]
    q = off // ALIGN
    r = off - q * ALIGN

    def table_off(s0):
        o = s0 - r
        qt = o // ALIGN
        return i32(qt), i32(o - qt * ALIGN)

    qt, rt = table_off(d["start"])
    qp, rp = table_off(d["pstart"])
    pt = d["ptable"]
    dual = pt.ndim == 3
    out = correlate_bank_hbm(
        i32(q), i32(np.arange(len(off))), qt, rt, f32(d["alpha"]),
        f32(np.mod(d["remc64"] - d["inc_c"] * r, 1.0)),
        f32(np.mod(d["inc_c"] * 128.0, 1.0)), f32(np.mod(d["inc_c"], 1.0)),
        f32(d["bsz"]), f32(r),
        to_rows(d["iq"][0::2], tq_s), to_rows(d["iq"][1::2], tq_s),
        to_rows(d["table"], tq_w),
        to_rows(pt[:, 0] if dual else pt, tq_w),
        to_rows(pt[:, 1], tq_w) if dual else None,
        k=k, blk_pad=blk_pad, qp=qp, rp=rp, alpha_p=f32(d["palpha"]),
        pilot_rot=rot, pilot2_rot=rot2, pilot_w1=w1, pilot_w2=w2,
        interp_taps=interp_taps, interpret=True)
    return np.asarray(out)


def _port(d, k, blk, interp_taps, rot, rot2, w1, w2):
    f32 = lambda x: torch.from_numpy(np.asarray(x, np.float32))
    n_ch = len(d["off"])
    return correlate_bank_plain(
        torch.from_numpy(d["iq"]), torch.from_numpy(d["off"]),
        torch.from_numpy(d["table"]), torch.arange(n_ch),
        torch.from_numpy(d["start"]), f32(d["alpha"]),
        f32(np.mod(d["remc64"], 1.0)), f32(np.mod(d["inc_c"] * 128.0, 1.0)),
        f32(np.mod(d["inc_c"], 1.0)), torch.from_numpy(d["bsz"]),
        k=k, blk=blk, interp_taps=interp_taps,
        ptable=torch.from_numpy(d["ptable"]),
        pstart=torch.from_numpy(d["pstart"]), palpha=f32(d["palpha"]),
        pilot_rot=rot, pilot2_rot=rot2, pilot_w1=w1,
        pilot_w2=w2).numpy()


@pytest.mark.parametrize("k", [1, 5])
@pytest.mark.parametrize("interp_taps", [True, False])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_pilot_correlator_matches_reference_kernel(variant, interp_taps,
                                                   k):
    rot, dual, rot2, w1, w2 = VARIANTS[variant]
    blk = 2056
    # the reference kernel takes banks of 8 channels
    d = _inputs(11 + k, 8, blk, k, 6 * 2048, dual)
    args = (d, k, blk, interp_taps, rot, rot2, w1, w2)
    ref = _reference(*args)
    got = _port(*args)
    assert got.shape == ref.shape == (8, 16)
    scale = np.abs(ref).max() + 1.0
    assert np.allclose(got, ref, atol=2e-4 * scale), (
        np.abs(got - ref).max(), scale)
    assert not got[:, 12:].any()
    # the pilot sums are not the data sums: the windows differ
    assert np.abs(got[:, 6:12] - got[:, :6]).max() > 0.1 * scale


def test_pilot_window_clamps_against_its_own_table():
    """``pstart`` is clamped against the pilot table's length, not the
    code table's: a long pilot's window lies far past the code table's
    end and must be read where it is."""
    blk, k = 2056, 1
    d = _inputs(4, 3, blk, k, 3 * 2048, False)
    p_len = d["ptable"].shape[1]
    win = blk + 2 * k + 1
    last = p_len - win                     # the last full pilot window
    assert last > d["table"].shape[1] - win   # past the code table's
    d["pstart"] = np.asarray([last, p_len, -5], np.int64)
    got = _port(d, k, blk, True, 0, 2, 1.0, 0.0)
    # the same window read as a data window of a table that is the pilot
    # table: pilot sums at rot 0 are those data sums
    d_as_data = dict(d, table=d["ptable"], start=np.full(3, last),
                     alpha=d["palpha"])
    want = _port(d_as_data, k, blk, True, 0, 2, 1.0, 0.0)
    assert np.array_equal(got[:, 6:12], want[:, :6])


PARAM_CASES = [("gal_e1c", {}), ("gal_e5a", {}), ("gal_e5b", {}),
               ("bds_b1c", {}), ("bds_b1c", dict(pilot_trk_flag=2)),
               ("gps_l5c", dict(pilot_trk_flag=1)),
               ("bds_b2a", dict(pilot_trk_flag=1)),
               ("gps_l2c", dict(pilot_trk_flag=1))]


@pytest.mark.parametrize("signal,over", PARAM_CASES)
def test_make_track_params_pilot_fields_match_reference(signal, over):
    ref = jeng.make_track_params(get_config(signal, **over),
                                 get_signal(signal))
    got = teng.make_track_params(t_get_config(signal, **over),
                                 t_get_signal(signal))
    assert got.has_pilot
    for f in dataclasses.fields(teng.TrackParams):
        if f.name == "fetch_in_kernel":
            # where the windows are fetched, not a pilot field: the port's
            # default is the fetch kernel, the reference's follows use_pallas
            continue
        assert getattr(got, f.name) == getattr(ref, f.name), f.name
    assert got.has_pilot2 == (over.get("pilot_trk_flag") == 2)


# (signal, config overrides, channel tuples or None for the default); a
# channel tuple's 4th element is its starting long-pilot period
TRACK_CASES = {
    "gal_e5a": ("gal_e5a", dict(sampling_freq=12.288e6), None),
    "gal_e5b": ("gal_e5b", dict(sampling_freq=12.288e6), None),
    "bds_b1c_wb": ("bds_b1c", dict(sampling_freq=16.368e6,
                                   pilot_trk_flag=2), None),
    # CL periods 73 and 74 roll over to 0 inside the 12 epochs
    "gps_l2c_cl": ("gps_l2c", dict(sampling_freq=2.048e6,
                                   pilot_trk_flag=1),
                   [(1, 7000.0, 101, 73), (2, 7200.0, 138, 5),
                    (3, 7400.0, 175, 74)]),
}


@pytest.mark.parametrize("case", list(TRACK_CASES))
def test_pilot_track_superblock_matches_reference(case):
    signal, over, channels = TRACK_CASES[case]
    over = dict(over, if_freq=7000.0)
    cfg, tcfg = get_config(signal, **over), t_get_config(signal, **over)
    sig, tsig = get_signal(signal), t_get_signal(signal)
    params = jeng.make_track_params(cfg, sig)
    tparams = teng.make_track_params(tcfg, tsig)
    assert params.fast_code and tparams.has_pilot
    spc = cfg.samples_per_code
    n_epochs, n_ch = 12, 3
    if channels is None:
        channels = [(1 + k, 7000.0 + 200.0 * k, 101 + 37 * k)
                    for k in range(n_ch)]
        rng = np.random.default_rng(7)
        samples = rng.integers(-16, 16, 2 * (n_epochs + 4) * spc).astype(
            np.int8)
    else:
        samples = _long_pilot_scene(cfg, sig, channels, n_epochs + 4)
    dops = [c[1] - cfg.if_freq for c in channels]
    ctabs, ptabs = jeng.build_replica_tables(cfg, sig, params, channels,
                                             dops)
    ttabs, tptabs = teng.build_replica_tables(tcfg, tsig, tparams,
                                              channels, dops)
    assert np.array_equal(ctabs, ttabs)
    assert tptabs.dtype == np.int8 and np.array_equal(ptabs, tptabs)

    params = dataclasses.replace(params, use_pallas=True,
                                 fetch_in_kernel=True, pallas_interpret=True)
    state = jeng.init_channel_state(channels, sig.chip_rate_hz,
                                    dopplers=dops,
                                    carrier_freq_hz=sig.carrier_freq_hz)
    st_j, out_j = jeng.track_superblock(
        jnp.asarray(samples), jnp.int64(0), jnp.asarray(ctabs),
        jnp.asarray(ptabs), state, params, n_epochs)
    tstate = teng.init_channel_state(channels, tsig.chip_rate_hz, "cpu",
                                     dopplers=dops,
                                     carrier_freq_hz=tsig.carrier_freq_hz)
    st_t, out_t = teng.track_superblock(
        torch.from_numpy(samples), 0, torch.from_numpy(ttabs),
        torch.from_numpy(tptabs), tstate, tparams, n_epochs)

    for name in ("i_e", "q_e", "i_p", "q_p", "i_l", "q_l",
                 "pilot_ip", "pilot_qp", "dll_discr", "pll_discr"):
        a = np.asarray(getattr(out_j, name))
        b = getattr(out_t, name).numpy()
        assert a.shape == b.shape == (n_epochs, n_ch), name
        scale = np.abs(a).max() + 1.0
        assert np.allclose(a, b, atol=2e-4 * scale), (
            name, np.abs(a - b).max(), scale)
    assert np.abs(out_t.pilot_ip.numpy()).max() > 0
    for name in ("carr_freq", "code_freq", "rem_code_phase",
                 "rem_carr_phase"):
        a = np.asarray(getattr(st_j, name))
        b = getattr(st_t, name).numpy()
        assert b.dtype == np.float64
        assert np.allclose(a, b, rtol=1e-6, atol=1e-4), (name, a, b)
    for name in ("abs_sample", "pilot_period"):
        assert np.array_equal(np.asarray(getattr(st_j, name)),
                              getattr(st_t, name).numpy()), name
    for name in ("abs_sample", "blksize"):
        assert np.array_equal(np.asarray(getattr(out_j, name)),
                              getattr(out_t, name).numpy()), name
    if tparams.pilot_period_mod > 1:
        start = np.asarray([c[3] for c in channels])
        assert np.array_equal(st_t.pilot_period.numpy(),
                              (start + n_epochs) % 75)
        # data and CL prompts locked in every channel once the PLL has
        # pulled in, past the roll to period 0
        for i, q in ((out_t.i_p, out_t.q_p),
                     (out_t.pilot_ip, out_t.pilot_qp)):
            i, q = i.numpy()[-4:], q.numpy()[-4:]
            assert (np.abs(i).mean(0) > 3 * np.abs(q).mean(0)).all()


def _long_pilot_scene(cfg, sig, channels, n_codes):
    """int8 scene of one SV per channel at its carrier and code phase,
    46 dB-Hz, with its CL code at the channel's starting period."""
    from cusdr_tpu.io.synth import SynthSV, quantize_iq_int8, synthesize_if
    svs = []
    for prn, carr, phase, period in channels:
        dop = carr - cfg.if_freq
        code_freq = sig.chip_rate_hz * (1.0 + dop / sig.carrier_freq_hz)
        per_samples = sig.code_length_chips * cfg.sampling_freq / code_freq
        svs.append(SynthSV(prn=prn, code_phase=phase - period * per_samples,
                           doppler_hz=dop, cn0_dbhz=46.0))
    return quantize_iq_int8(synthesize_if(
        cfg, sig, svs, num_ms=int(n_codes * sig.code_period_ms), seed=3))
