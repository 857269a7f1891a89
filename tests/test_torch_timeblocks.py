"""Time-parallel tracking of the port against the JAX reference
(cusdr_tpu/parallel/timeblocks.py), at the sizes of tests/test_timeblocks.py
(gps_l1ca, 2.048 Msps).

- ``predict_block_states``: every leaf and ``starts`` equal to the
  reference's (f64 and integers exact), gps_l1ca and the long-pilot gps_l2c.
- ``_track_blocks_flat`` against the reference's flat bank on its Pallas
  fetch kernel in interpret mode, and the port's per-block path (staged
  windows, one pseudo-record with per-row ends) against the reference's
  vmapped ``_track_blocks``: correlator outputs to ``2e-4·scale``,
  ``abs_sample`` exact, carrier frequency ``rtol 1e-6``, as
  tests/test_timeblocks.py holds the reference's two paths to each other.
- ``_ring_shift`` and ``_stitch`` on hand-made states.
- ``track_time_parallel``: ``handoff_iters = n_blocks - 1`` equals the
  port's own sequential ``track`` (the bounds of the reference's
  test_exact_handoff_parity), on the flat and on the per-block path, and
  ``handoff_iters = 1`` agrees with the reference's result field by field.
  The reference runs its XLA epoch there and the port its plain correlator,
  which sum in other orders; tolerances are those of
  tests/test_torch_receiver.py for 4 000 epochs of closed-loop tracking
  (I_P ``2e-4·scale``, carrier 1e-3 Hz, ``abs_sample`` exact).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cusdr_tpu import get_config
from cusdr_tpu.io.synth import SynthSV, quantize_iq_int8, synthesize_if
from cusdr_tpu.parallel import timeblocks as jtb
from cusdr_tpu.signals.defs import get_signal
from cusdr_tpu.tracking import engine as jeng
from cusdr_tpu_torch import get_config as t_get_config
from cusdr_tpu_torch.ops.correlator import LAUNCHES
from cusdr_tpu_torch.parallel import timeblocks as ttb
from cusdr_tpu_torch.signals.defs import get_signal as t_get_signal
from cusdr_tpu_torch.tracking import engine as teng

from test_torch_convert import (assert_states_equal, torch_params,
                                torch_state, torch_tables)
from test_torch_threads import few_torch_threads  # noqa: F401 (autouse)

OVER = dict(sampling_freq=2.048e6, if_freq=7000.0)


@pytest.mark.parametrize("signal,over,channels,n_blocks,epb", [
    ("gps_l1ca", {}, [(7, 9500.0, 1234), (13, 3800.0, 101)], 4, 1000),
    ("gps_l1ca", {}, [(7, 8500.0, 500), (9, 6000.0, 77), (21, 7500.0, 900)],
     2, 20),
    # CL period counters roll at 75 across the blocks
    ("gps_l2c", dict(pilot_trk_flag=1),
     [(1, 7000.0, 101, 73), (2, 7200.0, 138, 5), (3, 7400.0, 175, 74)],
     3, 40)])
def test_predict_block_states_equal_reference(signal, over, channels,
                                              n_blocks, epb):
    cfg = get_config(signal, **OVER, **over)
    tcfg = t_get_config(signal, **OVER, **over)
    j_states, j_starts = jtb.predict_block_states(
        channels, cfg, get_signal(signal), n_blocks, epb)
    t_states, t_starts = ttb.predict_block_states(
        channels, tcfg, t_get_signal(signal), n_blocks, epb, "cpu")
    assert t_starts.dtype == np.int64
    assert np.array_equal(j_starts, t_starts)
    assert t_states.abs_sample.shape == (n_blocks, len(channels))
    assert_states_equal(j_states, t_states)
    if signal == "gps_l2c":
        assert t_states.pilot_period[:, 0].tolist() == [73, 38, 3]


@pytest.fixture(scope="module")
def short_scene():
    """The 50 ms, 3-channel, 2-block scene of the reference's
    test_flat_path_matches_block_path, tracked by the reference both
    ways."""
    cfg = get_config("gps_l1ca", **OVER)
    sig = get_signal("gps_l1ca")
    svs = [SynthSV(prn=7, code_phase=500.0, doppler_hz=1500.0,
                   cn0_dbhz=48)]
    iq = quantize_iq_int8(synthesize_if(cfg, sig, svs, num_ms=50, seed=4))
    chans = [(7, 8500.0, 500), (9, 6000.0, 77), (21, 7500.0, 900)]
    n_blocks, epb = 2, 20
    params = jeng.make_track_params(cfg, sig)
    dops = [c[1] - cfg.if_freq for c in chans]
    ct, pt = jeng.build_replica_tables(cfg, sig, params, chans, dops)
    states, starts = jtb.predict_block_states(chans, cfg, sig, n_blocks,
                                              epb)
    # per-block buffers as track_time_parallel cuts them
    spc, total = cfg.samples_per_code, len(iq) // 2
    blk_len = (epb + 4) * spc + params.blk + 256
    sb = np.zeros((n_blocks, 2 * blk_len), np.int8)
    s0s = np.zeros(n_blocks, np.int64)
    s1s = np.zeros(n_blocks, np.int64)
    for b in range(n_blocks):
        s0 = max(int(starts[b].min()) - spc, 0)
        s1 = min(s0 + blk_len, total)
        s0s[b], s1s[b] = s0, s1
        sb[b, :2 * (s1 - s0)] = iq[2 * s0:2 * s1]
    return dict(cfg=cfg, sig=sig, iq=iq, chans=chans, n_blocks=n_blocks,
                epb=epb, params=params, ct=ct, pt=pt, states=states,
                sb=sb, s0s=s0s, s1s=s1s)


def _assert_block_runs_agree(st_j, out_j, st_t, out_t, shape):
    for name in ("i_e", "q_e", "i_p", "q_p", "i_l", "q_l"):
        a = np.asarray(getattr(out_j, name))
        b = getattr(out_t, name).numpy()
        assert a.shape == b.shape == shape, name
        scale = np.abs(a).max() + 1.0
        assert np.allclose(a, b, atol=2e-4 * scale), (
            name, np.abs(a - b).max(), scale)
    for name in ("abs_sample", "blksize"):
        assert np.array_equal(np.asarray(getattr(out_j, name)),
                              getattr(out_t, name).numpy()), name
    assert np.array_equal(np.asarray(st_j.abs_sample),
                          st_t.abs_sample.numpy())
    for name in ("carr_freq", "code_freq"):
        assert np.allclose(np.asarray(getattr(st_j, name)),
                           getattr(st_t, name).numpy(),
                           rtol=1e-6, atol=1e-6), name


def test_flat_bank_matches_reference(short_scene):
    s = short_scene
    p_pl = dataclasses.replace(s["params"], use_pallas=True,
                               fetch_in_kernel=True, pallas_interpret=True)
    st_j, out_j = jtb._track_blocks_flat(
        jnp.asarray(s["iq"]), jnp.asarray(s["ct"]), jnp.asarray(s["pt"]),
        s["states"], p_pl, s["epb"], s["n_blocks"])
    tables, ptables = torch_tables(s["ct"], s["pt"], False)
    tparams = torch_params(p_pl)
    assert tparams.fetch_in_kernel
    st_t, out_t = ttb._track_blocks_flat(
        torch.from_numpy(s["iq"]), tables, ptables, torch_state(s["states"]),
        tparams, s["epb"], s["n_blocks"])
    _assert_block_runs_agree(st_j, out_j, st_t, out_t,
                             (s["n_blocks"], s["epb"], 3))


@pytest.mark.parametrize("ref_kernel", ["xla", "pallas_staged"])
def test_per_block_path_matches_reference(short_scene, ref_kernel):
    """The reference's vmapped blocks on its XLA epoch and on its staged
    Pallas kernel (``correlate_bank``, interpret mode)."""
    s = short_scene
    j_params = s["params"]
    if ref_kernel == "pallas_staged":
        j_params = dataclasses.replace(j_params, use_pallas=True,
                                       pallas_interpret=True)
    st_j, out_j = jtb._track_blocks(
        jnp.asarray(s["sb"]), jnp.asarray(s["s0s"]), jnp.asarray(s["s1s"]),
        jnp.asarray(s["ct"]), jnp.asarray(s["pt"]), s["states"],
        j_params, s["epb"])
    tables, ptables = torch_tables(s["ct"], s["pt"], False)
    st_t, out_t = ttb._track_blocks(
        torch.from_numpy(s["sb"]), torch.from_numpy(s["s0s"]),
        torch.from_numpy(s["s1s"]), tables, ptables,
        torch_state(s["states"]), torch_params(s["params"]), s["epb"])
    _assert_block_runs_agree(st_j, out_j, st_t, out_t,
                             (s["n_blocks"], s["epb"], 3))


def test_per_block_rows_freeze_at_their_own_block_end(short_scene):
    """A block whose buffer ends early freezes its own rows only: the
    freeze is per row, not per bank."""
    s = short_scene
    tables, ptables = torch_tables(s["ct"], s["pt"], False)
    spc = s["cfg"].samples_per_code
    ends = torch.from_numpy(s["s1s"]).clone()
    ends[0] = s["s0s"][0] + 12 * spc           # block 0 loses its tail
    st, out = ttb._track_blocks(
        torch.from_numpy(s["sb"]), torch.from_numpy(s["s0s"]), ends,
        tables, ptables, torch_state(s["states"]),
        torch_params(s["params"]), s["epb"])
    alive = (out.blksize > 0).numpy()          # [B, E, C]
    assert alive[1].all() and st.active[1].all()
    assert not st.active[0].any()
    n_alive = alive[0].sum(axis=0)
    assert ((n_alive >= 8) & (n_alive <= 11)).all(), n_alive
    assert not out.i_p[0, 11:].any()


def test_ring_shift_moves_final_states_one_block_right():
    b, c = 3, 2
    mk = lambda base: teng.ChannelState(*(
        (torch.arange(b * c).reshape(b, c) + base).to(dt)
        for dt in (torch.float64,) * 12
        + (torch.int64, torch.int32, torch.bool)))
    s0, fin = mk(0), mk(100)
    out = ttb._ring_shift(s0, fin)
    for leaf0, leaf_f, leaf in zip(s0, fin, out):
        assert leaf.dtype == leaf0.dtype and leaf.shape == (b, c)
        assert torch.equal(leaf[0], leaf0[0])
        assert torch.equal(leaf[1:], leaf_f[:-1])


def test_stitch_resolves_block_signs():
    """Block 1 ended half a cycle away from the phase block 2 started
    with: blocks 2.. are re-signed; a sample gap is propagated at the
    block's final carrier frequency."""
    cfg = t_get_config("gps_l1ca", **OVER)
    b, c, e = 3, 2, 4
    z = torch.zeros(b, c, dtype=torch.float64)
    state = teng.ChannelState(
        *([z] * 12), torch.zeros(b, c, dtype=torch.int64),
        torch.zeros(b, c, dtype=torch.int32),
        torch.ones(b, c, dtype=torch.bool))
    fs = cfg.sampling_freq
    starts = state._replace(
        rem_carr_phase=torch.tensor([[0.0, 0.0], [0.3, 0.3], [1.0, 1.0]],
                                    dtype=torch.float64),
        abs_sample=torch.tensor([[0, 0], [100, 100], [200, 203]]))
    # channel 0: in phase at boundary 0|1, pi off at 1|2; channel 1: pi
    # off at 0|1, and at 1|2 in phase only through the 3-sample gap
    f1 = fs / 6.0                              # 3 samples = half a cycle
    final = state._replace(
        rem_carr_phase=torch.tensor(
            [[0.3, 0.3 + np.pi], [1.0 + np.pi, 1.0 + np.pi], [0.0, 0.0]],
            dtype=torch.float64),
        abs_sample=torch.tensor([[100, 100], [200, 200], [300, 300]]),
        carr_freq=torch.tensor([[0.0, 0.0], [0.0, f1], [0.0, 0.0]],
                               dtype=torch.float64))
    ones32 = torch.ones(b, e, c)
    outs = teng.TrackOutputs(**{
        name: (ones32.double() if name in ("carr_freq", "code_freq",
                                           "rem_code_phase",
                                           "rem_carr_phase")
               else ones32.long() if name in ("abs_sample", "blksize")
               else ones32)
        for name in teng.TrackOutputs._fields})
    res = ttb._stitch(cfg, [(1, 0.0, 0), (2, 0.0, 0)], b, e, 1, 200,
                      starts, final, outs)
    assert res.i_p.shape == (c, b * e)
    assert res.i_p[0].tolist() == [1.0] * 8 + [-1.0] * 4
    assert res.i_p[1].tolist() == [1.0] * 4 + [-1.0] * 8
    assert np.array_equal(res.q_e, res.i_p)
    assert (res.carr_freq == 1.0).all() and (res.blksize == 1).all()
    assert (res.n_blocks, res.epochs_per_block, res.settle_epochs) == (
        b, e, 0)
    res0 = ttb._stitch(cfg, [(1, 0.0, 0), (2, 0.0, 0)], b, e, 0, 200,
                       starts, final, outs)
    assert res0.settle_epochs == 200


@pytest.fixture(scope="module")
def long_scene():
    """The 4.2 s, 2-SV scene of tests/test_timeblocks.py with the port's
    sequential track of it."""
    cfg = get_config("gps_l1ca", **OVER)
    tcfg = t_get_config("gps_l1ca", **OVER)
    sig = get_signal("gps_l1ca")
    rng = np.random.default_rng(0)
    svs = [SynthSV(prn=7, code_phase=1234.0, doppler_hz=2500.0,
                   cn0_dbhz=47,
                   nav_bits=rng.choice(np.asarray([-1, 1], np.int8), 300)),
           SynthSV(prn=13, code_phase=100.2, doppler_hz=-3200.0,
                   cn0_dbhz=45,
                   nav_bits=rng.choice(np.asarray([-1, 1], np.int8), 300))]
    iq = quantize_iq_int8(synthesize_if(cfg, sig, svs, num_ms=4200,
                                        seed=3))
    chans = [(7, 9500.0, 1234), (13, 3800.0, 101)]
    seq = teng.track(tcfg, t_get_signal("gps_l1ca"), iq, chans, "cpu",
                     n_epochs=4000)
    return cfg, tcfg, iq, chans, seq


@pytest.mark.parametrize("fetch_in_kernel", [True, False])
def test_exact_handoff_equals_sequential_track(long_scene, fetch_in_kernel):
    """With handoff_iters = n_blocks - 1 every block has re-run from its
    left neighbour's true final state, so the stitched trajectory is the
    sequential one."""
    _, tcfg, iq, chans, seq = long_scene
    before = dict(LAUNCHES)
    par = ttb.track_time_parallel(
        tcfg, t_get_signal("gps_l1ca"), iq, chans, n_epochs=4000,
        n_blocks=4, handoff_iters=3, device="cpu",
        fetch_in_kernel=fetch_in_kernel)
    assert LAUNCHES == before                  # no kernel on the CPU
    assert par.settle_epochs == 0 and par.n_blocks == 4
    assert par.epochs_per_block == 1000
    assert par.status == ["T", "T"]
    np.testing.assert_array_equal(par.abs_sample, seq.abs_sample)
    np.testing.assert_allclose(par.carr_freq, seq.carr_freq,
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(par.code_freq, seq.code_freq,
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(par.i_p, seq.i_p, rtol=1e-4, atol=0.5)
    np.testing.assert_allclose(par.q_p, seq.q_p, rtol=1e-4, atol=0.5)


def test_single_handoff_matches_reference(long_scene):
    cfg, tcfg, iq, chans, seq = long_scene
    ref = jtb.track_time_parallel(cfg, get_signal("gps_l1ca"), iq, chans,
                                  n_epochs=4000, n_blocks=4,
                                  handoff_iters=1)
    par = ttb.track_time_parallel(tcfg, t_get_signal("gps_l1ca"), iq, chans,
                                  n_epochs=4000, n_blocks=4,
                                  handoff_iters=1, device="cpu")
    assert (par.n_blocks, par.epochs_per_block, par.settle_epochs) == (
        ref.n_blocks, ref.epochs_per_block, ref.settle_epochs) == (4, 1000, 0)
    assert par.status == ref.status
    assert np.array_equal(par.active_until, ref.active_until)
    for name in ("abs_sample", "blksize"):
        assert np.array_equal(getattr(par, name), getattr(ref, name)), name
    for name in ("i_e", "q_e", "i_p", "q_p", "i_l", "q_l"):
        a, b = getattr(ref, name), getattr(par, name)
        scale = np.abs(a).max() + 1.0
        assert np.abs(a - b).max() <= 2e-4 * scale, (
            name, np.abs(a - b).max(), scale)
    assert np.allclose(par.carr_freq, ref.carr_freq, rtol=0, atol=1e-3)
    assert np.allclose(par.code_freq, ref.code_freq, rtol=0, atol=1e-5)
    assert np.allclose(par.rem_code_phase, ref.rem_code_phase,
                       rtol=0, atol=1e-6)
    # blocks 0 and 1 are exactly the sequential trajectory
    assert np.allclose(par.carr_freq[:, :2000], seq.carr_freq[:, :2000],
                       rtol=0, atol=1e-6)
    # no sign flip at a block boundary: the nav-bit signs are sequential's
    assert np.mean(np.sign(par.i_p) == np.sign(seq.i_p)) > 0.995
