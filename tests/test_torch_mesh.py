"""Multi-device scale-out of the port (cusdr_tpu_torch/parallel/mesh.py,
distributed.py, ``track_time_parallel(mesh=)``, ``track_multi(mesh=)``,
``run_multi(mesh=)``) against the port's own unsharded functions and the
JAX reference's sharded ones on the 8-device virtual mesh that
tests/conftest.py gives jax.  The port's meshes here are n ``"cpu"``
entries, the counterpart of XLA's virtual host devices.

- ``tracking_step_sharded`` and ``pcps_sharded`` at the reference's
  multichip dryrun setups (1.024 Msps, 16 channels, 4 epochs; 16 PRNs, 3
  non-coherent slabs, 9 bins) on 8 entries: equal element for element to
  the port's unsharded ``track_superblock`` / ``_pcps_cdma_kernel`` (the
  shards run the same row-wise arithmetic; the dryrun asks sharded ==
  unsharded within rtol 1e-6 atol 1e-6, states 1e-9).  Against the
  reference's sharded results: the search at the dryrun's tolerances
  (peaks rtol 1e-5, code phase and bin exact); the tracking step's sums
  are added in another order than the reference's (2.5e-6 of the largest
  apart, beyond the dryrun's rtol 1e-6), so it is held at the port's
  ``track_superblock`` parity tolerances (sums 2e-4·(max + 1), loop state
  rtol 1e-6 atol 1e-4, ``abs_sample`` exact).
- ``track_time_parallel`` on the multihost scene (1.024 Msps, 80 epochs,
  4 blocks) over a 4-entry 'tb' mesh and a 2x2 ch x tb mesh, with state
  handoff (3 passes) and in predict mode: equal element for element to
  the port's unsharded per-block path; with handoff, held to the port's
  sequential ``track`` at the multihost worker's criteria (``abs_sample``
  exact, frequencies atol 1e-6, prompts rtol 1e-4 atol 0.5); against the
  reference's result on the same mesh shape, whose sums are added in
  another order (carriers 2.4e-4 Hz apart, beyond the worker's 1e-6), at
  the port's time-parallel parity tolerances (tests/test_torch_timeblocks
  .py: sums 2e-4·(max + 1), frequencies 1e-3 Hz, ``abs_sample`` exact).
- ``track_multi`` / ``run_multi`` on a 2-shard 'ch' mesh: equal element
  for element to the port's unsharded run (tests/test_multi_signal_track
  .py's mesh criteria ask abs_sample equal, prompts rtol 1e-6, carrier
  1e-9 Hz); against the reference's sharded run, whose sums are added in
  another order (2.4e-6 of themselves apart), at the port's
  ``track_multi`` parity tolerances (tests/test_torch_multi_signal_track
  .py).
- The refusals: axes that do not divide the work, meshes larger than the
  devices, a CUDA mesh without a card, a mesh and a device at once, a
  process-spanning mesh in ``track_multi``.
- int16 x 64 under a 'tb' mesh: every sum 64 times the int8 run's,
  everything else equal (the reference fails there: ROADMAP Queue C).
- The gather path (bds_b1c at 4.096 Msps, element tables) on 1x2 and 2x1
  meshes: equal element for element to the port's unsharded per-block
  path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh, NamedSharding, PartitionSpec as P

from cusdr_tpu import get_config
from cusdr_tpu.io.synth import SynthSV, quantize_iq_int8, synthesize_if
from cusdr_tpu.parallel import mesh as jmesh
from cusdr_tpu.parallel import timeblocks as jtb
from cusdr_tpu.signals.defs import get_signal, sample_code
from cusdr_tpu.tracking import engine as jeng
from cusdr_tpu.tracking import track_multi as j_track_multi
from cusdr_tpu_torch import get_config as t_get_config
from cusdr_tpu_torch.acquisition.pcps import _pcps_cdma_kernel
from cusdr_tpu_torch.parallel import (make_mesh, pcps_sharded,
                                      shard_channel_bank,
                                      tracking_step_sharded)
from cusdr_tpu_torch.parallel.distributed import make_mesh_2d
from cusdr_tpu_torch.parallel.mesh import Mesh
from cusdr_tpu_torch.parallel.timeblocks import track_time_parallel
from cusdr_tpu_torch.signals.defs import get_signal as t_get_signal
from cusdr_tpu_torch.tracking import engine as teng
from cusdr_tpu_torch.tracking.multi import track_multi

from test_multi_signal_track import scenes  # noqa: F401 (fixture)
from test_torch_convert import torch_params, torch_state, torch_tables
from test_torch_multi_signal_track import (_assert_fast_as_reference,
                                           _port_spec)
from test_torch_threads import few_torch_threads  # noqa: F401 (autouse)

N_DEV = 8
STEP_FIELDS = ("i_p", "q_p", "i_e", "i_l", "carr_freq", "code_freq",
               "abs_sample")
STATE_FIELDS = ("carr_freq", "code_freq", "rem_code_phase",
                "rem_carr_phase")
SUMS = ("i_e", "q_e", "i_p", "q_p", "i_l", "q_l", "pilot_ip", "pilot_qp")


def _assert_results_equal(a, b, times=1):
    """Two TrackResults equal element for element (``b``'s sums ``times``
    ``a``'s)."""
    for f in teng.TrackOutputs._fields:
        want = times * getattr(a, f) if f in SUMS else getattr(a, f)
        assert np.array_equal(getattr(b, f), want), f
    assert a.status == b.status


# ---- tracking step and PCPS, the multichip dryrun's setups ---------------

@pytest.fixture(scope="module")
def step_setup():
    """The reference's dryrun tracking step: gps_l1ca at 1.024 Msps,
    2·N_DEV channels on random samples, 4 epochs."""
    n_ch, n_epochs = 2 * N_DEV, 4
    cfg = get_config("gps_l1ca", sampling_freq=1.024e6, if_freq=7000.0,
                     num_channels=n_ch)
    sig = get_signal("gps_l1ca")
    params = jeng.make_track_params(cfg, sig)
    spc = cfg.samples_per_code
    rng = np.random.default_rng(0)
    samples = rng.integers(-16, 16, 2 * (n_epochs + 4) * spc).astype(
        np.int8)
    channels = [(1 + (k % 32), 7000.0 + 100.0 * k, k * 37)
                for k in range(n_ch)]
    dops = [c[1] - cfg.if_freq for c in channels]
    ctabs, ptabs = jeng.build_replica_tables(cfg, sig, params, channels,
                                             dops)
    state = jeng.init_channel_state(channels, sig.chip_rate_hz,
                                    dopplers=dops,
                                    carrier_freq_hz=sig.carrier_freq_hz)
    return dict(params=params, samples=samples, ctabs=ctabs, ptabs=ptabs,
                state=state, n_epochs=n_epochs)


def test_tracking_step_sharded(step_setup):
    s = step_setup
    n_epochs = s["n_epochs"]
    # the reference: sharded over its 8 virtual devices
    jm = jmesh.make_mesh(N_DEV)
    st_sh, ct_d, pt_d = jmesh.shard_channel_bank(
        s["state"], jnp.asarray(s["ctabs"]), jnp.asarray(s["ptabs"]), jm)
    samples_d = jax.device_put(jnp.asarray(s["samples"]),
                               NamedSharding(jm, P()))
    j_state, j_outs = jmesh.tracking_step_sharded(
        samples_d, jnp.int64(0), ct_d, pt_d, st_sh, s["params"], n_epochs)

    params = torch_params(s["params"])
    ct, pt = torch_tables(s["ctabs"], s["ptabs"], params.has_pilot)
    state = torch_state(s["state"])
    samples = torch.from_numpy(s["samples"])
    want = teng.track_superblock(samples, 0, ct, pt, state, params,
                                 n_epochs)
    mesh = make_mesh(N_DEV, device="cpu")
    bank = shard_channel_bank(state, ct, pt, mesh)
    assert [len(sh[1].carr_freq) for sh in bank.shards] == [2] * N_DEV
    got = tracking_step_sharded(samples, 0, bank, params, n_epochs)
    assert got[1].i_p.shape == (n_epochs, 2 * N_DEV)
    # against the port's unsharded step: equal element for element
    for g_all, w_all in zip(got, want):
        for name, g, w in zip(g_all._fields, g_all, w_all):
            assert g.dtype == w.dtype and torch.equal(g, w), name
    # against the reference's sharded step: the sums are added in another
    # order (2.5e-6 of the largest apart here), so at the port's
    # track_superblock parity tolerances (tests/test_torch_superblock.py)
    for name in STEP_FIELDS:
        a = np.asarray(getattr(j_outs, name))
        b = getattr(got[1], name).numpy()
        if name == "abs_sample":
            assert np.array_equal(a, b)
        elif b.dtype == np.float32:
            scale = np.abs(a).max() + 1.0
            assert np.allclose(a, b, rtol=0, atol=2e-4 * scale), (
                name, np.abs(a - b).max(), scale)
        else:
            assert np.allclose(a, b, rtol=1e-6, atol=1e-4), name
    for name in STATE_FIELDS:
        a = np.asarray(getattr(j_state, name))
        b = getattr(got[0], name).numpy()
        assert np.allclose(a, b, rtol=1e-6, atol=1e-4), (name, a, b)


@pytest.fixture(scope="module")
def pcps_setup():
    """The dryrun's acquisition: 2·N_DEV PRNs, 3 slabs, 9 bins."""
    cfg = get_config("gps_l1ca", sampling_freq=1.024e6, if_freq=7000.0)
    sig = get_signal("gps_l1ca")
    spc = cfg.samples_per_code
    nfft, n_prn, noncoh = 2 * spc, 2 * N_DEV, 3
    rng = np.random.default_rng(1)
    slabs_r = rng.standard_normal((noncoh, nfft)).astype(np.float32)
    slabs_i = rng.standard_normal((noncoh, nfft)).astype(np.float32)
    code_fft = np.stack([
        np.conj(np.fft.fft(np.concatenate([
            sample_code(sig.data_code(p + 1), 1, sig.chip_rate_hz,
                        cfg.sampling_freq, spc).astype(np.float32),
            np.zeros(spc, np.float32)])))[None, :]
        for p in range(n_prn)])
    f_grid = np.linspace(5000.0, 9000.0, 9).astype(np.float32)
    return dict(slabs_r=slabs_r, slabs_i=slabs_i, code_fft=code_fft,
                f_grid=f_grid, ts=np.float32(1.0 / cfg.sampling_freq),
                noncoh=noncoh)


def test_pcps_sharded(pcps_setup):
    s = pcps_setup
    cf = s["code_fft"]
    jm = jmesh.make_mesh(N_DEV)
    rep = NamedSharding(jm, P())
    shard3 = NamedSharding(jm, P("ch", None, None))
    ref = jmesh.pcps_sharded(
        (jax.device_put(jnp.asarray(s["slabs_r"]), rep),
         jax.device_put(jnp.asarray(s["slabs_i"]), rep)),
        (jax.device_put(jnp.asarray(cf.real.astype(np.float32)), shard3),
         jax.device_put(jnp.asarray(cf.imag.astype(np.float32)), shard3)),
        jnp.ones(1, jnp.float32), jnp.asarray(s["f_grid"]), s["ts"],
        n_comp=1)
    ref = [np.asarray(x) for x in ref]

    slabs = torch.from_numpy(s["slabs_r"] + 1j * s["slabs_i"]).to(
        torch.complex64)
    cfc = torch.from_numpy(cf.astype(np.complex64))
    weights = torch.ones(1)
    f_grid = torch.from_numpy(s["f_grid"])
    want = _pcps_cdma_kernel(slabs, cfc, weights, f_grid, s["ts"],
                             s["noncoh"], 1, None)
    got = pcps_sharded(slabs, cfc, weights, f_grid, s["ts"], n_comp=1,
                       mesh=make_mesh(N_DEV, device="cpu"))
    assert all(g.shape == (2 * N_DEV,) for g in got)
    # against the port's unsharded search: equal element for element
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    # against the reference's sharded search: peaks rtol 1e-5, the code
    # phase and the bin exact
    peak, b, ph, second, floor = (x.numpy() for x in got)
    assert np.allclose(ref[0], peak, rtol=1e-5)
    assert np.array_equal(ref[1], b) and np.array_equal(ref[2], ph)
    assert np.allclose(ref[3], second, rtol=1e-5)
    assert np.allclose(ref[4], floor, rtol=1e-5)


# ---- time blocks over 'tb' and ch x tb meshes -----------------------------

@pytest.fixture(scope="module")
def tb_scene():
    """tests/multihost_worker.py's scene: 1.024 Msps, two SVs, 80
    epochs."""
    cfg = get_config("gps_l1ca", sampling_freq=1.024e6, if_freq=7000.0)
    sig = get_signal("gps_l1ca")
    rng = np.random.default_rng(0)
    svs = [SynthSV(prn=7, code_phase=123.0, doppler_hz=2500.0, cn0_dbhz=47,
                   nav_bits=rng.choice(np.asarray([-1, 1], np.int8), 40)),
           SynthSV(prn=13, code_phase=400.2, doppler_hz=-3200.0,
                   cn0_dbhz=45,
                   nav_bits=rng.choice(np.asarray([-1, 1], np.int8), 40))]
    iq = quantize_iq_int8(synthesize_if(cfg, sig, svs, num_ms=90, seed=3))
    chans = [(7, 9500.0, 123), (13, 3800.0, 401)]
    tcfg = t_get_config("gps_l1ca", sampling_freq=1.024e6, if_freq=7000.0)
    return cfg, sig, tcfg, t_get_signal("gps_l1ca"), iq, chans


def _meshes(shape):
    """The reference's and the port's meshes of one shape: (4,) is 'tb',
    (2, 2) ch x tb."""
    axes = ("tb",) if len(shape) == 1 else ("ch", "tb")
    n = int(np.prod(shape))
    jm = JMesh(np.asarray(jax.devices()[:n]).reshape(shape), axes)
    return jm, Mesh(np.full(shape, "cpu", object), axes)


@pytest.fixture(scope="module")
def tb_sequential(tb_scene):
    _, _, tcfg, tsig, iq, chans = tb_scene
    return teng.track(tcfg, tsig, iq, chans, "cpu", n_epochs=80)


@pytest.mark.parametrize("shape,handoff", [((4,), 3), ((2, 2), 3),
                                           ((2, 2), 0)])
def test_time_parallel_on_mesh(tb_scene, tb_sequential, shape, handoff):
    cfg, sig, tcfg, tsig, iq, chans = tb_scene
    jm, tm = _meshes(shape)
    ref = jtb.track_time_parallel(cfg, sig, iq, chans, n_epochs=80,
                                  n_blocks=4, handoff_iters=handoff,
                                  mesh=jm)
    par = track_time_parallel(tcfg, tsig, iq, chans, 80, 4,
                              handoff_iters=handoff, mesh=tm)
    assert par.i_p.shape == (2, 80) and par.n_blocks == 4
    assert par.settle_epochs == ref.settle_epochs
    # the port's own unsharded per-block path: the same banks' arithmetic
    one = track_time_parallel(tcfg, tsig, iq, chans, 80, 4,
                              handoff_iters=handoff, device="cpu",
                              fetch_in_kernel=False)
    _assert_results_equal(one, par)
    if handoff == 3:
        # every block re-ran from its neighbour's true final state: the
        # port's sequential track, at the multihost worker's criteria
        seq = tb_sequential
        np.testing.assert_array_equal(par.abs_sample, seq.abs_sample)
        for f in ("carr_freq", "code_freq"):
            np.testing.assert_allclose(getattr(par, f), getattr(seq, f),
                                       rtol=0, atol=1e-6)
        for f in ("i_p", "q_p"):
            np.testing.assert_allclose(getattr(par, f), getattr(seq, f),
                                       rtol=1e-4, atol=0.5)
    # the reference on the same mesh shape: its sums are added in another
    # order and the loops feed that back (2.4e-4 Hz apart here), so at the
    # port's time-parallel parity tolerances (tests/test_torch_timeblocks.py)
    assert par.status == ref.status
    np.testing.assert_array_equal(par.abs_sample, ref.abs_sample)
    np.testing.assert_array_equal(par.blksize, ref.blksize)
    for f in SUMS[:6]:
        a, b = getattr(ref, f), getattr(par, f)
        assert np.abs(a - b).max() <= 2e-4 * (np.abs(a).max() + 1.0), f
    np.testing.assert_allclose(par.carr_freq, ref.carr_freq, rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(par.code_freq, ref.code_freq, rtol=0,
                               atol=1e-3)


def test_int16_under_a_tb_mesh_is_int8_times_64(tb_scene):
    """The reference fails here with a shape error; the port's int16 run
    on a 'tb' mesh is its int8 run with every sum 64 times."""
    _, _, tcfg, tsig, iq, chans = tb_scene
    mesh = Mesh(["cpu"] * 4, ("tb",))
    a = track_time_parallel(tcfg, tsig, iq, chans, 80, 4, device="cpu")
    b = track_time_parallel(tcfg, tsig, iq.astype(np.int16) * 64, chans,
                            80, 4, mesh=mesh)
    _assert_results_equal(a, b, times=64)


@pytest.mark.parametrize("shape", [(1, 2), (2, 1)])
def test_gather_path_on_a_mesh(shape):
    """bds_b1c NB at 4.096 Msps (the per-epoch gather path, element
    tables shared by row modulo) over a ch x tb mesh: equal element for
    element to the port's unsharded per-block gather path.  (Shards of
    one row, on a 2x2 mesh, sum the gather step's products in another
    order on the CPU: 6e-6 of the sums apart from the first epoch.)"""
    import warnings
    from cusdr_tpu_torch.io.synth import SynthSV as TSynthSV
    from cusdr_tpu_torch.io.synth import synthesize_if as t_synthesize
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cfg = t_get_config("bds_b1c", sampling_freq=4.096e6, if_freq=7000.0,
                           pilot_trk_flag=1)
    sig = t_get_signal("bds_b1c")
    svs = [TSynthSV(prn=19, code_phase=5120.0, doppler_hz=150.0,
                    cn0_dbhz=47),
           TSynthSV(prn=23, code_phase=20011.0, doppler_hz=-80.0,
                    cn0_dbhz=47)]
    iq = quantize_iq_int8(t_synthesize(cfg, sig, svs, num_ms=700, seed=9))
    chans = [(19, 7153.0, 5120), (23, 6923.0, 20011)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        one = track_time_parallel(cfg, sig, iq, chans, 60, 2,
                                  handoff_iters=1, device="cpu")
        got = track_time_parallel(cfg, sig, iq, chans, 60, 2,
                                  handoff_iters=1,
                                  mesh=Mesh(np.full(shape, "cpu", object),
                                            ("ch", "tb")))
    _assert_results_equal(one, got)


# ---- multi-signal tracking over 'ch' --------------------------------------

N_MS = 400


def test_track_multi_on_a_ch_mesh(scenes):  # noqa: F811
    spec_a, spec_b = scenes
    port_specs = [_port_spec(spec_a), _port_spec(spec_b)]
    got = track_multi(port_specs, n_ms=N_MS,
                      mesh=make_mesh(2, device="cpu"))
    one = track_multi(port_specs, n_ms=N_MS, device="cpu")
    ref = j_track_multi([spec_a, spec_b], n_ms=N_MS,
                        mesh=jmesh.make_mesh(2))
    for g, o in zip(got, one):
        _assert_results_equal(o, g)
    # the reference's sharded run: sums added in another order (2.4e-6 of
    # themselves apart, beyond the reference test's rtol 1e-6), so at the
    # port's track_multi parity tolerances; E1C's second channel is on
    # noise (the reference test's note)
    _assert_fast_as_reference(got[0], ref[0])
    _assert_fast_as_reference(got[1], ref[1], slice(0, 1))


def test_run_multi_on_a_ch_mesh(scenes):  # noqa: F811
    from cusdr_tpu.receiver import run_multi as j_run_multi
    from cusdr_tpu_torch.receiver import run_multi
    spec_a, spec_b = scenes
    # threshold 0 on E1C: PRN 2 (absent, on noise) takes the second
    # channel, so both banks split over two shards
    over_a = dict(acq_satellite_list=(7, 13, 20), acq_non_coh_time=4,
                  acq_threshold=2.5, num_channels=2)
    over_b = dict(acq_satellite_list=(2, 4), acq_non_coh_time=2,
                  acq_threshold=0.0, num_channels=2)
    entries = [(_port_spec(spec_a)[0].replace(**over_a), spec_a[2]),
               (_port_spec(spec_b)[0].replace(**over_b), spec_b[2])]
    got = run_multi(entries, device="cpu", n_ms=N_MS,
                    mesh=make_mesh(2, device="cpu"))
    one = run_multi(entries, device="cpu", n_ms=N_MS)
    ref = j_run_multi([(spec_a[0].replace(**over_a), spec_a[2]),
                       (spec_b[0].replace(**over_b), spec_b[2])],
                      n_ms=N_MS, mesh=jmesh.make_mesh(2))
    for g, o, r, rows in zip(got, one, ref, (slice(None), slice(0, 1))):
        assert g.channels == o.channels and len(g.channels) == 2
        _assert_results_equal(o.track, g.track)
        assert [c[0] for c in g.channels] == [c[0] for c in r.channels]
        assert [c[2] for c in g.channels] == [c[2] for c in r.channels]
        _assert_fast_as_reference(g.track, r.track, rows)
    ia = [p for p, *_ in got[0].channels].index(7)
    assert np.abs(got[0].track.i_p[ia, -100:]).mean() > \
        3 * np.abs(got[0].track.q_p[ia, -100:]).mean()


# ---- refusals -------------------------------------------------------------

def test_refusals(step_setup, tb_scene, scenes):  # noqa: F811
    s = step_setup
    params = torch_params(s["params"])
    ct, pt = torch_tables(s["ctabs"], s["ptabs"], params.has_pilot)
    state = torch_state(s["state"])
    with pytest.raises(ValueError, match="does not divide 16 channels"):
        shard_channel_bank(state, ct, pt, make_mesh(3, device="cpu"))
    with pytest.raises(ValueError, match="does not divide 5 PRNs"):
        pcps_sharded(torch.zeros(3, 8, dtype=torch.complex64),
                     torch.zeros(5, 1, 8, dtype=torch.complex64),
                     torch.ones(1), torch.zeros(2), 1e-6, 1,
                     mesh=make_mesh(2, device="cpu"))
    _, _, tcfg, tsig, iq, chans = tb_scene
    for mesh, what in ((Mesh(["cpu"] * 3, ("tb",)), "4 time blocks"),
                       (Mesh(np.full((4, 1), "cpu", object), ("ch", "tb")),
                        "2 channels")):
        with pytest.raises(ValueError, match=f"does not divide {what}"):
            track_time_parallel(tcfg, tsig, iq, chans, 80, 4, mesh=mesh)
    with pytest.raises(ValueError, match="no 'tb' axis"):
        track_time_parallel(tcfg, tsig, iq, chans, 80, 4,
                            mesh=make_mesh(2, device="cpu"))
    with pytest.raises(ValueError, match="not both"):
        track_time_parallel(tcfg, tsig, iq, chans, 80, 4, device="cpu",
                            mesh=Mesh(["cpu"] * 2, ("tb",)))
    spec_a, spec_b = scenes
    with pytest.raises(ValueError, match="does not divide 2 channels"):
        track_multi([_port_spec(spec_a)], n_ms=10,
                    mesh=make_mesh(4, device="cpu"))
    spans = Mesh(["cpu", "cpu"], ("ch",), ranks=[0, 1])
    with pytest.raises(RuntimeError, match="spans processes"):
        track_multi([_port_spec(spec_a)], n_ms=10, mesh=spans)
    # n_ch beyond the devices (one host entry in one process)
    with pytest.raises(ValueError, match="exceeds the 1 available"):
        make_mesh_2d(n_ch=2, device="cpu")
    with pytest.raises(ValueError, match="needs 3 devices, have 1"):
        make_mesh_2d(n_ch=1, n_tb=3, device="cpu")
    assert make_mesh_2d(device="cpu").devices.shape == (1, 1)


def test_a_cuda_mesh_needs_a_card():
    """Without a card a CUDA mesh raises: nothing falls back to the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="is_available"):
        make_mesh(2)
    with pytest.raises(RuntimeError, match="is_available"):
        make_mesh(device=["cuda:0", "cuda:0"])
    with pytest.raises(RuntimeError, match="is_available"):
        make_mesh_2d()
