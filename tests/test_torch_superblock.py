"""The port's per-superblock tracking on the CPU.

``track_superblock`` takes one launch of the superblock kernel on a card and
the eager loop ``track_superblock_epochs`` elsewhere; the eager loop is the
kernel's plain version.  Here, on the CPU:

- ``pack_state`` / ``unpack_state`` (the state as the kernel takes it) are
  each other's inverse on seeded state;
- ``track_superblock`` equals ``track_superblock_epochs`` bit for bit, and
  both match the JAX reference's ``track_superblock`` (its Pallas fetch
  kernel in interpret mode) on the same seeded inputs without a pilot, with
  a pilot (gal_e5a), with the dual pilot bank (bds_b1c WB) and with the long
  pilot (gps_l2c CL);
- a per-row ``end_sample`` freezes each row at its own end;
- the kernel's source and launch counts are registered, and the wrapper
  refuses CPU tensors;
- ``track``'s drain raises when a drained window lay outside its
  superblock's buffer;
- the entry points default to the card and raise where there is none.

Tolerances against the reference, as in tests/test_torch_correlator.py:
sums ``atol 2e-4·(max|ref| + 1)`` (f32 summation order), loop state ``rtol
1e-6, atol 1e-4``, ``abs_sample``, ``blksize`` and the long-pilot period
exact.  The kernel's own cases are in tests/test_torch_cuda.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cusdr_tpu import get_config
from cusdr_tpu.signals.defs import get_signal
from cusdr_tpu.tracking import engine as jeng
from cusdr_tpu_torch import get_config as t_get_config
from cusdr_tpu_torch.__main__ import main as cli_main
from cusdr_tpu_torch.ops import correlator as tcorr
from cusdr_tpu_torch.receiver import Receiver
from cusdr_tpu_torch.signals.defs import get_signal as t_get_signal
from cusdr_tpu_torch.tracking import engine as teng

from test_torch_pilot_correlator import TRACK_CASES, _long_pilot_scene
from test_torch_threads import few_torch_threads  # noqa: F401 (autouse)

CASES = dict(TRACK_CASES, gps_l1ca=(
    "gps_l1ca", dict(sampling_freq=2.048e6), None))
del CASES["gal_e5b"]
N_EPOCHS = 8


def _seeded_state(seed, c):
    rng = np.random.default_rng(seed)
    f64 = [torch.from_numpy(rng.normal(0, 1e3, c)) for _ in range(12)]
    return teng.ChannelState(
        *f64, abs_sample=torch.from_numpy(rng.integers(0, 1 << 40, c)),
        pilot_period=torch.from_numpy(rng.integers(0, 75, c).astype(
            np.int32)),
        active=torch.from_numpy(rng.integers(0, 2, c).astype(bool)))


@pytest.mark.parametrize("c", [1, 12, 96])
def test_pack_state_round_trip(c):
    state = _seeded_state(c, c)
    f64, abs_sample, pilot_period, active = teng.pack_state(state)
    assert f64.shape == (12, c) and f64.dtype == torch.float64
    assert abs_sample.dtype == torch.int64
    assert pilot_period.dtype == torch.int32 and active.dtype == torch.bool
    for j, name in enumerate(teng.ChannelState._fields[:12]):
        assert torch.equal(f64[j], getattr(state, name)), name
    back = teng.unpack_state(f64, abs_sample, pilot_period, active)
    for name, a, b in zip(state._fields, state, back):
        assert a.dtype == b.dtype and torch.equal(a, b), name


def _setup(case):
    """Both packages' configs, tables and initial states for ``case`` on
    the same seeded record (random int8 samples; a synthesized scene for
    the long pilot, as tests/test_torch_pilot_correlator.py explains)."""
    signal, over, channels = CASES[case]
    over = dict(over, if_freq=7000.0)
    cfg, tcfg = get_config(signal, **over), t_get_config(signal, **over)
    sig, tsig = get_signal(signal), t_get_signal(signal)
    params = dataclasses.replace(
        jeng.make_track_params(cfg, sig), use_pallas=True,
        fetch_in_kernel=True, pallas_interpret=True)
    tparams = teng.make_track_params(tcfg, tsig)
    spc = cfg.samples_per_code
    if channels is None:
        channels = [(1 + k, 7000.0 + 200.0 * k, 101 + 37 * k)
                    for k in range(3)]
        samples = np.random.default_rng(7).integers(
            -16, 16, 2 * (N_EPOCHS + 4) * spc).astype(np.int8)
    else:
        samples = _long_pilot_scene(cfg, sig, channels, N_EPOCHS + 4)
    dops = [c[1] - cfg.if_freq for c in channels]
    ctabs, ptabs = jeng.build_replica_tables(cfg, sig, params, channels,
                                             dops)
    ttabs, tptabs = teng.build_replica_tables(tcfg, tsig, tparams, channels,
                                              dops)
    state = jeng.init_channel_state(channels, sig.chip_rate_hz,
                                    dopplers=dops,
                                    carrier_freq_hz=sig.carrier_freq_hz)
    tstate = teng.init_channel_state(channels, tsig.chip_rate_hz, "cpu",
                                     dopplers=dops,
                                     carrier_freq_hz=tsig.carrier_freq_hz)
    ref = (jnp.asarray(samples), jnp.int64(0), jnp.asarray(ctabs),
           jnp.asarray(ptabs), state, params, N_EPOCHS)
    port = (torch.from_numpy(samples), 0, torch.from_numpy(ttabs),
            None if tptabs is None else torch.from_numpy(tptabs), tstate,
            tparams, N_EPOCHS)
    return ref, port, channels


@pytest.mark.parametrize("case", list(CASES))
def test_track_superblock_is_the_eager_loop_and_matches_reference(case):
    ref, port, channels = _setup(case)
    tparams = port[5]
    assert tparams.has_pilot == (case != "gps_l1ca")
    assert tparams.has_pilot2 == (case == "bds_b1c_wb")
    assert (tparams.pilot_period_mod > 1) == (case == "gps_l2c_cl")
    before = dict(tcorr.LAUNCHES)
    st_t, out_t = teng.track_superblock(*port)
    st_e, out_e = teng.track_superblock_epochs(*port)
    assert tcorr.LAUNCHES == before                # no kernel on the CPU
    for name, a, b in zip(st_t._fields + out_t._fields, st_t + out_t,
                          st_e + out_e):
        assert a.dtype == b.dtype and torch.equal(a, b), name

    st_j, out_j = jeng.track_superblock(*ref)
    for name in ("i_e", "q_e", "i_p", "q_p", "i_l", "q_l", "pilot_ip",
                 "pilot_qp", "dll_discr", "pll_discr"):
        a = np.asarray(getattr(out_j, name))
        b = getattr(out_t, name).numpy()
        assert a.shape == b.shape == (N_EPOCHS, len(channels)), name
        scale = np.abs(a).max() + 1.0
        assert np.allclose(a, b, atol=2e-4 * scale), (
            name, np.abs(a - b).max(), scale)
    for name in ("carr_freq", "code_freq", "rem_code_phase",
                 "rem_carr_phase"):
        a = np.asarray(getattr(st_j, name))
        b = getattr(st_t, name).numpy()
        assert np.allclose(a, b, rtol=1e-6, atol=1e-4), (name, a, b)
    for name in ("abs_sample", "pilot_period"):
        assert np.array_equal(np.asarray(getattr(st_j, name)),
                              getattr(st_t, name).numpy()), name
    for name in ("abs_sample", "blksize"):
        assert np.array_equal(np.asarray(getattr(out_j, name)),
                              getattr(out_t, name).numpy()), name


def test_per_row_end_sample_freezes_rows_at_their_own_ends():
    _, port, channels = _setup("gps_l1ca")
    iq, sb_start, tables, ptables, state, params, n_epochs = port
    spc = 2048
    # row 0 runs to the end, row 1 stops after 3 epochs, row 2 never starts
    ends = torch.tensor([iq.shape[0] // 2, channels[1][2] + 3 * spc + 40,
                         channels[2][2] + 100])
    st, out = teng.track_superblock(*port, end_sample=ends)
    full_st, full = teng.track_superblock(*port)
    valid = (out.blksize > 0).numpy()
    assert valid[:, 0].all() and not valid[:, 2].any()
    assert valid[:3, 1].all() and not valid[3:, 1].any()
    assert st.active.tolist() == [True, False, False]
    # a frozen row keeps its state, writes zero sums and repeats its
    # abs_sample; the rows before their ends are the unbounded run's
    assert torch.equal(out.i_p[valid], full.i_p[valid])
    assert not out.i_p[~valid].any() and not out.dll_filt[~valid].any()
    assert st.abs_sample[1] == out.abs_sample[3, 1] == out.abs_sample[-1, 1]
    assert st.abs_sample[2] == channels[2][2]
    assert st.abs_sample[0] == full_st.abs_sample[0]
    assert torch.equal(st.carr_freq[:1], full_st.carr_freq[:1])
    assert st.carr_freq[1] == out.carr_freq[3, 1]


def test_superblock_kernel_is_registered_and_takes_cuda_tensors_only():
    assert "superblock" in tcorr.SOURCES
    assert (tcorr.CSRC_DIR / "superblock.cu").is_file()
    for name in ("track_superblock", "track_superblock_pilot",
                 "track_superblock_dual_pilot"):
        assert name in tcorr.LAUNCHES
    # int8 launches count under the variant, int16 ones under
    # "<variant>[int16]"
    int8 = [n for n in tcorr.LAUNCHES if not n.endswith("[int16]")]
    assert tcorr.SUPERBLOCK_VARIANTS == tuple(
        n for n in int8 if n.startswith("track_superblock")
        and n not in tcorr.STAGED_SUPERBLOCK_VARIANTS)
    assert tuple(n + "[int16]" for n in tcorr.SUPERBLOCK_VARIANTS) == tuple(
        n for n in tcorr.LAUNCHES if n.startswith("track_superblock")
        and n.endswith("[int16]") and "staged" not in n)
    assert [tcorr.cluster_size(c) for c in (6, 12, 15, 16, 17, 33, 48, 66,
                                            67, 96)] == [
        8, 8, 8, 8, 4, 4, 2, 2, 1, 1]
    _, port, _ = _setup("gps_l1ca")
    iq, sb_start, tables, _, state, params, n_epochs = port
    end = torch.full((3,), iq.shape[0] // 2)
    before = dict(tcorr.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tcorr.track_superblock_bank(
            iq, sb_start, tables, None, *teng.pack_state(state), end,
            n_epochs, params, up_margin=teng.UP_MARGIN)
    assert tcorr.LAUNCHES == before


def _l1_scene(n_ms):
    from cusdr_tpu_torch.io.synth import (SynthSV, quantize_iq_int8,
                                          synthesize_if)
    cfg = t_get_config("gps_l1ca", sampling_freq=2.048e6, if_freq=7000.0,
                       superblock_ms=20, lock_detect=False)
    sig = t_get_signal("gps_l1ca")
    svs = [SynthSV(prn=3, code_phase=200.0, doppler_hz=1200.0,
                   cn0_dbhz=48.0)]
    iq = quantize_iq_int8(synthesize_if(cfg, sig, svs, num_ms=n_ms, seed=5))
    return cfg, sig, iq, [(3, 7000.0 + 1200.0, 200)]


def test_drain_raises_when_a_window_left_its_superblocks_buffer(monkeypatch):
    cfg, sig, iq, channels = _l1_scene(70)
    res = teng.track(cfg, sig, iq, channels, "cpu", n_epochs=60)
    assert res.status == ["T"] and res.i_p.shape == (1, 60)

    real = teng.track_superblock
    calls = []

    def drifted(iq_sb, sb_start, *args):
        """The second superblock reports windows far outside its buffer,
        as a channel whose block size ran away from the analytic bounds
        would."""
        st, out = real(iq_sb, sb_start, *args)
        calls.append(sb_start)
        if len(calls) == 2:
            out = out._replace(abs_sample=out.abs_sample
                               + iq_sb.shape[0] // 2)
        return st, out

    monkeypatch.setattr(teng, "track_superblock", drifted)
    with pytest.raises(RuntimeError, match=r"PRN 3.*outside its superblock"):
        teng.track(cfg, sig, iq, channels, "cpu", n_epochs=60)
    assert len(calls) == 3         # the drain lags the dispatch by one


def test_entry_points_default_to_the_card(tmp_path):
    """No device named means CUDA: here, without a card, both entry points
    raise and say so; nothing runs on the CPU unasked."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default would run on it")
    with pytest.raises(RuntimeError, match="(?i)cuda"):
        Receiver(t_get_config("gps_l1ca"))
    path = tmp_path / "if.bin"
    np.zeros(4 * 2 * 2048, np.int8).tofile(path)
    with pytest.raises(RuntimeError, match="(?i)cuda"):
        cli_main(["run", "--file", str(path), "--fs", "2.048e6"])
    assert Receiver(t_get_config("gps_l1ca"), "cpu").device.type == "cpu"
