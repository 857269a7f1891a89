"""The port's checkpoints, stage timing and CLI outputs: the mirror of
tests/test_checkpoint_profiling.py (its scene: gps_l1ca at 2.048 Msps, one
SV at 50 dB-Hz, 300 ms).

- Round trips of the acquisition, tracking and channel-state files; a
  channel state saved by the reference's ``save_channel_state`` loads into
  the port's ``load_channel_state`` and tracks on to the reference's next
  outputs (the closed-loop tolerances of the port's fast-path parity
  tests: ``abs_sample`` equal, sums within 2e-4 of the largest, loop state
  rtol 1e-6 atol 1e-4).
- ``StageTimer.report``; ``device_trace`` as a no-op, and writing a
  Chrome trace on the CPU.
- ``python -m cusdr_tpu_torch run --device cpu --out D`` writes the three
  checkpoints; a rerun with ``--skip-acquisition D/acqResults.npz`` gives
  the same tracking outputs; ``probe`` writes its PNG.
- ``show_channel_status`` renders ``best_channels``' 4-tuples.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from cusdr_tpu import checkpoint as j_checkpoint
from cusdr_tpu.tracking import engine as jeng
from cusdr_tpu_torch import checkpoint
from cusdr_tpu_torch import get_config as t_get_config
from cusdr_tpu_torch.acquisition.pcps import acquire
from cusdr_tpu_torch.io.synth import quantize_iq_int8
from cusdr_tpu_torch.runtime.profiling import StageTimer, device_trace
from cusdr_tpu_torch.signals.defs import get_signal as t_get_signal
from cusdr_tpu_torch.tracking import engine as teng

from test_checkpoint_profiling import PRN, scene  # noqa: F401 (fixture)
from test_torch_convert import torch_params, torch_tables
from test_torch_threads import THREADS, few_torch_threads  # noqa: F401

SUM_RTOL = 2e-4
STATE_RTOL, STATE_ATOL = 1e-6, 1e-4


def _port(scene):  # noqa: F811
    cfg, sig, sv, samples = scene
    tcfg = t_get_config("gps_l1ca", sampling_freq=cfg.sampling_freq,
                        if_freq=cfg.if_freq,
                        acq_satellite_list=cfg.acq_satellite_list,
                        acq_threshold=cfg.acq_threshold)
    return tcfg, t_get_signal("gps_l1ca"), samples


@pytest.fixture(scope="module")
def port_acq(scene):  # noqa: F811
    cfg, sig, samples = _port(scene)
    return acquire(cfg, sig, samples, "cpu")


class TestCheckpoints:
    def test_acquisition_roundtrip(self, port_acq, tmp_path):
        acq = port_acq
        p = tmp_path / "acq.npz"
        checkpoint.save_acquisition(p, acq)
        a2 = checkpoint.load_acquisition(p)
        assert np.array_equal(a2.prns, acq.prns)
        assert np.array_equal(a2.detected, acq.detected)
        assert np.allclose(a2.carr_freq, acq.carr_freq)
        assert a2.best_channels(4) == acq.best_channels(4)

    def test_tracking_roundtrip(self, scene, port_acq, tmp_path):  # noqa: F811
        cfg, sig, samples = _port(scene)
        chans = port_acq.best_channels(2)
        trk = teng.track(cfg, sig, quantize_iq_int8(samples), chans, "cpu",
                         n_epochs=120)
        p = tmp_path / "trk.npz"
        checkpoint.save_tracking(p, trk)
        t2 = checkpoint.load_tracking(p, cfg)
        assert list(t2.prns) == list(trk.prns)
        assert np.allclose(t2.i_p, trk.i_p)
        assert np.allclose(t2.abs_sample, trk.abs_sample)
        assert np.allclose(t2.cno[0], trk.cno[0], equal_nan=True)
        # the reference reads the port's file
        from cusdr_tpu import get_config
        t3 = j_checkpoint.load_tracking(p, get_config("gps_l1ca"))
        assert np.array_equal(t3.i_p, trk.i_p)

    def test_channel_state_roundtrip(self, tmp_path):
        st = teng.init_channel_state([(PRN, 7000.0, 123, 5)], 1.023e6,
                                     "cpu", dopplers=[0.0],
                                     carrier_freq_hz=1575.42e6)
        p = tmp_path / "state.npz"
        checkpoint.save_channel_state(p, st)
        st2 = checkpoint.load_channel_state(p, "cpu")
        for f in st._fields:
            a, b = getattr(st, f), getattr(st2, f)
            assert a.dtype == b.dtype and torch.equal(a, b), f

    def test_reference_state_tracks_on_in_the_port(
            self, scene, tmp_path):  # noqa: F811
        """The reference tracks 60 epochs and saves its channel state; the
        port loads it and tracks the next 60 epochs as the reference
        does."""
        import jax.numpy as jnp
        jcfg, jsig, sv, samples = scene
        cfg, sig, _ = _port(scene)
        iq = quantize_iq_int8(samples)
        chans = [(PRN, 7000.0 - 900.0, 321)]
        jp = jeng.make_track_params(jcfg, jsig)
        ct, pt = jeng.build_replica_tables(jcfg, jsig, jp, chans, [-900.0])
        st = jeng.init_channel_state(chans, jsig.chip_rate_hz,
                                     dopplers=[-900.0],
                                     carrier_freq_hz=jsig.carrier_freq_hz)
        jiq, end = jnp.asarray(iq), jnp.int64(len(iq) // 2)
        st, _ = jeng.track_superblock(jiq, jnp.int64(0), jnp.asarray(ct),
                                      jnp.asarray(pt), st, jp, 60, end)
        p = tmp_path / "ref_state.npz"
        j_checkpoint.save_channel_state(p, st)
        ref_st, ref = jeng.track_superblock(
            jiq, jnp.int64(0), jnp.asarray(ct), jnp.asarray(pt), st, jp, 60,
            end)
        loaded = checkpoint.load_channel_state(p, "cpu")
        tables, ptables = torch_tables(ct, pt, False)
        got_st, got = teng.track_superblock(
            torch.from_numpy(iq), 0, tables, ptables, loaded,
            torch_params(jp), 60, len(iq) // 2)
        assert np.array_equal(got.abs_sample.numpy(),
                              np.asarray(ref.abs_sample))
        scale = np.abs(np.asarray(ref.i_p)).max() + 1.0
        for f in ("i_e", "q_e", "i_p", "q_p", "i_l", "q_l"):
            assert np.abs(getattr(got, f).numpy()
                          - np.asarray(getattr(ref, f))).max() \
                <= SUM_RTOL * scale, f
        for f in ("carr_freq", "code_freq", "rem_code_phase",
                  "rem_carr_phase"):
            np.testing.assert_allclose(getattr(got_st, f).numpy(),
                                       np.asarray(getattr(ref_st, f)),
                                       rtol=STATE_RTOL, atol=STATE_ATOL,
                                       err_msg=f)
        assert abs(float(got_st.carr_freq[0]) - (7000.0 - 900.0)) < 10.0


class TestProfiling:
    def test_stage_timer_report(self):
        t = StageTimer(sampling_freq=1e6, device="cpu")
        with t.stage("acquisition", samples=2_000_000):
            pass
        with t.stage("tracking", samples=500_000):
            pass
        rep = t.report()
        assert "acquisition" in rep and "tracking" in rep
        assert t.stages["acquisition"].calls == 1
        assert np.isfinite(t.realtime_factor("tracking"))

    def test_device_trace_noop(self):
        with device_trace(None):
            pass

    def test_device_trace_writes_a_chrome_trace(self, tmp_path):
        with device_trace(str(tmp_path / "trace")):
            torch.ones(64).sum()
        trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
        assert trace["traceEvents"]


def _cli(*args, timeout=600):
    env = dict(os.environ, OMP_NUM_THREADS=str(THREADS))
    return subprocess.run([sys.executable, "-m", "cusdr_tpu_torch", *args],
                          capture_output=True, text=True, timeout=timeout,
                          env=env)


def test_cli_run_and_resume(scene, tmp_path):  # noqa: F811
    cfg, sig, sv, samples = scene
    f = tmp_path / "scene.bin"
    quantize_iq_int8(samples).tofile(f)
    out = tmp_path / "out"
    base = ["run", "--signal", "gps_l1ca", "--file", str(f),
            "--fs", "2048000", "--if-freq", "7000", "--ms", "200",
            "--out", str(out), "--no-plots", "--timing",
            "--prns", f"{PRN},{PRN + 4}", "--acq-threshold", "2.5",
            "--device", "cpu"]
    r = _cli(*base)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    for name in ("acqResults.npz", "trkResults.npz"):
        assert (out / name).exists(), name
    assert "tracking" in r.stdout and "TOTAL" in r.stdout
    first = dict(np.load(out / "trkResults.npz"))
    # resume from the acquisition checkpoint
    r2 = _cli(*base, "--skip-acquisition", str(out / "acqResults.npz"))
    assert r2.returncode == 0, r2.stderr[-2000:]
    assert "acquisition reused" in r2.stdout
    again = dict(np.load(out / "trkResults.npz"))
    assert first.keys() == again.keys()
    for k in first:
        assert np.array_equal(first[k], again[k], equal_nan=True), k


def test_cli_probe_writes_its_plot(scene, tmp_path):  # noqa: F811
    cfg, sig, sv, samples = scene
    f = tmp_path / "scene.bin"
    quantize_iq_int8(samples).tofile(f)
    png = tmp_path / "probe.png"
    r = _cli("probe", "--signal", "gps_l1ca", "--file", str(f), "--fs",
             "2048000", "--if-freq", "7000", "--out", str(png))
    assert r.returncode == 0, r.stderr[-2000:]
    assert png.read_bytes()[:4] == b"\x89PNG"


def test_show_channel_status_on_best_channels(port_acq, scene):  # noqa: F811
    from cusdr_tpu_torch.plotting import show_channel_status
    cfg, _, _ = _port(scene)
    chans = port_acq.best_channels(4)
    assert chans and len(chans[0]) == 4
    table = show_channel_status(chans, port_acq, cfg)
    assert f"| {PRN:3d} |" in table
