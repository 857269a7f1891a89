"""The port runs where jax and the reference package are absent, as on a
GPU machine: each case runs in a subprocess that sets
``sys.modules['jax'] = None`` (so any jax import raises) before importing
``cusdr_tpu_torch``; one case runs from a copy of the tree that has no
``cusdr_tpu/`` directory at all."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np

from test_torch_threads import THREADS

ROOT = Path(__file__).resolve().parents[1]

BLOCK_JAX = "import sys; sys.modules['jax'] = None\n"


def _run(code: str, *args, timeout=240, root=ROOT):
    env = dict(os.environ, PYTHONPATH=str(root),
               OMP_NUM_THREADS=str(THREADS))
    res = subprocess.run([sys.executable, "-c", BLOCK_JAX + code, *args],
                         cwd=root, env=env, capture_output=True, text=True,
                         timeout=timeout)
    assert res.returncode == 0, res.stdout + res.stderr
    return res.stdout


def test_host_layers_and_port_modules_import_without_jax():
    out = _run(textwrap.dedent("""
        import importlib, os
        mods = ["config", "constants", "signals.defs", "signals.codes",
                "io", "io.ingest", "io.synth", "io.scenario", "nav",
                "nav.lnav", "nav.dispatch", "nav.cnav", "pvt", "pvt.lsq",
                "pvt.pseudorange", "geodesy", "orbits", "orbits.kepler",
                "runtime"]
        port = os.path.join(os.getcwd(), "cusdr_tpu_torch") + os.sep
        for m in mods + ["receiver", "__main__", "tracking.engine",
                         "tracking.qmboc", "tracking.multi",
                         "acquisition.pcps", "ops.correlator",
                         "parallel.timeblocks", "parallel.mesh",
                         "parallel.distributed", "runtime.profiling",
                         "tools.perf_correlator", "checkpoint",
                         "plotting"]:
            mod = importlib.import_module("cusdr_tpu_torch." + m)
            assert mod.__file__.startswith(port), mod.__file__
        assert sys.modules["jax"] is None
        assert not any(k == "cusdr_tpu" or k.startswith("cusdr_tpu.")
                       for k in sys.modules)
        print("ok", len(mods))
        """))
    assert out.split() == ["ok", "19"]


def test_acquisition_and_tracking_pass_without_jax():
    out = _run(textwrap.dedent("""
        from cusdr_tpu_torch import get_config
        from cusdr_tpu_torch.io.synth import (SynthSV,
            quantize_iq_int8, synthesize_if)
        from cusdr_tpu_torch.signals.defs import get_signal
        from cusdr_tpu_torch.receiver import Receiver
        cfg = get_config("gps_l1ca", sampling_freq=2.048e6, if_freq=7000.0,
                         acq_satellite_list=(3, 7, 12))
        sig = get_signal("gps_l1ca")
        svs = [SynthSV(prn=7, code_phase=500.0, doppler_hz=1500.0,
                       cn0_dbhz=48),
               SynthSV(prn=12, code_phase=1500.0, doppler_hz=-2300.0,
                       cn0_dbhz=46)]
        iq = quantize_iq_int8(synthesize_if(cfg, sig, svs, num_ms=400,
                                            seed=4))
        res = Receiver(cfg, "cpu").run(iq)
        ip = abs(res.track.i_p[:, -100:]).mean(axis=1)
        qp = abs(res.track.q_p[:, -100:]).mean(axis=1)
        print(sorted(c[0] for c in res.channels), res.track.i_p.shape[1],
              bool((ip > 5 * qp).all()), res.track.status)
        assert sys.modules["jax"] is None
        """))
    prns, rest = out.split("]", 1)
    assert prns == "[7, 12"
    n_ep, locked, status = rest.split(maxsplit=2)
    assert int(n_ep) > 300 and locked == "True"
    assert status.strip() == "['T', 'T']"


def test_cpu_smoke_runs_without_the_reference_package(tmp_path):
    """A copy of the tree with no ``cusdr_tpu/`` directory: the port's
    modules import and a short ``track_superblock`` (and a two-block
    time-parallel pass, and ``track_multi`` of the bank beside itself) run
    on the CPU."""
    import shutil
    shutil.copytree(ROOT / "cusdr_tpu_torch", tmp_path / "cusdr_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "build",
                                                  "*.so"))
    assert not (tmp_path / "cusdr_tpu").exists()
    out = _run(textwrap.dedent("""
        import os
        import numpy as np, torch
        import cusdr_tpu_torch
        from cusdr_tpu_torch import get_config
        from cusdr_tpu_torch.io.synth import (SynthSV, quantize_iq_int8,
            synthesize_if)
        from cusdr_tpu_torch.parallel.timeblocks import track_time_parallel
        from cusdr_tpu_torch.signals.defs import get_signal
        from cusdr_tpu_torch.tracking import engine
        assert cusdr_tpu_torch.__file__.startswith(os.getcwd())
        assert not os.path.exists("cusdr_tpu")
        cfg = get_config("gps_l1ca", sampling_freq=2.048e6, if_freq=7000.0)
        sig = get_signal("gps_l1ca")
        svs = [SynthSV(prn=7, code_phase=500.0, doppler_hz=1500.0,
                       cn0_dbhz=48)]
        iq = quantize_iq_int8(synthesize_if(cfg, sig, svs, num_ms=90,
                                            seed=4))
        chans = [(7, 8500.0, 500)]
        params = engine.make_track_params(cfg, sig)
        ct, pt = engine.build_replica_tables(cfg, sig, params, chans,
                                             [1500.0])
        st = engine.init_channel_state(chans, sig.chip_rate_hz, "cpu",
                                       dopplers=[1500.0],
                                       carrier_freq_hz=sig.carrier_freq_hz)
        st, outs = engine.track_superblock(torch.from_numpy(iq), 0,
                                           torch.from_numpy(ct), None, st,
                                           params, 40)
        i_p = outs.i_p[-20:, 0].abs().mean()
        q_p = outs.q_p[-20:, 0].abs().mean()
        res = track_time_parallel(cfg, sig, iq, chans, 80, 2, device="cpu")
        from cusdr_tpu_torch.tracking.multi import track_multi
        two = track_multi([(cfg, sig, iq, chans)] * 2, n_ms=40,
                          device="cpu")
        assert (two[0].i_p == two[1].i_p).all()
        assert (two[0].i_p == outs.i_p.numpy().T).all()
        assert sys.modules["jax"] is None
        assert not any(k == "cusdr_tpu" or k.startswith("cusdr_tpu.")
                       for k in sys.modules)
        print(bool(i_p > 3 * q_p), int(st.abs_sample[0]) > 40 * 2047,
              res.i_p.shape, res.status)
        """), root=tmp_path)
    assert out.strip() == "True True (1, 80) ['T']"


def test_cli_runs_without_jax(tmp_path):
    from cusdr_tpu.io.synth import SynthSV, synthesize_if, quantize_iq_int8
    from cusdr_tpu import get_config
    from cusdr_tpu.signals.defs import get_signal
    cfg = get_config("gps_l1ca", sampling_freq=2.048e6, if_freq=7000.0)
    iq = quantize_iq_int8(synthesize_if(
        cfg, get_signal("gps_l1ca"),
        [SynthSV(prn=5, code_phase=300.0, doppler_hz=900.0, cn0_dbhz=48)],
        num_ms=300, seed=2))
    f = tmp_path / "l1.bin"
    iq.tofile(f)
    cli = ("import runpy; sys.argv = ['cusdr_tpu_torch'] + sys.argv[1:]; "
           "runpy.run_module('cusdr_tpu_torch', run_name='__main__')")
    out = _run(cli, "signals")
    assert "gps_l1ca" in out
    out = _run(cli, "run", "--signal", "gps_l1ca", "--file", str(f),
               "--fs", "2.048e6", "--if-freq", "7000", "--prns", "4,5,6",
               "--ms", "250", "--device", "cpu", "--out",
               str(tmp_path / "out"))
    assert "acquisition: 1 channels (PRN 5)" in out
    assert "tracking:" in out
    assert np.isfinite(float(out.split("tracking: ")[1].split()[0]))
    # its checkpoints and plots
    for name in ("acqResults.npz", "trkResults.npz", "acquisition.png",
                 "tracking_ch0.png"):
        assert (tmp_path / "out" / name).is_file(), name
