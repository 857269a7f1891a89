"""The port runs where jax is absent, as on a GPU machine: each case runs
in a subprocess that sets ``sys.modules['jax'] = None`` (so any jax import
raises) before importing ``cusdr_tpu_torch``."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np

from test_torch_threads import THREADS

ROOT = Path(__file__).resolve().parents[1]

BLOCK_JAX = "import sys; sys.modules['jax'] = None\n"


def _run(code: str, *args, timeout=240):
    env = dict(os.environ, PYTHONPATH=str(ROOT),
               OMP_NUM_THREADS=str(THREADS))
    res = subprocess.run([sys.executable, "-c", BLOCK_JAX + code, *args],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=timeout)
    assert res.returncode == 0, res.stdout + res.stderr
    return res.stdout


def test_host_layers_and_port_modules_import_without_jax():
    out = _run(textwrap.dedent("""
        import importlib
        mods = ["config", "constants", "signals.defs", "signals.codes",
                "io", "io.ingest", "io.synth", "io.scenario", "nav",
                "nav.lnav", "nav.dispatch", "nav.cnav", "pvt", "pvt.lsq",
                "pvt.pseudorange", "geodesy", "orbits", "orbits.kepler",
                "runtime"]
        for m in mods:
            mod = importlib.import_module("cusdr_tpu_torch.host." + m)
            assert "/cusdr_tpu/" in mod.__file__, mod.__file__
        for m in ["cusdr_tpu_torch", "cusdr_tpu_torch.receiver",
                  "cusdr_tpu_torch.__main__",
                  "cusdr_tpu_torch.tracking.engine",
                  "cusdr_tpu_torch.tracking.qmboc",
                  "cusdr_tpu_torch.acquisition.pcps",
                  "cusdr_tpu_torch.ops.correlator"]:
            importlib.import_module(m)
        assert sys.modules["jax"] is None
        assert not any(k == "cusdr_tpu" or k.startswith("cusdr_tpu.")
                       for k in sys.modules)
        print("ok", len(mods))
        """))
    assert out.split() == ["ok", "19"]


def test_acquisition_and_tracking_pass_without_jax():
    out = _run(textwrap.dedent("""
        from cusdr_tpu_torch import get_config
        from cusdr_tpu_torch.host.io.synth import (SynthSV,
            quantize_iq_int8, synthesize_if)
        from cusdr_tpu_torch.host.signals.defs import get_signal
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
               "--ms", "250", "--device", "cpu")
    assert "acquisition: 1 channels (PRN 5)" in out
    assert "tracking:" in out
    assert np.isfinite(float(out.split("tracking: ")[1].split()[0]))
