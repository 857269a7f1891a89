"""The port's multi-process runtime: two gloo processes tracking over a 2-D
(ch x tb) mesh that spans both, the counterpart of tests/test_multihost.py.

The test runs this file twice as a worker (the ``__main__`` block).  Each
worker imports no jax, joins a two-process gloo group on a free port with
two local ``"cpu"`` entries, builds the 2x2 mesh with 'ch' across the
processes and 'tb' across each one's entries, and tracks
tests/multihost_worker.py's scene time-parallel over it (4 blocks, three
handoff passes).  Its stitched result must match its own sequential
``track`` at the reference worker's criteria (``abs_sample`` exact,
frequencies atol 1e-6, prompts rtol 1e-4 atol 0.5); it writes the result
to the test's directory.  The test then checks that both ranks returned
the same result, element for element, and holds it to the reference's
``track_time_parallel`` on a single-process 2x2 virtual mesh at the port's
time-parallel parity tolerances (tests/test_torch_timeblocks.py: the two
packages add their sums in other orders).  A worker that does not finish
within its timeout is killed and fails the test.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
N_EPOCHS, N_BLOCKS = 80, 4
FIELDS = ("i_e", "q_e", "i_p", "q_p", "i_l", "q_l", "carr_freq",
          "code_freq", "abs_sample", "blksize", "active_until")
WORKER_TIMEOUT_S = 300


def _scene():
    """tests/multihost_worker.py's scene, made by the port's copy of the
    synthesizer (the same numpy code as the reference's)."""
    from cusdr_tpu_torch import get_config
    from cusdr_tpu_torch.io.synth import (SynthSV, quantize_iq_int8,
                                          synthesize_if)
    from cusdr_tpu_torch.signals.defs import get_signal
    cfg = get_config("gps_l1ca", sampling_freq=1.024e6, if_freq=7000.0)
    sig = get_signal("gps_l1ca")
    rng = np.random.default_rng(0)
    svs = [SynthSV(prn=7, code_phase=123.0, doppler_hz=2500.0, cn0_dbhz=47,
                   nav_bits=rng.choice(np.asarray([-1, 1], np.int8), 40)),
           SynthSV(prn=13, code_phase=400.2, doppler_hz=-3200.0,
                   cn0_dbhz=45,
                   nav_bits=rng.choice(np.asarray([-1, 1], np.int8), 40))]
    iq = quantize_iq_int8(synthesize_if(cfg, sig, svs,
                                        num_ms=N_EPOCHS + 10, seed=3))
    return cfg, sig, iq, [(7, 9500.0, 123), (13, 3800.0, 401)]


def _worker(port: str, pid: int, out_dir: str) -> None:
    sys.modules["jax"] = None          # any jax import raises
    import torch
    import torch.distributed as dist
    from test_torch_threads import THREADS
    torch.set_num_threads(THREADS)
    from cusdr_tpu_torch.parallel.distributed import (init_distributed,
                                                      make_mesh_2d)
    from cusdr_tpu_torch.parallel.timeblocks import track_time_parallel
    from cusdr_tpu_torch.tracking.engine import track

    init_distributed(f"localhost:{port}", num_processes=2, process_id=pid,
                     local_device_ids=[0, 1])
    try:
        mesh = make_mesh_2d(n_ch=2, n_tb=2, device="cpu")
        assert mesh.ranks.tolist() == [[0, 0], [1, 1]], mesh
        assert mesh.spans_processes and mesh.rank == pid
        cfg, sig, iq, chans = _scene()
        par = track_time_parallel(cfg, sig, iq, chans, N_EPOCHS, N_BLOCKS,
                                  handoff_iters=N_BLOCKS - 1, mesh=mesh)
        seq = track(cfg, sig, iq, chans, "cpu", n_epochs=N_EPOCHS)
    finally:
        dist.destroy_process_group()
    np.testing.assert_array_equal(par.abs_sample, seq.abs_sample)
    for f in ("carr_freq", "code_freq"):
        np.testing.assert_allclose(getattr(par, f), getattr(seq, f),
                                   rtol=0, atol=1e-6)
    for f in ("i_p", "q_p"):
        np.testing.assert_allclose(getattr(par, f), getattr(seq, f),
                                   rtol=1e-4, atol=0.5)
    assert not {"jax", "cusdr_tpu"} & {m.split(".")[0] for m, v
                                       in sys.modules.items() if v is not None}
    np.savez(Path(out_dir) / f"rank{pid}.npz",
             status=np.asarray(par.status),
             **{f: getattr(par, f) for f in FIELDS})
    print(f"proc {pid}: multihost parity OK (mesh ch x tb = "
          f"{mesh.devices.shape}, ranks {mesh.ranks.tolist()})", flush=True)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_tracking_parity(tmp_path):
    from test_torch_threads import THREADS
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT),
               OMP_NUM_THREADS=str(THREADS))
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(port), str(pid), str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=ROOT, env=env) for pid in range(2)]
    try:
        # the reference on a single-process 2x2 virtual mesh, meanwhile
        import jax
        from jax.sharding import Mesh
        from cusdr_tpu import get_config
        from cusdr_tpu.parallel.timeblocks import track_time_parallel
        from cusdr_tpu.signals.defs import get_signal
        _, _, iq, chans = _scene()
        ref = track_time_parallel(
            get_config("gps_l1ca", sampling_freq=1.024e6, if_freq=7000.0),
            get_signal("gps_l1ca"), iq, chans, n_epochs=N_EPOCHS,
            n_blocks=N_BLOCKS, handoff_iters=N_BLOCKS - 1,
            mesh=Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                      ("ch", "tb")))
        outs = [p.communicate(timeout=WORKER_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out[-3000:]}"
        assert "multihost parity OK" in out, out[-1000:]
    got = [np.load(tmp_path / f"rank{pid}.npz") for pid in range(2)]
    for f in FIELDS + ("status",):
        assert np.array_equal(got[0][f], got[1][f]), f
    res = got[0]
    assert res["i_p"].shape == (2, N_EPOCHS)
    assert list(res["status"]) == ref.status
    for f in ("abs_sample", "blksize", "active_until"):
        assert np.array_equal(res[f], getattr(ref, f)), f
    for f in FIELDS[:6]:
        a = getattr(ref, f)
        assert np.abs(res[f] - a).max() <= 2e-4 * (np.abs(a).max() + 1.0), f
    for f in ("carr_freq", "code_freq"):
        np.testing.assert_allclose(res[f], getattr(ref, f), rtol=0,
                                   atol=1e-3)


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    _worker(sys.argv[1], int(sys.argv[2]), sys.argv[3])
