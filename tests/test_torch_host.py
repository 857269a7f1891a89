"""The port's own copies of the reference's numpy layers stay verbatim.

The port imports nothing of ``cusdr_tpu`` (whose package ``__init__``
imports jax), so it keeps copies of ``config``, ``constants``, ``signals``,
``io``, ``nav``, ``pvt``, ``geodesy``, ``orbits``, the native ingest loader
of ``runtime``, ``tracking.cno``, ``tracking.loop_filters``,
``tracking.qmboc`` and ``acquisition.resample``.  A copy that drifts from
its original would make the two packages disagree, so every copied file is
held to its original byte for byte.  Two copies are edited:
``nav/dispatch.py`` differs only inside ``decode_lnav``, where a comment
says that ``..receiver`` is the port's own module, and ``plotting.py``
(numpy and matplotlib only) only in ``probe_data``'s histogram line, which
calls ``np.ptp``: the reference's ``ndarray.ptp`` is gone from NumPy 2,
so the reference's ``probe`` raises there."""

from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

COPIED_DIRS = ("signals", "io", "nav", "pvt", "geodesy", "orbits")
EDITED = {"nav/dispatch.py", "plotting.py"}
SUFFIXES = {".py", ".npz", ".c"}


def _copied_files():
    rels = ["config.py", "constants.py", "plotting.py", "tracking/cno.py",
            "tracking/loop_filters.py", "tracking/qmboc.py",
            "acquisition/resample.py", "runtime/__init__.py",
            "runtime/native.c", "runtime/Makefile"]
    for d in COPIED_DIRS:
        rels += sorted(
            str(p.relative_to(ROOT / "cusdr_tpu"))
            for p in (ROOT / "cusdr_tpu" / d).rglob("*")
            if p.is_file() and p.suffix in SUFFIXES)
    return [r for r in rels if r not in EDITED]


@pytest.mark.parametrize("rel", _copied_files())
def test_copy_equals_reference(rel):
    assert (ROOT / "cusdr_tpu_torch" / rel).read_bytes() == \
        (ROOT / "cusdr_tpu" / rel).read_bytes()


def test_copied_layers_are_complete():
    """Every module of the copied reference packages has its copy (and the
    jax-importing runtime modules have none)."""
    rels = _copied_files()
    assert len(rels) >= 45
    for d in COPIED_DIRS:
        assert (ROOT / "cusdr_tpu_torch" / d / "__init__.py").is_file()
    assert len([r for r in rels if r.endswith(".npz")]) == 8
    for name in ("cache.py", "profiling.py"):
        src = (ROOT / "cusdr_tpu" / "runtime" / name).read_text()
        assert "import jax" in src
    assert not (ROOT / "cusdr_tpu_torch" / "runtime" / "cache.py").exists()
    assert not (ROOT / "cusdr_tpu_torch" / "host").exists()


def _outside_function(text: str, name: str) -> str:
    """``text`` without the body of top-level function ``name``."""
    lines = text.splitlines()
    start = lines.index(next(l for l in lines
                             if l.startswith(f"def {name}(")))
    end = next(i for i in range(start + 1, len(lines))
               if lines[i] and not lines[i][0].isspace())
    return "\n".join(lines[:start] + lines[end:])


def test_edited_copy_differs_only_in_decode_lnav():
    ref = (ROOT / "cusdr_tpu" / "nav" / "dispatch.py").read_text()
    got = (ROOT / "cusdr_tpu_torch" / "nav" / "dispatch.py").read_text()
    assert got != ref
    assert _outside_function(got, "decode_lnav") == \
        _outside_function(ref, "decode_lnav")
    # inside it, only a comment was added
    code = lambda t: [l for l in t.splitlines()
                      if not l.strip().startswith("#")]
    assert code(got) == code(ref)


def test_plotting_copy_differs_only_in_ptp():
    ref = (ROOT / "cusdr_tpu" / "plotting.py").read_text().splitlines()
    got = (ROOT / "cusdr_tpu_torch" / "plotting.py").read_text().splitlines()
    assert len(got) == len(ref)
    diff = [(a, b) for a, b in zip(ref, got) if a != b]
    assert diff == [(
        "    ax.hist(x.real, bins=np.arange(-130, 131) if x.real.ptp() > 20",
        "    ax.hist(x.real, bins=np.arange(-130, 131) if np.ptp(x.real) > 20",
    )]


def test_plotting_copy_draws_every_figure(tmp_path):
    """The port's plotting module on a small tracking and navigation
    result: every figure renders, and ``probe_data`` (which the
    reference's ``ndarray.ptp`` breaks under NumPy 2) too."""
    import types
    import numpy as np
    from cusdr_tpu_torch import get_config
    from cusdr_tpu_torch import plotting
    cfg = get_config("gps_l1ca", sampling_freq=2.048e6)
    rng = np.random.default_rng(0)
    iq = (rng.integers(-30, 30, 40000)
          + 1j * rng.integers(-30, 30, 40000)).astype(np.complex64)
    acq = types.SimpleNamespace(prns=np.arange(1, 5),
                                detected=np.array([1, 0, 1, 0], bool),
                                peak_metric=np.array([5.0, 1.0, 4.0, 1.2]))
    n = 60
    trk = types.SimpleNamespace(
        prns=[1, 3], cno={0: np.full(3, 45.0), 1: np.full(3, 44.0)},
        **{f: rng.normal(size=(2, n)) for f in (
            "i_p", "q_p", "i_e", "q_e", "i_l", "q_l", "pll_discr",
            "dll_discr")})
    nav = types.SimpleNamespace(
        E=rng.normal(size=8), N=rng.normal(size=8), U=rng.normal(size=8),
        az=rng.uniform(0, 360, (8, 2)), el=rng.uniform(10, 80, (8, 2)))
    figs = [plotting.probe_data(iq, cfg), plotting.plot_acquisition(acq),
            plotting.plot_tracking(trk, 1, cfg),
            plotting.plot_navigation(nav), plotting.sky_plot(nav, trk.prns)]
    for k, fig in enumerate(figs):
        fig.savefig(tmp_path / f"{k}.png", dpi=40)
        assert (tmp_path / f"{k}.png").read_bytes()[:4] == b"\x89PNG"


def test_port_modules_live_in_the_port():
    import cusdr_tpu_torch.config as hc
    import cusdr_tpu_torch.nav.dispatch as nd
    import cusdr_tpu_torch.receiver as rx
    import cusdr_tpu_torch.signals.defs as hd
    port = ROOT / "cusdr_tpu_torch"
    assert Path(hc.__file__) == port / "config.py"
    assert Path(hd.__file__) == port / "signals" / "defs.py"
    assert hc.get_config("gps_l1ca") == hc.get_config("gps_l1ca")
    assert hc.get_config("gps_l1ca").samples_per_code == 18000
    # the LNAV adapter reaches the port's decoder
    assert nd.decode_lnav.__module__ == "cusdr_tpu_torch.nav.dispatch"
    assert nd.decode_lnav.__globals__["__package__"] == "cusdr_tpu_torch.nav"
    assert rx.decode_nav_channel.__module__ == "cusdr_tpu_torch.receiver"


def test_cuda_device_requires_a_card():
    """The port never falls back to the CPU: asking for CUDA without a
    card raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from cusdr_tpu_torch import get_config
    from cusdr_tpu_torch.receiver import Receiver
    with pytest.raises(RuntimeError, match="cuda"):
        Receiver(get_config("gps_l1ca"), "cuda")
