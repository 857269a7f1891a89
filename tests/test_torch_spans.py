"""The port's spans (``runtime.profiling.span``) on the CPU.

A 1.2 s gps_l1ca record at 2.048 Msps, three SVs, in superblocks of 200
ms, run by ``Receiver.run`` once with no profiler and once under
``torch.profiler`` (CPU activity):

- with no profiler the run enters no ``record_function`` (it is patched to
  raise) and ``timings`` holds exactly its three stage keys;
- under the profiler every span the record reaches is a range in the
  kineto events, each inside its stage's range (``trk.wait`` inside
  ``trk.stage`` or ``trk.drain``); the record reaches no long-pilot search
  (gps_l1ca has none) and no fix (no frame in 1.2 s), so
  ``acq.pilot_phase`` and ``nav.pvt`` are not among them;
- ``trk.launch``'s calls equal the superblocks of the window plan, every
  ``*_s`` total is >= 0, and each stage's direct sub-spans sum to no more
  than the stage's seconds (``trk.wait``, nested, counted once);
- the results (acquisition, every ``TrackResults`` field, fixes) are equal
  element for element with tracing on and off;
- under the profiler ``timings`` also carries the lock gate's count of
  dropped channels, ``trk_lock_drops`` (0: every SV holds lock), the
  fine stage's count of the detected PRNs it searched, ``acq_fine_rows``,
  and ``acq_codes_hit``: 1, since the untraced run before it built the
  code spectra of the same key.

``nav.fec``: navigation's decode of an F/NAV prompt stream (pages with
their sync words, the secondary code on every symbol) opens it inside
``nav.decode`` for each page it de-interleaves and Viterbi-decodes, and
``timings`` carries ``nav_fec_s`` only under a profiler; LNAV opens none.

Also ``StageTimer``'s span collection and report, a span's own seconds with
no profiler, and the CLI's ``--profile``: one trace of the whole run with
every stage's spans, and their totals printed under their stages.  And the
layering: ``runtime/profiling.py``, which every layer that opens spans
imports, loads no tracking, acquisition, signals or ops module itself.
"""

import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cusdr_tpu_torch import get_config
from cusdr_tpu_torch.acquisition import pcps
from cusdr_tpu_torch.io.synth import SynthSV, quantize_iq_int8, synthesize_if
from cusdr_tpu_torch.nav import galileo_nav
from cusdr_tpu_torch.receiver import Receiver, _acquire_record, nav_solve
from cusdr_tpu_torch.runtime import profiling
from cusdr_tpu_torch.runtime.profiling import StageTimer, span
from cusdr_tpu_torch.signals import codes
from cusdr_tpu_torch.signals.defs import get_signal
from cusdr_tpu_torch.tracking import engine

from test_torch_threads import THREADS, few_torch_threads  # noqa: F401

OVER = dict(sampling_freq=2.048e6, if_freq=7000.0, superblock_ms=200,
            acq_satellite_list=(3, 7, 12, 20))
SVS = [SynthSV(prn=3, code_phase=200.0, doppler_hz=1200.0, cn0_dbhz=48.0),
       SynthSV(prn=7, code_phase=900.5, doppler_hz=-800.0, cn0_dbhz=48.0),
       SynthSV(prn=12, code_phase=1500.0, doppler_hz=300.0, cn0_dbhz=48.0)]
RECORD_MS = 1200

STAGES = ("acquisition", "tracking", "navigation")
# each stage's direct sub-spans, in the order the stage opens them
SUB_SPANS = {"acquisition": ("acq.input", "acq.codes", "acq.coarse",
                             "acq.fine"),
             "tracking": ("trk.setup", "trk.stage", "trk.launch",
                          "trk.drain", "trk.results"),
             "navigation": ("nav.decode", "nav.pvt")}
REACHED = {"acq.input", "acq.codes", "acq.coarse", "acq.fine", "trk.setup",
           "trk.stage", "trk.launch", "trk.drain", "trk.wait",
           "trk.results", "nav.decode"}
ALL_SPANS = REACHED | {"acq.pilot_phase", "nav.pvt"}


def _key(name):
    return name.replace(".", "_") + "_s"


@pytest.fixture(scope="module")
def record():
    cfg = get_config("gps_l1ca", **OVER)
    return cfg, quantize_iq_int8(synthesize_if(
        cfg, get_signal("gps_l1ca"), SVS, num_ms=RECORD_MS, seed=5))


@pytest.fixture(scope="module")
def runs(record):
    """(untraced result, traced result, the trace's span and stage ranges
    {name: [(start_us, end_us)]})."""
    cfg, iq = record
    rx = Receiver(cfg, "cpu")
    real = torch.profiler.record_function

    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler")

    torch.profiler.record_function = refuse
    try:
        off = rx.run(iq)
    finally:
        torch.profiler.record_function = real
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = rx.run(iq)
    ranges = {}
    for ev in prof.events():
        if ev.name in ALL_SPANS or ev.name in STAGES:
            ranges.setdefault(ev.name, []).append(
                (ev.time_range.start, ev.time_range.end))
    return off, on, ranges


def test_no_profiler_no_record_function_and_three_keys(runs):
    off, _, _ = runs
    assert set(off.timings) == {"acquisition_s", "tracking_s",
                                "navigation_s"}
    assert off.track is not None and len(off.channels) == 3


def test_every_reached_span_lies_inside_its_stage(runs):
    _, _, ranges = runs
    assert set(ranges) == set(STAGES) | REACHED
    for stage in STAGES:
        assert len(ranges[stage]) == 1
    for stage, names in SUB_SPANS.items():
        (a, b), = ranges[stage]
        for name in names:
            for s, e in ranges.get(name, []):
                assert a <= s <= e <= b, (name, stage)
    outer = ranges["trk.stage"] + ranges["trk.drain"]
    for s, e in ranges["trk.wait"]:
        assert any(a <= s <= e <= b for a, b in outer)


def test_launches_equal_the_window_plan(runs, record):
    _, on, ranges = runs
    cfg, _ = record
    sig = get_signal("gps_l1ca")
    n_epochs = on.track.i_p.shape[1]
    plan = engine.superblock_plan(
        n_epochs, min(n_epochs, engine.superblock_epochs(cfg, sig)))
    assert len(plan) >= 5
    assert len(ranges["trk.launch"]) == len(plan)
    assert len(ranges["trk.stage"]) == len(ranges["trk.drain"]) == len(plan)
    assert len(ranges["trk.wait"]) == 2 * len(plan)


def test_totals_reach_timings_and_sum_within_their_stage(runs):
    _, on, _ = runs
    t = on.timings
    want = {f"{s}_s" for s in STAGES} | {_key(n) for n in REACHED}
    assert set(t) == want | {"trk_lock_drops", "acq_fine_rows",
                             "acq_codes_hit"}
    assert t.pop("trk_lock_drops") == 0
    assert t.pop("acq_codes_hit") == 1
    assert t.pop("acq_fine_rows") == on.acq.detected.sum() >= 3
    assert all(v >= 0.0 for v in t.values())
    for stage, names in SUB_SPANS.items():
        assert sum(t.get(_key(n), 0.0) for n in names) <= t[f"{stage}_s"]
    assert t["trk_wait_s"] <= t["trk_stage_s"] + t["trk_drain_s"]


def test_results_equal_with_tracing_on_and_off(runs):
    off, on, _ = runs
    for name in ("prns", "carr_freq", "code_phase", "peak_metric",
                 "detected", "coarse_freq", "pilot_phase"):
        assert np.array_equal(getattr(off.acq, name), getattr(on.acq, name))
    assert set(off.acq.timings) == set(on.acq.timings) == {
        "coarse_s", "pilot_phase_s", "fine_s"}
    assert on.acq.timings["pilot_phase_s"] == 0.0
    assert off.channels == on.channels
    fields = set(vars(off.track))
    assert fields == set(vars(on.track))
    assert {"i_p", "carr_freq", "active_until", "cno", "status"} <= fields
    for name in fields:
        a, b = getattr(off.track, name), getattr(on.track, name)
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            for k in a:
                assert np.array_equal(a[k], b[k]), (name, k)
        else:
            assert np.array_equal(np.asarray(a), np.asarray(b)), name
    assert off.nav is None and on.nav is None


def test_span_with_no_profiler_times_itself_and_adds_to_nothing():
    timer = StageTimer()
    with timer.stage("acquisition"):
        with span("acq.coarse") as s:
            sum(range(1000))
    assert s.seconds > 0.0
    assert timer.stages["acquisition"].spans == {}
    assert timer.seconds() == {"acquisition_s":
                               timer.stages["acquisition"].seconds}
    assert not profiling._OPEN_STAGES


def test_stage_timer_collects_spans_under_a_profiler():
    from torch.profiler import ProfilerActivity, profile
    timer = StageTimer(sampling_freq=1e6)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with timer.stage("tracking", samples=1000):
                with span("trk.launch"):
                    with span("trk.wait"):
                        pass
    with span("trk.launch"):                 # outside every stage
        pass
    rec = timer.stages["tracking"]
    assert rec.calls == 3
    assert {n: r.calls for n, r in rec.spans.items()} == {
        "trk.launch": 3, "trk.wait": 3}
    assert rec.spans["trk.wait"].seconds <= rec.spans["trk.launch"].seconds
    assert rec.spans["trk.launch"].seconds <= rec.seconds
    names = [ev.name for ev in prof.events()]
    assert names.count("tracking") == names.count("trk.wait") == 3
    assert set(timer.seconds()) == {"tracking_s", "trk_launch_s",
                                    "trk_wait_s"}
    lines = timer.report().splitlines()
    assert lines[1].startswith("tracking")
    assert lines[2].split() == ["trk.launch", lines[2].split()[1], "3"]
    assert lines[2].startswith("  trk.launch") and lines[3].startswith(
        "  trk.wait")
    assert not profiling._OPEN_STAGES


def test_cli_profile_traces_the_whole_run(record, tmp_path):
    cfg, iq = record
    f = tmp_path / "rec.bin"
    iq.tofile(f)
    env = dict(os.environ, OMP_NUM_THREADS=str(THREADS))
    out = subprocess.run(
        [sys.executable, "-m", "cusdr_tpu_torch", "run", "--signal",
         "gps_l1ca", "--file", str(f), "--fs", "2048000", "--if-freq",
         "7000", "--prns", "3,7,12,20", "--out", str(tmp_path / "out"),
         "--no-plots", "--device", "cpu", "--profile",
         str(tmp_path / "trace")],
        capture_output=True, text=True, timeout=600, env=env)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    names = {ev.get("name") for ev in trace["traceEvents"]}
    assert set(STAGES) | REACHED <= names
    lines = out.stdout.splitlines()
    i = lines.index(next(x for x in lines if x.startswith("Stage ")))
    table = [x.split()[0] for x in lines[i + 1:]]
    assert table[:6] == ["acquisition", "acq.input", "acq.codes",
                         "acq.coarse", "acq.fine", "tracking"]
    assert "trk.launch" in table and "nav.decode" in table
    assert table.index("navigation") < table.index("nav.decode")


def _navigation(signal, i_p, traced):
    """``nav_solve`` of one channel's prompts ``i_p`` in a "navigation"
    stage, under a profiler or not.  Returns (the stage's timings, the
    trace's "nav.decode" and "nav.fec" ranges)."""
    from torch.profiler import ProfilerActivity, profile
    trk = SimpleNamespace(prns=[4], i_p=i_p[None, :])
    timer = StageTimer()
    if not traced:
        with timer.stage("navigation"):
            assert nav_solve(get_config(signal), get_signal(signal),
                             trk) is None
        return timer.seconds(), {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timer.stage("navigation"):
            assert nav_solve(get_config(signal), get_signal(signal),
                             trk) is None
    ranges = {}
    for ev in prof.events():
        if ev.name in ("nav.decode", "nav.fec"):
            ranges.setdefault(ev.name, []).append(
                (ev.time_range.start, ev.time_range.end))
    return timer.seconds(), ranges


def _fnav_prompts():
    """Three F/NAV pages of random bits behind their sync words, 20 ms
    symbols, each epoch signed by the E5a-I secondary code."""
    rng = np.random.default_rng(7)
    bits = np.concatenate([np.concatenate([galileo_nav.FNAV_SYNC,
                                           rng.integers(0, 2, 488)])
                           for _ in range(3)])
    sec = codes.E5AI_SECONDARY.astype(np.float64)
    return 100.0 * np.repeat(1.0 - 2.0 * bits, 20) * np.tile(sec, len(bits))


@pytest.mark.parametrize("traced", [False, True], ids=["untraced", "traced"])
def test_nav_fec_opens_inside_nav_decode_for_fnav(traced):
    t, ranges = _navigation("gal_e5a", _fnav_prompts(), traced)
    if not traced:
        assert set(t) == {"navigation_s"}
        return
    assert set(t) == {"navigation_s", "nav_decode_s", "nav_fec_s"}
    (a, b), = ranges["nav.decode"]
    assert len(ranges["nav.fec"]) >= 3
    assert all(a <= s <= e <= b for s, e in ranges["nav.fec"])
    assert 0.0 <= t["nav_fec_s"] <= t["nav_decode_s"] <= t["navigation_s"]


def test_lnav_opens_no_nav_fec():
    rng = np.random.default_rng(8)
    t, ranges = _navigation("gps_l1ca", rng.normal(size=40_000), True)
    assert set(t) == {"navigation_s", "nav_decode_s"}
    assert "nav.fec" not in ranges and len(ranges["nav.decode"]) == 1


def test_counters_reach_timings_only_under_a_profiler():
    from torch.profiler import ProfilerActivity, profile
    timer = StageTimer()
    with timer.stage("tracking"):
        profiling.count("trk_lock_drops", 2)
    assert timer.seconds() == {"tracking_s":
                               timer.stages["tracking"].seconds}
    with profile(activities=[ProfilerActivity.CPU]):
        for n in (0, 2, 1):
            with timer.stage("tracking"):
                profiling.count("trk_lock_drops", n)
    profiling.count("trk_lock_drops", 5)          # outside every stage
    assert timer.stages["tracking"].counts == {"trk_lock_drops": 3}
    assert timer.seconds()["trk_lock_drops"] == 3


def test_acq_codes_hit_reads_the_cache_only_under_a_profiler(record):
    """The record's acquisition in an "acquisition" stage: under a
    profiler ``acq_codes_hit`` reads 0 on the first record of a key (the
    spectra built) and 1 on the next (taken from the cache); with no
    profiler it is absent from the stage's timings."""
    from torch.profiler import ProfilerActivity, profile
    cfg, iq = record
    sig = get_signal("gps_l1ca")

    def acquisition():
        timer = StageTimer()
        with timer.stage("acquisition"):
            _acquire_record(cfg, sig, iq, torch.device("cpu"))
        return timer.seconds()

    pcps._code_spectra.cache_clear()
    assert set(acquisition()) == {"acquisition_s"}
    pcps._code_spectra.cache_clear()
    with profile(activities=[ProfilerActivity.CPU]):
        reads = [acquisition()["acq_codes_hit"] for _ in range(2)]
    assert reads == [0, 1]


def test_profiling_imports_no_layer_above_it():
    """In a fresh interpreter ``runtime.profiling`` loads, of the package,
    only what the package's ``__init__`` loads (``config``) and
    ``runtime`` itself."""
    code = ("import sys, cusdr_tpu_torch.runtime.profiling\n"
            "print(*sorted(m for m in sys.modules\n"
            "              if m.startswith('cusdr_tpu_torch.')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = out.stdout.split()
    assert "cusdr_tpu_torch.runtime.profiling" in loaded
    above = [m for m in loaded if m.split(".")[1] in
             ("tracking", "acquisition", "signals", "ops")]
    assert above == []
