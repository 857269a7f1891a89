"""The gal_e5a_lockgate configuration and its cell: the configuration file
states the preset whole (the port's lock-gate test among its settings),
the new per-layer readers return None where the program has nothing to
read, and a planted fault is judged incorrect: a kept channel without
carrier lock.

The fault runs on a tiny E5a cell (10.23 Msps, superblocks of 200 ms, 1.2
s captures, four SVs 15 Hz past the midpoint between two coarse bins).
At seed 9 the coarse stage picks the farther bin for one SV, in the
reference's search as in the program's, and the fine window around it
misses the sky: the channel starts 300 Hz off and its carrier rotates.
The preset's gate drops it and the run is correct; with the carrier test
blinded the channel is kept, and only ``trk_lock_diff`` is over its
limit."""

import json
from pathlib import Path
from types import SimpleNamespace

import pytest

import tiny

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
EDGE = '''"""A snapshot sky whose SVs lie 15 Hz past the midpoint between two
coarse bins, so that a coarse pick of the farther bin leaves the sky
outside the fine window around it."""

from ..scenario import snapshot_sky


def make(seed, capture, config, traffic):
    s, g = config["settings"], config["signal"]
    spc = int(round(s["sampling_freq"]
                    / (g["chip_rate_hz"] / g["code_length_chips"])))
    sky = snapshot_sky(seed, capture, samples_per_code=spc,
                       prns=s["acq_satellite_list"], n_svs=traffic["n_svs"],
                       cn0_dbhz=traffic["cn0_dbhz"],
                       seconds=traffic["record_ms"] * 1e-3,
                       nav_symbol_ms=g["nav_symbol_ms"], doppler_hz=0.0)
    step = s["acq_search_step"]
    for k, sv in enumerate(sky.svs):
        sv.doppler_hz = (k - len(sky.svs) // 2) * step + step / 2 + 15.0
    return sky
'''
EDGE_TRAFFIC = {"config": "tinye5a", "sky": "edge", "n_svs": 4,
                "cn0_dbhz": 50.0, "record_ms": 1200, "pool": 1,
                "check_records": 1,
                "why": "four E5a SVs past the coarse bins' midpoints"}
MISS_SEED = 9


# the limits of the gal_e5a configurations' comparison (PERF.md section 2)
LIMITS = {"acq_set_diff": 0, "acq_gap": 1e-4, "trk_chan_diff": 0,
          "trk_geom_diff": 0, "trk_sum_gap": 2e-4, "trk_carr_gap_hz": 5e-3,
          "trk_code_gap_hz": 2e-3, "trk_phase_gap": 1e-6,
          "trk_lock_diff": 0, "nav_diff": 0, "pvt_count_diff": 0,
          "pvt_gap_m": 1e-3, "pvt_truth_m": 2e4}


def test_the_configuration_states_the_preset():
    import dataclasses
    from benchmark.harness import cells, program
    from benchmark.reference.check import NAMES
    from cusdr_tpu_torch import get_config
    from cusdr_tpu_torch.signals.defs import get_signal
    cell = cells.find_cell(ROOT, "e5a_snap4s")
    assert cell.config_name == "gal_e5a_lockgate" and cell.chips == 1
    rx = program.receiver(cell.config, "cpu")
    preset = get_config("gal_e5a")
    assert rx.cfg == preset
    assert rx.cfg.carrier_lock_test == "in_phase_share"
    assert cell.config["preset"] == "gal_e5a" and cell.config["reduced"] == []
    assert "in_phase_share" in cell.config["lock_gate"]
    settings = dict(cell.config["settings"])
    assert settings.pop("cno") == dataclasses.asdict(preset.cno)
    assert set(settings) == {f.name for f in dataclasses.fields(preset)} - {
        "cno", "true_position", "use_pallas"}
    assert settings == {k: list(v) if isinstance(v, tuple) else v
                        for k, v in ((k, getattr(preset, k))
                                     for k in settings)}
    sig, g = get_signal("gal_e5a"), cell.config["signal"]
    assert g == {"codes": "gal_e5a", "carrier_freq_hz": sig.carrier_freq_hz,
                 "chip_rate_hz": sig.chip_rate_hz,
                 "code_length_chips": sig.code_length_chips,
                 "nav_symbol_ms": sig.nav_symbol_ms,
                 "pilot": sig.pilot_code is not None,
                 "nav_codec": sig.nav_codec}
    assert set(cell.limits) == set(NAMES)
    assert cell.limits == LIMITS


@pytest.mark.parametrize("name", ["nav_fec_s", "trk_lock_drops"])
def test_the_new_timings_readers_return_none_where_absent(name):
    from benchmark.harness import cells
    read = cells.reader(name)
    bare = {"acquisition_s": 0.3, "tracking_s": 0.1, "navigation_s": 0.0}
    assert read(SimpleNamespace(records=[{"timings": bare}] * 3)) is None
    assert read(SimpleNamespace(records=[])) is None
    run = SimpleNamespace(records=[{"timings": dict(bare, **{name: v})}
                                   for v in (0, 1, 2)] + [{"timings": bare}])
    assert read(run) == 1.0


def test_the_s1p_roofline_reader_returns_none_without_a_pilot_trace():
    from benchmark.harness import cells
    read = cells.reader("s1p_roofline")
    e5a = json.loads((BENCH / "configs/gal_e5a_lockgate.json").read_text())
    l1 = json.loads((BENCH / "configs/gps_l1ca.json").read_text())
    rec = {"work": {"rows": 12, "epochs": 1000, "valid_epochs": 12000,
                    "valid_samples": 12000 * 18000, "span": 18_000_000}}
    trace = SimpleNamespace(op_seconds={
        "void track_superblock_kernel<int8_t, 1, true>(...)": 0.5})
    assert read(SimpleNamespace(config=e5a, trace=None,
                                records=[rec])) is None
    assert read(SimpleNamespace(config=l1, trace=trace,
                                records=[rec])) is None
    assert read(SimpleNamespace(config=e5a, trace=SimpleNamespace(
        op_seconds={}), records=[rec])) is None
    assert 0.0 < read(SimpleNamespace(config=e5a, trace=trace,
                                      records=[rec])) < 100.0


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A tiny checkout with the E5a edge cell ``tedge``."""
    root = tiny.make(tmp_path_factory.mktemp("tinye5a") / "checkout")
    b = root / "benchmark"
    cfg = json.loads((b / "configs/gal_e5a_lockgate.json").read_text())
    cfg["settings"].update(sampling_freq=10.23e6, superblock_ms=200,
                           acq_satellite_list=[4, 11, 19, 24])
    (b / "configs/tinye5a.json").write_text(json.dumps(cfg))
    (b / "reference/limits/tinye5a.json").write_text(
        (b / "reference/limits/gal_e5a_lockgate.json").read_text())
    (b / "traffic/skies/edge.py").write_text(EDGE)
    (b / "workloads/tedge.json").write_text(json.dumps(EDGE_TRAFFIC))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tinye5a", "source": "a test copy",
                             "file": "benchmark/configs/tinye5a.json",
                             "reduced": ["sampling_freq", "superblock_ms",
                                         "acq_satellite_list"],
                             "why": "tests"})
    bench["workloads"].append({"name": "tedge", "config": "tinye5a",
                               "traffic": "tedge", "chips": 1,
                               "why": EDGE_TRAFFIC["why"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def test_the_gate_drops_the_missed_hand_off_and_the_run_is_correct(root):
    res = tiny.run(root, "tedge", seed=MISS_SEED, trace=1)
    assert res["correct"], res["checks"]
    assert res["metrics"]["trk_lock_drops"]["value"] == 1.0


def test_a_kept_channel_without_carrier_lock_is_not_correct(root,
                                                            monkeypatch):
    from cusdr_tpu_torch.tracking import engine
    monkeypatch.setattr(engine, "carrier_unlocked", lambda *a: False)
    res = tiny.run(root, "tedge", seed=MISS_SEED, trace=1)
    assert not res["correct"]
    assert res["metrics"]["trk_lock_drops"]["value"] == 0.0
    over = {k for k, c in res["checks"].items() if c["value"] > c["limit"]}
    assert over == {"trk_lock_diff"}
