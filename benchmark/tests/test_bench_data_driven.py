"""The harness is driven by data: a configuration, a traffic mix and a
per-layer metric added as new files under new names (and entries in
BENCHMARK.json) are found and run, with no edit to a file that is there;
and BENCHMARK.json keeps the form its readers expect."""

import json
import re
from pathlib import Path

import numpy as np
import pytest

import tiny

BENCH = Path(__file__).resolve().parent.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
# a sample type as a later cell of 16-bit records would add it
INT16 = '''"""Interleaved int16 I/Q from a 16-bit front end: the int8 record's
signal and noise at 64 times the scale (noise std 256 per component),
rounded half to even, clipped to +-32767."""

import numpy as np
import torch

DTYPE = np.int16
SCALE = 64.0


def quantize(i, q):
    return torch.stack([(SCALE * x).round().clamp(-32767, 32767)
                        for x in (i, q)], dim=1).to(torch.int16).reshape(-1)
'''


def _snapshot(root: Path) -> dict:
    return {p: p.read_bytes() for p in (root / "benchmark").rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_are_found_and_run(tmp_path):
    """A configuration with int16 records (a new sample type) and a nav
    codec the benchmark has no file for (a cell of short captures decodes nothing, so never
    looks it up), a new sky builder, a traffic mix and a metric."""
    root = tiny.make(tmp_path / "checkout")
    before = _snapshot(root)
    b = root / "benchmark"
    cfg = json.loads((b / "configs/tiny.json").read_text())
    cfg["settings"]["num_channels"] = 3
    cfg["settings"]["data_type"] = "int16"
    cfg["signal"]["nav_codec"] = "cnav"
    (b / "configs/tiny3.json").write_text(json.dumps(cfg))
    (b / "reference/limits/tiny3.json").write_text(
        (b / "reference/limits/tiny.json").read_text())
    (b / "traffic/samples/int16.py").write_text(INT16)
    (b / "traffic/skies/slow.py").write_text(
        '"""Snapshot skies of slow SVs: Dopplers within a fifth of the '
        'traffic\'s."""\n\n'
        "from . import snapshot\n\n\n"
        "def make(seed, capture, config, traffic):\n"
        "    return snapshot.make(seed, capture, config, dict(\n"
        "        traffic, doppler_hz=traffic['doppler_hz'] / 5))\n")
    traffic = dict(tiny.SNAP, config="tiny3", sky="slow", n_svs=5, pool=1,
                   check_records=1, record_ms=300, why="three channels")
    (b / "workloads/tsnap3.json").write_text(json.dumps(traffic))
    (b / "metrics/records_n.py").write_text(
        '"""Records the window completed."""\n\n\n'
        "def read(run):\n    return float(len(run.records))\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny3", "source": "a test copy",
                             "file": "benchmark/configs/tiny3.json",
                             "reduced": ["sampling_freq", "num_channels"],
                             "why": "tests"})
    bench["workloads"].append({"name": "tsnap3", "config": "tiny3",
                               "traffic": "tsnap3", "chips": 1,
                               "why": "three channels"})
    bench["per_layer"].append({"name": "records_n", "unit": "records",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "receiver entry (receiver.py)",
                               "moves": "realtime_x",
                               "workloads": ["tsnap3"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _snapshot(root)
    assert all(after[p] == v for p, v in before.items())
    runner = tiny.harness(root)
    from benchmark.harness import cells, records
    cell = cells.find_cell(root, "tsnap3", b)
    (iq, sky), = records.make_pool(cell.config, cell.traffic, 7, "cpu")
    assert iq.dtype == np.int16 and np.abs(iq).max() > 127
    assert max(abs(sv.doppler_hz) for sv in sky.svs) <= 900.0
    assert runner.cells is cells
    res = tiny.run(root, "tsnap3", trace=1)
    assert res["correct"], res["checks"]
    assert res["metrics"]["records_n"]["value"] == res["attempted"]
    assert {"acq_s", "track_s", "nav_s"} <= set(res["metrics"])
    assert len(res["checks"]) == 13
    res = tiny.run(root, "tsnap3", trace=0)
    assert set(res["metrics"]) == {"realtime_x", "capture_p95_s",
                                   "setup_s"}


def test_benchmark_json_keeps_the_form():
    root = BENCH.parent
    bench = json.loads((root / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    assert 1 <= bench["run_seconds"] <= 51
    names = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and (root / c["file"]).is_file()
        assert c["file"].startswith("benchmark/")
        assert c["reduced"] == [] or all(NAME.match(k) for k in c["reduced"])
        names.add(c["name"])
    cells = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] in (1, 4)
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert (BENCH / "workloads" / f"{w['traffic']}.json").is_file()
        assert (BENCH / "reference/limits" / f"{w['config']}.json").is_file()
        assert 1 <= len(w["why"]) <= 200
        cells.add(w["name"])
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        assert set(m.get("workloads", cells)) <= cells


@pytest.mark.card
def test_a_run_on_the_card(tmp_path):
    """One short run of the smallest cell through run.py on the card: the
    result line's form."""
    import subprocess
    import sys
    root = BENCH.parent
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "l1ca_snap4s",
         "--seed", "4000000001", "--seconds", "3", "--trace", "0"],
        cwd=root, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert list(res)[-1] == "checks"
