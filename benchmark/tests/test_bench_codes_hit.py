"""The per-layer metric ``acq_codes_hit``: declared as the program's
counter of acquisition, in %, its cells l1ca_60s, l1ca_snap4s and
e5a_snap4s; the reader returns None where the program has no such counter
and 100 x the mean over the records where it has; a traced run of the tiny
cell reads 100 (the warm record built the spectra, every record of the
window takes them from the cache) and an untraced run reads none (the
program counts only while a profiler records)."""

import json
from pathlib import Path
from types import SimpleNamespace

import tiny

BENCH = Path(__file__).resolve().parent.parent


def test_the_counter_metric_is_declared():
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    m = {m["name"]: m for m in bench["per_layer"]}["acq_codes_hit"]
    assert (m["source"], m["unit"], m["better"], m["moves"], m["layer"]) == (
        "program_counter", "%", "higher", "realtime_x",
        "acquisition (acquisition/pcps.py)")
    assert m["workloads"] == ["l1ca_60s", "l1ca_snap4s", "e5a_snap4s",
                              "e5a_60s"]


def test_the_reader_returns_none_where_absent():
    from benchmark.harness import cells
    read = cells.reader("acq_codes_hit")
    bare = {"acquisition_s": 0.3, "tracking_s": 0.1, "navigation_s": 0.0}
    assert read(SimpleNamespace(records=[{"timings": bare}] * 3)) is None
    assert read(SimpleNamespace(records=[])) is None
    run = SimpleNamespace(records=[{"timings": dict(bare, acq_codes_hit=v)}
                                   for v in (0, 1, 1, 1)])
    assert read(run) == 75.0


def test_a_traced_run_reads_100_and_an_untraced_run_none(tmp_path):
    root = tiny.make(tmp_path / "checkout")
    res = tiny.run(root, "tsnap", trace=1)
    assert res["correct"], res["checks"]
    assert res["metrics"]["acq_codes_hit"]["value"] == 100.0
    res = tiny.run(root, "tsnap", trace=0)
    assert "acq_codes_hit" not in res["metrics"]
