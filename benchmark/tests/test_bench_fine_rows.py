"""The per-layer metric ``acq_fine_rows``: declared as the program's
counter of acquisition, its cells among them l1ca_60s, l1ca_snap4s and
e5a_snap4s; a traced run of the tiny cell reads the detected PRNs whose
fine search ran, more than 0, and an untraced run reads none (the program
counts only while a profiler records); the reader returns None where the
program has no such counter."""

import json
from pathlib import Path
from types import SimpleNamespace

import tiny

BENCH = Path(__file__).resolve().parent.parent


def test_the_counter_metric_is_declared():
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    m = {m["name"]: m for m in bench["per_layer"]}["acq_fine_rows"]
    assert (m["source"], m["unit"], m["moves"], m["layer"]) == (
        "program_counter", "rows", "realtime_x",
        "acquisition (acquisition/pcps.py)")
    assert {"l1ca_60s", "l1ca_snap4s", "e5a_snap4s"} <= set(m["workloads"])


def test_the_reader_returns_none_where_absent():
    from benchmark.harness import cells
    read = cells.reader("acq_fine_rows")
    bare = {"acquisition_s": 0.3, "tracking_s": 0.1, "navigation_s": 0.0}
    assert read(SimpleNamespace(records=[{"timings": bare}] * 3)) is None
    assert read(SimpleNamespace(records=[])) is None
    run = SimpleNamespace(records=[{"timings": dict(bare, acq_fine_rows=v)}
                                   for v in (3, 4, 5)])
    assert read(run) == 4.0


def test_a_traced_run_reads_the_rows_and_an_untraced_run_none(tmp_path):
    root = tiny.make(tmp_path / "checkout")
    res = tiny.run(root, "tsnap", trace=1)
    assert res["correct"], res["checks"]
    assert res["metrics"]["acq_fine_rows"]["value"] > 0
    res = tiny.run(root, "tsnap", trace=0)
    assert "acq_fine_rows" not in res["metrics"]
