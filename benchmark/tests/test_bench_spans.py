"""The per-layer metrics that read the program's spans: a traced run of
the tiny cell reports the six of both cells, finite, and acquisition's
three parts sum to no more than the stage; an untraced run reports none of
the eight (the program collects spans only while a profiler records)."""

import json
import math
from pathlib import Path

import tiny

BENCH = Path(__file__).resolve().parent.parent
BOTH = ("acq_prep_s", "acq_coarse_s", "acq_fine_s", "trk_setup_s",
        "trk_wait_s", "trk_results_s")
LONG = ("nav_decode_s", "pvt_s")


def test_the_span_metrics_are_declared():
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    for name in BOTH + LONG:
        m = per_layer[name]
        assert (m["source"], m["unit"], m["better"], m["moves"]) == (
            "program_span", "s", "lower", "realtime_x")
        assert m.get("workloads") == (
            ["l1ca_60s", "e5a_60s"] if name in LONG else None)


def test_a_traced_run_reads_the_spans_and_an_untraced_run_none(tmp_path):
    root = tiny.make(tmp_path / "checkout")
    res = tiny.run(root, "tsnap", trace=1)
    assert res["correct"], res["checks"]
    m = {k: v["value"] for k, v in res["metrics"].items()}
    for name in BOTH:
        assert name in m and math.isfinite(m[name]) and m[name] >= 0, name
    assert m["acq_prep_s"] + m["acq_coarse_s"] + m["acq_fine_s"] \
        <= m["acq_s"]
    assert "pvt_s" not in m          # 1.2 s captures make no fix
    res = tiny.run(root, "tsnap", trace=0)
    assert not set(res["metrics"]) & set(BOTH + LONG)
