"""A tiny checkout for the CPU tests: BENCHMARK.json and a copy of the
benchmark's folder with a 2.048 Msps copy of the gps_l1ca configuration
(``tiny``) and short cells, so that a whole run fits a test.  Tests
import the harness from the copy."""

from __future__ import annotations

import importlib
import json
import shutil
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent

SNAP = {"config": "tiny", "sky": "snapshot", "n_svs": 4, "cn0_dbhz": 45.0,
        "record_ms": 1200, "doppler_hz": 4500.0, "pool": 2,
        "check_records": 2, "why": "four SVs, 1.2 s captures (two superblocks)"}


def make(root: Path, workloads=None) -> Path:
    """A checkout at ``root`` holding the cells ``workloads`` (name ->
    traffic dict; default one snapshot cell ``tsnap``)."""
    workloads = workloads or {"tsnap": SNAP}
    if root.exists():
        shutil.rmtree(root)
    root.mkdir(parents=True)
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = root / "benchmark"
    cfg = json.loads((b / "configs/gps_l1ca.json").read_text())
    cfg["settings"]["sampling_freq"] = 2.048e6
    (b / "configs/tiny.json").write_text(json.dumps(cfg))
    shutil.copy(b / "reference/limits/gps_l1ca.json",
                b / "reference/limits/tiny.json")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny", "source": "a test copy",
                             "file": "benchmark/configs/tiny.json",
                             "reduced": ["sampling_freq"], "why": "tests"})
    bench["workloads"] = []
    for name, traffic in workloads.items():
        (b / "workloads" / f"{name}.json").write_text(json.dumps(traffic))
        bench["workloads"].append({"name": name, "config": "tiny",
                                   "traffic": name, "chips": 1,
                                   "why": traffic["why"]})
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def harness(root: Path):
    """The copy's ``benchmark.harness.runner``, imported from ``root``."""
    for name in [m for m in sys.modules
                 if m == "benchmark" or m.startswith("benchmark.")]:
        del sys.modules[name]
    sys.path.insert(0, str(root))
    try:
        return importlib.import_module("benchmark.harness.runner")
    finally:
        sys.path.remove(str(root))


def run(root: Path, cell: str, seed: int = 123456789012, seconds=0.5,
        trace=0):
    """One run of ``cell`` on the CPU; returns the result object."""
    import torch
    torch.set_num_threads(2)
    runner = harness(root)
    args = runner.parse(["--workload", cell, "--seed", str(seed),
                         "--seconds", str(seconds), "--trace", str(trace)])
    return runner.run_cell(root, args, "cpu", time.perf_counter(),
                           bench_dir=root / "benchmark")
