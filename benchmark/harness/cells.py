"""A cell's files, found by name: its entry in BENCHMARK.json, its traffic
mix (``workloads/<traffic>.json``), its configuration
(``configs/<config>.json``), the limits of its comparison
(``reference/limits/<config>.json``) and its metrics (``metrics/<metric>.py``,
each with ``read(run) -> float | None``)."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent      # the benchmark's folder


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list          # BENCHMARK.json metric entries of this cell
    per_layer: list


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _for_cell(entries, name):
    return [m for m in entries if "workloads" not in m
            or name in m["workloads"]]


def find_cell(root: Path, name: str, bench_dir: Path = HERE) -> Cell:
    """The cell ``name`` of ``root``/BENCHMARK.json; raises KeyError."""
    bench = _load(root / "BENCHMARK.json")
    entry = {w["name"]: w for w in bench["workloads"]}[name]
    return Cell(
        name=name, chips=int(entry["chips"]),
        config_name=entry["config"],
        config=_load(bench_dir / "configs" / f"{entry['config']}.json"),
        traffic=_load(bench_dir / "workloads" / f"{entry['traffic']}.json"),
        limits=_load(bench_dir / "reference" / "limits"
                     / f"{entry['config']}.json"),
        end_to_end=_for_cell(bench["end_to_end"], name),
        per_layer=_for_cell(bench["per_layer"], name))


def reader(name: str, bench_dir: Path = HERE):
    """``read`` of metrics/<name>.py."""
    path = bench_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
