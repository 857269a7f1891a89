"""Readings for the limits of the comparison, on the card at a cell's own
size: for each seed, the program's numbers (the lower readings), and for
the control seeds the control's numbers (the upper readings), as one JSON
line per seed.

    python3 -m benchmark.harness.control --workload l1ca_60s \
        --seeds 11,12,13 --control 11,12,13 [--device cuda]

Each seed makes the cell's pool as a run does, runs the program once
over each record of the pool that a run's check would judge (all of a
pool of one; ``check_records`` captures of a larger pool), and judges
them with the reference."""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent.parent


def readings(cell, seed: int, control: bool, device, out=sys.stdout):
    import torch
    from . import program, records
    from ..reference.check import check_record
    from ..reference.control import control_outputs
    from ..reference.precision import REFERENCE
    from ..traffic.codes import signal_of
    from ..traffic.scenario import rng_of
    s, g = cell.config["settings"], cell.config["signal"]
    codes = signal_of(g)
    t0 = time.perf_counter()
    pool = records.make_pool(cell.config, cell.traffic, seed, device)
    rx = program.receiver(cell.config, device)
    n = min(len(pool), cell.traffic["check_records"]) if len(pool) > 1 \
        else 1
    rows = []
    for j in range(n):
        iq, sky = pool[j]
        prog = program.plain(rx.run(iq))
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        row = dict(seed=seed, record=j)
        row["program"], row["program_info"] = check_record(
            iq, prog, sky, s, g, codes, device, REFERENCE,
            rng_of(seed, 3, j))
        if control:
            ctl = control_outputs(iq, prog, sky, s, g, codes, device,
                                  rng_of(seed, 3, j))
            row["control"], row["control_info"] = check_record(
                iq, ctl, sky, s, g, codes, device, REFERENCE,
                rng_of(seed, 3, j))
        row["seconds"] = time.perf_counter() - t0
        print(json.dumps(row), file=out, flush=True)
        rows.append(row)
    return rows


def main(argv=None) -> int:
    from . import cells
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", default="")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    cell = cells.find_cell(Path.cwd(), a.workload)
    ctl = {int(x) for x in a.control.split(",") if x}
    for seed in [int(x) for x in a.seeds.split(",") if x]:
        readings(cell, seed, seed in ctl, a.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
