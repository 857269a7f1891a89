"""One run of one cell: set-up, the measured window, the metrics, and the
comparison that decides ``correct``.

``main`` is the command line (``run.py``); ``run_cell`` is the run itself,
on any device, so that the benchmark's tests can drive it on the CPU."""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
import traceback
from pathlib import Path
from types import SimpleNamespace

import numpy as np

from . import cells

FORBIDDEN = ("jax", "jaxlib", "flax", "cusdr_tpu")


def parse(argv):
    ap = argparse.ArgumentParser(description="one run of one cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is jax, jaxlib, flax or the JAX
    package, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _window(rx, pool, seconds, trace, device):
    """Records back to back from the pool until ``seconds`` have passed;
    the last record is the last that started before then.  Returns
    (records, window seconds, profiler or None)."""
    import torch
    from . import program
    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    recs = []
    t_start = time.perf_counter()
    i = 0
    while i == 0 or time.perf_counter() - t_start < seconds:
        iq, _ = pool[i % len(pool)]
        t0 = time.perf_counter()
        res, err = None, None
        try:
            with torch.profiler.record_function("record"):
                res = rx.run(iq)
        except Exception:          # a record that raises counts as failed
            err = traceback.format_exc()
        t1 = time.perf_counter()
        recs.append(dict(index=i, pool=i % len(pool), result=res,
                         error=err, latency_s=t1 - t0, host=(t0, t1),
                         timings=dict(res.timings) if res else {},
                         work=program.work(res) if res else None))
        i += 1
    window_s = recs[-1]["host"][1] - t_start
    _sync(device)
    if prof is not None:
        prof.__exit__(None, None, None)
    return recs, window_s, prof


def _judge(cell, pool, recs, seed, device, out=sys.stderr):
    """The reference's numbers of a sample of the window's records drawn
    from the seed, each the worst over the sample.  Returns (checks
    {name: (value, limit)}, failed records)."""
    from ..reference.check import NAMES, check_record
    from ..reference.precision import REFERENCE
    from ..traffic.codes import signal_of
    from ..traffic.scenario import rng_of
    rng = rng_of(seed, 2)
    ok = [r for r in recs if r["error"] is None]
    n = min(cell.traffic["check_records"], len(ok))
    picks = sorted(rng.choice(len(ok), n, replace=False)) if n else []
    codes = signal_of(cell.config["signal"])
    worst = dict.fromkeys(NAMES, 0.0)
    failed = 0
    for k in picks:
        rec = ok[k]
        iq, sky = pool[rec["pool"]]
        nums, info = check_record(
            iq, rec["plain"], sky, cell.config["settings"],
            cell.config["signal"], codes, device, REFERENCE,
            rng_of(seed, 3, rec["index"]))
        print(f"record {rec['index']} judged: {info}", file=out)
        bad = [nm for nm, v in nums.items() if not v <= cell.limits[nm]]
        if bad:
            failed += 1
            print(f"record {rec['index']}: over the limit: {bad}", file=out)
        for nm, v in nums.items():
            worst[nm] = max(worst[nm], v)
    return {nm: (worst[nm], cell.limits[nm]) for nm in NAMES}, failed, n


def run_cell(root: Path, args, device, t_process: float,
             bench_dir: Path = cells.HERE, out=sys.stderr):
    """One run; returns the result line's object (without printing)."""
    import torch
    from . import program, records, trace as trace_mod
    cell = cells.find_cell(root, args.workload, bench_dir)
    marks = [("start", t_process), ("imports", time.perf_counter())]
    pool = records.make_pool(cell.config, cell.traffic, args.seed, device)
    marks.append(("records", time.perf_counter()))
    rx = program.receiver(cell.config, device)
    rx.run(pool[0][0])                    # the warm record
    _sync(device)
    marks.append(("warm record", time.perf_counter()))
    print("set-up s: " + ", ".join(
        f"{name} {b - a:.3f}" for (_, a), (name, b) in zip(marks, marks[1:])),
        file=out)
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_process
    recs, window_s, prof = _window(rx, pool, args.seconds, args.trace,
                                   device)
    peak = (int(torch.cuda.max_memory_allocated())
            if torch.device(device).type == "cuda" else 0)
    tr = None
    if prof is not None and torch.device(device).type == "cuda":
        tr = trace_mod.reduce(prof, recs)
    del prof, rx
    for r in recs:
        r["plain"] = program.plain(r["result"]) if r["result"] else None
        r["result"] = None
        r["record_s"] = cell.traffic["record_ms"] * 1e-3
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    for r in recs:
        if r["error"]:
            print(f"record {r['index']} raised:\n{r['error']}", file=out)
    lat = np.asarray([r["latency_s"] for r in recs])
    print(f"window {window_s:.3f} s, {len(recs)} records, latency s "
          f"min/median/max {lat.min():.4f}/{np.median(lat):.4f}/"
          f"{lat.max():.4f}, first {np.round(lat[:4], 4).tolist()}, "
          f"setup {setup_s:.3f} s", file=out)
    run = SimpleNamespace(
        records=[r for r in recs if r["error"] is None],
        window_s=window_s, setup_s=setup_s, trace=tr, config=cell.config,
        traffic=cell.traffic)
    wanted = cell.per_layer if args.trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        v = cells.reader(m["name"], bench_dir)(run)
        if v is not None and math.isfinite(v):
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    checks, failed, judged = _judge(cell, pool, recs, args.seed, device,
                                    out)
    failed += sum(1 for r in recs if r["error"])
    checks_ok = all(v <= lim for v, lim in checks.values())
    result = {
        "correct": bool(failed == 0 and checks_ok and judged > 0),
        "attempted": len(recs), "failed": failed, "metrics": metrics,
        "device": _device(device, cell.chips, peak, tr)}
    if tr is not None:
        result["breakdown"] = {
            "device_ops": sorted(([n, s] for n, s in tr.op_seconds.items()),
                                 key=lambda x: -x[1])[:10],
            "idle_gaps": [[n, s] for n, s in tr.gaps[:10]]}
    result["checks"] = {nm: {"value": v, "limit": lim}
                        for nm, (v, lim) in checks.items()}
    return result


def _device(device, chips, peak, tr):
    import torch
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    d = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
         "count": chips, "memory_peak_bytes": peak}
    if tr is not None:
        d["busy_s"] = tr.busy_s
        d["window_s"] = tr.window_s
    return d


def main(argv, t_process: float, root: Path, threads: int) -> int:
    args = parse(argv)
    import torch
    torch.set_num_threads(threads)
    cell = cells.find_cell(root, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); this "
              "machine has none or fewer", file=sys.stderr)
        return 2
    result = run_cell(root, args, "cuda", t_process)
    for nm, c in result["checks"].items():
        print(f"check {nm} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['value'] <= c['limit'] else 'OVER'}",
              file=sys.stderr)
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
