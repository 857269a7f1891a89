"""The device trace of a measured window (``torch.profiler``), reduced to
what the metrics read: device busy time (the union of every kernel, copy
and set on the device), device time by operation, and the idle gaps named
by the stage the host was in."""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np


@dataclass
class Trace:
    window_s: float                    # first record's start to last's end
    busy_s: float
    op_seconds: dict                   # device op name -> seconds
    gaps: list = field(default_factory=list)  # (stage, seconds), longest


def _ns(ev, what):
    """An event's start or duration in ns, across profiler versions."""
    fn = getattr(ev, f"{what}_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(ev, f"{what}_us")() * 1000)


def _is_device(ev) -> bool:
    """A kernel, copy or set on the device (not the device-side shadow of
    a host annotation such as the "record" span)."""
    if not str(ev.device_type()).endswith("CUDA") or ev.name() == "record":
        return False
    annotation = getattr(ev, "is_user_annotation", None)
    return not (annotation is not None and annotation())


def _stages_in(stages, starts, a: int, b: int) -> str:
    """The host stages the interval [a, b) overlaps, in order, joined by
    "+" ("between records" for time in no record)."""
    k = max(int(np.searchsorted(starts, a, side="right")) - 1, 0)
    names, t = [], a
    while t < b:
        if k < len(stages) and stages[k][0] <= t < stages[k][1]:
            name, t = stages[k][2], min(stages[k][1], b)
            k += 1
        elif k < len(stages) and t < stages[k][0]:
            name, t = "between records", min(stages[k][0], b)
        elif k < len(stages):
            k += 1
            continue
        else:
            name, t = "between records", b
        if not names or names[-1] != name:
            names.append(name)
    return "+".join(names)


def reduce(prof, records) -> Trace:
    """``records``: the window's records in order, each a dict with
    "timings" (stage seconds) and "host" (start, end) on the host clock.
    The "record" spans the harness put around each call tie the two
    clocks."""
    events = prof.profiler.kineto_results.events()
    spans, dev = [], []
    for ev in events:
        if _is_device(ev):
            d = _ns(ev, "duration")
            if d > 0:
                dev.append((_ns(ev, "start"), d, ev.name()))
        elif ev.name() == "record" and str(ev.device_type()).endswith("CPU"):
            spans.append((_ns(ev, "start"), _ns(ev, "duration")))
    spans.sort()
    if len(spans) != len(records):
        raise RuntimeError(f"the trace holds {len(spans)} record spans "
                           f"for {len(records)} records")
    w0, w1 = spans[0][0], spans[-1][0] + spans[-1][1]
    dev = [(s, d, n) for s, d, n in dev if s < w1 and s + d > w0]
    op = defaultdict(float)
    iv = []
    for s, d, n in dev:
        a, b = max(s, w0), min(s + d, w1)
        op[n] += (b - a) * 1e-9
        iv.append((a, b))
    iv.sort()
    merged = []
    for a, b in iv:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged) * 1e-9
    # stage intervals on the trace clock: each record's span start plus
    # its stages' seconds in order
    stages = []
    for (s0, dur), rec in zip(spans, records):
        t = s0
        for name in ("acquisition", "tracking", "navigation"):
            sec = rec["timings"].get(f"{name}_s")
            if sec is None:
                continue
            stages.append((t, t + int(sec * 1e9), name))
            t += int(sec * 1e9)
        stages.append((t, s0 + dur, "results"))
    starts = np.asarray([s[0] for s in stages])
    gaps = []
    edges = [w0] + [x for ab in merged for x in ab] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            gaps.append((_stages_in(stages, starts, a, b), (b - a) * 1e-9))
    gaps.sort(key=lambda g: -g[1])
    return Trace(window_s=(w1 - w0) * 1e-9, busy_s=busy,
                 op_seconds=dict(op), gaps=gaps)
