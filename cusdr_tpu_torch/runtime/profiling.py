"""The receiver's stage timers and the spans and counters inside them.

``StageTimer`` (the CLI's ``--timing`` and ``--profile``, the benchmark's
per-layer metrics) accumulates wall seconds and samples per named stage and
prints them with the real-time factor; a stage that ran work on a CUDA
device ends with ``torch.cuda.synchronize``, so its seconds include the
device's work.  ``span`` names a part of a stage (``acq.coarse``,
``trk.launch``, ``nav.pvt``, ...): while a ``torch.profiler`` session
records, each span is a ``record_function`` range in its trace, beside the
device's kernels and copies on the same clock, and adds its seconds and
calls to the innermost open stage (``StageRecord.spans``); otherwise it
only reads the host clock.  ``count`` adds to a named counter of the
innermost open stage likewise.  ``device_trace`` records the enclosed block
with ``torch.profiler`` and writes a Chrome trace into a directory.

The module imports nothing of the package: the tracking engine, acquisition,
the receiver and the navigation decoders all import it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from pathlib import Path
from typing import Dict, Optional

import torch
import torch.autograd.profiler as _autograd_profiler


@dataclasses.dataclass
class StageRecord:
    seconds: float = 0.0
    calls: int = 0
    samples: int = 0
    # the totals of the spans closed inside the stage while a profiler
    # recorded, by span name (nested spans each under their own name)
    spans: Dict[str, "StageRecord"] = dataclasses.field(default_factory=dict)
    # the counters (``count``) added to inside the stage while a profiler
    # recorded, by name
    counts: Dict[str, int] = dataclasses.field(default_factory=dict)


# the records of the StageTimer stages open now, innermost last: where a
# span closed while a profiler records adds its seconds and calls
_OPEN_STAGES: list = []


class span:
    """A named part of a stage, timed on the host clock.

    >>> with span("trk.results") as s:
    ...     results = build()
    >>> s.seconds

    While a ``torch.profiler`` session records, the span is a
    ``record_function`` range of its name in that trace (on the clock of
    the device's kernels and copies) and adds its seconds and one call to
    the innermost open ``StageTimer`` stage's ``spans``.  Otherwise it
    costs a flag test and two host-clock reads, enters no
    ``record_function`` and adds to nothing; ``seconds`` holds its own
    duration either way.  No span is named "record": a trace's "record"
    ranges are the benchmark's, one per record."""

    __slots__ = ("name", "seconds", "_t0", "_range", "_rec")

    def __init__(self, name: str):
        self.name = name
        self.seconds = 0.0
        self._range = self._rec = None

    def __enter__(self):
        if _autograd_profiler._is_profiler_enabled:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
            if _OPEN_STAGES:        # listed in the order spans first open
                self._rec = _OPEN_STAGES[-1].spans.setdefault(
                    self.name, StageRecord())
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
            if self._rec is not None:
                self._rec.seconds += self.seconds
                self._rec.calls += 1
                self._rec = None
        return False


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to the counter ``name`` of the innermost open
    ``StageTimer`` stage while a ``torch.profiler`` session records (an
    ``n`` of 0 makes the counter appear); otherwise does nothing."""
    if _autograd_profiler._is_profiler_enabled and _OPEN_STAGES:
        counts = _OPEN_STAGES[-1].counts
        counts[name] = counts.get(name, 0) + n


@dataclasses.dataclass
class StageTimer:
    """Accumulates per-stage wall time and sample counts.

    >>> timer = StageTimer(sampling_freq=18e6, device="cuda")
    >>> with timer.stage("acquisition", samples=n):
    ...     acquire(...)
    >>> print(timer.report())

    With a CUDA ``device`` every stage ends with
    ``torch.cuda.synchronize(device)``, so that its seconds hold the work
    it queued on the card and not only the time to queue it.  Each stage
    is also the ``span`` of its name, and collects the spans closed inside
    it while a profiler records."""
    sampling_freq: float = 0.0
    device: Optional[object] = None
    stages: Dict[str, StageRecord] = dataclasses.field(default_factory=dict)

    @contextlib.contextmanager
    def stage(self, name: str, samples: int = 0):
        rec = self.stages.setdefault(name, StageRecord())
        with span(name):
            _OPEN_STAGES.append(rec)
            t0 = time.perf_counter()
            try:
                yield rec
            finally:
                if self.device is not None \
                        and torch.device(self.device).type == "cuda":
                    torch.cuda.synchronize(self.device)
                rec.seconds += time.perf_counter() - t0
                rec.calls += 1
                rec.samples += samples
                _OPEN_STAGES.pop()

    def realtime_factor(self, name: str) -> float:
        rec = self.stages.get(name)
        if not rec or not rec.seconds or not self.sampling_freq:
            return float("nan")
        return (rec.samples / rec.seconds) / self.sampling_freq

    def seconds(self) -> Dict[str, float]:
        """Each stage's seconds as ``<stage>_s`` and, where a profiler
        recorded, each span's total as ``<span, "." as "_">_s`` and each
        counter's under its name."""
        out = {f"{name}_s": rec.seconds for name, rec in self.stages.items()}
        for rec in self.stages.values():
            for name, sp in rec.spans.items():
                key = name.replace(".", "_") + "_s"
                out[key] = out.get(key, 0.0) + sp.seconds
            for name, n in rec.counts.items():
                out[name] = out.get(name, 0) + n
        return out

    def report(self) -> str:
        """The stages' seconds, calls, samples and real-time factors, each
        stage's spans indented under it."""
        lines = ["Stage              time [s]   calls     Msamples  xRT"]
        total = 0.0
        for name, rec in self.stages.items():
            total += rec.seconds
            xrt = self.realtime_factor(name)
            lines.append(
                f"{name:<18} {rec.seconds:9.3f} {rec.calls:7d} "
                f"{rec.samples / 1e6:11.2f}  "
                f"{'' if xrt != xrt else f'{xrt:.2f}'}")
            for sp_name, sp in rec.spans.items():
                lines.append(f"  {sp_name:<16} {sp.seconds:9.3f} "
                             f"{sp.calls:7d}")
        lines.append(f"{'TOTAL':<18} {total:9.3f}")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(trace_dir: Optional[str]):
    """``torch.profiler`` trace of the enclosed block (CPU activity, and
    CUDA activity where a card is present), written as a Chrome trace
    ``trace.json`` into ``trace_dir``; a no-op when ``trace_dir`` is
    falsy.  View with chrome://tracing or Perfetto."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(trace_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(out / "trace.json"))
