"""Profiles of the tracking engine: where an epoch's and a superblock's
time goes.

The eager epoch loop (``engine.track_superblock_epochs``) pays, per epoch,
one correlator launch and some tens of small elementwise launches.
``profile_epochs`` measures that split for one channel bank: launches per
epoch, host-clock wall time per epoch, device time per epoch, the
correlator's share of it and the device's idle share.  On a card
``engine.track_superblock`` is one launch of the superblock kernel, and
the host loop ``engine.track`` around it stages the record, copies it to
the card, launches and drains the outputs: ``profile_superblock`` measures
those four steps and the launch's own profile, for either superblock kernel
(windows fetched in the kernel, or staged into shared memory).  PERF.md's "where the time
goes" tables are made by these functions (``chip_smoke.py`` calls them), so
that successive readings are made the same way.

    python -m cusdr_tpu_torch.runtime.profiling --signal gps_l1ca --epochs 1000

prints the per-superblock profile of one preset's bank.  Run it as a
process of its own for the ``torch.profiler`` part (launches, kernel time):
in a process some minutes old a trace of one short launch comes back empty.

The device numbers come from ``torch.profiler`` (CUPTI) and from CUDA
events and exist only on a CUDA device; on the CPU they are None ("not
measured").

For the receiver's stages (the CLI's ``--timing`` and ``--profile``):
``StageTimer`` accumulates wall seconds and samples per named stage and
prints them with the real-time factor; a stage that ran work on a CUDA
device ends with ``torch.cuda.synchronize``, so its seconds include the
device's work.  ``span`` names a part of a stage (``acq.coarse``,
``trk.launch``, ``nav.pvt``, ...): while a ``torch.profiler`` session
records, each span is a ``record_function`` range in its trace, beside the
device's kernels and copies on the same clock, and adds its seconds and
calls to the innermost open stage (``StageRecord.spans``); otherwise it
only reads the host clock.  ``device_trace`` records the enclosed block
with ``torch.profiler`` and writes a Chrome trace into a directory.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import sys
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler

from .. import get_config, resolve_device
from ..signals.defs import get_signal

# the correlator kernels' names in a trace (csrc/*.cu)
_CORRELATOR_KERNELS = ("correlate_bank_kernel", "correlate_windows")
# the superblock kernels' names in a trace, windows fetched / staged
_SUPERBLOCK_KERNELS = {True: "track_superblock_kernel",
                       False: "track_superblock_staged_kernel"}


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


def _bank_channels(cfg, sig):
    """``make_bank``'s channels: ``cfg.num_channels`` of the preset's PRNs
    spread over the Doppler band (an FDMA signal's on their frequency
    channels' carriers)."""
    n_ch = cfg.num_channels
    prns = list(cfg.acq_satellite_list)[:n_ch]
    fdma = sig.fdma_spacing_hz if sig.fdma else 0.0
    return [(prn, cfg.if_freq + fdma * prn + 500.0 * (j - n_ch // 2),
             149 * j) for j, prn in enumerate(prns)]


def make_bank(cfg, device, n_blocks: int = 1, n_epochs: int = 20,
              seed: int = 0):
    """A channel bank at ``cfg``'s width on random int8 samples:
    ``cfg.num_channels`` channels spread over the Doppler band (an FDMA
    signal's on their frequency channels' carriers), as ``n_blocks`` time
    blocks of ``n_epochs`` (B·C rows sharing C table rows).  Returns (iq,
    tables, ptables, state, params)."""
    from ..tracking import engine
    sig = get_signal(cfg.signal)
    params = engine.make_track_params(cfg, sig)
    n_ch = cfg.num_channels
    spc = cfg.samples_per_code
    rng = np.random.default_rng(seed)
    n_samp = (n_blocks * n_epochs + 6) * spc
    iq = torch.from_numpy(
        rng.integers(-16, 17, 2 * n_samp).astype(np.int8)).to(device)
    channels = _bank_channels(cfg, sig)
    dops = engine.code_dopplers(cfg, sig, channels)
    ctabs, ptabs = engine.build_tables(cfg, sig, params, channels, dops)
    tables = torch.from_numpy(ctabs).to(device)
    ptables = None if ptabs is None else torch.from_numpy(ptabs).to(device)
    base = engine.init_channel_state(channels, sig.chip_rate_hz, device,
                                     dopplers=dops,
                                     carrier_freq_hz=sig.carrier_freq_hz)
    # block b of a row starts b·n_epochs code periods later
    shift = (torch.arange(n_blocks, device=device) * n_epochs * spc)
    state = engine.ChannelState(*(x.repeat(n_blocks) for x in base))
    state = state._replace(
        abs_sample=state.abs_sample + shift.repeat_interleave(n_ch))
    return iq, tables, ptables, state, params


def profile_epochs(cfg, device, n_blocks: int = 1, n_epochs: int = 20,
                   fetch_in_kernel: bool = True, repeats: int = 3,
                   seed: int = 0) -> dict:
    """Profile the eager loop ``track_superblock_epochs`` over ``n_epochs``
    epochs of the bank ``make_bank`` builds, after a warm-up run.

    Returns a dict: ``rows``, ``epochs``, ``wall_ms_per_epoch`` (each of
    ``repeats`` unprofiled runs, host clock around a synchronised run) and,
    on a CUDA device, ``launches_per_epoch`` (device kernels and copies in
    the trace over epochs), ``device_ms_per_epoch``,
    ``correlator_ms_per_epoch`` and ``idle_share`` (1 − device time over
    the fastest unprofiled run); None for these on the CPU."""
    from ..tracking import engine
    device = resolve_device(device)
    iq, tables, ptables, state, params = make_bank(cfg, device, n_blocks,
                                                   n_epochs, seed)
    params = dataclasses.replace(params, fetch_in_kernel=fetch_in_kernel)
    on_card = device.type == "cuda"

    def run():
        out = engine.track_superblock_epochs(iq, 0, tables, ptables, state,
                                             params, n_epochs)
        if on_card:
            torch.cuda.synchronize(device)
        return out

    run()                                           # warm-up (and build)
    walls = [_wall_ms(run) / n_epochs for _ in range(repeats)]
    res = dict(signal=cfg.signal, rows=int(state.abs_sample.shape[0]),
               epochs=n_epochs, fetch_in_kernel=fetch_in_kernel,
               wall_ms_per_epoch=walls, launches_per_epoch=None,
               device_ms_per_epoch=None, correlator_ms_per_epoch=None,
               idle_share=None)
    if not on_card:
        return res
    launches, device_ms, corr_ms, _ = _device_profile(run,
                                                      _CORRELATOR_KERNELS)
    if device_ms is None:
        return res                  # the trace held no device time
    res.update(
        launches_per_epoch=launches / n_epochs,
        device_ms_per_epoch=device_ms / n_epochs,
        correlator_ms_per_epoch=corr_ms / n_epochs,
        idle_share=1.0 - device_ms / n_epochs / min(walls))
    return res


def _wall_ms(fn) -> float:
    """Host-clock milliseconds of one call of ``fn`` (which ends with the
    device's work done)."""
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def _device_profile(run, kernel_names):
    """One call of ``run`` under ``torch.profiler``: (device kernels and
    copies in the trace, their device milliseconds, the device milliseconds
    of the kernels named in ``kernel_names``, the trace's device span in
    milliseconds: from the start of its first device event to the end of
    its last); (0, None, None, None) when the trace holds no device time,
    as it can for a run as short as one launch in a process some minutes
    old.  ``run`` ends with the device's work done."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    device_us = sum(e.self_device_time_total for e in events)
    if device_us <= 0:
        return 0, None, None, None
    named_us = sum(e.self_device_time_total for e in events
                   if any(k in e.key for k in kernel_names))
    spans = [e.time_range for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    span_ms = ((max(r.end for r in spans) - min(r.start for r in spans))
               / 1e3 if spans else None)
    return (sum(e.count for e in events), device_us / 1e3, named_us / 1e3,
            span_ms)


def profile_superblock(cfg, device, n_epochs: int, n_blocks: int = 1,
                       repeats: int = 3, seed: int = 0,
                       fetch_in_kernel: bool = True,
                       n_superblocks: int = 8) -> dict:
    """Profile one superblock of ``n_epochs`` epochs the way
    ``engine.track`` runs it, step by step on the bank ``make_bank``
    builds, each step ended with the device's work done; with
    ``fetch_in_kernel`` False on the staged superblock kernel.  Then, for
    one block of the fetch kernel's bank, ``engine.track`` itself over
    superblocks of ``n_epochs`` back to back.

    Returns a dict: ``rows``, ``epochs``, ``buffer_bytes`` and, in host
    milliseconds (each of ``repeats`` runs after a warm-up), ``stage_ms``
    (``engine.stage_superblock`` into a fresh zeroed buffer, as the loop
    staged before its ring), ``stage_ring_ms`` (into a reused buffer,
    page-locked on a card, as ``track``'s ring stages), ``h2d_ms`` (the
    fresh buffer's blocking copy to the device), ``h2d_ring_ms`` (the
    reused buffer's copy, non-blocking from page-locked memory, waited
    for), ``track_ms`` (``engine.track_superblock``: one launch of the
    superblock kernel on a card, the eager loop on the CPU) and
    ``drain_ms`` (the outputs' copy to the host); ``pipelined_ms`` (the
    steady-state host milliseconds per superblock of ``engine.track`` with
    the lock gate off on a record of random samples: the wall time of
    ``2·n_superblocks`` superblocks less that of ``n_superblocks``, over
    ``n_superblocks``; None for a bank of several blocks or the staged
    kernel, which ``track`` does not run, and with ``n_superblocks`` 0);
    on a CUDA device also
    ``device_ms`` (the card's time per ``track_superblock`` call: CUDA
    events over five calls made back to back, which keep the card busy
    throughout), ``idle_share`` (1 − ``device_ms`` over the least
    ``track_ms``) and, from ``torch.profiler`` where its trace holds the
    call,
    ``launches`` (device kernels and copies of ``track_superblock``),
    ``kernel_ms`` (the superblock kernel alone) and ``busy_share_traced``
    (in a traced run of the longer ``track``, the superblock kernel's time
    over the trace's span from its first device event to its last: the
    loop alone, without the host's set-up before it and ``TrackResults``
    after it); None for these on the CPU."""
    from ..tracking import engine
    device = resolve_device(device)
    iq, tables, ptables, state, params = make_bank(cfg, device, n_blocks,
                                                   n_epochs, seed)
    params = dataclasses.replace(params, fetch_in_kernel=fetch_in_kernel)
    record = iq.cpu().numpy()
    buf_len = len(record) // 2
    on_card = device.type == "cuda"
    ring = torch.empty(2 * buf_len, dtype=iq.dtype, pin_memory=on_card)
    ring_dev = torch.empty_like(iq)
    kept = {}

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    def stage():
        kept["buf"] = engine.stage_superblock(record, 0, buf_len)

    def stage_ring():
        engine.stage_superblock(record, 0, buf_len, out=ring.numpy())

    def h2d():
        kept["iq"] = torch.from_numpy(kept["buf"]).to(device)
        sync()

    def h2d_ring():
        ring_dev.copy_(ring, non_blocking=True)
        sync()

    def launch():
        kept["outs"] = engine.track_superblock(
            kept["iq"], 0, tables, ptables, state, params, n_epochs)[1]

    def run():
        launch()
        sync()

    def drain():
        host, done = engine._to_host(kept["outs"], device)
        if done is not None:
            done.synchronize()
        kept["host"] = [x.numpy() for x in host]

    steps = dict(stage_ms=stage, stage_ring_ms=stage_ring, h2d_ms=h2d,
                 h2d_ring_ms=h2d_ring, track_ms=run, drain_ms=drain)
    for fn in steps.values():                       # warm-up (and build)
        fn()
    res = dict(signal=cfg.signal, rows=int(state.abs_sample.shape[0]),
               epochs=n_epochs, fetch_in_kernel=fetch_in_kernel,
               buffer_bytes=2 * buf_len,
               **{name: [] for name in steps}, pipelined_ms=None,
               superblocks=None, launches=None, device_ms=None,
               kernel_ms=None, idle_share=None, busy_share_traced=None)
    for _ in range(repeats):
        for name, fn in steps.items():
            res[name].append(_wall_ms(fn))
    pipelined = n_blocks == 1 and fetch_in_kernel and n_superblocks > 0
    if pipelined:
        track_run = _pipelined_track(cfg, device, record, n_epochs,
                                     n_superblocks)
        walls = {n: [] for n in (n_superblocks, 2 * n_superblocks)}
        for _ in range(repeats):
            for n in walls:
                walls[n].append(_wall_ms(lambda: track_run(n)))
        res.update(superblocks=2 * n_superblocks, pipelined_ms=(
            min(walls[2 * n_superblocks]) - min(walls[n_superblocks]))
            / n_superblocks)
    if not on_card:
        return res
    first, last = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    first.record()
    for _ in range(5):
        launch()
    last.record()
    last.synchronize()
    device_ms = first.elapsed_time(last) / 5
    res.update(device_ms=device_ms,
               idle_share=1.0 - device_ms / min(res["track_ms"]))
    kernel = (_SUPERBLOCK_KERNELS[fetch_in_kernel],)
    launches, traced_ms, kernel_ms, _ = _device_profile(run, kernel)
    if traced_ms is not None:
        res.update(launches=launches, kernel_ms=kernel_ms)
    if pipelined:
        _, traced_ms, kernel_ms, span_ms = _device_profile(
            lambda: track_run(2 * n_superblocks), kernel)
        if traced_ms is not None and span_ms:
            res["busy_share_traced"] = kernel_ms / span_ms
    return res


def _pipelined_track(cfg, device, record, n_epochs, n_superblocks):
    """A function of n that runs ``engine.track`` with the lock gate off
    over n superblocks of ``n_epochs`` on ``make_bank``'s channels, the
    record ``record`` repeated to ``2·n_superblocks`` superblocks' length
    (and a few epochs' margin)."""
    from ..tracking import engine
    sig = get_signal(cfg.signal)
    cfg = cfg.replace(lock_detect=False,
                      superblock_ms=n_epochs * sig.code_period_ms)
    channels = _bank_channels(cfg, sig)
    spc = cfg.samples_per_code
    n_samp = (2 * n_superblocks * n_epochs + 6) * spc
    long_record = np.resize(record, 2 * n_samp)

    def track_run(n):
        return engine.track(cfg, sig, long_record, channels, device,
                            n_epochs=n * n_epochs)
    return track_run


def format_superblock_profile(p: dict) -> str:
    """One line of ``profile_superblock``'s result."""
    def span(name):
        return f"{min(p[name]):.3f}-{max(p[name]):.3f}"

    def f(x, spec):
        return "not measured" if x is None else format(x, spec)

    return (f"{p['signal']}, {p['rows']} rows x {p['epochs']} epochs, "
            f"{'fetch' if p['fetch_in_kernel'] else 'staged'}, "
            f"{p['buffer_bytes'] / 1e6:.1f} MB buffer: stage "
            f"{span('stage_ms')} ms (reused buffer "
            f"{span('stage_ring_ms')} ms), copy to device "
            f"{span('h2d_ms')} ms (page-locked, non-blocking "
            f"{span('h2d_ring_ms')} ms), track_superblock "
            f"{span('track_ms')} ms (device {f(p['device_ms'], '.3f')} ms, "
            f"idle {f(p['idle_share'], '.1%')}; "
            f"{f(p['launches'], 'd')} launches, superblock kernel "
            f"{f(p['kernel_ms'], '.3f')} ms), drain {span('drain_ms')} ms"
            + ("" if p["pipelined_ms"] is None else
               f"; track pipelined {p['pipelined_ms']:.3f} ms per "
               f"superblock over {p['superblocks']} (superblock kernel "
               f"{f(p['busy_share_traced'], '.1%')} of the trace's device "
               f"span)"))


def format_profile(p: dict) -> str:
    """One line of ``profile_epochs``'s result."""
    def f(x, spec):
        return "not measured" if x is None else format(x, spec)

    walls = "-".join(f"{w:.3f}" for w in (min(p["wall_ms_per_epoch"]),
                                          max(p["wall_ms_per_epoch"])))
    return (f"{p['signal']}, {p['rows']} rows, "
            f"{'fetch' if p['fetch_in_kernel'] else 'staged'}: "
            f"{f(p['launches_per_epoch'], '.1f')} launches/epoch, wall "
            f"{walls} ms/epoch, device "
            f"{f(p['device_ms_per_epoch'], '.4f')} ms/epoch, correlator "
            f"{f(p['correlator_ms_per_epoch'], '.4f')} ms/epoch, idle "
            f"{f(p['idle_share'], '.1%')}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="cusdr_tpu_torch.runtime.profiling",
        description="per-superblock profile of one preset's channel bank")
    ap.add_argument("--signal", default="gps_l1ca")
    ap.add_argument("--epochs", type=int, default=1000,
                    help="epochs in the superblock")
    ap.add_argument("--blocks", type=int, default=1,
                    help="time blocks in the bank (rows = blocks x channels)")
    ap.add_argument("--staged", action="store_true",
                    help="windows staged into shared memory by the kernel")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    p = profile_superblock(get_config(args.signal), args.device, args.epochs,
                           n_blocks=args.blocks,
                           fetch_in_kernel=not args.staged)
    print(format_superblock_profile(p))
    return 0


if __name__ == "__main__":
    sys.exit(main())
