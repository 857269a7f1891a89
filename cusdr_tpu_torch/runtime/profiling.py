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
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

from .. import get_config, resolve_device
from ..signals.defs import get_signal
from ..tracking import engine

# the correlator kernels' names in a trace (csrc/*.cu)
_CORRELATOR_KERNELS = ("correlate_bank_kernel", "correlate_windows")
# the superblock kernels' names in a trace, windows fetched / staged
_SUPERBLOCK_KERNELS = {True: "track_superblock_kernel",
                       False: "track_superblock_staged_kernel"}


def make_bank(cfg, device, n_blocks: int = 1, n_epochs: int = 20,
              seed: int = 0):
    """A channel bank at ``cfg``'s width on random int8 samples:
    ``cfg.num_channels`` channels spread over the Doppler band (an FDMA
    signal's on their frequency channels' carriers), as ``n_blocks`` time
    blocks of ``n_epochs`` (B·C rows sharing C table rows).  Returns (iq,
    tables, ptables, state, params)."""
    sig = get_signal(cfg.signal)
    params = engine.make_track_params(cfg, sig)
    n_ch = cfg.num_channels
    spc = cfg.samples_per_code
    rng = np.random.default_rng(seed)
    n_samp = (n_blocks * n_epochs + 6) * spc
    iq = torch.from_numpy(
        rng.integers(-16, 17, 2 * n_samp).astype(np.int8)).to(device)
    prns = list(cfg.acq_satellite_list)[:n_ch]
    fdma = sig.fdma_spacing_hz if sig.fdma else 0.0
    channels = [(prn, cfg.if_freq + fdma * prn + 500.0 * (j - n_ch // 2),
                 149 * j) for j, prn in enumerate(prns)]
    dops = engine.code_dopplers(cfg, sig, channels)
    ctabs, ptabs = engine.build_replica_tables(cfg, sig, params, channels,
                                               dops)
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
    launches, device_ms, corr_ms = _device_profile(run, _CORRELATOR_KERNELS)
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
    of the kernels named in ``kernel_names``); (0, None, None) when the
    trace holds no device time, as it can for a run as short as one launch
    in a process some minutes old.  ``run`` ends with the device's work
    done."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    device_us = sum(e.self_device_time_total for e in events)
    if device_us <= 0:
        return 0, None, None
    named_us = sum(e.self_device_time_total for e in events
                   if any(k in e.key for k in kernel_names))
    return sum(e.count for e in events), device_us / 1e3, named_us / 1e3


def profile_superblock(cfg, device, n_epochs: int, n_blocks: int = 1,
                       repeats: int = 3, seed: int = 0,
                       fetch_in_kernel: bool = True) -> dict:
    """Profile one superblock of ``n_epochs`` epochs the way
    ``engine.track`` runs it, step by step on the bank ``make_bank``
    builds, each step ended with the device's work done; with
    ``fetch_in_kernel`` False on the staged superblock kernel.

    Returns a dict: ``rows``, ``epochs``, ``buffer_bytes`` and, in host
    milliseconds (each of ``repeats`` runs after a warm-up), ``stage_ms``
    (``engine.stage_superblock``: the zeroed buffer and the copy of the
    record into it), ``h2d_ms`` (the buffer's copy to the device),
    ``track_ms`` (``engine.track_superblock``: one launch of the
    superblock kernel on a card, the eager loop on the CPU) and
    ``drain_ms`` (the outputs' copy to the host); on a CUDA device also
    ``device_ms`` (the card's time per ``track_superblock`` call: CUDA
    events over five calls made back to back, which keep the card busy
    throughout), ``idle_share`` (1 − ``device_ms`` over the least
    ``track_ms``) and, from ``torch.profiler`` where its trace holds the
    call, ``launches`` (device kernels and copies of ``track_superblock``)
    and ``kernel_ms`` (the superblock kernel alone); None for these on the
    CPU."""
    device = resolve_device(device)
    iq, tables, ptables, state, params = make_bank(cfg, device, n_blocks,
                                                   n_epochs, seed)
    params = dataclasses.replace(params, fetch_in_kernel=fetch_in_kernel)
    record = iq.cpu().numpy()
    buf_len = len(record) // 2
    on_card = device.type == "cuda"
    kept = {}

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    def stage():
        kept["buf"] = engine.stage_superblock(record, 0, buf_len)

    def h2d():
        kept["iq"] = torch.from_numpy(kept["buf"]).to(device)
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

    steps = dict(stage_ms=stage, h2d_ms=h2d, track_ms=run, drain_ms=drain)
    for fn in steps.values():                       # warm-up (and build)
        fn()
    res = dict(signal=cfg.signal, rows=int(state.abs_sample.shape[0]),
               epochs=n_epochs, fetch_in_kernel=fetch_in_kernel,
               buffer_bytes=2 * buf_len,
               **{name: [] for name in steps}, launches=None,
               device_ms=None, kernel_ms=None, idle_share=None)
    for _ in range(repeats):
        for name, fn in steps.items():
            res[name].append(_wall_ms(fn))
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
    launches, traced_ms, kernel_ms = _device_profile(
        run, (_SUPERBLOCK_KERNELS[fetch_in_kernel],))
    if traced_ms is not None:
        res.update(launches=launches, kernel_ms=kernel_ms)
    return res


def format_superblock_profile(p: dict) -> str:
    """One line of ``profile_superblock``'s result."""
    def span(name):
        return f"{min(p[name]):.3f}-{max(p[name]):.3f}"

    def f(x, spec):
        return "not measured" if x is None else format(x, spec)

    return (f"{p['signal']}, {p['rows']} rows x {p['epochs']} epochs, "
            f"{'fetch' if p['fetch_in_kernel'] else 'staged'}, "
            f"{p['buffer_bytes'] / 1e6:.1f} MB buffer: stage "
            f"{span('stage_ms')} ms, copy to device {span('h2d_ms')} ms, "
            f"track_superblock {span('track_ms')} ms (device "
            f"{f(p['device_ms'], '.3f')} ms, idle "
            f"{f(p['idle_share'], '.1%')}; "
            f"{f(p['launches'], 'd')} launches, superblock kernel "
            f"{f(p['kernel_ms'], '.3f')} ms), drain {span('drain_ms')} ms")


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
