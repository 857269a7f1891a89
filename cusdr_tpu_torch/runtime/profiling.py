"""Per-epoch profile of the tracking engine: where an epoch's time goes.

The eager engine pays, per epoch, one correlator launch and some tens of
small elementwise launches (``tracking/engine.py``).  ``profile_epochs``
measures that split for one channel bank: launches per epoch, host-clock
wall time per epoch, device time per epoch, the correlator's share of it
and the device's idle share.  PERF.md's "where the time goes" table is made
by this function (``chip_smoke.py`` calls it), so that successive readings
are made the same way.

The device numbers come from ``torch.profiler`` (CUPTI) and exist only on a
CUDA device; on the CPU they are None ("not measured").
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .. import resolve_device
from ..signals.defs import get_signal
from ..tracking import engine

# the correlator kernels' names in a trace (csrc/*.cu)
_CORRELATOR_KERNELS = ("correlate_bank_kernel", "correlate_windows")


def make_bank(cfg, device, n_blocks: int = 1, n_epochs: int = 20,
              seed: int = 0):
    """A channel bank at ``cfg``'s width on random int8 samples:
    ``cfg.num_channels`` channels spread over the Doppler band, as
    ``n_blocks`` time blocks of ``n_epochs`` (B·C rows sharing C table
    rows).  Returns (iq, tables, ptables, state, params)."""
    sig = get_signal(cfg.signal)
    params = engine.make_track_params(cfg, sig)
    n_ch = cfg.num_channels
    spc = cfg.samples_per_code
    rng = np.random.default_rng(seed)
    n_samp = (n_blocks * n_epochs + 6) * spc
    iq = torch.from_numpy(
        rng.integers(-16, 17, 2 * n_samp).astype(np.int8)).to(device)
    prns = list(cfg.acq_satellite_list)[:n_ch]
    channels = [(prn, cfg.if_freq + 500.0 * (j - n_ch // 2), 149 * j)
                for j, prn in enumerate(prns)]
    dops = [c[1] - cfg.if_freq for c in channels]
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
    """Profile ``track_superblock`` over ``n_epochs`` epochs of the bank
    ``make_bank`` builds, after a warm-up run.

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
        out = engine.track_superblock(iq, 0, tables, ptables, state, params,
                                      n_epochs)
        if on_card:
            torch.cuda.synchronize(device)
        return out

    run()                                           # warm-up (and build)
    walls = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        run()
        walls.append((time.perf_counter() - t0) * 1e3 / n_epochs)
    res = dict(signal=cfg.signal, rows=int(state.abs_sample.shape[0]),
               epochs=n_epochs, fetch_in_kernel=fetch_in_kernel,
               wall_ms_per_epoch=walls, launches_per_epoch=None,
               device_ms_per_epoch=None, correlator_ms_per_epoch=None,
               idle_share=None)
    if not on_card:
        return res
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    device_us = sum(e.self_device_time_total for e in events)
    if device_us <= 0:
        return res                  # the trace held no device time
    corr_us = sum(e.self_device_time_total for e in events
                  if any(k in e.key for k in _CORRELATOR_KERNELS))
    res.update(
        launches_per_epoch=sum(e.count for e in events) / n_epochs,
        device_ms_per_epoch=device_us / 1e3 / n_epochs,
        correlator_ms_per_epoch=corr_us / 1e3 / n_epochs,
        idle_share=1.0 - device_us / 1e3 / n_epochs / min(walls))
    return res


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
