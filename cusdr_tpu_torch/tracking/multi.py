"""Concurrent multi-signal tracking: several signals' channel banks at once.

Counterpart of cusdr_tpu/tracking/multi.py (same names).  Each signal keeps
its own IF record (bands are recorded separately), tables, TrackParams and
ChannelState bank; a *hyperepoch* spans the least common multiple of the
signals' code periods (L1CA 1 ms + E1C 4 ms -> 4 ms), within which bank b
runs ``strides[b]`` of its own epochs.

The banks do not interact, so a bank's result equals a standalone ``track``
of it.  With a ``mesh`` (parallel/mesh.py) every bank's channel rows split
over its 'ch' axis, and each (bank, shard) is a bank of its own on the
shard's device; the results are joined in channel order.  On a card each
bank runs on its own CUDA stream: its record goes to the card once, whole
(as the reference holds it), and a fast bank is
advanced one superblock at a time by ``engine.track_superblock`` (one launch
of ops/csrc/superblock.cu per superblock, fetch form, ``sb_start`` 0 and the
record's end), on the epoch boundaries ``track`` uses; a gather bank
(``fast_code`` False) runs the eager gather loop on its stream.  The host
issues the banks' superblocks in turn, so the kernels of the banks can run
side by side on the card; a bank's outputs are read only after its stream's
last event.  There is no lock gate here, as in the reference's
``track_multi``: every channel is tracked through the whole span.
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..parallel.mesh import Shard, check_divides, shard_plan
from .engine import (ChannelState, TrackOutputs, TrackResults, build_tables,
                     code_dopplers, init_channel_state, make_track_params,
                     superblock_epochs, superblock_plan, track_superblock)


class BankInputs(NamedTuple):
    """Device-side inputs of one signal's channel bank."""
    samples: torch.Tensor        # [2S] int8 or int16 interleaved I/Q
    sb_start: int                # absolute sample index of samples[0]
    code_tables: torch.Tensor
    pilot_tables: Optional[torch.Tensor]
    state: ChannelState
    end_sample: Optional[int] = None


def track_superblock_multi(banks, params_list, strides, n_hyper: int,
                           sb_epochs: Optional[Sequence[int]] = None):
    """Advance every bank through ``n_hyper`` hyperepochs.

    banks: sequence of BankInputs; params_list: matching TrackParams;
    strides: epochs per hyperepoch per bank; sb_epochs: per bank, the
    epochs of one launch (default: the whole span in one).  On a card each
    bank runs on a stream of its own, and the host issues the banks'
    superblocks in turn.  Returns a tuple of (new_state, TrackOutputs
    [n_hyper·stride, C]) on the banks' device, ready to read."""
    if sb_epochs is None:
        sb_epochs = [None] * len(banks)
    plans = [superblock_plan(n_hyper * stride,
                             n_hyper * stride if per is None else per)
             for stride, per in zip(strides, sb_epochs)]
    cuda = banks[0].samples.device.type == "cuda"
    streams = []
    if cuda:
        # the inputs were made on the current stream of their device: each
        # bank's stream waits for them, and the allocator keeps them for
        # its stream
        for b in banks:
            dev = b.samples.device
            s = torch.cuda.Stream(dev)
            s.wait_stream(torch.cuda.current_stream(dev))
            for x in (b.samples, b.code_tables, b.pilot_tables, *b.state):
                if x is not None:
                    x.record_stream(s)
            streams.append(s)

    def on(i):
        return torch.cuda.stream(streams[i]) if cuda \
            else contextlib.nullcontext()

    states = [b.state for b in banks]
    outs = [[] for _ in banks]
    for j in range(max(len(p) for p in plans)):
        for i, (b, params, plan) in enumerate(zip(banks, params_list,
                                                  plans)):
            if j >= len(plan):
                continue
            with on(i):
                states[i], o = track_superblock(
                    b.samples, b.sb_start, b.code_tables, b.pilot_tables,
                    states[i], params, plan[j], b.end_sample)
            outs[i].append(o)
    results = []
    for i in range(len(banks)):
        with on(i):
            merged = TrackOutputs(*(torch.cat(x) for x in zip(*outs[i])))
        if cuda:
            done = torch.cuda.Event()
            done.record(streams[i])
            # the current stream reads the bank's outputs after its event,
            # and the allocator keeps them for it
            cur = torch.cuda.current_stream(banks[i].samples.device)
            cur.wait_event(done)
            for x in (*states[i], *merged):
                x.record_stream(cur)
        results.append((states[i], merged))
    return tuple(results)


def _hyper_grid(sigs) -> tuple:
    """Common clock: (hyper_period_ms, per-signal strides)."""
    periods = [int(round(s.code_period_ms)) for s in sigs]
    for p, s in zip(periods, sigs):
        if abs(p - s.code_period_ms) > 1e-9:
            raise ValueError(f"{s.name}: non-integer-ms code period")
    hyper = periods[0]
    for p in periods[1:]:
        hyper = hyper * p // math.gcd(hyper, p)
    return hyper, tuple(hyper // p for p in periods)


def track_multi(specs: Sequence, n_ms: Optional[int] = None,
                device=None, mesh=None) -> list:
    """Track several signals' channel banks concurrently on ``device``
    (default ``"cuda"``), or over ``mesh``.

    specs: sequence of (cfg, sig, samples_iq, channels), one entry per
    signal, each with its own IF record (int8 or int16 interleaved I/Q;
    records need not share fs or length); channels as in ``engine.track``.
    n_ms: common span in milliseconds (default: the largest span every
    record allows).  Each record is held on the device whole, as the
    reference holds it; each bank runs in superblocks of its
    ``cfg.superblock_ms``.  With ``mesh`` (this process's devices; a mesh
    that spans processes raises, as the reference fails to fetch its
    results), each bank's channel rows split over the 'ch' axis, which
    must divide every bank's channel count.

    Returns a list of TrackResults, one per signal, each equal to what
    ``engine.track`` with ``lock_detect`` off produces over the same span.
    """
    if mesh is not None:
        if device is not None:
            raise ValueError("give a device or a mesh, not both")
        if mesh.spans_processes:
            raise RuntimeError("track_multi takes a mesh of this process's "
                               "devices; this one spans processes")
        plan = shard_plan(mesh, ("ch",))
        for _, sig, _, channels in specs:
            check_divides(len(channels), mesh, "ch",
                          f"channels of {sig.name}")
    else:
        plan = [Shard((0,), resolve_device(
            "cuda" if device is None else device), 0)]
    sigs = [sp[1] for sp in specs]
    hyper_ms, strides = _hyper_grid(sigs)
    # one bank per (signal, shard), shard after shard within a signal
    banks, params_list, sb_epochs, bank_strides, limits = [], [], [], [], []
    for (cfg, sig, samples_iq, channels), stride in zip(specs, strides):
        params = make_track_params(cfg, sig)
        samples_iq = np.ascontiguousarray(np.asarray(samples_iq))
        total = len(samples_iq) // 2
        dops = code_dopplers(cfg, sig, channels)
        ct, pt = build_tables(cfg, sig, params, channels, dops)
        spc = cfg.samples_per_code
        max_phase = max(ch[2] for ch in channels)
        limits.append((total - max_phase - 2 * spc) // spc
                      * sig.code_period_ms)
        c_loc = len(channels) // len(plan)
        recs = {}
        for s in plan:
            rows = slice(s.key[0] * c_loc, (s.key[0] + 1) * c_loc)
            if s.device not in recs:
                recs[s.device] = torch.from_numpy(samples_iq).to(s.device)
            banks.append(BankInputs(
                recs[s.device], 0, torch.from_numpy(ct[rows]).to(s.device),
                None if pt is None else
                torch.from_numpy(pt[rows]).to(s.device),
                init_channel_state(channels[rows], sig.chip_rate_hz,
                                   s.device, dopplers=dops[rows],
                                   carrier_freq_hz=sig.carrier_freq_hz),
                total))
            params_list.append(params)
            sb_epochs.append(superblock_epochs(cfg, sig))
            bank_strides.append(stride)
    if n_ms is None:
        n_ms = int(min(limits))
    n_hyper = int(n_ms) // hyper_ms
    if n_hyper < 1:
        raise ValueError(f"n_ms={n_ms} below one {hyper_ms} ms hyperepoch")

    results = track_superblock_multi(banks, params_list, bank_strides,
                                     n_hyper, sb_epochs)
    out = []
    for i, (cfg, _, _, channels) in enumerate(specs):
        touts = [r[1] for r in results[i * len(plan):(i + 1) * len(plan)]]
        merged = {f: torch.cat([getattr(t, f).cpu() for t in touts],
                               1).numpy().T
                  for f in TrackOutputs._fields}
        out.append(TrackResults([ch[0] for ch in channels], merged, cfg))
    return out
