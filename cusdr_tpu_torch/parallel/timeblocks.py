"""Time-block parallel tracking (the sequence-parallel axis).

Counterpart of cusdr_tpu/parallel/timeblocks.py, single device.  Sequential
tracking carries the DLL/PLL state from epoch to epoch; here the record's
timeline is split into B blocks that are tracked at the same time as one
B·C-row channel bank, so the per-epoch host work of the eager engine is
paid once for B epochs of record.  Two modes compose:

  * predict (handoff_iters = 0): each block starts from a state propagated
    open-loop from the acquisition solution (``predict_block_states``).
    The prediction error stays within the loops' pull-in range, so every
    block re-converges within a short transient (``settle_epochs``) that
    consumers mask from measurement formation (``receiver.nav_solve``).

  * state handoff (handoff_iters >= 1): after a pass, block k+1 restarts
    from block k's final loop state (``_ring_shift``).  Block 0 always
    holds the true initial state, so after pass i the first i+1 blocks are
    exactly the sequential trajectory, and converged later blocks differ
    only by the loops' decayed memory of their predicted start.

Two ways to run a pass, as in the reference: the flat bank over the whole
record on the device, windows fetched by the kernel (``_track_blocks_flat``,
the default), and the per-block path over per-block sample buffers with
windows staged (``_track_blocks``); on a card each is one superblock-kernel
launch per pass.  The reference vmaps
its per-block path; here the blocks' buffers are concatenated into one
pseudo-record and run as one flat bank with a per-row record end, as the
reference's sharded body does.  Sharding the block axis over several
devices is not ported yet (ROADMAP.md Queue A item 11).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..signals.defs import SignalDef
from ..tracking.engine import (ChannelState, TrackOutputs, TrackParams,
                               TrackResults, build_replica_tables,
                               code_dopplers, init_channel_state,
                               make_track_params, track_superblock,
                               track_superblock_epochs)

# correlator outputs that flip with a block's Costas lock sign
_SIGNED = {"i_e", "q_e", "i_p", "q_p", "i_l", "q_l", "pilot_ip", "pilot_qp"}


def _ring_shift(states0: ChannelState, final: ChannelState) -> ChannelState:
    """Block k+1 restarts from block k's final state; block 0 keeps the
    true initial state.  Leaves [B, C]."""
    return ChannelState(*(torch.cat([s0[:1], fin[:-1]])
                          for s0, fin in zip(states0, final)))


def _track_bank_of_blocks(rec, tables, ptables, states: ChannelState,
                          params: TrackParams, n_epochs: int, end_sample,
                          epoch_loop: bool = False):
    """``track_superblock`` over the [B, C] states as one B·C-row bank on
    the record ``rec`` (sb_start 0); ``track_superblock_epochs`` with
    ``epoch_loop``.  Returns (states [B, C], outputs [B, n_epochs, C])."""
    b, c = states.abs_sample.shape
    flat = ChannelState(*(x.reshape(b * c) for x in states))
    track = track_superblock_epochs if epoch_loop else track_superblock
    st, outs = track(rec, 0, tables, ptables, flat, params, n_epochs,
                     end_sample)
    st = ChannelState(*(x.reshape(b, c) for x in st))
    outs = TrackOutputs(*(x.reshape(n_epochs, b, c).permute(1, 0, 2)
                          for x in outs))
    return st, outs


def _track_blocks_flat(samples_iq, tables, ptables, states: ChannelState,
                       params: TrackParams, n_epochs: int, n_blocks: int,
                       epoch_loop: bool = False):
    """The B concurrent blocks as ONE B·C-row bank over the full record:
    ``abs_sample`` already positions every block, the kernel reads its
    windows straight from the record, the replica tables are shared by row
    modulo, and no per-block sample buffers are made.

    samples_iq: [2S] int8 or int16 full record on the device; states
    leaves
    [B, C].  Returns (states [B, C], outputs [B, n_epochs, C])."""
    if states.abs_sample.shape[0] != n_blocks:
        raise ValueError(f"states hold {states.abs_sample.shape[0]} blocks, "
                         f"n_blocks={n_blocks}")
    return _track_bank_of_blocks(samples_iq, tables, ptables, states,
                                 params, n_epochs, None, epoch_loop)


def _track_blocks(samples_blocks, block_starts, block_ends, tables, ptables,
                  states: ChannelState, params: TrackParams, n_epochs: int,
                  epoch_loop: bool = False):
    """The per-block path: every block tracks inside its own sample
    buffer, with the windows staged (``fetch_in_kernel=False``): on a card
    one launch of the staged superblock kernel per pass, which copies each
    epoch's windows into shared memory; on the CPU the eager loop, which
    gathers them before its per-epoch kernel.

    samples_blocks: [B, 2·S_blk] int8 or int16 interleaved block buffers;
    block_starts / block_ends: [B] int64 absolute sample range of each
    buffer; states leaves [B, C].  The buffers are read as one
    pseudo-record with block b at sample b·S_blk: ``abs_sample`` is
    remapped into it on the way in and back on the way out, and each row
    freezes at its own block's end."""
    params = dataclasses.replace(params, fetch_in_kernel=False)
    b, c = states.abs_sample.shape
    blk_len = samples_blocks.shape[1] // 2
    offs = block_starts - torch.arange(
        b, dtype=torch.int64, device=block_starts.device) * blk_len
    st = states._replace(abs_sample=states.abs_sample - offs[:, None])
    end_rows = (block_ends - offs)[:, None].expand(b, c).reshape(b * c)
    st, outs = _track_bank_of_blocks(samples_blocks.reshape(-1), tables,
                                     ptables, st, params, n_epochs,
                                     end_rows, epoch_loop)
    st = st._replace(abs_sample=st.abs_sample + offs[:, None])
    outs = outs._replace(abs_sample=outs.abs_sample + offs[:, None, None])
    return st, outs


def predict_block_states(channels: Sequence, cfg, sig: SignalDef,
                         n_blocks: int, epochs_per_block: int, device):
    """Open-loop state prediction for each block start (numpy f64 on the
    host, then tensors on ``device``).

    Returns (states with leaves [B, C], block first-epoch sample offsets
    [B, C] as a numpy int64 array)."""
    fs = cfg.sampling_freq
    code_len = sig.code_length_chips
    dopplers = code_dopplers(cfg, sig, channels)
    code_freqs = sig.chip_rate_hz * (1.0 + dopplers / sig.carrier_freq_hz)
    phase0 = np.asarray([ch[2] for ch in channels], np.float64)

    starts = np.zeros((n_blocks, len(channels)), np.int64)
    rems = np.zeros((n_blocks, len(channels)), np.float64)
    for b in range(n_blocks):
        # chips elapsed by this block's first epoch
        chips = b * epochs_per_block * code_len
        # sample position where that code period starts
        pos = phase0 + chips * (fs / code_freqs)
        starts[b] = np.ceil(pos).astype(np.int64)
        # rem_code_phase convention: fractional chips already elapsed at
        # the integer start sample
        rems[b] = (starts[b] - pos) * (code_freqs / fs)
    base = init_channel_state(channels, sig.chip_rate_hz, device,
                              dopplers=dopplers,
                              carrier_freq_hz=sig.carrier_freq_hz)
    # a long pilot's period counter advances one per epoch, rolling at mod
    mod = max(getattr(sig, "pilot_phase_hypotheses", 0), 1)
    pper = ((base.pilot_period.cpu().numpy()[None, :]
             + np.arange(n_blocks)[:, None] * epochs_per_block)
            % mod).astype(np.int32)
    stacked = ChannelState(*(x.expand(n_blocks, -1).clone() for x in base))
    stacked = stacked._replace(
        abs_sample=torch.as_tensor(starts, device=device),
        rem_code_phase=torch.as_tensor(rems, device=device),
        pilot_period=torch.as_tensor(pper, device=device))
    return stacked, starts


def track_time_parallel(cfg, sig: SignalDef, samples_iq: np.ndarray,
                        channels: Sequence, n_epochs: int, n_blocks: int,
                        settle_epochs: Optional[int] = None,
                        handoff_iters: Optional[int] = None, *, device,
                        fetch_in_kernel: bool = True,
                        epoch_loop: bool = False) -> TrackResults:
    """Track ``n_epochs`` split into ``n_blocks`` concurrent time blocks
    on ``device``.

    ``handoff_iters`` further passes re-seed each block from its left
    neighbour's final state (module docstring); at 0, per-block transients
    are flagged through ``settle_epochs`` / ``epochs_per_block`` on the
    result and ``nav_solve`` masks them.  ``fetch_in_kernel`` picks the
    flat bank over the whole record (True) or the per-block path over
    per-block buffers with staged windows (False).  ``epoch_loop`` runs the
    eager epoch loop, the superblock kernels' plain version, in their place
    on the card too (a yardstick for the kernels in the same process)."""
    device = torch.device(device)
    samples_iq = np.ascontiguousarray(np.asarray(samples_iq))
    params = dataclasses.replace(make_track_params(cfg, sig),
                                 fetch_in_kernel=fetch_in_kernel)
    spc = cfg.samples_per_code
    if settle_epochs is None:
        settle_epochs = cfg.settle_epochs
    if handoff_iters is None:
        handoff_iters = cfg.handoff_iters
    epochs_per_block = n_epochs // n_blocks
    if epochs_per_block * n_blocks != n_epochs:
        raise ValueError(f"n_epochs={n_epochs} is not a multiple of "
                         f"n_blocks={n_blocks}")

    states0, starts = predict_block_states(channels, cfg, sig, n_blocks,
                                           epochs_per_block, device)
    dopplers0 = code_dopplers(cfg, sig, channels)
    ctabs, ptabs = build_replica_tables(cfg, sig, params, channels,
                                        dopplers0)
    tables = torch.from_numpy(ctabs).to(device)
    ptables = None if ptabs is None else torch.from_numpy(ptabs).to(device)

    if params.fetch_in_kernel:
        samples_d = torch.from_numpy(samples_iq).to(device)

        def one_pass(states):
            return _track_blocks_flat(samples_d, tables, ptables, states,
                                      params, epochs_per_block, n_blocks,
                                      epoch_loop)
    else:
        # per-block sample buffers: one code period of front margin (the
        # handoff may move a block's start slightly before its predicted
        # one) and a tail margin
        total = len(samples_iq) // 2
        blk_len = (epochs_per_block + 4) * spc + params.blk + 256
        sb = np.zeros((n_blocks, 2 * blk_len), samples_iq.dtype)
        sb_start = np.zeros(n_blocks, np.int64)
        sb_end = np.zeros(n_blocks, np.int64)
        for b in range(n_blocks):
            s0 = max(int(starts[b].min()) - spc, 0)
            s1 = min(s0 + blk_len, total)
            sb_start[b], sb_end[b] = s0, s1
            sb[b, :2 * (s1 - s0)] = samples_iq[2 * s0:2 * s1]
        sb_d, starts_d, ends_d = (torch.from_numpy(x).to(device)
                                  for x in (sb, sb_start, sb_end))

        def one_pass(states):
            return _track_blocks(sb_d, starts_d, ends_d, tables, ptables,
                                 states, params, epochs_per_block,
                                 epoch_loop)

    # every pass's outputs stay on the device; only the last pass's are
    # fetched (once, in _stitch)
    states = states0
    for it in range(handoff_iters + 1):
        final, outs = one_pass(states)
        if it < handoff_iters:
            states = _ring_shift(states0, final)
    return _stitch(cfg, channels, n_blocks, epochs_per_block, handoff_iters,
                   settle_epochs, states, final, outs)


def _stitch(cfg, channels, n_blocks, epochs_per_block, handoff_iters,
            settle_epochs, states: ChannelState, final: ChannelState,
            outs: TrackOutputs) -> TrackResults:
    """Join the last pass's block outputs into one [C, n_epochs] result.

    ``states`` are the states the last pass STARTED from, ``final`` the
    ones it ended in.  A block's Costas lock sign is ambiguous: it ran from
    a predicted phase or from its left neighbour's previous-pass final
    state, so its loop may settle pi away from its neighbour's, inverting
    every correlator output of the block and breaking the stitched nav-bit
    stream at the boundary.  A locked loop holds the NCO within ~0 or ~pi
    of the true carrier, so the phase discrepancy at each boundary — block
    k's end phase against the start phase block k+1 used, propagated over
    any small sample offset — resolves the relative sign; cumulative
    products re-sign every block onto block 0's."""
    def fetch(x):
        return x.cpu().numpy()

    signs = None
    if n_blocks > 1:
        fs = cfg.sampling_freq
        fin_phi = fetch(final.rem_carr_phase)              # [B, C] rad
        fin_s = fetch(final.abs_sample).astype(np.float64)
        fin_f = fetch(final.carr_freq)
        st_phi = fetch(states.rem_carr_phase)
        st_s = fetch(states.abs_sample).astype(np.float64)
        dphi = (fin_phi[:-1] - st_phi[1:]
                + 2.0 * np.pi * fin_f[:-1] * (st_s[1:] - fin_s[:-1]) / fs)
        rel = np.where(np.cos(dphi) < 0.0, -1.0, 1.0)      # [B-1, C]
        signs = np.concatenate(
            [np.ones((1, rel.shape[1])), np.cumprod(rel, axis=0)],
            axis=0).astype(np.float32)                     # [B, C]

    # outs leaves: [B, epochs_per_block, C] -> [C, B·epochs_per_block]
    merged = {}
    for name in TrackOutputs._fields:
        v = fetch(getattr(outs, name))
        if signs is not None and name in _SIGNED:
            v = v * signs[:, None, :]
        merged[name] = np.concatenate(list(v), axis=0).T
    res = TrackResults([ch[0] for ch in channels], merged, cfg)
    res.n_blocks = n_blocks
    res.epochs_per_block = epochs_per_block
    # exactly stitched results have no transient to mask
    res.settle_epochs = 0 if handoff_iters >= 1 else settle_epochs
    return res
