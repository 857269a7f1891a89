"""Channel-bank tracking engine in PyTorch.

Counterpart of cusdr_tpu/tracking/engine.py (same names, fields and
[n_epochs, C] output layout).  ``track_superblock`` tracks the whole bank
through a superblock of epochs.  On a card that is ONE launch of a
superblock kernel (window geometry, correlator sums and loop closure of
every epoch, loop state in the row's thread block): ops/csrc/superblock.cu
with the windows fetched in the kernel, ops/csrc/superblock_staged.cu with
them staged (``fetch_in_kernel=False``: bulk copies into shared memory).
Their plain version is the eager loop ``track_superblock_epochs``, which
the CPU runs: per epoch one correlator launch (ops/correlator.py; staged
windows are gathered before it) and a few [C]-wide f64 tensor ops for the
discriminators and loop filters (``_close_epoch``); loop state stays
float64 on the device.  The host loop ``track`` stages the record one
superblock at a time and reads a superblock's outputs back one superblock
late, so the host waits on the device once per superblock.

Covered: the fast sliced-replica path (``fast_code``) for data-only and
data+pilot signals, including the long pilot (L2C CL, ``pilot_period_mod``)
and the B1C WB QMBOC dual pilot bank, FDMA channels (GLONASS: each
channel's carrier sits ``fdma_spacing_hz · k`` off the IF, and only the
Doppler left after that offset aids its code rate), both tap modes
(``interp_taps``), int8 or int16 records (``cfg.data_type``; the kernels
are instantiated for both); windows fetched in the kernel
(``fetch_in_kernel``, the default) or staged before it; a scalar or per-row
record end, so that one flat bank can hold rows of several time blocks
(parallel/timeblocks.py).

Where the correlator spacing falls under half a sample (``fast_code``
False: bds_b1c's 0.06 chips below 8.525 Msps) the replica tables cannot
hold an E-L offset of at least one sample, and the engine takes the
reference's per-epoch gather path: chip-grid element tables
(``build_element_tables``) and, per epoch, the E/P/L chips of every sample
gathered by ceil-index from them (``_epoch_bank_gather``).  The reference
has no Pallas kernel there, and neither has the port: on a card as on the
CPU it is the eager loop of [C, blk] tensor ops, under the same
``track_superblock`` entry.
"""

from __future__ import annotations

import functools
import warnings
from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..signals.defs import SignalDef
from ..ops.correlator import (clamp_offsets, correlate_bank,
                              correlate_windows, pack_sums, stage_windows,
                              track_superblock_bank,
                              track_superblock_staged_bank)
from .cno import cno_vsm, pll_lock_detector
from .loop_filters import (calc_loop_coef, calc_loop_coef_carr3,
                           calc_loop_coef_exact)
from .qmboc import calc_weighing_factor

_TWO_PI = 2.0 * np.pi
# replica table margin [samples]: the reference's value, so both packages
# build bit-identical tables
UP_MARGIN = 1024


@dataclass(frozen=True)
class TrackParams:
    """Static tracking parameters (the reference's TrackParams less its
    TPU-only fields, same names and defaults)."""
    fs: float
    code_len: int               # chips per code period
    elements_per_chip: int      # data code elements per chip
    code_freq_basis: float      # nominal chip rate [Hz]
    blk: int                    # fixed block size [samples]
    spacing: float              # E-L correlator spacing [chips]
    tau1_code: float
    tau2_code: float
    tau1_carr: float
    tau2_carr: float
    pdi: float                  # integration time [s]
    k_spacing: int = 1          # E-L spacing [samples]
    pll_order: int = 2
    pf1: float = 0.0            # 3rd-order PLL gains
    pf2: float = 0.0
    pf3: float = 0.0
    interp_taps: bool = True    # sub-sample replica interpolation; False
                                # = nearest-sample taps
    has_pilot: bool = False
    data_weight: float = 0.5    # data/pilot PLL combining
    pilot_weight: float = 0.5
    dll_data_weight: float = 0.5    # data/pilot DLL combining
    dll_pilot_weight: float = 0.5
    dll_scale: float = 1.0      # DLL discriminator scale (WB: 1-spacing)
    pilot_rot: int = 1          # pilot carrier phase in quarter turns vs
                                # data: 1 = +Q, 0 = +I (L2C CL), 2 = -I,
                                # 3 = -Q
    pilot_period_mod: int = 0   # long pilot spanning N code periods (L2C
                                # CL: 75): its window advances one period
                                # per epoch, rolling at N
    has_pilot2: bool = False    # B1C WB QMBOC: a second pilot bank
    pilot2_rot: int = 2         # bank-2 quarter-turn rotation
    pilot_w1: float = 1.0       # composite weights of the rotated banks
    pilot_w2: float = 0.0
    fetch_in_kernel: bool = True    # the kernel reads its windows from the
                                    # record and tables at per-row offsets;
                                    # False = windows staged with tensor
                                    # indexing before the staged kernel
    fast_code: bool = True      # sliced pre-sampled replicas; False = the
                                # per-epoch gather from element tables
                                # (spacing under half a sample)
    pilot_epc: int = 0          # gather path: pilot elements per chip (0 =
                                # elements_per_chip)
    pilot2_epc: int = 0         # gather path: bank-2 elements per chip
                                # (B1C WB BOC(6,1): 12)


class ChannelState(NamedTuple):
    """Per-channel loop state, [C] tensors on the tracking device."""
    carr_freq: torch.Tensor          # f64 [Hz]
    carr_freq_basis: torch.Tensor    # f64 [Hz]
    code_freq: torch.Tensor          # f64 [Hz]
    code_freq_basis: torch.Tensor    # f64 [Hz]
    rem_code_phase: torch.Tensor     # f64 [chips]
    rem_carr_phase: torch.Tensor     # f64 [rad]
    carr_nco: torch.Tensor           # f64
    carr_err: torch.Tensor           # f64
    code_nco: torch.Tensor           # f64
    code_err: torch.Tensor           # f64
    d_carr: torch.Tensor             # f64 — 3rd-order PLL integrators
    d2_carr: torch.Tensor            # f64
    abs_sample: torch.Tensor         # i64 — sample index of epoch start
    pilot_period: torch.Tensor       # i32 — long-pilot period counter
    active: torch.Tensor             # bool — channel lifecycle


class TrackOutputs(NamedTuple):
    """Per-epoch outputs [n_epochs, C]."""
    i_e: torch.Tensor
    q_e: torch.Tensor
    i_p: torch.Tensor
    q_p: torch.Tensor
    i_l: torch.Tensor
    q_l: torch.Tensor
    pilot_ip: torch.Tensor
    pilot_qp: torch.Tensor
    carr_freq: torch.Tensor
    code_freq: torch.Tensor
    dll_discr: torch.Tensor
    dll_filt: torch.Tensor
    pll_discr: torch.Tensor
    pll_filt: torch.Tensor
    rem_code_phase: torch.Tensor
    rem_carr_phase: torch.Tensor
    abs_sample: torch.Tensor
    blksize: torch.Tensor


# ChannelState's f64 fields, in the order the superblock kernel reads them
_F64_FIELDS = ChannelState._fields[:12]


def pack_state(state: ChannelState):
    """The state as the superblock kernel takes it: (f64 [12, C] of the
    f64 fields in order, abs_sample [C] int64, pilot_period [C] int32,
    active [C] bool)."""
    return (torch.stack(state[:len(_F64_FIELDS)]), state.abs_sample,
            state.pilot_period, state.active)


def unpack_state(f64, abs_sample, pilot_period, active) -> ChannelState:
    """``pack_state``'s inverse; the f64 fields are views of ``f64``."""
    return ChannelState(*f64.unbind(0), abs_sample=abs_sample,
                        pilot_period=pilot_period, active=active)


def init_channel_state(channels: Sequence, code_freq_basis: float,
                       device, dopplers=None,
                       carrier_freq_hz: float = 0.0) -> ChannelState:
    """channels: iterable of (prn, acquired_carr_freq, code_phase_samples
    [, pilot_period]).  With ``dopplers`` and ``carrier_freq_hz`` the code
    NCO centre is Doppler-aided: basis·(1 + doppler/f_carrier)."""
    c = len(channels)
    carr = np.asarray([ch[1] for ch in channels], np.float64)
    phase = np.asarray([ch[2] for ch in channels], np.int64)
    pper = np.asarray([ch[3] if len(ch) > 3 else 0 for ch in channels],
                      np.int32)
    basis = np.full(c, code_freq_basis, np.float64)
    if dopplers is not None and carrier_freq_hz > 0:
        basis = basis * (1.0 + np.asarray(dopplers, np.float64)
                         / carrier_freq_hz)

    def t(x):
        return torch.as_tensor(x, device=device)

    def z():
        return torch.zeros(c, dtype=torch.float64, device=device)

    return ChannelState(
        carr_freq=t(carr), carr_freq_basis=t(carr.copy()),
        code_freq=t(basis.copy()), code_freq_basis=t(basis),
        rem_code_phase=z(), rem_carr_phase=z(),
        carr_nco=z(), carr_err=z(), code_nco=z(), code_err=z(),
        d_carr=z(), d2_carr=z(),
        abs_sample=t(phase), pilot_period=t(pper),
        active=torch.ones(c, dtype=torch.bool, device=device))


def _epoch_bank(iq, sb_start: int, end_sample, tables, ptables, wrow,
                st: ChannelState, p: TrackParams):
    """One epoch for the whole bank: window geometry and carrier steps as
    [C] tensor ops, the correlator (one launch, pilot banks included),
    then ``_close_epoch`` (the counterpart of the reference's
    ``_epoch_bank_pallas``).  ``end_sample``: int or [C] int64 tensor."""
    k = p.k_spacing
    code_phase_step = st.code_freq / p.fs           # f64 [C]
    blksize = torch.ceil((p.code_len - st.rem_code_phase)
                         / code_phase_step).long().clamp(max=p.blk)
    shift_f = st.rem_code_phase / code_phase_step
    shift = torch.floor(shift_f)
    alpha = (shift_f - shift).float()
    start = UP_MARGIN - k + shift.long()
    ptab = pstart = palpha = None
    if p.has_pilot:
        ptab = ptables
        pstart, palpha = start, alpha
        if p.pilot_period_mod > 1:
            # long pilot (L2C CL): the window advances one code period per
            # epoch within the full-period table.  The chip -> index map
            # is the table's, so divide by the BUILD-time step
            # (code_freq_basis), not the live DLL rate: at period P the
            # difference grows by P·code_len chips and would walk the
            # replica off by whole chips within a few periods.
            pshift_f = ((st.rem_code_phase
                         + st.pilot_period.double() * p.code_len)
                        / (st.code_freq_basis / p.fs))
            pshift = torch.floor(pshift_f)
            palpha = (pshift_f - pshift).float()
            pstart = UP_MARGIN - k + pshift.long()
    rot = dict(pilot_rot=p.pilot_rot, pilot2_rot=p.pilot2_rot,
               pilot_w1=p.pilot_w1, pilot_w2=p.pilot_w2)
    inc = _TWO_PI * st.carr_freq / p.fs             # f64 rad/sample
    inc_c = st.carr_freq / p.fs                     # f64 cycles/sample
    # the carrier's u·v factors: shi steps u per 128 samples, slo steps v
    shi = torch.remainder(inc_c * 128.0, 1.0).float()
    slo = torch.remainder(inc_c, 1.0).float()
    remc = torch.remainder(st.rem_carr_phase / _TWO_PI, 1.0).float()
    # i64 window offsets: an i32 offset would overflow past ~115 s of an
    # 18 Msps record
    off = st.abs_sample - sb_start
    if p.fetch_in_kernel:
        out = correlate_bank(iq, off, tables, wrow, start, alpha, remc, shi,
                             slo, blksize, k=k, blk=p.blk,
                             interp_taps=p.interp_taps, ptable=ptab,
                             pstart=pstart, palpha=palpha, **rot)
    else:
        siq, wt, wp = stage_windows(iq, off, tables, wrow, start, k=k,
                                    blk=p.blk, ptable=ptab, pstart=pstart)
        out = correlate_windows(siq, wt, alpha, remc, shi, slo, blksize,
                                k=k, interp_taps=p.interp_taps, wp=wp,
                                palpha=palpha, **rot)
    return _close_epoch(st, p, blksize, code_phase_step, inc, end_sample,
                        out)


def _epoch_bank_gather(iq, sb_start: int, end_sample, tables, ptables,
                       wrow, st: ChannelState, p: TrackParams,
                       tap_offsets: torch.Tensor):
    """One epoch for the whole bank on the gather path (``fast_code``
    False), the counterpart of the reference's ``_epoch_one_channel`` with
    ``fast_code`` False, as [C, blk] tensor ops: the E/P/L chips of sample
    n are the elements ``ceil((tcode_n + off)·epc) - 1`` (mod the code's
    elements) of the row's element table, with ``tcode_n = f32(rem) +
    n·f32(step)`` in f32.  The reference's XLA program contracts that
    product and sum into one fused multiply-add (on the CPU its tcode is
    the once-rounded value in every element), and a tcode rounded twice
    moves a few indices in ten thousand by one; so the port forms it
    exactly in f64 (n < 2^17 and the f32 operands make the product and the
    sum exact there) and rounds once, the same on either device.  The
    carrier is the reference's n = 256·n_hi + n_lo split in f32.  Then the
    six sums per bank and ``_close_epoch`` as on the fast path.  tables:
    [R, E] int8 element tables; ptables: None, [R, Ep] or, for the dual
    bank, [R, Ep + E2] (bank 2's elements after bank 1's); row c reads
    table row ``wrow[c]``; tap_offsets: f32 [3] (-spacing, 0, spacing) on
    the device, made once per superblock."""
    dev = iq.device
    blk, epc = p.blk, p.elements_per_chip
    code_phase_step = st.code_freq / p.fs           # f64 [C]
    blksize = torch.ceil((p.code_len - st.rem_code_phase)
                         / code_phase_step).long().clamp(max=blk)
    # sample windows, offsets clamped as dynamic_slice clamps them
    off = clamp_offsets(st.abs_sample - sb_start, iq.shape[0] // 2, blk)
    n_i = torch.arange(blk, device=dev)
    siq = iq.view(-1, 2)[off[:, None] + n_i].float()
    mask = (n_i[None, :] < blksize[:, None]).float()
    # f32(rem) + n·f32(step), exact in f64, rounded once to f32
    tcode = (st.rem_code_phase.float().double()[:, None]
             + n_i.double()[None, :]
             * code_phase_step.float().double()[:, None]).float()
    # E/P/L chip phases [C, 3, blk], f32(tcode) + f32(-spacing, 0, spacing)
    taps = tcode[:, None, :] + tap_offsets[None, :, None]
    rows = wrow[:, None, None]

    def chips(table, per_chip: int, base: int, n_elem: int, shift=0):
        """[C, 3, blk] E/P/L chips of the elements ``base ..`` of each
        row's table, ``shift`` [C, 1, 1] elements into them."""
        idx = torch.ceil(taps * per_chip).long() - 1 + shift
        return table[rows, base + torch.remainder(idx, n_elem)].float()

    # carrier wipe-off: phase in cycles from n = 256·n_hi + n_lo, so both
    # products stay small enough for f32
    inc_c = st.carr_freq / p.fs                     # f64 cycles/sample
    step_hi = torch.remainder(inc_c * 256.0, 1.0).float()[:, None]
    step_lo = torch.remainder(inc_c, 1.0).float()[:, None]
    rem_c = torch.remainder(st.rem_carr_phase / _TWO_PI, 1.0).float()
    cyc = (rem_c[:, None] + step_hi * (n_i // 256).float()[None, :]
           + step_lo * (n_i % 256).float()[None, :])
    phase = (cyc - torch.floor(cyc)) * np.float32(_TWO_PI)
    cosw, sinw = torch.cos(phase), torch.sin(phase)
    sig_i, sig_q = siq[..., 0], siq[..., 1]
    bb = torch.stack([(sig_i * cosw + sig_q * sinw) * mask,
                      (sig_q * cosw - sig_i * sinw) * mask], dim=2)

    def sums(codes):
        """Six sums iE qE iP qP iL qL [C] of [C, 3, blk] chips."""
        return list(torch.bmm(codes, bb).reshape(-1, 6).unbind(1))

    n_elem = p.code_len * epc
    pilot_sums = []
    if p.has_pilot:
        pepc = p.pilot_epc or epc
        pn_elem = p.code_len * pepc * max(p.pilot_period_mod, 1)
        # a long pilot (L2C CL) reads the code period of its period counter
        pshift = (st.pilot_period.long()[:, None, None]
                  * (p.code_len * pepc) if p.pilot_period_mod > 1 else 0)
        pilot_sums.append(sums(chips(ptables, pepc, 0, pn_elem, pshift)))
        if p.has_pilot2:
            pilot_sums.append(sums(chips(ptables, p.pilot2_epc, pn_elem,
                                         p.code_len * p.pilot2_epc)))
    out = pack_sums(sums(chips(tables, epc, 0, n_elem)), pilot_sums,
                p.pilot_rot, p.pilot2_rot, p.pilot_w1, p.pilot_w2)
    return _close_epoch(st, p, blksize, code_phase_step,
                        _TWO_PI * st.carr_freq / p.fs, end_sample, out)


def _close_epoch(st: ChannelState, p: TrackParams, blksize,
                 code_phase_step, inc, end_sample, sums):
    """Discriminators, loop filters and state/output packing, all [C]
    elementwise; ``sums`` is the correlator's [C, 8] output, or [C, 16]
    with the pilot sums in columns 6-11.  Returns the new state and
    (out_f32 [12, C], out_f64 [4, C], out_i64 [2, C])."""
    i_e, q_e, i_p, q_p, i_l, q_l = sums[:, :6].unbind(1)
    if p.has_pilot:
        pi_e, pq_e, pi_p, pq_p, pi_l, pq_l = sums[:, 6:12].unbind(1)
    # an epoch is valid only while the channel is active and its window
    # stays inside the record
    valid = st.active & (st.abs_sample + p.blk <= end_sample)
    bsf = blksize.double()
    rem_code = (st.rem_code_phase + bsf * code_phase_step) - p.code_len
    rem_carr = torch.remainder(st.rem_carr_phase + inc * bsf, _TWO_PI)

    # PLL: atan Costas + loop filter (f32 discriminator, f64 filter)
    eps = 1e-12
    carr_err = torch.atan(q_p / (i_p + eps)) / _TWO_PI
    if p.has_pilot:
        pcarr = torch.atan(pq_p / (pi_p + eps)) / _TWO_PI
        carr_err = p.data_weight * carr_err + p.pilot_weight * pcarr
    carr_err = carr_err.double()
    if p.pll_order == 3:
        d2_carr = st.d2_carr + carr_err * p.pf3
        d_carr = d2_carr + carr_err * p.pf2 + st.d_carr
        carr_nco = d_carr + carr_err * p.pf1
    else:
        d_carr, d2_carr = st.d_carr, st.d2_carr
        carr_nco = (st.carr_nco
                    + (p.tau2_carr / p.tau1_carr) * (carr_err - st.carr_err)
                    + carr_err * (p.pdi / p.tau1_carr))
    carr_freq = st.carr_freq_basis + carr_nco

    # DLL: E-L envelope + 2nd-order filter
    env_e = torch.sqrt(i_e * i_e + q_e * q_e)
    env_l = torch.sqrt(i_l * i_l + q_l * q_l)
    code_err = (env_e - env_l) / (env_e + env_l + eps)
    if p.has_pilot:
        penv_e = torch.sqrt(pi_e * pi_e + pq_e * pq_e)
        penv_l = torch.sqrt(pi_l * pi_l + pq_l * pq_l)
        p_err = (penv_e - penv_l) / (penv_e + penv_l + eps)
        code_err = p.dll_scale * (p.dll_data_weight * code_err
                                  + p.dll_pilot_weight * p_err)
    code_err = code_err.double()
    code_nco = (st.code_nco
                + (p.tau2_code / p.tau1_code) * (code_err - st.code_err)
                + code_err * (p.pdi / p.tau1_code))
    code_freq = st.code_freq_basis - code_nco
    pilot_period = st.pilot_period
    if p.pilot_period_mod > 1:
        pilot_period = torch.remainder(pilot_period + 1, p.pilot_period_mod)

    # freeze inactive / out-of-data channels
    def keep(new, old):
        return torch.where(valid, new, old)

    new_state = st._replace(
        carr_freq=keep(carr_freq, st.carr_freq),
        code_freq=keep(code_freq, st.code_freq),
        rem_code_phase=keep(rem_code, st.rem_code_phase),
        rem_carr_phase=keep(rem_carr, st.rem_carr_phase),
        carr_nco=keep(carr_nco, st.carr_nco),
        carr_err=keep(carr_err, st.carr_err),
        code_nco=keep(code_nco, st.code_nco),
        code_err=keep(code_err, st.code_err),
        d_carr=keep(d_carr, st.d_carr),
        d2_carr=keep(d2_carr, st.d2_carr),
        abs_sample=keep(st.abs_sample + blksize, st.abs_sample),
        pilot_period=keep(pilot_period, st.pilot_period),
        active=valid)

    # rows 6, 7 are the pilot prompt pair: sums columns 8, 9 with a pilot
    # bank, else the zero columns 6, 7
    pp = 8 if p.has_pilot else 6
    out_f32 = torch.cat([
        sums[:, :6].T, sums[:, pp:pp + 2].T,
        torch.stack([code_err, code_nco, carr_err, carr_nco]).float()
    ]) * valid.float()
    out_f64 = torch.stack([st.carr_freq, st.code_freq, st.rem_code_phase,
                           st.rem_carr_phase])
    out_i64 = torch.stack([st.abs_sample,
                           torch.where(valid, blksize, 0)])
    return new_state, (out_f32, out_f64, out_i64)


def track_superblock(iq: torch.Tensor, sb_start: int, tables: torch.Tensor,
                     pilot_tables: Optional[torch.Tensor],
                     state: ChannelState, params: TrackParams,
                     n_epochs: int, end_sample=None):
    """Track all channels through ``n_epochs`` code periods.

    iq: [2S] int8 or int16 interleaved I/Q superblock on the tracking
    device;
    sb_start: absolute sample index of iq[0]; tables / pilot_tables: int8
    replica tables from ``build_replica_tables`` (pilot_tables None
    without a pilot bank); end_sample: absolute end of the record
    (channels whose next window crosses it freeze), an int or a [C] int64
    tensor on iq's device (rows of time blocks with different buffer ends
    in one flat bank), default the end of the superblock.  More rows than
    table rows share the tables by row modulo.  Returns (new_state,
    TrackOutputs [n_epochs, C]).

    A record on a card takes one launch of a superblock kernel: the
    windows fetched in the kernel with ``params.fetch_in_kernel``, else
    staged into shared memory (a build or launch failure raises); a record
    on the CPU takes ``track_superblock_epochs``, and so does the gather
    path (``params.fast_code`` False, element tables) on either device."""
    if iq.device.type != "cuda" or not params.fast_code:
        return track_superblock_epochs(iq, sb_start, tables, pilot_tables,
                                       state, params, n_epochs, end_sample)
    end_sample = _check_superblock(iq, sb_start, pilot_tables, params,
                                   end_sample)
    n_ch = state.carr_freq.shape[0]
    if not isinstance(end_sample, torch.Tensor):
        end_sample = torch.full((n_ch,), end_sample, dtype=torch.int64,
                                device=iq.device)
    bank = (track_superblock_bank if params.fetch_in_kernel
            else track_superblock_staged_bank)
    new, packed = bank(
        iq, sb_start, tables, pilot_tables if params.has_pilot else None,
        *pack_state(state), end_sample, n_epochs, params,
        up_margin=UP_MARGIN)[:2]
    return _finish_bank(unpack_state(*new), packed)


def _check_superblock(iq, sb_start, pilot_tables, params, end_sample):
    """What ``track_superblock`` takes on either path; returns
    ``end_sample`` with its default filled in."""
    if params.has_pilot and pilot_tables is None:
        raise ValueError("a pilot bank needs pilot_tables")
    if iq.dtype not in (torch.int8, torch.int16):
        raise ValueError(f"the record must be int8 or int16 I/Q, got "
                         f"{iq.dtype}")
    if end_sample is None:
        end_sample = sb_start + iq.shape[0] // 2
    return end_sample


def track_superblock_epochs(iq: torch.Tensor, sb_start: int,
                            tables: torch.Tensor,
                            pilot_tables: Optional[torch.Tensor],
                            state: ChannelState, params: TrackParams,
                            n_epochs: int, end_sample=None):
    """``track_superblock`` as an eager loop over the epochs (arguments and
    result as there), on any device: per epoch the geometry as [C] tensor
    ops, one correlator launch and ``_close_epoch``.  It is the plain
    version the superblock kernels are held against (the staged one with
    ``params.fetch_in_kernel`` False).  With ``params.fast_code`` False
    each epoch is the gather step ``_epoch_bank_gather`` instead, on
    element tables, and launches no kernel of ops/."""
    end_sample = _check_superblock(iq, sb_start, pilot_tables, params,
                                   end_sample)
    n_ch = state.carr_freq.shape[0]
    wrow = torch.arange(n_ch, device=iq.device) % tables.shape[0]
    step = _epoch_bank
    if not params.fast_code:
        # the E/P/L offsets [chips], sent to the device once per superblock
        step = functools.partial(_epoch_bank_gather, tap_offsets=torch.tensor(
            [-params.spacing, 0.0, params.spacing], dtype=torch.float32,
            device=iq.device))
    o32, o64, oi = [], [], []
    for _ in range(n_epochs):
        state, (a, b, c) = step(iq, sb_start, end_sample, tables,
                                pilot_tables, wrow, state, params)
        o32.append(a)
        o64.append(b)
        oi.append(c)
    return _finish_bank(state, (torch.stack(o32), torch.stack(o64),
                                torch.stack(oi)))


def _finish_bank(new_state, packed):
    """Unpack the epoch loop's dtype-homogeneous output stacks into
    TrackOutputs."""
    o32, o64, oi = packed
    # o32: [E, 12, C]; o64: [E, 4, C]; oi: [E, 2, C]
    outs = TrackOutputs(
        i_e=o32[:, 0], q_e=o32[:, 1], i_p=o32[:, 2], q_p=o32[:, 3],
        i_l=o32[:, 4], q_l=o32[:, 5],
        pilot_ip=o32[:, 6], pilot_qp=o32[:, 7],
        dll_discr=o32[:, 8], dll_filt=o32[:, 9],
        pll_discr=o32[:, 10], pll_filt=o32[:, 11],
        carr_freq=o64[:, 0], code_freq=o64[:, 1],
        rem_code_phase=o64[:, 2], rem_carr_phase=o64[:, 3],
        abs_sample=oi[:, 0], blksize=oi[:, 1])
    return new_state, outs


# --------------------------------------------------------------------------
# Host orchestration
# --------------------------------------------------------------------------

class TrackResults:
    """Per-channel tracking results (numpy, [C, n_epochs] fields).

    ``active_until[c]`` is the first epoch at which channel c stopped
    producing valid correlations — n_epochs when it ran to the end;
    ``status[c]`` is 'T' tracking or '-' dropped."""

    def __init__(self, prns, outputs: dict, cfg):
        self.prns = prns
        for k, v in outputs.items():
            setattr(self, k, v)
        n_epochs = self.i_p.shape[1]
        alive = np.asarray(self.blksize) > 0     # [C, E]
        self.active_until = np.where(
            alive.any(axis=1),
            n_epochs - np.argmax(alive[:, ::-1], axis=1),
            0).astype(np.int64)
        self.status = ['T' if a == n_epochs else '-'
                       for a in self.active_until]
        self.cno = {}
        vsm = cfg.cno.vsm_interval_ms
        for c in range(len(prns)):
            vals = []
            for s in range(0, n_epochs - vsm + 1, vsm):
                vals.append(cno_vsm(self.i_p[c, s:s + vsm],
                                    self.q_p[c, s:s + vsm],
                                    cfg.cno.acc_time_s))
            self.cno[c] = np.asarray(vals)


def sample_code_any(elements, code_len_chips, code_freq, fs, n, phase0):
    """Nearest-element sampling with the element grid derived from the
    array length; int8 (codes are exactly ±1)."""
    epc = len(elements) // code_len_chips
    idx = np.floor((phase0 + np.arange(n) * (code_freq / fs))
                   * epc).astype(np.int64) % len(elements)
    return elements[idx].astype(np.int8)


def build_replica_tables(cfg, sig: SignalDef, params: TrackParams,
                         channels: Sequence, dopplers) -> tuple:
    """Pre-sampled replicas for the fast path, as the reference builds them.

    Returns (code_tables, pilot_tables): code tables int8 [C, L], L = blk +
    2*UP_MARGIN, where index m holds the code at chip phase
    (m - UP_MARGIN)*step_c, step_c the channel's Doppler-aided code step.
    Pilot tables on the same grid: [C, L]; [C, L + (mod-1)*spc_max] for a
    long pilot spanning mod code periods; [C, 2, L] for the dual bank
    (BOC(1,1) then BOC(6,1)); None without a pilot bank."""
    m0 = UP_MARGIN
    length = params.blk + 2 * m0
    c = len(channels)
    ctabs = np.empty((c, length), np.int8)
    mod = max(params.pilot_period_mod, 1)
    spc_max = int(np.ceil(cfg.sampling_freq * sig.code_length_chips
                          / sig.chip_rate_hz)) + 2
    plength = length + (mod - 1) * spc_max
    ptabs = None
    if params.has_pilot2:
        ptabs = np.zeros((c, 2, plength), np.int8)
    elif params.has_pilot:
        ptabs = np.zeros((c, plength), np.int8)
    for k, ch in enumerate(channels):
        code_freq = sig.chip_rate_hz * (
            1.0 + dopplers[k] / sig.carrier_freq_hz)
        phase0 = -m0 * code_freq / cfg.sampling_freq
        elems = sig.data_code(0 if sig.fdma else int(ch[0]))
        ctabs[k] = sample_code_any(elems, sig.code_length_chips, code_freq,
                                   cfg.sampling_freq, length, phase0)
        if params.has_pilot2:
            for b, pfn in enumerate((sig.pilot_code, sig.pilot_code_wb)):
                ptabs[k, b] = sample_code_any(
                    pfn(int(ch[0])), sig.code_length_chips, code_freq,
                    cfg.sampling_freq, plength, phase0)
        elif params.has_pilot:
            ptabs[k] = sample_code_any(
                sig.pilot_code(int(ch[0])), sig.code_length_chips * mod,
                code_freq, cfg.sampling_freq, plength, phase0)
    return ctabs, ptabs


def build_element_tables(cfg, sig: SignalDef, params: TrackParams,
                         channels: Sequence) -> tuple:
    """Chip-grid element tables for the gather path, as the reference
    builds them: (code_tables int8 [C, code_len·epc], pilot_tables int8
    [C, Ep], or [C, Ep + E2] for the dual bank with bank 2's elements after
    bank 1's, or None without a pilot bank)."""
    ctabs = np.stack([sig.data_code(0 if sig.fdma else int(ch[0]))
                      for ch in channels])
    if not params.has_pilot:
        return ctabs, None
    if params.has_pilot2:
        ptabs = np.stack([np.concatenate([sig.pilot_code(int(ch[0])),
                                          sig.pilot_code_wb(int(ch[0]))])
                          for ch in channels])
    else:
        ptabs = np.stack([sig.pilot_code(int(ch[0])) for ch in channels])
    return ctabs, ptabs


def build_tables(cfg, sig: SignalDef, params: TrackParams,
                 channels: Sequence, dopplers) -> tuple:
    """The tables ``params`` tracks on: replica tables on the fast path,
    element tables on the gather path."""
    if params.fast_code:
        return build_replica_tables(cfg, sig, params, channels, dopplers)
    return build_element_tables(cfg, sig, params, channels)


def make_track_params(cfg, sig: SignalDef) -> TrackParams:
    """Loop constants, block geometry and pilot-bank settings for ``sig``
    under ``cfg`` (the reference's derivation)."""
    coef = calc_loop_coef_exact if cfg.loop_design == "exact" \
        else lambda bw, z, k, _t: calc_loop_coef(bw, z, k)
    t1c, t2c = coef(cfg.dll_noise_bandwidth,
                    cfg.dll_damping_ratio, 1.0, cfg.int_time)
    t1p, t2p = coef(cfg.pll_noise_bandwidth,
                    cfg.pll_damping_ratio, 0.25, cfg.int_time)
    pf1, pf2, pf3 = calc_loop_coef_carr3(cfg.pll_noise_bandwidth,
                                         cfg.int_time)
    # the sliced-replica path needs an E-L offset of at least one sample
    k_nominal = cfg.dll_correlator_spacing * cfg.sampling_freq \
        / sig.chip_rate_hz
    fast = k_nominal >= 0.5
    if not fast:
        warnings.warn(
            f"{sig.name}: correlator spacing {cfg.dll_correlator_spacing} "
            f"chips is under half a sample at fs={cfg.sampling_freq:.3e}; "
            "falling back to the slow per-epoch gather path",
            stacklevel=2)
    has_pilot = cfg.pilot_trk_flag > 0 and sig.pilot_code is not None
    # data/pilot combining weights: the squared acquisition amplitude
    # weights (B1C 11/40 + 29/40), else 50/50
    if len(sig.acq_weights) >= 2:
        w = np.asarray(sig.acq_weights[:2], np.float64) ** 2
        wd, wp = (w / w.sum()).tolist()
    else:
        wd = wp = 0.5
    dll_wd, dll_wp = wd, wp
    dll_scale = 1.0
    has_pilot2 = False
    pilot2_epc = 0
    pilot_w1, pilot_w2 = 1.0, 0.0
    pilot_rot = 0 if sig.pilot_in_phase else 1
    if cfg.pilot_trk_flag == 2 and sig.pilot_code_wb is not None:
        # B1C WB QMBOC: BOC(1,1) and BOC(6,1) pilot banks tracked together
        # and combined as sqrt(29/33)·p11 + sqrt(4/33)·p61 after rotating
        # both onto +I (the +Q BOC(1,1) by -j, rot 3; the -I BOC(6,1) by
        # -1, pilot2_rot 2); PLL 1/4 + 3/4, DLL by the RMS-bandwidth
        # factor with a (1 - spacing) scale
        factor = calc_weighing_factor(sig.chip_rate_hz, cfg.front_end_bw)
        wd, wp = 0.25, 0.75
        dll_wd, dll_wp = factor, 1.0 - factor
        dll_scale = 1.0 - cfg.dll_correlator_spacing
        has_pilot2 = True
        pilot2_epc = sig.pilot_wb_elements_per_chip
        pilot_w1, pilot_w2 = np.sqrt(29.0 / 33.0), np.sqrt(4.0 / 33.0)
        pilot_rot = 3
    return TrackParams(
        fs=cfg.sampling_freq, code_len=sig.code_length_chips,
        elements_per_chip=sig.elements_per_chip,
        code_freq_basis=sig.chip_rate_hz,
        blk=cfg.samples_per_code + cfg.track_block_pad,
        spacing=cfg.dll_correlator_spacing, fast_code=fast,
        pilot2_epc=pilot2_epc,
        tau1_code=t1c, tau2_code=t2c, tau1_carr=t1p, tau2_carr=t2p,
        pdi=cfg.int_time, k_spacing=max(int(round(k_nominal)), 1),
        pll_order=cfg.pll_order, pf1=pf1, pf2=pf2, pf3=pf3,
        interp_taps=cfg.interp_taps,
        has_pilot=has_pilot, data_weight=wd, pilot_weight=wp,
        dll_data_weight=dll_wd, dll_pilot_weight=dll_wp,
        dll_scale=dll_scale, pilot_rot=pilot_rot,
        pilot_period_mod=(sig.pilot_phase_hypotheses
                          if has_pilot and sig.pilot_phase_hypotheses > 1
                          else 0),
        has_pilot2=has_pilot2, pilot2_rot=(4 - sig.pilot_wb_rot) % 4,
        pilot_w1=float(pilot_w1), pilot_w2=float(pilot_w2))


def code_dopplers(cfg, sig: SignalDef, channels: Sequence) -> np.ndarray:
    """Each channel's Doppler [Hz], f64: its acquired carrier less the IF
    and, for an FDMA signal, less its frequency channel's offset
    ``fdma_spacing_hz · k`` (k = the channel's prn).  It aids the code rate
    (tables and the code NCO's centre); the carrier NCO keeps the full
    acquired carrier."""
    carr = np.asarray([ch[1] for ch in channels], np.float64)
    offsets = np.zeros(len(channels))
    if sig.fdma:
        offsets = np.asarray([sig.fdma_spacing_hz * ch[0]
                              for ch in channels])
    return carr - cfg.if_freq - offsets


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _to_host(outs: TrackOutputs, device: torch.device):
    """Start copying a superblock's outputs to the host.  Returns (host
    TrackOutputs, CUDA event to wait on before reading them, or None)."""
    if device.type != "cuda":
        return outs, None
    host = TrackOutputs(*(x.to("cpu", non_blocking=True) for x in outs))
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(device))
    return host, done


def stage_superblock(samples_iq: np.ndarray, sb_start: int,
                     buf_len: int) -> np.ndarray:
    """A superblock's staging buffer: ``buf_len`` samples of the
    interleaved record (int8 or int16, kept) from sample ``sb_start``,
    zeros past the record's end."""
    buf = np.zeros(2 * buf_len, samples_iq.dtype)
    lo, hi = sb_start, min(sb_start + buf_len, len(samples_iq) // 2)
    buf[:2 * (hi - lo)] = samples_iq[2 * lo:2 * hi]
    return buf


def superblock_epochs(cfg, sig: SignalDef) -> int:
    """Epochs in one superblock of ``cfg.superblock_ms`` (at least one)."""
    return max(int(cfg.superblock_ms / sig.code_period_ms), 1)


def superblock_plan(n_epochs: int, per: int) -> list:
    """Epoch counts of the superblocks that ``n_epochs`` epochs are cut
    into, ``per`` at a time from the first (the last may hold fewer)."""
    per = max(int(per), 1)
    return [min(per, n_epochs - done) for done in range(0, n_epochs, per)]


def track(cfg, sig: SignalDef, samples_iq: np.ndarray, channels: Sequence,
          device, n_epochs: Optional[int] = None) -> TrackResults:
    """Host loop: stage superblocks on ``device``, run the engine,
    collect results.

    samples_iq: int8 or int16 interleaved I/Q for the whole record
    channels: [(prn, acquired_carr_freq, code_phase_samples
    [, pilot_period])]; the optional 4th element seeds the long pilot's
    period counter (``init_channel_state``).  For an FDMA signal the prn is
    the frequency channel k and the carrier includes its offset.
    """
    device = torch.device(device)
    params = make_track_params(cfg, sig)
    samples_iq = np.ascontiguousarray(np.asarray(samples_iq))
    spc = cfg.samples_per_code
    total_samples = len(samples_iq) // 2
    max_phase = max(ch[2] for ch in channels)
    if n_epochs is None:
        n_epochs = int((total_samples - max_phase - 2 * spc) // spc)
    sb_epochs = min(n_epochs, superblock_epochs(cfg, sig))

    # Doppler-aided code rates (tables + state init)
    dopplers0 = code_dopplers(cfg, sig, channels)
    ctabs, ptabs = build_tables(cfg, sig, params, channels, dopplers0)
    tables = torch.from_numpy(ctabs).to(device)
    ptables = None if ptabs is None else torch.from_numpy(ptabs).to(device)
    state = init_channel_state(channels, sig.chip_rate_hz, device,
                               dopplers=dopplers0,
                               carrier_freq_hz=sig.carrier_freq_hz)
    vsm = cfg.cno.vsm_interval_ms
    low_lock = np.zeros(len(channels), np.int32)
    base_pwr = [None]
    chunks = []
    drop_ratio = 10.0 ** (-cfg.lock_power_drop_db / 10.0)

    def drain(outs, done, cur, sb_start, buf_len):
        """Wait for a dispatched superblock's outputs, hold its windows to
        the buffer it was staged in (``buf_len`` samples from
        ``sb_start``) and run the lock gate on them; returns a drop mask
        for the carry state, or None.

        Lock gate: the PLL NBD/NBP detector plus a prompt-power gate
        against the channel's running-max power; a channel failing either
        for 2 consecutive superblocks is dropped.  The fetch lags the
        dispatch by one superblock, so a drop takes effect one superblock
        later than in a synchronous loop (as in the reference)."""
        if done is not None:
            done.synchronize()
        out_np = TrackOutputs(*(x.numpy() for x in outs))
        # the window bounds below are analytic; a window outside the buffer
        # was clamped on the device and correlated the wrong samples
        off = out_np.abs_sample - sb_start
        outside = (out_np.blksize > 0) & ((off < 0)
                                          | (off > buf_len - params.blk))
        if outside.any():
            ep, ch = np.argwhere(outside)[0]
            raise RuntimeError(
                f"channel {ch} (PRN {channels[ch][0]}): the window at "
                f"sample {out_np.abs_sample[ep, ch]} lies outside its "
                f"superblock's buffer [{sb_start}, {sb_start + buf_len})")
        chunks.append(out_np)
        if not (cfg.lock_detect and cur >= vsm):
            return None
        alive = out_np.blksize[-1] > 0
        pwr = (out_np.i_p.astype(np.float64) ** 2
               + out_np.q_p.astype(np.float64) ** 2).mean(axis=0)
        if base_pwr[0] is None:
            base_pwr[0] = pwr.copy()
        else:
            base_pwr[0] = np.maximum(base_pwr[0], pwr)
        for c in range(len(channels)):
            if not alive[c]:
                continue
            pld = pll_lock_detector(out_np.i_p[-vsm:, c],
                                    out_np.q_p[-vsm:, c])
            bad = (pld < cfg.lock_threshold
                   or pwr[c] < drop_ratio * base_pwr[0][c])
            low_lock[c] = low_lock[c] + 1 if bad else 0
        drop = low_lock >= 2
        return drop if drop.any() else None

    # Pipelined superblock loop: window bounds are analytic (the per-epoch
    # block size stays within spc±2 samples of nominal), so the host never
    # reads device state inside the loop; outputs are read back one
    # superblock behind the dispatch.  Buffers share one size.
    min_phase0 = min(ch[2] for ch in channels)
    done = 0
    pending = None
    drop_mask = None
    buf_len = None
    for cur in superblock_plan(n_epochs, sb_epochs):
        drift = 2 * (done + cur + 3)
        sb_start = max(min_phase0 + done * spc - drift - spc, 0)
        need = (max_phase + (done + cur + 3) * spc + drift
                + params.blk + 256 - sb_start)
        if buf_len is None:
            drift_end = 2 * (n_epochs + 3)
            buf_len = _round_up(
                max_phase - min_phase0 + (sb_epochs + 4) * spc
                + 2 * drift_end + params.blk + 256, 4 * spc)
        buf_len = max(buf_len, _round_up(need, 4 * spc))
        buf = stage_superblock(samples_iq, sb_start, buf_len)
        if drop_mask is not None:
            state = state._replace(active=state.active & torch.from_numpy(
                ~drop_mask).to(device))
        state, outs = track_superblock(
            torch.from_numpy(buf).to(device), sb_start, tables, ptables,
            state, params, cur, total_samples)
        done += cur
        if pending is not None:
            drop_mask = drain(*pending)     # lags one superblock
        pending = (*_to_host(outs, device), cur, sb_start, buf_len)
    if pending is not None:
        drain(*pending)

    merged = {}
    for fieldname in TrackOutputs._fields:
        merged[fieldname] = np.concatenate(
            [getattr(c, fieldname) for c in chunks], axis=0).T  # [C, E]
    return TrackResults([ch[0] for ch in channels], merged, cfg)
