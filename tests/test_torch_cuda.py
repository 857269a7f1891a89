"""The CUDA kernels on a card: each epoch correlator against its plain
PyTorch version, alone at the ported paths' shapes (no pilot, pilot, dual
pilot; windows fetched in the kernel or staged; u·v, phase-ramp and table
carriers; the phase-ramp kernel, a thread-block cluster per row, also at
every cluster size on ragged rows, bit for bit across two launches, and
its wrapper's refusals); the two superblock kernels (one launch per superblock, windows
fetched or staged into shared memory) against their plain version, the
eager epoch loop, at the gps_l1ca, gal_e5a and bds_b1c WB shapes (the staged
one also at gps_l2c CL's) and at the shapes of three presets no other case
runs (bds_b1i's k = 4, bds_b3i's 15 rows, gal_e1c's 72 008-sample pilot rows
of 4 ms), on locked channels with a cluster per row within chip_smoke.py's
phase 3e tolerances and with one block per row bit for bit, also on
gps_l1ca banks of 17-67 rows in the cluster classes 4, 2 and 1; and
``track_superblock`` on the card against the
CPU (gps_l1ca, gal_e5a with its pilot bank, the flat 96-row time-parallel
bank, the per-block path).  The int16 instantiations of the four kernels
on the receiver's path (``correlate_bank``, ``correlate_windows`` and the
two superblock kernels) against their plain versions, and on an int16
record that is an int8 one times 64 against the int8 instantiations: sums
exactly 64 times, everything else equal.  A glo_l1 bank at the preset's 12
Msps (FDMA carriers up to ±3.94 MHz) through both superblock kernels
against the eager loop, and the circular-shift acquisition with the CL
period search on the card against the CPU.  The gather path's step (no
kernel of ops/, bds_b1c at 4.096 Msps, NB and WB) on the card against the
CPU from the same states; ``track_multi`` of two fast banks and a gather
bank on three streams, each equal to a standalone ``track``; and
``StageTimer`` holding the card's time.  ``engine.track``'s pipelined loop
(a ring of two page-locked staging buffers, copies on a side stream)
against chip_smoke.py's synchronous yardstick, element for element: int8
and int16, the fetch and the staged superblock kernel, the gather path and
a short last superblock, and with the lock gate on, a channel dropped one
superblock late by a drop mask sent to the card; the ring's buffers
page-locked; and the spans of a traced ``Receiver.run`` on the clock of the
card's kernels, their device-side shadows user annotations.

Every case needs a CUDA card and skips without one.  The file imports no
jax, so it also runs where jax is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance for the sums: the kernel and the plain version add ~18 000 f32
products in different orders (per-thread strides and a block tree against
PyTorch's reductions), so |kernel - plain| <= 1e-4 * (max|plain| + 1).
Through ``track_superblock`` the tolerances are those of
tests/test_torch_correlator.py: sums ``atol 2e-4·scale`` (the summation
order differs in every epoch and feeds the loops), loop state ``rtol 1e-6,
atol 1e-4``, ``abs_sample`` exact.  The superblock kernel with one thread
block per row repeats the eager loop's arithmetic operation by operation
and must equal it bit for bit; with a cluster per row the slices of an
epoch are summed in rank order, so its sums are held to the kernels'
tolerance above.
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

from cusdr_tpu_torch import get_config
from cusdr_tpu_torch.signals.defs import get_signal
from cusdr_tpu_torch.ops import correlator as corr
from cusdr_tpu_torch.ops.correlator import (LAUNCHES, correlate_bank,
                                            correlate_bank_plain)
from cusdr_tpu_torch.parallel import timeblocks
from cusdr_tpu_torch.tracking import engine

pytestmark = pytest.mark.cuda

RTOL_SUM = 1e-4
RTOL_TRACK = 2e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _bank_args(dev, seed=11, n_ch=12, blk=18008, k=9, n_samp=4 * 18000):
    """Main-path shapes: 12 channels, blk = 18 008, k = 9, tables of
    blk + 2 * 1024; the last three windows run off the record's end and
    are clamped."""
    rng = np.random.default_rng(seed)
    iq = rng.integers(-16, 17, 2 * n_samp).astype(np.int8)
    table = rng.choice(np.array([-1, 1], np.int8), (n_ch, blk + 2048))
    off = rng.integers(0, n_samp - blk, n_ch)
    off[-3:] = [n_samp - blk, n_samp - blk + 5, n_samp + 100]
    inc = (20e3 + rng.uniform(-7e3, 7e3, n_ch)) / 18e6

    def t(x, dt):
        return torch.as_tensor(np.asarray(x), dtype=dt, device=dev)

    f32, i64 = torch.float32, torch.int64
    return (t(iq, torch.int8), t(off, i64), t(table, torch.int8),
            torch.arange(n_ch, device=dev),
            t(rng.integers(1024 - k - 1, 1024 - k + 2, n_ch), i64),
            t(rng.uniform(0, 1, n_ch), f32), t(rng.uniform(0, 1, n_ch), f32),
            t(np.mod(inc * 128, 1.0), f32), t(np.mod(inc, 1.0), f32),
            t(blk - rng.integers(0, 9, n_ch), i64))


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


@pytest.mark.parametrize("interp_taps", [True, False])
def test_kernel_matches_plain_version(cuda, interp_taps):
    blk, k = 18008, 9
    args = _bank_args(cuda, blk=blk, k=k)
    before = LAUNCHES["correlate_bank"]
    got = correlate_bank(*args, k=k, blk=blk, interp_taps=interp_taps)
    want = correlate_bank_plain(*args, k=k, blk=blk,
                                interp_taps=interp_taps)
    torch.cuda.synchronize()
    assert LAUNCHES["correlate_bank"] == before + 1
    assert got.shape == (12, 8) and torch.isfinite(got).all()
    tol = RTOL_SUM * (want.abs().max().item() + 1.0)
    assert (got - want).abs().max().item() <= tol
    assert not got[:, 6:].any()


def test_wrapper_rejects_what_the_kernel_cannot_take(cuda):
    args = list(_bank_args(cuda))
    mixed = args.copy()
    mixed[1] = mixed[1].cpu()
    with pytest.raises(ValueError, match="off"):
        correlate_bank(*mixed, k=9, blk=18008)
    odd = args.copy()
    odd[0] = args[0][1:-1]          # contiguous, but I/Q pairs misaligned
    with pytest.raises(ValueError, match="even address"):
        correlate_bank(*odd, k=9, blk=18008)
    before = dict(LAUNCHES)
    strided = args.copy()
    strided[2] = torch.cat([args[2], args[2]], dim=1)[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        correlate_bank(*strided, k=9, blk=18008)
    assert LAUNCHES == before


def _pilot_args(dev, n_ch, blk, k, dual, seed=12):
    """Pilot arguments beside ``_bank_args``: a table longer than the code
    table (two banks for ``dual``), windows at their own starts, the last
    two clamped at the table's ends."""
    rng = np.random.default_rng(seed)
    p_len = blk + 4096
    shape = (n_ch, 2, p_len) if dual else (n_ch, p_len)
    ptable = rng.choice(np.array([-1, 1], np.int8), shape)
    pstart = rng.integers(0, p_len - blk - 2 * k - 1, n_ch)
    pstart[-2:] = [p_len - blk, -3]
    return dict(ptable=torch.as_tensor(ptable, device=dev),
                pstart=torch.as_tensor(pstart, device=dev),
                palpha=torch.as_tensor(rng.uniform(0, 1, n_ch),
                                       dtype=torch.float32, device=dev),
                pilot_rot=3 if dual else 1, pilot2_rot=2,
                pilot_w1=float(np.sqrt(29 / 33)) if dual else 1.0,
                pilot_w2=float(np.sqrt(4 / 33)) if dual else 0.0)


@pytest.mark.parametrize("interp_taps", [True, False])
@pytest.mark.parametrize("variant,n_ch,blk,k", [
    ("correlate_bank_pilot", 12, 18008, 1),        # gal_e5a preset
    ("correlate_bank_pilot", 12, 72008, 5),        # gal_e1c preset
    ("correlate_bank_dual_pilot", 15, 180008, 1),  # bds_b1c WB
])
def test_pilot_kernels_match_plain_version(cuda, variant, n_ch, blk, k,
                                           interp_taps):
    args = list(_bank_args(cuda, n_ch=n_ch, blk=blk, k=k, n_samp=4 * blk))
    args[4] = args[4].clone()
    args[4][-1] = args[2].shape[1]        # clamped at the code table's end
    pilot = _pilot_args(cuda, n_ch, blk, k,
                        variant == "correlate_bank_dual_pilot")
    before = dict(LAUNCHES)
    got = correlate_bank(*args, k=k, blk=blk, interp_taps=interp_taps,
                         **pilot)
    want = correlate_bank_plain(*args, k=k, blk=blk,
                                interp_taps=interp_taps, **pilot)
    torch.cuda.synchronize()
    assert LAUNCHES[variant] == before[variant] + 1
    assert got.shape == (n_ch, 16) and torch.isfinite(got).all()
    tol = RTOL_SUM * (want.abs().max().item() + 1.0)
    assert (got - want).abs().max().item() <= tol
    assert not got[:, 12:].any()


@pytest.mark.parametrize("signal,interp_taps", [
    ("gps_l1ca", True), ("gps_l1ca", False), ("gal_e5a", True)])
def test_track_superblock_on_card_matches_cpu(cuda, signal, interp_taps):
    """12 channels at the preset's 18 Msps for 12 epochs: one launch of
    the superblock kernel, outputs and loop state as on the CPU."""
    cfg = get_config(signal, interp_taps=interp_taps)
    sig = get_signal(signal)
    params = engine.make_track_params(cfg, sig)
    spc = cfg.samples_per_code
    n_epochs, n_ch = 12, 12
    rng = np.random.default_rng(7)
    samples = rng.integers(-16, 16, 2 * (n_epochs + 4) * spc).astype(
        np.int8)
    channels = [(1 + c, cfg.if_freq + 300.0 * (c - 6), 101 + 1337 * c)
                for c in range(n_ch)]
    dops = [ch[1] - cfg.if_freq for ch in channels]
    tabs, ptabs = (None if t is None else torch.from_numpy(t)
                   for t in engine.build_replica_tables(
                       cfg, sig, params, channels, dops))
    assert (ptabs is not None) == (signal == "gal_e5a")

    def run(dev):
        st = engine.init_channel_state(channels, sig.chip_rate_hz, dev,
                                       dopplers=dops,
                                       carrier_freq_hz=sig.carrier_freq_hz)
        return engine.track_superblock(
            torch.from_numpy(samples).to(dev), 0, tabs.to(dev),
            None if ptabs is None else ptabs.to(dev), st, params, n_epochs)

    st_c, out_c = run(torch.device("cpu"))
    want = dict(LAUNCHES)
    want["track_superblock" if ptabs is None
         else "track_superblock_pilot"] += 1
    st_g, out_g = run(cuda)
    torch.cuda.synchronize()
    assert LAUNCHES == want
    for name in ("i_e", "q_e", "i_p", "q_p", "i_l", "q_l", "pilot_ip",
                 "pilot_qp"):
        a = getattr(out_c, name).numpy()
        b = getattr(out_g, name).cpu().numpy()
        assert b.shape == (n_epochs, n_ch)
        scale = np.abs(a).max() + 1.0
        assert np.abs(a - b).max() <= RTOL_TRACK * scale, name
    for name in ("carr_freq", "code_freq", "rem_code_phase",
                 "rem_carr_phase"):
        a = getattr(st_c, name).numpy()
        b = getattr(st_g, name).cpu().numpy()
        assert np.allclose(a, b, rtol=1e-6, atol=1e-4), name
    for name in ("abs_sample", "blksize"):
        assert np.array_equal(getattr(out_c, name).numpy(),
                              getattr(out_g, name).cpu().numpy()), name


def _close(got, want, n_out):
    assert got.shape == want.shape == (want.shape[0], n_out)
    assert torch.isfinite(got).all()
    tol = RTOL_SUM * (want.abs().max().item() + 1.0)
    assert (got - want).abs().max().item() <= tol


@pytest.mark.parametrize("interp_taps", [True, False])
@pytest.mark.parametrize("variant,n_ch,blk,k", [
    ("correlate_windows", 12, 18008, 9),               # gps_l1ca preset
    ("correlate_windows", 96, 18008, 9),               # 8 time blocks
    ("correlate_windows_pilot", 12, 72008, 5),         # gal_e1c preset
    ("correlate_windows_dual_pilot", 15, 180008, 1),   # bds_b1c WB
])
def test_window_kernels_match_plain_version(cuda, variant, n_ch, blk, k,
                                            interp_taps):
    args = _bank_args(cuda, n_ch=n_ch, blk=blk, k=k, n_samp=4 * blk)
    iq, off, table, wrow, start, alpha, remc, shi, slo, bsz = args
    n_pilots = corr.WINDOW_VARIANTS.index(variant)
    pilot = _pilot_args(cuda, n_ch, blk, k, n_pilots == 2) if n_pilots \
        else {}
    siq, wt, wp = corr.stage_windows(iq, off, table, wrow, start, k=k,
                                     blk=blk, ptable=pilot.get("ptable"),
                                     pstart=pilot.get("pstart"))
    kw = dict(k=k, interp_taps=interp_taps, wp=wp,
              palpha=pilot.get("palpha"),
              **{n: v for n, v in pilot.items() if n.startswith("pilot_")})
    before = dict(LAUNCHES)
    got = corr.correlate_windows(siq, wt, alpha, remc, shi, slo, bsz, **kw)
    want = corr.correlate_windows_plain(siq, wt, alpha, remc, shi, slo, bsz,
                                        **kw)
    torch.cuda.synchronize()
    before[variant] += 1
    assert LAUNCHES == before
    _close(got, want, 16 if n_pilots else 8)
    # the staged kernel and the fetch kernel read the same windows
    fetch = correlate_bank(*args, k=k, blk=blk, interp_taps=interp_taps,
                           **pilot)
    _close(got, fetch, 16 if n_pilots else 8)
    # both kernels run the same row loop on the same windows: after the
    # loop's split into accumulate / reduce / output steps they still agree
    # to the bit
    assert torch.equal(got, fetch)


def _assert_tracks_close(got, want, exact):
    """``exact``: every field of the state and the outputs equal.  Else
    (a cluster per row, whose sums are added in another order): the integer
    fields equal, every value finite, and the first epoch's sums within
    the kernels' tolerance; on these noise records the loops amplify the
    later epochs' rounding, so the whole superblock is held to the eager
    loop on the locked channels of chip_smoke.py's phase 3e."""
    for g_all, w_all in zip(got, want):
        for name, g, w in zip(g_all._fields, g_all, w_all):
            assert g.shape == w.shape and g.dtype == w.dtype, name
            if exact or not g.is_floating_point():
                assert torch.equal(g, w), name
            else:
                assert torch.isfinite(g).all(), name
    if not exact:
        for name in ("i_e", "q_e", "i_p", "q_p", "i_l", "q_l", "pilot_ip",
                     "pilot_qp"):
            g, w = getattr(got[1], name)[0], getattr(want[1], name)[0]
            tol = RTOL_SUM * (w.abs().max().item() + 1.0)
            assert (g - w).abs().max().item() <= tol, name


@pytest.mark.parametrize("interp_taps", [True, False])
@pytest.mark.parametrize("signal,over,n_blocks,n_epochs", [
    ("gps_l1ca", {}, 1, 40),                      # 12 x 18 008, k = 9
    ("gps_l1ca", dict(pll_order=3), 1, 40),
    ("gps_l1ca", {}, 8, 20),                      # the 96-row flat bank
    ("gal_e5a", {}, 1, 40),                       # pilot, 12 x 18 008
    ("bds_b1c", dict(pilot_trk_flag=2), 1, 12),   # dual pilot, 15 x 180 008
    ("bds_b1i", {}, 1, 40),                       # 12 x 18 008, k = 4
    ("bds_b3i", {}, 1, 40),                       # 15 x 18 008, k = 1
    ("gal_e1c", {}, 1, 20),                       # pilot, 12 x 72 008, 4 ms
])
def test_superblock_kernel_matches_eager_loop(cuda, signal, over, n_blocks,
                                              n_epochs, interp_taps):
    """One launch for the whole superblock against the eager epoch loop on
    the same card: bit for bit with one block per row; with a cluster per
    row the block sizes equal and the first epoch's sums within the kernels'
    tolerance; the last rows end part way through and freeze, and a row
    that comes in inactive (a dropped channel) stays frozen."""
    cfg = get_config(signal, **over)
    iq, tables, ptables, state, params = make_bank(cfg, cuda, n_blocks,
                                                   n_epochs)
    params = dataclasses.replace(params, interp_taps=interp_taps)
    n_rows = state.abs_sample.shape[0]
    active = state.active.clone()
    active[-3] = False
    state = state._replace(active=active)
    end = torch.full((n_rows,), iq.shape[0] // 2, device=cuda)
    end[-2] = state.abs_sample[-2] + (n_epochs // 2) * cfg.samples_per_code
    end[-1] = state.abs_sample[-1] + 5
    args = (iq, 0, tables, ptables, state, params, n_epochs, end)
    before = dict(LAUNCHES)
    want = engine.track_superblock_epochs(*args)
    name = corr.SUPERBLOCK_VARIANTS[
        0 if ptables is None else ptables.dim() - 1]
    assert LAUNCHES[name] == before[name]
    assert LAUNCHES[corr.VARIANTS[corr.SUPERBLOCK_VARIANTS.index(name)]] \
        == before[corr.VARIANTS[corr.SUPERBLOCK_VARIANTS.index(name)]] \
        + n_epochs
    valid = want[1].blksize > 0
    assert valid[:, :-3].all() and not valid[:, -1].any()
    assert valid[0, -2] and not valid[-1, -2] and not valid[:, -3].any()
    got = engine.track_superblock(*args)
    torch.cuda.synchronize()
    assert LAUNCHES[name] == before[name] + 1
    cluster = corr.cluster_size(n_rows)
    _assert_tracks_close(got, want, exact=cluster == 1)
    new, packed = corr.track_superblock_bank(
        iq, 0, tables, ptables, *engine.pack_state(state), end, n_epochs,
        params, up_margin=engine.UP_MARGIN, cluster=1)
    torch.cuda.synchronize()
    one = engine._finish_bank(engine.unpack_state(*new), packed)
    _assert_tracks_close(one, want, exact=True)


def test_superblock_wrapper_rejects_what_the_kernel_cannot_take(cuda):
    cfg = get_config("gps_l1ca")
    iq, tables, _, state, params = make_bank(cfg, cuda, 1, 4)
    end = torch.full((12,), iq.shape[0] // 2, device=cuda)
    packed = engine.pack_state(state)
    kw = dict(up_margin=engine.UP_MARGIN)
    before = dict(LAUNCHES)
    with pytest.raises(ValueError, match="end_sample"):
        corr.track_superblock_bank(iq, 0, tables, None, *packed,
                                   end.int(), 4, params, **kw)
    with pytest.raises(ValueError, match="state_f64"):
        corr.track_superblock_bank(iq, 0, tables, None, packed[0][:10],
                                   *packed[1:], end, 4, params, **kw)
    with pytest.raises(ValueError, match="n_epochs"):
        corr.track_superblock_bank(iq, 0, tables, None, *packed, end, 0,
                                   params, **kw)
    with pytest.raises(RuntimeError, match="launch failed"):
        corr.track_superblock_bank(iq, 0, tables, None, *packed, end, 4,
                                   params, cluster=3, **kw)
    assert LAUNCHES == before


@pytest.mark.parametrize("n_ch", [12, 96])
def test_ramp_and_table_kernels_match_plain_version(cuda, n_ch):
    blk, k = 18008, 9
    iq, off, table, wrow, start, alpha, remc, _, slo, bsz = _bank_args(
        cuda, n_ch=n_ch, blk=blk, k=k)
    siq, wt, _ = corr.stage_windows(iq, off, table, wrow, start, k=k,
                                    blk=blk)
    inc = (20e3 + np.linspace(-7e3, 7e3, n_ch)) / 18e6
    f32 = dict(dtype=torch.float32, device=cuda)
    shi = torch.as_tensor(np.mod(256 * inc, 1.0), **f32)
    slo = torch.as_tensor(np.mod(inc, 1.0), **f32)
    before = dict(LAUNCHES)
    got = corr.correlate_windows_ramp(siq, wt, alpha, remc, shi, slo, bsz,
                                      k=k)
    want = corr.correlate_windows_ramp_plain(siq, wt, alpha, remc, shi, slo,
                                             bsz, k=k)
    _close(got, want, 8)
    ph = 2 * np.pi * inc[:, None] * np.arange(blk)[None, :]
    tc, ts = torch.as_tensor(np.cos(ph), **f32), torch.as_tensor(
        np.sin(ph), **f32)
    c0, s0 = torch.cos(remc * 6.0), torch.sin(remc * 6.0)
    got = corr.correlate_windows_table(siq, wt, tc, ts, alpha, c0, s0, bsz,
                                       k=k)
    want = corr.correlate_windows_table_plain(siq, wt, tc, ts, alpha, c0,
                                              s0, bsz, k=k)
    torch.cuda.synchronize()
    _close(got, want, 8)
    before["correlate_windows_ramp"] += 1
    before["correlate_windows_table"] += 1
    assert LAUNCHES == before


def _ramp_case(cuda, n_ch, blk, k=9):
    """Staged windows at ``n_ch`` x ``blk`` with ragged rows (bsz 0 on row
    1, past blk on row 2, blk / 3 on row 3) and the ramp's phase steps."""
    iq, off, table, wrow, start, alpha, remc, _, _, bsz = _bank_args(
        cuda, n_ch=n_ch, blk=blk, k=k)
    siq, wt, _ = corr.stage_windows(iq, off, table, wrow, start, k=k,
                                    blk=blk)
    bsz[1], bsz[2], bsz[3] = 0, blk + 100, blk // 3
    inc = (20e3 + np.linspace(-7e3, 7e3, n_ch)) / 18e6
    f32 = dict(dtype=torch.float32, device=cuda)
    shi = torch.as_tensor(np.mod(256 * inc, 1.0), **f32)
    slo = torch.as_tensor(np.mod(inc, 1.0), **f32)
    return siq, wt, alpha, remc, shi, slo, bsz


def _ramp_call(plan, k=9):
    """The wrapper (its own plan) when ``plan`` is None, else one launch at
    ``plan``."""
    if plan is None:
        return lambda *args: corr.correlate_windows_ramp(*args, k=k)
    return lambda *args: corr._ramp_launch(*args, k=k, plan=plan)


@pytest.mark.parametrize("cluster", [None, 1, 2, 4, 8])
@pytest.mark.parametrize("n_ch,blk", [(12, 18008), (96, 18008), (12, 18011)])
def test_ramp_cluster_kernel_matches_plain_version(cuda, n_ch, blk, cluster):
    """The ramp kernel, a cluster of blocks per row (the wrapper's plan, or
    each size forced), against its plain version on ragged rows (bsz below
    blk, 0 on one row, past blk on another).  The replica rows are blk + 19
    bytes apart and, at blk = 18 011, the sample rows 36 022, so rows start
    off the 16-byte grid the bulk copies move, and the tensors' last bytes
    are no whole 16-byte unit.  Two launches on the same inputs give the
    same bits; each call counts one launch."""
    args = _ramp_case(cuda, n_ch, blk)
    assert args[1].shape[1] % 16
    call = _ramp_call(None if cluster is None
                      else corr.ramp_plan(n_ch, blk, 9, cluster))
    before = LAUNCHES["correlate_windows_ramp"]
    got = call(*args)
    again = call(*args)
    torch.cuda.synchronize()
    assert LAUNCHES["correlate_windows_ramp"] == before + 2
    assert torch.equal(got, again)
    want = corr.correlate_windows_ramp_plain(*args, k=9)
    _close(got, want, 8)
    assert not got[1].any() and not got[:, 6:].any()


def test_ramp_wrapper_rejects_what_the_kernel_cannot_take(cuda):
    """Windows off a 16-byte boundary (the bulk copies move aligned
    units), int16 samples, a layout whose slices do not cover the row:
    each refused, and no launch counted."""
    iq, off, table, wrow, start, alpha, remc, shi, slo, bsz = _bank_args(
        cuda)
    siq, wt, _ = corr.stage_windows(iq, off, table, wrow, start, k=9,
                                    blk=18008)
    buf = torch.zeros(wt.numel() + 16, dtype=torch.int8, device=cuda)
    shifted = buf[3:3 + wt.numel()].view(wt.shape)
    scal = (alpha, remc, shi, slo, bsz)
    before = dict(LAUNCHES)
    with pytest.raises(ValueError, match="16-byte"):
        corr.correlate_windows_ramp(siq, shifted, *scal, k=9)
    with pytest.raises(ValueError, match="int8"):
        corr.correlate_windows_ramp(siq.to(torch.int16), wt, *scal, k=9)
    with pytest.raises(RuntimeError, match="launch failed"):
        corr._ramp_launch(siq, wt, *scal, k=9,
                          plan=corr.ramp_plan(12, 9000, 9))
    assert LAUNCHES == before


@pytest.mark.parametrize("n_ch,smem_bytes,cluster",
                         [(96, 40 * 1024, 1), (96, 96 * 1024, 1),
                          (12, 8 * 1024, 8), (12, 8 * 1024, 2)])
def test_ramp_kernel_through_a_ring_of_tiles(cuda, n_ch, smem_bytes,
                                             cluster):
    """Each block's slice walked in several tiles through the ring of two
    stages (bulk copies of the next tile in flight while one is summed,
    each stage reused), with one block a row and with a cluster, on ragged
    rows, against the plain version and the wrapper's one-tile plan."""
    args = _ramp_case(cuda, n_ch, 18008)
    plan = corr.ramp_plan(n_ch, 18008, 9, cluster, smem_bytes=smem_bytes)
    assert plan.stages == 2 and plan.tile < plan.chunk
    got = _ramp_call(plan)(*args)
    again = _ramp_call(plan)(*args)
    one = corr.correlate_windows_ramp(*args, k=9)
    want = corr.correlate_windows_ramp_plain(*args, k=9)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _close(got, want, 8)
    _close(one, want, 8)


@pytest.mark.parametrize("cluster", [None, 8])
def test_ramp_kernel_carrier_is_the_plain_versions(cuda, cluster):
    """The kernel's cos and sin of its phase ramp, sample by sample: each
    row holds one sample 1 + 0j at its own index, its replica taps are all
    1, so its P sums are exactly the carrier's cos and -sin there, as the
    kernel and the plain version compute them.  Held to 2e-6, far inside
    the sums' tolerance."""
    n_rows, blk, k = 2048, 18008, 9
    rng = np.random.default_rng(5)
    at = torch.as_tensor(rng.integers(0, blk, n_rows), device=cuda)
    rows = torch.arange(n_rows, device=cuda)
    siq = torch.zeros((n_rows, blk, 2), dtype=torch.int8, device=cuda)
    siq[rows, at, 0] = 1
    wt = torch.ones((n_rows, blk + 2 * k + 1), dtype=torch.int8, device=cuda)
    inc = (20e3 + rng.uniform(-7e3, 7e3, n_rows)) / 18e6
    f32 = dict(dtype=torch.float32, device=cuda)
    args = (siq, wt, torch.zeros(n_rows, **f32),
            torch.as_tensor(rng.uniform(0, 1, n_rows), **f32),
            torch.as_tensor(np.mod(256 * inc, 1.0), **f32),
            torch.as_tensor(np.mod(inc, 1.0), **f32),
            torch.full((n_rows,), blk, dtype=torch.int64, device=cuda))
    call = _ramp_call(None if cluster is None
                      else corr.ramp_plan(n_rows, blk, k, cluster))
    got = call(*args)[:, 2:4]
    want = corr.correlate_windows_ramp_plain(*args, k=k)[:, 2:4]
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 2e-6


def test_window_wrapper_rejects_what_the_kernel_cannot_take(cuda):
    iq, off, table, wrow, start, alpha, remc, shi, slo, bsz = _bank_args(
        cuda)
    siq, wt, _ = corr.stage_windows(iq, off, table, wrow, start, k=9,
                                    blk=18008)
    before = dict(LAUNCHES)
    with pytest.raises(ValueError, match="contiguous"):
        corr.correlate_windows(siq, torch.cat([wt, wt], dim=1)[:, ::2][
            :, :wt.shape[1]], alpha, remc, shi, slo, bsz, k=9)
    with pytest.raises(ValueError, match="wt is on"):
        corr.correlate_windows(siq, wt.cpu(), alpha, remc, shi, slo, bsz,
                               k=9)
    assert LAUNCHES == before


@pytest.mark.parametrize("fetch_in_kernel", [True, False])
def test_flat_96_row_bank_on_card_matches_cpu(cuda, fetch_in_kernel):
    """Eight time blocks of the 12-channel gps_l1ca preset as one 96-row
    bank for 10 epochs: one launch of the superblock kernel (flat path)
    or of the staged superblock kernel (per-block path), block states and
    outputs as on the CPU."""
    cfg = get_config("gps_l1ca")
    sig = get_signal("gps_l1ca")
    params = engine.make_track_params(cfg, sig)
    spc = cfg.samples_per_code
    n_blocks, epb, n_ch = 8, 10, 12
    rng = np.random.default_rng(5)
    samples = rng.integers(-16, 16, 2 * (n_blocks * epb + 5) * spc).astype(
        np.int8)
    channels = [(1 + c, cfg.if_freq + 300.0 * (c - 6), 101 + 1337 * c)
                for c in range(n_ch)]
    dops = [ch[1] - cfg.if_freq for ch in channels]
    tabs, _ = engine.build_replica_tables(cfg, sig, params, channels, dops)

    def run(dev):
        states, starts = timeblocks.predict_block_states(
            channels, cfg, sig, n_blocks, epb, dev)
        tables = torch.from_numpy(tabs).to(dev)
        if fetch_in_kernel:
            return timeblocks._track_blocks_flat(
                torch.from_numpy(samples).to(dev), tables, None, states,
                params, epb, n_blocks)
        blk_len = (epb + 4) * spc + params.blk + 256
        sb = np.zeros((n_blocks, 2 * blk_len), np.int8)
        s0s = np.maximum(starts.min(axis=1) - spc, 0)
        s1s = np.minimum(s0s + blk_len, len(samples) // 2)
        for b in range(n_blocks):
            sb[b, :2 * (s1s[b] - s0s[b])] = samples[2 * s0s[b]:2 * s1s[b]]
        return timeblocks._track_blocks(
            torch.from_numpy(sb).to(dev), torch.from_numpy(s0s).to(dev),
            torch.from_numpy(s1s).to(dev), tables, None, states, params,
            epb)

    st_c, out_c = run(torch.device("cpu"))
    want = dict(LAUNCHES)
    want["track_superblock" if fetch_in_kernel
         else "track_superblock_staged"] += 1
    st_g, out_g = run(cuda)
    torch.cuda.synchronize()
    assert LAUNCHES == want
    for name in ("i_e", "q_e", "i_p", "q_p", "i_l", "q_l"):
        a = getattr(out_c, name).numpy()
        b = getattr(out_g, name).cpu().numpy()
        assert b.shape == (n_blocks, epb, n_ch)
        scale = np.abs(a).max() + 1.0
        assert np.abs(a - b).max() <= RTOL_TRACK * scale, name
    for name in ("carr_freq", "code_freq", "rem_code_phase",
                 "rem_carr_phase"):
        a = getattr(st_c, name).numpy()
        b = getattr(st_g, name).cpu().numpy()
        assert np.allclose(a, b, rtol=1e-6, atol=1e-4), name
    for name in ("abs_sample", "blksize"):
        assert np.array_equal(getattr(out_c, name).numpy(),
                              getattr(out_g, name).cpu().numpy()), name


# phase 3e's tolerances for a cluster (chip_smoke.py, TRACK_RTOL and the
# lines above it): f32 fields 2e-4·(max|eager| + 1); the f64 frequencies
# and filter integrators 2e-3 Hz; the other f64 fields rtol 1e-6, atol 1e-4;
# integer and boolean fields equal
FREQ_FIELDS = ("carr_freq", "code_freq", "carr_nco", "code_nco", "d_carr",
               "d2_carr")


def _assert_within_phase_3e(got, want):
    for g_all, w_all in zip(got, want):
        for name, g, w in zip(g_all._fields, g_all, w_all):
            assert g.shape == w.shape and g.dtype == w.dtype, name
            if not g.is_floating_point():
                assert torch.equal(g, w), name
                continue
            assert torch.isfinite(g).all(), name
            d = (g.double() - w.double()).abs()
            if g.dtype == torch.float32:
                assert d.max() <= RTOL_TRACK * (w.abs().max() + 1.0), name
            elif name in FREQ_FIELDS:
                assert d.max() <= 2e-3, name
            else:
                assert (d <= 1e-4 + 1e-6 * w.abs()).all(), name


def _staged(params):
    return dataclasses.replace(params, fetch_in_kernel=False)


L2C_CL = dict(sampling_freq=2.048e6, if_freq=7000.0, pilot_trk_flag=1,
              num_channels=5)


@pytest.mark.parametrize("interp_taps", [True, False])
@pytest.mark.parametrize("signal,over,n_blocks,n_epochs", [
    ("gps_l1ca", {}, 1, 40),                      # 12 x 18 008, k = 9
    ("gps_l1ca", dict(pll_order=3), 1, 40),
    ("gps_l1ca", {}, 8, 20),                      # the 96-row per-block bank
    ("gal_e5a", {}, 1, 40),                       # pilot, 12 x 18 008
    ("bds_b1c", dict(pilot_trk_flag=2), 1, 12),   # dual pilot, 15 x 180 008
    ("gps_l2c", L2C_CL, 1, 12),                   # long pilot, 5 x 40 968
    ("bds_b1i", {}, 1, 40),                       # 12 x 18 008, k = 4
    ("bds_b3i", {}, 1, 40),                       # 15 x 18 008, k = 1
    ("gal_e1c", {}, 1, 20),                       # pilot, 12 x 72 008, 4 ms
])
def test_staged_superblock_kernel_matches_eager_loop(cuda, signal, over,
                                                     n_blocks, n_epochs,
                                                     interp_taps):
    """One launch of the staged superblock kernel against the eager loop on
    staged windows on the same card: bit for bit with one block per row,
    the integer fields equal and the first epoch's sums within the kernels'
    tolerance with a cluster.  Of the last four rows one comes in inactive,
    two end part way through, and one runs its code NCO 5 % slow, so that
    from its second epoch on its windows miss the prefetch and take the
    slow path (read from device memory), still bit for bit."""
    cfg = get_config(signal, **over)
    iq, tables, ptables, state, params = make_bank(cfg, cuda, n_blocks,
                                                   n_epochs)
    params = dataclasses.replace(_staged(params), interp_taps=interp_taps)
    n_rows = state.abs_sample.shape[0]
    active = state.active.clone()
    active[-3] = False
    code_freq = state.code_freq.clone()
    code_freq[-4] *= 0.95
    state = state._replace(active=active, code_freq=code_freq)
    end = torch.full((n_rows,), iq.shape[0] // 2, device=cuda)
    end[-2] = state.abs_sample[-2] + (n_epochs // 2) * cfg.samples_per_code
    end[-1] = state.abs_sample[-1] + 5
    args = (iq, 0, tables, ptables, state, params, n_epochs, end)
    n_pilots = 0 if ptables is None else ptables.dim() - 1
    name = corr.STAGED_SUPERBLOCK_VARIANTS[n_pilots]
    before = dict(LAUNCHES)
    want = engine.track_superblock_epochs(*args)
    before[corr.WINDOW_VARIANTS[n_pilots]] += n_epochs
    assert LAUNCHES == before
    valid = want[1].blksize > 0
    assert valid[:, :-3].all() and not valid[:, -1].any()
    assert valid[0, -2] and not valid[-1, -2] and not valid[:, -3].any()
    got = engine.track_superblock(*args)
    torch.cuda.synchronize()
    before[name] += 1
    assert LAUNCHES == before
    cluster = corr.cluster_size(n_rows)
    _assert_tracks_close(got, want, exact=cluster == 1)
    new, packed, slow = corr.track_superblock_staged_bank(
        iq, 0, tables, ptables, *engine.pack_state(state), end, n_epochs,
        params, up_margin=engine.UP_MARGIN, cluster=1)
    torch.cuda.synchronize()
    one = engine._finish_bank(engine.unpack_state(*new), packed)
    _assert_tracks_close(one, want, exact=True)
    slow = slow.cpu()
    assert slow[-4] == n_epochs - 1 and not slow[:-4].any(), slow


def _locked_bank(signal, over, n_ch, n_epochs, cn0_dbhz, dev, staged=True,
                 n_rows=None):
    """``n_ch`` SVs of ``signal`` synthesized at ``cn0_dbhz``, and the bank
    tracking them from their true code phases and carriers (on staged
    windows, or with ``staged=False`` fetched in the kernel); with
    ``n_rows`` the bank has that many rows, the SVs repeated."""
    from cusdr_tpu_torch.io.synth import (SynthSV, quantize_iq_int8,
                                          synthesize_if)
    cfg, sig = get_config(signal, **over), get_signal(signal)
    spc = cfg.samples_per_code
    rng = np.random.default_rng(3)
    svs = [SynthSV(prn=prn, code_phase=float(rng.integers(0, spc - 1)),
                   doppler_hz=float(d), cn0_dbhz=cn0_dbhz)
           for prn, d in zip(cfg.acq_satellite_list,
                             np.linspace(-4000.0, 4000.0, n_ch))]
    iq = quantize_iq_int8(synthesize_if(
        cfg, sig, svs, num_ms=int((n_epochs + 4) * sig.code_period_ms),
        seed=3))
    rows = [svs[r % n_ch] for r in range(n_rows or n_ch)]
    channels = [(sv.prn, cfg.if_freq + sv.doppler_hz, int(sv.code_phase))
                for sv in rows]
    params = engine.make_track_params(cfg, sig)
    if staged:
        params = _staged(params)
    dops = [sv.doppler_hz for sv in rows]
    tabs, ptabs = (None if t is None else torch.from_numpy(t).to(dev)
                   for t in engine.build_replica_tables(cfg, sig, params,
                                                        channels, dops))
    state = engine.init_channel_state(channels, sig.chip_rate_hz, dev,
                                      dopplers=dops,
                                      carrier_freq_hz=sig.carrier_freq_hz)
    return torch.from_numpy(iq).to(dev), tabs, ptabs, state, params


# locked banks: (signal, overrides, rows, epochs, C/N0 [dB-Hz])
LOCKED_BANKS = [
    ("gps_l1ca", {}, 12, 40, 45.0),
    ("gal_e5a", {}, 12, 40, 50.0),
    ("bds_b1i", {}, 12, 40, 45.0),                # k = 4
    ("bds_b3i", {}, 15, 40, 45.0),                # 15 rows, a cluster of 8
    ("gal_e1c", {}, 12, 20, 45.0),                # pilot, 72 008, 4 ms
]


@pytest.mark.parametrize("signal,over,n_ch,n_epochs,cn0", LOCKED_BANKS)
def test_superblock_cluster_holds_phase_3e_tolerances(cuda, signal, over,
                                                      n_ch, n_epochs, cn0):
    """On locked channels the superblock kernel (windows fetched in the
    kernel) with a cluster per row stays within phase 3e's tolerances of
    the eager loop over the whole superblock, and with one block per row
    equals it bit for bit."""
    iq, tables, ptables, state, params = _locked_bank(
        signal, over, n_ch, n_epochs, cn0, cuda, staged=False)
    end = torch.full((n_ch,), iq.shape[0] // 2, device=cuda)
    args = (iq, 0, tables, ptables, state, params, n_epochs, end)
    want = engine.track_superblock_epochs(*args)
    assert corr.cluster_size(n_ch) > 1
    for cluster in (None, 1):
        new, packed = corr.track_superblock_bank(
            iq, 0, tables, ptables, *engine.pack_state(state), end,
            n_epochs, params, up_margin=engine.UP_MARGIN, cluster=cluster)
        torch.cuda.synchronize()
        got = engine._finish_bank(engine.unpack_state(*new), packed)
        if cluster == 1:
            _assert_tracks_close(got, want, exact=True)
        else:
            _assert_within_phase_3e(got, want)


@pytest.mark.parametrize("signal,over,n_ch,n_epochs,cn0", LOCKED_BANKS)
def test_staged_superblock_cluster_holds_phase_3e_tolerances(
        cuda, signal, over, n_ch, n_epochs, cn0):
    """On locked channels the staged kernel with a cluster per row stays
    within phase 3e's tolerances of the eager loop over the whole
    superblock, and reads every epoch from its prefetched stages."""
    iq, tables, ptables, state, params = _locked_bank(signal, over, n_ch,
                                                      n_epochs, cn0, cuda)
    end = torch.full((n_ch,), iq.shape[0] // 2, device=cuda)
    args = (iq, 0, tables, ptables, state, params, n_epochs, end)
    want = engine.track_superblock_epochs(*args)
    new, packed, slow = corr.track_superblock_staged_bank(
        iq, 0, tables, ptables, *engine.pack_state(state), end, n_epochs,
        params, up_margin=engine.UP_MARGIN)
    torch.cuda.synchronize()
    assert corr.cluster_size(n_ch) > 1
    _assert_within_phase_3e(
        engine._finish_bank(engine.unpack_state(*new), packed), want)
    assert not slow.any()


# gps_l1ca banks in the cluster classes the card had not run before
# chip_smoke.py's phase 20 (12 SVs repeated): (rows, the cluster
# ``cluster_size`` picks, the largest bank of the class)
CLASS_BANKS = [(17, 4, 33), (33, 4, 33), (34, 2, 66), (40, 2, 66),
               (66, 2, 66), (67, 1, None)]


@pytest.mark.parametrize("staged", [False, True])
@pytest.mark.parametrize("n_rows,cluster,last", CLASS_BANKS)
def test_superblock_kernels_in_every_cluster_class(cuda, n_rows, cluster,
                                                   last, staged):
    """Both superblock kernels on a locked bank of ``n_rows`` rows: with
    the cluster ``cluster_size`` picks within phase 3e's tolerances of the
    eager loop, with one block per row equal to it bit for bit; the staged
    one reads every epoch from its prefetched stages."""
    assert corr.cluster_size(n_rows) == cluster
    if last is not None:
        assert corr.cluster_size(last) == cluster
        assert corr.cluster_size(last + 1) == cluster // 2
    iq, tables, ptables, state, params = _locked_bank(
        "gps_l1ca", {}, 12, 40, 45.0, cuda, staged=staged, n_rows=n_rows)
    end = torch.full((n_rows,), iq.shape[0] // 2, device=cuda)
    args = (iq, 0, tables, ptables, state, params, 40, end)
    want = engine.track_superblock_epochs(*args)
    bank = (corr.track_superblock_staged_bank if staged
            else corr.track_superblock_bank)
    for size in (None, 1):
        res = bank(iq, 0, tables, ptables, *engine.pack_state(state), end,
                   40, params, up_margin=engine.UP_MARGIN, cluster=size)
        torch.cuda.synchronize()
        got = engine._finish_bank(engine.unpack_state(*res[0]), res[1])
        if size == 1:
            _assert_tracks_close(got, want, exact=True)
        else:
            _assert_within_phase_3e(got, want)
        if staged:
            assert not res[2].any()


def test_staged_superblock_wrapper_rejects_what_the_kernel_cannot_take(cuda):
    cfg = get_config("gps_l1ca")
    iq, tables, _, state, params = make_bank(cfg, cuda, 1, 4)
    params = _staged(params)
    end = torch.full((12,), iq.shape[0] // 2, device=cuda)
    packed = engine.pack_state(state)
    kw = dict(up_margin=engine.UP_MARGIN)
    before = dict(LAUNCHES)
    with pytest.raises(ValueError, match="16-byte"):
        corr.track_superblock_staged_bank(iq[2:], 0, tables, None, *packed,
                                          end, 4, params, **kw)
    with pytest.raises(ValueError, match="end_sample"):
        corr.track_superblock_staged_bank(iq, 0, tables, None, *packed,
                                          end.int(), 4, params, **kw)
    with pytest.raises(ValueError, match="n_epochs"):
        corr.track_superblock_staged_bank(iq, 0, tables, None, *packed, end,
                                          0, params, **kw)
    with pytest.raises(RuntimeError, match="launch failed"):
        corr.track_superblock_staged_bank(iq, 0, tables, None, *packed, end,
                                          4, params, cluster=3, **kw)
    assert LAUNCHES == before


def test_per_block_path_is_one_staged_launch_per_pass(cuda):
    """``track_time_parallel`` on the per-block path: one staged
    superblock-kernel launch per pass, no per-epoch kernel."""
    cfg = get_config("gps_l1ca")
    sig = get_signal("gps_l1ca")
    n_blocks, epb, n_ch = 8, 10, 12
    spc = cfg.samples_per_code
    samples = np.random.default_rng(5).integers(
        -16, 16, 2 * (n_blocks * epb + 5) * spc).astype(np.int8)
    channels = [(1 + c, cfg.if_freq + 300.0 * (c - 6), 101 + 1337 * c)
                for c in range(n_ch)]
    before = dict(LAUNCHES)
    res = timeblocks.track_time_parallel(
        cfg, sig, samples, channels, n_blocks * epb, n_blocks,
        handoff_iters=1, device=cuda, fetch_in_kernel=False)
    before["track_superblock_staged"] += 2
    assert LAUNCHES == before
    assert res.i_p.shape == (n_ch, n_blocks * epb)
    assert np.isfinite(res.i_p).all() and (res.blksize > 0).all()


def _int16(iq):
    """The record as int16 samples 64 times the int8 ones: every sum of the
    kernels scales by 64 exactly (a power of two) and the loops not at
    all."""
    return iq.to(torch.int16) * 64


_SUMS = ("i_e", "q_e", "i_p", "q_p", "i_l", "q_l", "pilot_ip", "pilot_qp")


def _assert_int16_is_int8_times_64(got, want8):
    for g_all, w_all in zip(got, want8):
        for name, g, w in zip(g_all._fields, g_all, w_all):
            assert torch.equal(g, 64 * w if name in _SUMS else w), name


@pytest.mark.parametrize("interp_taps", [True, False])
@pytest.mark.parametrize("variant,n_ch,blk,k", [
    ("correlate_bank", 12, 18008, 9),
    ("correlate_bank_pilot", 12, 18008, 1),
    ("correlate_bank_dual_pilot", 15, 180008, 1),
    ("correlate_windows", 12, 18008, 9),
    ("correlate_windows_pilot", 12, 72008, 5),
    ("correlate_windows_dual_pilot", 15, 180008, 1),
])
def test_int16_kernels_match_plain_version(cuda, variant, n_ch, blk, k,
                                           interp_taps):
    """The int16 instantiation against the plain version on the int16
    record, and against the int8 instantiation on the int8 record: 64
    times its sums, to the bit."""
    args = list(_bank_args(cuda, n_ch=n_ch, blk=blk, k=k, n_samp=4 * blk))
    n_pilots = 2 if "dual" in variant else 1 if "pilot" in variant else 0
    pilot = _pilot_args(cuda, n_ch, blk, k, n_pilots == 2) if n_pilots \
        else {}
    rot = {n: v for n, v in pilot.items() if n.startswith("pilot_")}

    def call(a, plain=False):
        if variant.startswith("correlate_bank"):
            fn = correlate_bank_plain if plain else correlate_bank
            return fn(*a, k=k, blk=blk, interp_taps=interp_taps, **pilot)
        siq, wt, wp = corr.stage_windows(*a[:5], k=k, blk=blk,
                                         ptable=pilot.get("ptable"),
                                         pstart=pilot.get("pstart"))
        fn = corr.correlate_windows_plain if plain \
            else corr.correlate_windows
        return fn(siq, wt, *a[5:], k=k, interp_taps=interp_taps, wp=wp,
                  palpha=pilot.get("palpha"), **rot)

    args16 = [_int16(args[0])] + args[1:]
    before = dict(LAUNCHES)
    got = call(args16)
    torch.cuda.synchronize()
    before[f"{variant}[int16]"] += 1
    assert LAUNCHES == before
    _close(got, call(args16, plain=True), 16 if n_pilots else 8)
    assert torch.equal(got, 64 * call(args))


@pytest.mark.parametrize("staged", [False, True])
@pytest.mark.parametrize("signal,over,n_epochs", [
    ("gps_l1ca", {}, 40),                          # 12 x 18 008, k = 9
    ("gal_e5a", {}, 40),                           # pilot
    ("bds_b1c", dict(pilot_trk_flag=2), 12),       # dual pilot
])
def test_int16_superblock_kernels_equal_int8_times_64(cuda, staged, signal,
                                                      over, n_epochs):
    """One launch of the int16 instantiation (the wrapper's cluster size):
    the int8 run's states and 64 times its sums; with one block per row
    the eager loop on the int16 record, bit for bit."""
    cfg = get_config(signal, **over)
    iq, tables, ptables, state, params = make_bank(cfg, cuda, 1, n_epochs)
    if staged:
        params = _staged(params)
    n_rows = state.abs_sample.shape[0]
    end = torch.full((n_rows,), iq.shape[0] // 2, device=cuda)
    n_pilots = 0 if ptables is None else ptables.dim() - 1
    name = (corr.STAGED_SUPERBLOCK_VARIANTS if staged
            else corr.SUPERBLOCK_VARIANTS)[n_pilots]
    iq16 = _int16(iq)
    rest = (tables, ptables, state, params, n_epochs, end)
    before = dict(LAUNCHES)
    got = engine.track_superblock(iq16, 0, *rest)
    torch.cuda.synchronize()
    before[f"{name}[int16]"] += 1
    assert LAUNCHES == before
    _assert_int16_is_int8_times_64(got, engine.track_superblock(iq, 0,
                                                                *rest))
    bank = corr.track_superblock_staged_bank if staged \
        else corr.track_superblock_bank
    res = bank(iq16, 0, tables, ptables, *engine.pack_state(state), end,
               n_epochs, params, up_margin=engine.UP_MARGIN, cluster=1)
    torch.cuda.synchronize()
    _assert_tracks_close(engine._finish_bank(engine.unpack_state(*res[0]),
                                             res[1]),
                         engine.track_superblock_epochs(iq16, 0, *rest),
                         exact=True)


@pytest.mark.parametrize("staged", [False, True])
@pytest.mark.parametrize("interp_taps", [True, False])
def test_fdma_bank_superblock_matches_eager_loop(cuda, staged, interp_taps):
    """glo_l1 at the preset's 12 Msps and IF 0: 12 rows on frequency
    channels -7..4, whose carriers reach ±3.94 MHz (0.33 cycles a sample).
    One block per row gives the eager loop's bits; with the wrapper's
    cluster the integer fields are equal and the first epoch's sums within
    the kernels' tolerance."""
    cfg = get_config("glo_l1", interp_taps=interp_taps)
    iq, tables, ptables, state, params = make_bank(cfg, cuda, 1, 40)
    if staged:
        params = _staged(params)
    assert ptables is None and (state.carr_freq.abs().max() > 3.9e6)
    end = torch.full((12,), iq.shape[0] // 2, device=cuda)
    args = (iq, 0, tables, None, state, params, 40, end)
    want = engine.track_superblock_epochs(*args)
    _assert_tracks_close(engine.track_superblock(*args), want,
                         exact=corr.cluster_size(12) == 1)
    bank = corr.track_superblock_staged_bank if staged \
        else corr.track_superblock_bank
    res = bank(iq, 0, tables, None, *engine.pack_state(state), end, 40,
               params, up_margin=engine.UP_MARGIN, cluster=1)
    torch.cuda.synchronize()
    _assert_tracks_close(engine._finish_bank(engine.unpack_state(*res[0]),
                                             res[1]), want, exact=True)


def test_circshift_acquisition_on_card_matches_cpu(cuda):
    """gps_l2c's circular-shift search (±1 kHz here) with the CL period
    search, on the card and on the CPU: the same detection, code phase,
    CL period (37, the scene's), coarse and fine carrier; peak metrics
    within f32 FFT rounding (cuFFT against PocketFFT)."""
    from cusdr_tpu_torch.acquisition.pcps import acquire
    from cusdr_tpu_torch.io.synth import SynthSV, synthesize_if
    cfg = get_config("gps_l2c", sampling_freq=2.048e6, if_freq=7000.0,
                     acq_satellite_list=(3, 7, 9), acq_search_band=1000.0,
                     fine_search_step=5.0, acq_threshold=3.0)
    sig = get_signal("gps_l2c")
    spc = cfg.samples_per_code
    sv = SynthSV(prn=7, code_phase=7000.0 - 37 * spc, doppler_hz=90.0,
                 cn0_dbhz=50)
    x = synthesize_if(cfg, sig, [sv], num_ms=100, seed=3)
    host = acquire(cfg, sig, x, "cpu")
    card = acquire(cfg, sig, x, cuda)
    assert np.array_equal(card.detected, host.detected)
    det = host.detected
    assert det.tolist() == [False, True, False]
    for name in ("code_phase", "pilot_phase", "coarse_freq", "carr_freq"):
        assert np.array_equal(getattr(card, name)[det],
                              getattr(host, name)[det]), name
    assert card.pilot_phase[1] == 37 and card.code_phase[1] == 7000
    assert np.allclose(card.peak_metric, host.peak_metric, rtol=1e-3)


def _gather_scene(dev_seed=5, ms=300):
    """bds_b1c at 4.096 Msps (the gather path): four SVs at 47 dB-Hz, their
    channels at the truth."""
    from cusdr_tpu_torch.io.synth import SynthSV, quantize_iq_int8, \
        synthesize_if
    cfg = get_config("bds_b1c", sampling_freq=4.096e6, if_freq=7000.0)
    sig = get_signal("bds_b1c")
    rng = np.random.default_rng(dev_seed)
    truth = [(19, 5120.0, 150.0), (23, 20011.0, -80.0),
             (25, 31000.0, 900.0), (30, 777.0, -1500.0)]
    svs = [SynthSV(prn=p, code_phase=cp, doppler_hz=d, cn0_dbhz=47,
                   nav_bits=rng.choice(np.asarray([-1, 1], np.int8), 40))
           for p, cp, d in truth]
    iq = quantize_iq_int8(synthesize_if(cfg, sig, svs, num_ms=ms, seed=9))
    return iq, [(p, cfg.if_freq + d, int(cp)) for p, cp, d in truth]


@pytest.mark.parametrize("flag", [1, 2])
def test_gather_step_on_card_matches_cpu(cuda, flag):
    """The gather step (no kernel of ops/) on the card against the CPU, 30
    epochs, each from the card's state: block sizes and every integer
    field equal, the state it started from equal, sums within the
    kernels' tolerance (cuBLAS against the CPU's batched product, and the
    card's f32 cos/sin); no correlator kernel launched."""
    iq, chans = _gather_scene()
    cfg = get_config("bds_b1c", sampling_freq=4.096e6, if_freq=7000.0,
                     pilot_trk_flag=flag)
    sig = get_signal("bds_b1c")
    with pytest.warns(UserWarning, match="gather path"):
        params = engine.make_track_params(cfg, sig)
    dops = engine.code_dopplers(cfg, sig, chans)
    ct, pt = engine.build_element_tables(cfg, sig, params, chans)
    tables = {d: (torch.from_numpy(ct).to(d), torch.from_numpy(pt).to(d),
                  torch.from_numpy(iq).to(d)) for d in ("cpu", cuda)}
    state = engine.init_channel_state(chans, sig.chip_rate_hz, cuda,
                                      dopplers=dops,
                                      carrier_freq_hz=sig.carrier_freq_hz)
    end = len(iq) // 2
    corr.reset_launches()
    for epoch in range(30):
        t, p, x = tables[cuda]
        new, got = engine.track_superblock(x, 0, t, p, state, params, 1, end)
        t, p, x = tables["cpu"]
        host_state = engine.ChannelState(*(v.cpu() for v in state))
        _, want = engine.track_superblock(x, 0, t, p, host_state, params, 1,
                                          end)
        got = engine.TrackOutputs(*(v.cpu() for v in got))
        for f in ("abs_sample", "blksize", "carr_freq", "code_freq",
                  "rem_code_phase", "rem_carr_phase"):
            assert torch.equal(getattr(got, f), getattr(want, f)), (epoch, f)
        for f in ("i_e", "q_e", "i_p", "q_p", "i_l", "q_l", "pilot_ip",
                  "pilot_qp"):
            a, b = getattr(want, f), getattr(got, f)
            tol = RTOL_SUM * (a.abs().max().item() + 1.0)
            assert (a - b).abs().max().item() <= tol, (epoch, f)
        state = new
    assert not any(LAUNCHES.values())


def test_track_multi_streams_equal_standalone_tracks(cuda):
    """Two fast banks (gps_l1ca 12 channels at 2.048 Msps, gal_e1c 12
    channels at 4.096 Msps with its pilot) and a gather bank (bds_b1c at
    4.096 Msps) tracked at once on three streams: each equals a standalone
    ``track`` with the lock gate off, every field, element for element;
    one superblock launch per superblock on each fast bank."""
    from cusdr_tpu_torch.io.synth import SynthSV, quantize_iq_int8, \
        synthesize_if
    from cusdr_tpu_torch.tracking.multi import track_multi
    specs = []
    for signal, over, prns in (
            ("gps_l1ca", dict(sampling_freq=2.048e6, if_freq=7000.0),
             [1, 3, 6, 8, 11, 13, 17, 19, 22, 24, 28, 31]),
            ("gal_e1c", dict(sampling_freq=4.096e6, if_freq=7000.0),
             [1, 3, 5, 7, 9, 11, 13, 19, 21, 24, 26, 30])):
        cfg = get_config(signal, lock_detect=False, superblock_ms=200,
                         **over)
        sig = get_signal(signal)
        rng = np.random.default_rng(len(specs))
        spc = cfg.samples_per_code
        svs = [SynthSV(prn=p, code_phase=float(rng.uniform(0, spc - 1)),
                       doppler_hz=float(d), cn0_dbhz=50)
               for p, d in zip(prns, np.linspace(-4000, 4000, len(prns)))]
        iq = quantize_iq_int8(synthesize_if(cfg, sig, svs, num_ms=700,
                                            seed=1))
        specs.append((cfg, sig, iq, [(sv.prn, cfg.if_freq + sv.doppler_hz,
                                      int(round(sv.code_phase)))
                                     for sv in svs]))
    iq, chans = _gather_scene(ms=700)
    cfg = get_config("bds_b1c", sampling_freq=4.096e6, if_freq=7000.0,
                     lock_detect=False)
    specs.append((cfg, get_signal("bds_b1c"), iq, chans))
    corr.reset_launches()
    with pytest.warns(UserWarning, match="gather path"):
        multi = track_multi(specs, n_ms=600, device=cuda)
    launches = dict(LAUNCHES)
    assert launches["track_superblock"] == 3
    assert launches["track_superblock_pilot"] == 3
    assert sum(launches.values()) == 6
    for spec, got in zip(specs, multi):
        cfg, sig, iq, chans = spec
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            solo = engine.track(cfg, sig, iq, chans, cuda,
                                n_epochs=int(600 / sig.code_period_ms))
        for f in engine.TrackOutputs._fields:
            assert np.array_equal(getattr(got, f), getattr(solo, f)), \
                (cfg.signal, f)


def test_stage_timer_counts_device_time(cuda):
    """A stage that queues ~50 ms of card work reads at least that long:
    the timer synchronises the card at the stage's end."""
    from cusdr_tpu_torch.runtime.profiling import StageTimer
    a = torch.randn(4096, 4096, device=cuda)
    a @ a
    torch.cuda.synchronize()
    first, last = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    timer = StageTimer(device=cuda)
    with timer.stage("matmul"):
        first.record()
        for _ in range(40):
            a = (a @ a) * 1e-3
        last.record()
    device_s = first.elapsed_time(last) / 1e3
    assert device_s > 0.01
    assert timer.stages["matmul"].seconds >= device_s


# ---- multi-device on one card: chip_smoke.py phase 17 (a)-(c), small -----

def _sv_scene(fs, n_ch, ms, cn0_dbhz=45.0):
    """gps_l1ca at ``fs``: ``n_ch`` SVs, a record of ``ms`` ms, and the
    channels at their true carriers and code phases."""
    from cusdr_tpu_torch.io.synth import (SynthSV, quantize_iq_int8,
                                          synthesize_if)
    cfg = get_config("gps_l1ca", sampling_freq=fs, if_freq=7000.0)
    sig = get_signal("gps_l1ca")
    rng = np.random.default_rng(4)
    svs = [SynthSV(prn=prn, code_phase=float(rng.integers(
        0, cfg.samples_per_code - 1)), doppler_hz=float(d),
        cn0_dbhz=cn0_dbhz)
        for prn, d in zip(cfg.acq_satellite_list,
                          np.linspace(-4000.0, 4000.0, n_ch))]
    iq = quantize_iq_int8(synthesize_if(cfg, sig, svs, num_ms=ms, seed=4))
    return cfg, sig, iq, [(sv.prn, cfg.if_freq + sv.doppler_hz,
                           int(sv.code_phase)) for sv in svs]


def test_tracking_step_sharded_on_card(cuda):
    """Two 'ch' shards on the one card: one superblock-kernel launch per
    shard, the joined states and outputs within phase 3e's tolerances of
    ``track_superblock`` on the whole 12-row bank (both with a cluster of
    8 a row) and of the eager loop, the kernel's plain version."""
    from cusdr_tpu_torch.parallel import (make_mesh, shard_channel_bank,
                                          tracking_step_sharded)
    iq, tables, ptables, state, params = _locked_bank("gps_l1ca", {}, 12,
                                                      40, 45.0, cuda)
    params = dataclasses.replace(params, fetch_in_kernel=True)
    want = engine.track_superblock(iq, 0, tables, ptables, state, params,
                                   40)
    mesh = make_mesh(device=[cuda, cuda])
    bank = shard_channel_bank(state, tables, ptables, mesh)
    before = dict(LAUNCHES)
    got = tracking_step_sharded(iq, 0, bank, params, 40)
    torch.cuda.synchronize()
    before["track_superblock"] += 2
    assert LAUNCHES == before
    assert corr.cluster_size(6) == corr.cluster_size(12)
    assert got[1].i_p.shape == (40, 12) and got[1].i_p.is_cuda
    _assert_within_phase_3e(got, want)
    _assert_within_phase_3e(got, engine.track_superblock_epochs(
        iq, 0, tables, ptables, state, params, 40))


def test_pcps_sharded_on_card(cuda):
    """The PRN axis over two 'ch' shards of the card against the unsharded
    search on the card: code phase and bin exact, peaks rtol 1e-5."""
    from cusdr_tpu_torch.acquisition.pcps import _pcps_cdma_kernel
    from cusdr_tpu_torch.parallel import make_mesh, pcps_sharded
    from cusdr_tpu_torch.signals.defs import sample_code
    cfg, sig, iq, _ = _sv_scene(2.048e6, 4, 12)
    spc = cfg.samples_per_code
    nfft, noncoh, prns = 4 * spc, 4, list(range(1, 9))
    x = iq[0::2].astype(np.float32) + 1j * iq[1::2].astype(np.float32)
    slabs = np.zeros((noncoh, nfft), np.complex64)
    for i in range(noncoh):
        slabs[i, :2 * spc] = x[i * spc:(i + 2) * spc]
    cfc = np.stack([np.conj(np.fft.fft(np.concatenate([
        sample_code(sig.data_code(p), 1, sig.chip_rate_hz,
                    cfg.sampling_freq, spc).astype(np.float32),
        np.zeros(nfft - spc, np.float32)])))[None] for p in prns]).astype(
        np.complex64)
    args = (torch.from_numpy(slabs).to(cuda), torch.from_numpy(cfc).to(cuda),
            torch.ones(1, device=cuda),
            torch.from_numpy((cfg.if_freq + 500.0 * np.arange(-8, 9))
                             .astype(np.float32)).to(cuda),
            np.float32(1.0 / cfg.sampling_freq))
    want = _pcps_cdma_kernel(*args, noncoh, 1, 2 * spc)
    got = pcps_sharded(*args, n_comp=1, search_len=2 * spc,
                       mesh=make_mesh(device=[cuda, cuda]))
    assert got[0].is_cuda and got[0].shape == (len(prns),)
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    for g, w in zip(got[::3] + got[4:], want[::3] + want[4:]):
        assert torch.allclose(g, w, rtol=1e-5, atol=0), (g, w)


def test_time_parallel_on_a_card_mesh(cuda):
    """A 1x2 ch x tb mesh of the card: each shard tracks its two blocks
    over its own buffers, one superblock-kernel launch per shard and
    pass; the stitched result within phase 3e's tolerances of the flat
    bank on the card (24 rows a shard against 48: other cluster sizes) and
    of the eager loop, the kernel's plain version, on the same mesh (the
    same block buffers and per-row ends)."""
    from cusdr_tpu_torch.parallel.mesh import Mesh
    cfg, sig, iq, chans = _sv_scene(2.048e6, 12, 410)
    before = dict(LAUNCHES)
    flat = timeblocks.track_time_parallel(cfg, sig, iq, chans, 400, 4,
                                          handoff_iters=1, device=cuda)
    mesh = Mesh([[cuda, cuda]], ("ch", "tb"))
    got = timeblocks.track_time_parallel(cfg, sig, iq, chans, 400, 4,
                                         handoff_iters=1, mesh=mesh)
    torch.cuda.synchronize()
    before["track_superblock"] += 2 + 2 * 2
    assert LAUNCHES == before
    assert corr.cluster_size(24) != corr.cluster_size(48)
    assert corr.cluster_size(24) > 1
    plain = timeblocks.track_time_parallel(cfg, sig, iq, chans, 400, 4,
                                           handoff_iters=1, mesh=mesh,
                                           epoch_loop=True)
    for want in (flat, plain):
        for f in ("abs_sample", "blksize", "active_until"):
            assert np.array_equal(getattr(got, f), getattr(want, f)), f
        for f in _SUMS:
            a, b = getattr(want, f), getattr(got, f)
            assert np.abs(a - b).max() <= RTOL_TRACK * (np.abs(a).max()
                                                        + 1.0), f
        for f in ("carr_freq", "code_freq"):
            assert np.abs(getattr(got, f) - getattr(want, f)).max() <= 2e-3, f



@pytest.fixture(scope="module")
def smoke():
    """chip_smoke.py as a module: its synchronous yardstick ``sync_track``
    for ``engine.track``'s pipelined loop."""
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_pipeline", Path(__file__).resolve().parents[1]
        / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _staged_superblock(real):
    """``engine.track_superblock`` on the staged superblock kernel."""
    def staged(iq, sb_start, tables, ptables, state, params, *args):
        return real(iq, sb_start, tables, ptables, state,
                    dataclasses.replace(params, fetch_in_kernel=False),
                    *args)
    return staged


def _no_synchronize(*args, **kw):
    raise AssertionError("torch.cuda.synchronize inside track")


# 12 SVs at 2.048 Msps, 760 ms, superblocks of 20 ms: 38 superblocks, the
# last of 17 epochs; "short_last" cuts it to 7
PIPELINE_CASES = ("int8", "int16", "staged", "gather", "short_last")


@pytest.mark.parametrize("case", PIPELINE_CASES)
def test_pipelined_track_equals_the_synchronous_loop(cuda, smoke, case,
                                                     monkeypatch):
    """``engine.track`` (staging ring, side-stream copies, events) against
    chip_smoke.py's ``sync_track`` (a fresh buffer, a blocking copy and a
    synchronisation per superblock) on the same window plan, the lock gate
    off: every field equal, element for element, on the fetch and the
    staged superblock kernel, int8 and int16, the gather path (a 0.2-chip
    spacing, 0.4 samples) and a record whose last superblock is short;
    the loop itself calls no ``torch.cuda.synchronize``."""
    cfg, sig, iq, chans = _sv_scene(2.048e6, 12, 760, cn0_dbhz=48.0)
    cfg = cfg.replace(superblock_ms=20, lock_detect=False)
    n_epochs = None
    if case == "int16":
        iq = np.multiply(iq, 64, dtype=np.int16)
    elif case == "staged":
        monkeypatch.setattr(engine, "track_superblock",
                            _staged_superblock(engine.track_superblock))
    elif case == "gather":
        cfg = cfg.replace(dll_correlator_spacing=0.2)
    elif case == "short_last":
        n_epochs = 35 * 20 + 7
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # the gather path's warning
        assert engine.make_track_params(cfg, sig).fast_code == (
            case != "gather")
        want = smoke.sync_track(cfg, sig, iq, chans, cuda, n_epochs)
        corr.reset_launches()
        with monkeypatch.context() as m:
            m.setattr(torch.cuda, "synchronize", _no_synchronize)
            got = engine.track(cfg, sig, iq, chans, cuda, n_epochs=n_epochs)
    n_sb = -(-want.i_p.shape[1] // 20)
    assert n_sb >= 36 and got.i_p.shape == want.i_p.shape
    if n_epochs:
        assert got.i_p.shape[1] == n_epochs
    variant = {"int16": "track_superblock[int16]",
               "staged": "track_superblock_staged"}.get(case,
                                                        "track_superblock")
    assert {k: v for k, v in LAUNCHES.items() if v} == (
        {} if case == "gather" else {variant: n_sb})
    assert got.status == want.status == ["T"] * 12
    for f in engine.TrackOutputs._fields + ("active_until",):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f


def test_pipelined_track_drops_one_superblock_late_on_the_card(
        cuda, smoke, monkeypatch):
    """The lock gate on, on tests/test_torch_pipeline.py's drop scene
    (PRN 7 stops transmitting at 450 ms; superblocks of 100 ms): on the
    card as on the CPU the gate drops PRN 7 from epoch 800, one superblock
    later than a synchronous loop would; each drop mask reaches the card
    through ``_host_to`` as a CUDA tensor, and the loop calls no
    ``torch.cuda.synchronize``.  Every field equals ``sync_track``'s (the
    same plan, the gate off) element for element, but PRN 7's from epoch
    800, where its windows are empty."""
    from cusdr_tpu_torch.io.synth import (SynthSV, quantize_iq_int8,
                                          synthesize_if)
    cfg = get_config("gps_l1ca", sampling_freq=2.048e6, if_freq=7000.0,
                     superblock_ms=100, lock_detect=True)
    sig = get_signal("gps_l1ca")
    svs = [SynthSV(prn=3, code_phase=200.0, doppler_hz=1200.0,
                   cn0_dbhz=48.0),
           SynthSV(prn=7, code_phase=900.5, doppler_hz=-800.0,
                   cn0_dbhz=48.0, stop_ms=450.0)]
    iq = quantize_iq_int8(synthesize_if(cfg, sig, svs, num_ms=1010, seed=5))
    chans = [(sv.prn, cfg.if_freq + sv.doppler_hz + 3.0, int(sv.code_phase))
             for sv in svs]
    want = smoke.sync_track(cfg.replace(lock_detect=False), sig, iq, chans,
                            cuda)
    on_cpu = engine.track(cfg, sig, iq, chans, "cpu")
    masks = []
    host_to = engine._host_to

    def recorded(device, arr):
        masks.append(host_to(device, arr))
        return masks[-1]

    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "synchronize", _no_synchronize)
        m.setattr(engine, "_host_to", recorded)
        got = engine.track(cfg, sig, iq, chans, cuda)
    assert masks and all(t.is_cuda for t in masks)
    assert got.status == on_cpu.status == ["T", "-"]
    assert list(got.active_until) == list(on_cpu.active_until)
    assert got.active_until[1] == 800 and got.i_p.shape[1] > 900
    assert np.all(got.blksize[1, :800] > 0)
    assert not got.blksize[1, 800:].any()
    for f in engine.TrackOutputs._fields:
        g, w = getattr(got, f), getattr(want, f)
        assert g.shape == w.shape, f
        assert np.array_equal(g[0], w[0]), f
        assert np.array_equal(g[1, :800], w[1, :800]), f


def test_staging_ring_is_page_locked(cuda):
    """The ring's host buffers are page-locked and its device buffers on
    the card; a superblock put into it reaches the card equal to a fresh
    staging."""
    rng = np.random.default_rng(2)
    record = rng.integers(-100, 100, 2 * 50_000).astype(np.int8)
    ring = engine._StagingRing(2 * 20_000, np.int8, cuda)
    assert all(h.is_pinned() for h in ring.host)
    assert all(d.is_cuda for d in ring.dev)
    for sb_start, buf_len in ((0, 20_000), (45_000, 20_000), (10, 300)):
        dev = ring.put(record, sb_start, buf_len)
        ring.launched()
        assert dev.is_cuda and dev.shape == (2 * buf_len,)
        assert np.array_equal(dev.cpu().numpy(), engine.stage_superblock(
            record, sb_start, buf_len))


def test_spans_share_the_card_clock_and_shadow_as_annotations(cuda):
    """A traced ``Receiver.run`` on the card (a 1.2 s gps_l1ca record at
    2.048 Msps, superblocks of 200 ms): the spans and the card's kernels
    lie on one clock, every superblock-kernel launch inside the
    ``tracking`` stage's range; the device-side shadows of the spans
    report ``is_user_annotation()``, so a reader of device work can leave
    them out; ``timings`` gains the span totals, and the results equal an
    untraced run's element for element."""
    from torch.profiler import ProfilerActivity, profile
    from cusdr_tpu_torch.receiver import Receiver
    cfg, sig, iq, _ = _sv_scene(2.048e6, 4, 1200, cn0_dbhz=48.0)
    cfg = cfg.replace(superblock_ms=200,
                      acq_satellite_list=cfg.acq_satellite_list[:6])
    rx = Receiver(cfg, cuda)
    off = rx.run(iq)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        on = rx.run(iq)
        torch.cuda.synchronize()
    assert set(off.timings) == {"acquisition_s", "tracking_s",
                                "navigation_s"}
    assert {"acq_coarse_s", "trk_launch_s", "trk_wait_s",
            "nav_decode_s"} <= set(on.timings)
    for f in engine.TrackOutputs._fields + ("active_until",):
        assert np.array_equal(getattr(on.track, f), getattr(off.track, f)), f
    names = {"acquisition", "tracking", "navigation"} | {
        k[:-2].replace("_", ".", 1) for k in on.timings
        if k[:4] in ("acq_", "trk_", "nav_")}
    host, kernels, shadows = {}, [], []
    for ev in prof.profiler.kineto_results.events():
        dev = str(ev.device_type()).endswith("CUDA")
        if ev.name() in names:
            if dev:
                shadows.append(ev)
            else:
                host.setdefault(ev.name(), []).append(
                    (ev.start_ns(), ev.start_ns() + ev.duration_ns()))
        elif dev and "track_superblock_kernel" in ev.name():
            kernels.append(ev.start_ns())
    n_sb = -(-on.track.i_p.shape[1] // 200)
    assert len(kernels) == n_sb == len(host["trk.launch"])
    (t0, t1), = host["tracking"]
    assert all(t0 <= k <= t1 for k in kernels)
    (a0, a1), = host["acquisition"]
    assert a1 <= t0
    assert all(ev.is_user_annotation() for ev in shadows), \
        sorted({ev.name() for ev in shadows if not ev.is_user_annotation()})


# ---- acquisition's fine search (ops/csrc/fine.cu) --------------------------

FINE_PRESETS = ("bds_b1c", "bds_b1i", "bds_b2a", "bds_b3i", "gal_e1c",
                "gal_e5a", "gal_e5b", "glo_l1", "glo_l2", "gps_l1ca",
                "gps_l2c", "gps_l5c")
# every preset as shipped, and gps_l1ca at a 2.5 Hz fine step: 201 bins,
# two of the kernel's bin tiles
FINE_SHAPES = [(name, {}) for name in FINE_PRESETS] + [
    ("gps_l1ca", dict(fine_search_step=2.5))]


def _fine_case(name, n_rows, seed=21, **over):
    """``fine_search``'s arguments at the preset's own rate and fine shape
    (n_fine bins, n_codes periods of spc samples, its fine set-up's code
    tables for ``n_rows`` PRNs, gps_l2c's CL pilot at long-pilot offsets,
    GLONASS's channels on their MHz carriers), on the card: a record of
    int8-sized values holding each row's replica, with its secondary
    signs, on a carrier bin of its own.  Returns (args, kw, hyp, envelope,
    true bins)."""
    from cusdr_tpu_torch.acquisition import pcps
    from cusdr_tpu_torch.signals.defs import sample_code
    cfg, sig = get_config(name, **over), get_signal(name)
    fs, spc = cfg.sampling_freq, cfg.samples_per_code
    n_codes = cfg.fine_n_codes or max(int(round(40.0 / sig.code_period_ms)),
                                      4)
    n_fine = int(round(cfg.acq_search_step / cfg.fine_search_step)) + 1
    n_seg = n_codes * spc
    rng = np.random.default_rng(seed)
    x = (rng.integers(-40, 41, n_seg + 2 * spc)
         + 1j * rng.integers(-40, 41, n_seg + 2 * spc))
    prns = [int(p) for p in cfg.acq_satellite_list[:n_rows]]
    cps = [int(c) for c in rng.integers(0, 2 * spc, n_rows)]
    offs = (np.asarray(prns) * sig.fdma_spacing_hz if sig.fdma
            else np.zeros(n_rows))
    freqs = (cfg.if_freq + offs[:, None] + rng.uniform(-3000, 3000,
                                                       (n_rows, 1))
             + cfg.acq_search_step / 2
             - cfg.fine_search_step * np.arange(n_fine)[None, :]
             ).astype(np.float32)
    truth = rng.integers(0, n_fine, n_rows)
    tables, offsets, hyps, envelope = [], [], [], False
    t = np.arange(n_seg) / fs
    for j, prn in enumerate(prns):
        code_fn, H = pcps.fine_setup(sig, prn, n_codes)
        envelope = H is None
        code_prn = 0 if sig.fdma else prn
        offset = (float((30 + j) * sig.code_length_chips)
                  if sig.pilot_phase_hypotheses > 1 else 0.0)
        rep = sample_code(code_fn(code_prn), sig.elements_per_chip,
                          sig.chip_rate_hz, fs, n_seg,
                          code_phase_chips=offset).astype(np.float32)
        signs = (H[j % len(H)] if H is not None and np.all(np.abs(H) == 1)
                 else np.ones(n_codes))
        x[cps[j]:cps[j] + n_seg] += 8.0 * rep * np.repeat(signs, spc) \
            * np.exp(2j * np.pi * float(freqs[j, truth[j]]) * t)
        tables.append(torch.from_numpy(code_fn(code_prn).astype(np.int8)))
        offsets.append(offset)
        hyps.append(np.ones((1, n_codes), np.float32) if envelope else H)
    ts = np.float32(1.0 / fs)
    args = (torch.from_numpy(x.real.astype(np.float32)).cuda(),
            torch.from_numpy(x.imag.astype(np.float32)).cuda(), cps,
            torch.nn.utils.rnn.pad_sequence(tables, batch_first=True).cuda(),
            [len(tb) for tb in tables], offsets,
            float(2.0 * np.pi * ts) * torch.from_numpy(freqs).cuda())
    kw = dict(epc=sig.elements_per_chip, ratio=sig.chip_rate_hz / fs,
              n_codes=n_codes, spc=spc)
    return (args, kw, torch.from_numpy(np.stack(hyps)).cuda(), envelope,
            truth)


@pytest.mark.parametrize("name,over", FINE_SHAPES)
def test_fine_kernel_matches_plain_version(cuda, name, over):
    """Every preset's fine search at its own shape (12 rows at gps_l1ca and
    gal_e5a, whose cells run it; 3 elsewhere), and 201 bins in two bin
    tiles: the kernel's sums against the plain version's on the card
    within 1e-4·(max|plain| + 1) (each period's 12 000-180 000 products
    added in another order: per thread, a warp butterfly, warps, tiles,
    and an FMA where the plain version rounds the product), the same bin
    of largest power in every row (at the shipped steps the scene's), one
    launch, and a second launch equal to the bit."""
    from cusdr_tpu_torch.acquisition import pcps
    args, kw, hyp, envelope, truth = _fine_case(
        name, 12 if name in ("gps_l1ca", "gal_e5a") and not over else 3,
        **over)
    before = dict(LAUNCHES)
    sr, si = pcps.fine_search(*args, **kw)
    sr2, si2 = pcps.fine_search(*args, **kw)
    torch.cuda.synchronize()
    before["fine_search"] += 2
    assert LAUNCHES == before
    assert torch.equal(sr, sr2) and torch.equal(si, si2)
    pr, pi = pcps.fine_search_plain(*args, **kw)
    for got, want in ((sr, pr), (si, pi)):
        got, want = got.cpu().numpy(), want.cpu().numpy()
        assert np.abs(got - want).max() <= RTOL_SUM * (np.abs(want).max()
                                                       + 1.0)
    power = pcps._fine_powers(sr, si, hyp, envelope).cpu().numpy()
    plain = pcps._fine_powers(pr, pi, hyp, envelope).cpu().numpy()
    assert power.argmax(1).tolist() == plain.argmax(1).tolist()
    if not over:          # 2.5 Hz bins lie within the noise of their peak
        assert power.argmax(1).tolist() == truth.tolist()


def test_fine_wrapper_rejects_what_the_kernel_cannot_take(cuda):
    """A wrong dtype, a tensor on the CPU beside the card's, a table
    shorter than its code, a segment past the record, non-contiguous
    samples, a segment past the kernel's f32 sample index (2^24, read from
    the library): ValueError, and nothing launched."""
    from cusdr_tpu_torch.acquisition import pcps
    args, kw, _, _, _ = _fine_case("gps_l1ca", 2)
    sig_r, sig_i, cps, tables, lengths, offsets, omega = args
    strided = torch.stack([sig_r, sig_i], dim=1)
    bad = [(sig_r.double(), sig_i, cps, tables, lengths, offsets, omega),
           (sig_r, sig_i, cps, tables.float(), lengths, offsets, omega),
           (sig_r, sig_i, cps, tables.cpu(), lengths, offsets, omega),
           (sig_r, sig_i, cps, tables, lengths, offsets, omega.cpu()),
           (sig_r, sig_i, cps, tables, [1024, 1023], offsets, omega),
           (sig_r, sig_i, [0, sig_r.numel() - kw["n_codes"] * kw["spc"] + 1],
            tables, lengths, offsets, omega),
           (strided[:, 0], strided[:, 1], cps, tables, lengths, offsets,
            omega)]
    before = dict(LAUNCHES)
    for a in bad:
        with pytest.raises(ValueError):
            pcps.fine_search(*a, **kw)
    long = torch.zeros((1 << 24) + 2, device=sig_r.device)
    with pytest.raises(ValueError, match="f32 sample index"):
        pcps.fine_search(long, long, [0, 0], tables, lengths, offsets, omega,
                         **dict(kw, n_codes=2, spc=(1 << 23) + 1))
    assert LAUNCHES == before


def test_acquisition_launches_the_fine_kernel_once(cuda):
    """``acquire`` on the card (gps_l1ca at 2.048 Msps, four SVs): one
    fine-search launch for all its detected PRNs; detections, code phases
    and carriers equal the CPU's."""
    from cusdr_tpu_torch.acquisition.pcps import acquire
    cfg, sig, iq, _ = _sv_scene(2.048e6, 4, 120, cn0_dbhz=48.0)
    cfg = cfg.replace(acq_satellite_list=cfg.acq_satellite_list[:8])
    x = iq[0::2].astype(np.float32) + 1j * iq[1::2].astype(np.float32)
    host = acquire(cfg, sig, x, "cpu")
    before = dict(LAUNCHES)
    card = acquire(cfg, sig, x, cuda)
    before["fine_search"] += 1
    assert LAUNCHES == before
    assert host.detected.sum() == 4
    for name in ("detected", "code_phase", "coarse_freq", "carr_freq"):
        assert np.array_equal(getattr(card, name), getattr(host, name)), name


def test_receiver_on_a_gal_e5a_scene_matches_cpu(cuda):
    """``Receiver.run`` on a 0.4 s gal_e5a scene (three SVs at 50 dB-Hz,
    12.288 Msps, the CS100 fine stage of 100 periods over 101 bins) on the
    card and on the CPU: the same detections, code phases and fine
    carriers, the same channels, and tracked carriers within 0.05 Hz."""
    from cusdr_tpu_torch.io.synth import (SynthSV, quantize_iq_int8,
                                          synthesize_if)
    from cusdr_tpu_torch.receiver import Receiver
    cfg = get_config("gal_e5a", sampling_freq=12.288e6, if_freq=7000.0,
                     superblock_ms=100, acq_satellite_list=(4, 8, 11, 19))
    sig = get_signal("gal_e5a")
    svs = [SynthSV(prn=4, code_phase=5233.0, doppler_hz=1100.0,
                   cn0_dbhz=50.0),
           SynthSV(prn=11, code_phase=901.0, doppler_hz=-2210.0,
                   cn0_dbhz=50.0),
           SynthSV(prn=19, code_phase=10412.0, doppler_hz=620.0,
                   cn0_dbhz=50.0)]
    iq = quantize_iq_int8(synthesize_if(cfg, sig, svs, num_ms=400, seed=6))
    host = Receiver(cfg, "cpu").run(iq)
    card = Receiver(cfg, cuda).run(iq)
    assert host.acq.detected.sum() == 3
    for name in ("detected", "code_phase", "carr_freq"):
        assert np.array_equal(getattr(card.acq, name),
                              getattr(host.acq, name)), name
    assert card.channels == host.channels and len(host.channels) == 3
    tail = slice(-100, None)
    assert np.abs(np.asarray(card.track.carr_freq)[:, tail]
                  - np.asarray(host.track.carr_freq)[:, tail]).max() <= 0.05
