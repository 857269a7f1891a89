"""The CUDA epoch correlators on a card: each kernel against its plain
PyTorch version, alone at the ported paths' shapes (no pilot, pilot, dual
pilot; windows fetched in the kernel or staged; u·v, phase-ramp and table
carriers) and inside ``track_superblock`` (gps_l1ca, gal_e5a with its pilot
bank, the flat 96-row time-parallel bank, the staged path).

Every case needs a CUDA card and skips without one.  The file imports no
jax, so it also runs where jax is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance for the sums: the kernel and the plain version add ~18 000 f32
products in different orders (per-thread strides and a block tree against
PyTorch's reductions), so |kernel - plain| <= 1e-4 * (max|plain| + 1).
Through ``track_superblock`` the tolerances are those of
tests/test_torch_correlator.py: sums ``atol 2e-4·scale`` (the summation
order differs in every epoch and feeds the loops), loop state ``rtol 1e-6,
atol 1e-4``, ``abs_sample`` exact.
"""

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
    """12 channels at the preset's 18 Msps for 12 epochs: one kernel
    launch per epoch, outputs and loop state as on the CPU."""
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
    want["correlate_bank" if ptabs is None else "correlate_bank_pilot"] += \
        n_epochs
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
    bank for 10 epochs: one launch per epoch of the fetch kernel (flat
    path) or of the staged kernel (per-block path), block states and
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
    want["correlate_bank" if fetch_in_kernel else "correlate_windows"] += epb
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
