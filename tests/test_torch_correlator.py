"""Parity of the ported epoch correlator and tracking engine with the JAX
reference.

The port's plain PyTorch correlator is held against the reference's TPU
kernel ``correlate_bank_hbm`` (Pallas, interpret mode on the CPU), and the
port's ``track_superblock`` against the reference's with the in-kernel-fetch
Pallas bank, at gps_l1ca 2.048 Msps in both tap modes.  Tolerances are those
of tests/test_pallas_correlator.py: sums ``atol 2e-4·scale`` (f32 summation
order; the reference factorizes the carrier from the 512-aligned row start,
the port from the window start), loop state ``rtol 1e-6, atol 1e-4``,
``abs_sample`` exact.  The CUDA kernel's own cases are in
tests/test_torch_cuda.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cusdr_tpu import get_config
from cusdr_tpu.ops.correlator import ALIGN, correlate_bank_hbm, hbm_geometry
from cusdr_tpu.signals.defs import get_signal
from cusdr_tpu.tracking import engine as jeng
from cusdr_tpu_torch import get_config as t_get_config
from cusdr_tpu_torch.signals.defs import get_signal as t_get_signal
from cusdr_tpu_torch.ops.correlator import (LAUNCHES, correlate_bank,
                                            correlate_bank_plain)
from cusdr_tpu_torch.tracking import engine as teng

from test_torch_threads import few_torch_threads  # noqa: F401 (autouse)


def _bank_inputs(seed, n_ch, blk, k, table_len, n_samples):
    """Random channel-bank correlator inputs (numpy), f64 carrier steps
    kept for the reference's residual fold."""
    rng = np.random.default_rng(seed)
    iq = rng.integers(-16, 17, 2 * n_samples).astype(np.int8)
    table = rng.choice(np.array([-1, 1], np.int8), (n_ch, table_len))
    off = rng.integers(0, n_samples - blk, n_ch).astype(np.int64)
    start = rng.integers(ALIGN + 8, table_len - blk - 2 * k - 2,
                         n_ch).astype(np.int64)
    inc_c = (7000.0 + rng.uniform(-5000, 5000, n_ch)) / 2.048e6
    remc64 = rng.uniform(0, 1, n_ch)
    return dict(
        iq=iq, table=table, off=off, start=start, inc_c=inc_c,
        remc64=remc64,
        alpha=rng.uniform(0, 1, n_ch).astype(np.float32),
        bsz=(blk - rng.integers(0, 9, n_ch)).astype(np.int64))


def _port_args(d):
    f32 = lambda x: torch.from_numpy(np.asarray(x, np.float32))
    n_ch = len(d["off"])
    return (torch.from_numpy(d["iq"]), torch.from_numpy(d["off"]),
            torch.from_numpy(d["table"]),
            torch.arange(n_ch, dtype=torch.int64),
            torch.from_numpy(d["start"]), f32(d["alpha"]),
            f32(np.mod(d["remc64"], 1.0)),
            f32(np.mod(d["inc_c"] * 128.0, 1.0)),
            f32(np.mod(d["inc_c"], 1.0)), torch.from_numpy(d["bsz"]))


def _reference_hbm(d, k, blk, interp_taps):
    """The reference kernel on the same inputs, staged as its engine
    stages them (512-sample rows, residual folded into the carrier)."""
    blk_pad = -(-blk // 128) * 128
    _, tq_s, tq_w = hbm_geometry(blk_pad, k)

    def to_rows(x, tq_min):
        n = x.shape[-1]
        nr = max(-(-n // ALIGN), tq_min) + tq_min
        pad = [(0, 0)] * (x.ndim - 1) + [(0, nr * ALIGN - n)]
        return jnp.pad(jnp.asarray(x), pad).reshape(
            x.shape[:-1] + (nr, 4, 128))

    off, start = d["off"], d["start"]
    q = off // ALIGN
    r = off - q * ALIGN
    o = start - r
    qt = o // ALIGN
    i32 = lambda x: jnp.asarray(x, jnp.int32)
    f32 = lambda x: jnp.asarray(np.asarray(x, np.float32))
    out = correlate_bank_hbm(
        i32(q), i32(np.arange(len(off))), i32(qt), i32(o - qt * ALIGN),
        f32(d["alpha"]), f32(np.mod(d["remc64"] - d["inc_c"] * r, 1.0)),
        f32(np.mod(d["inc_c"] * 128.0, 1.0)), f32(np.mod(d["inc_c"], 1.0)),
        f32(d["bsz"]), f32(r),
        to_rows(d["iq"][0::2], tq_s), to_rows(d["iq"][1::2], tq_s),
        to_rows(d["table"], tq_w), k=k, blk_pad=blk_pad,
        interp_taps=interp_taps, interpret=True)
    return np.asarray(out)


@pytest.mark.parametrize("interp_taps", [True, False])
@pytest.mark.parametrize("k", [1, 9])
def test_plain_correlator_matches_reference_kernel(interp_taps, k):
    blk = 2056
    # the reference kernel takes banks of 8 channels
    d = _bank_inputs(3, 8, blk, k, blk + 2048, 6 * 2048)
    ref = _reference_hbm(d, k, blk, interp_taps)
    got = correlate_bank_plain(*_port_args(d), k=k, blk=blk,
                               interp_taps=interp_taps).numpy()
    assert got.shape == ref.shape == (8, 8)
    scale = np.abs(ref).max() + 1.0
    assert np.allclose(got, ref, atol=2e-4 * scale), (
        np.abs(got - ref).max(), scale)
    assert not got[:, 6:].any()


def test_window_clamp_matches_dynamic_slice():
    """Out-of-range windows read what jax.lax.dynamic_slice would: a
    negative offset counts from the end, then the window is clamped to
    the last (or first) full one."""
    blk, k = 2056, 9
    d = _bank_inputs(5, 4, blk, k, blk + 2048, 3 * 2048)
    n_samp, tab_len = len(d["iq"]) // 2, d["table"].shape[1]
    d["off"] = np.asarray([-7, n_samp - blk + 1, n_samp + 500, -3 * n_samp],
                          np.int64)
    d["start"] = np.asarray([tab_len, -3, 40, tab_len - blk], np.int64)
    args = list(_port_args(d))
    got = correlate_bank_plain(*args, k=k, blk=blk).numpy()

    def clamped(x, size, win):
        return np.asarray([int(jax.lax.dynamic_slice(
            jnp.arange(size), (int(v),), (win,))[0]) for v in x], np.int64)

    args[1] = torch.from_numpy(clamped(d["off"], n_samp, blk))
    args[4] = torch.from_numpy(clamped(d["start"], tab_len,
                                       blk + 2 * k + 1))
    want = correlate_bank_plain(*args, k=k, blk=blk).numpy()
    assert np.array_equal(got, want)


def test_wrapper_takes_plain_version_on_cpu_and_checks_inputs():
    blk, k = 2056, 9
    d = _bank_inputs(9, 3, blk, k, blk + 2048, 3 * 2048)
    args = _port_args(d)
    before = dict(LAUNCHES)
    a = correlate_bank(*args, k=k, blk=blk)
    b = correlate_bank_plain(*args, k=k, blk=blk)
    assert torch.equal(a, b)
    assert LAUNCHES == before     # no kernel on the CPU
    bad = list(args)
    bad[1] = bad[1].int()
    with pytest.raises(ValueError, match="off"):
        correlate_bank(*bad, k=k, blk=blk)
    bad = list(args)
    bad[5] = bad[5].double()
    with pytest.raises(ValueError, match="alpha"):
        correlate_bank(*bad, k=k, blk=blk)


@pytest.mark.parametrize("interp_taps,pll_order", [
    (True, 2), (False, 2), (True, 3)])
def test_track_superblock_matches_reference(interp_taps, pll_order):
    over = dict(sampling_freq=2.048e6, if_freq=7000.0,
                interp_taps=interp_taps, pll_order=pll_order)
    cfg, tcfg = get_config("gps_l1ca", **over), t_get_config("gps_l1ca",
                                                             **over)
    sig, tsig = get_signal("gps_l1ca"), t_get_signal("gps_l1ca")
    params = jeng.make_track_params(cfg, sig)
    tparams = teng.make_track_params(tcfg, tsig)
    spc = cfg.samples_per_code
    n_epochs, n_ch = 12, 3
    rng = np.random.default_rng(7)
    samples = rng.integers(-16, 16, 2 * (n_epochs + 4) * spc).astype(
        np.int8)
    channels = [(1 + k, 7000.0 + 200.0 * k, 101 + 37 * k)
                for k in range(n_ch)]
    dops = [c[1] - cfg.if_freq for c in channels]
    ctabs, ptabs = jeng.build_replica_tables(cfg, sig, params, channels,
                                             dops)
    ttabs, tptabs = teng.build_replica_tables(tcfg, tsig, tparams,
                                              channels, dops)
    assert np.array_equal(ctabs, ttabs) and tptabs is None

    p_pl = dataclasses.replace(params, use_pallas=True,
                               fetch_in_kernel=True, pallas_interpret=True)
    state = jeng.init_channel_state(channels, sig.chip_rate_hz,
                                    dopplers=dops,
                                    carrier_freq_hz=sig.carrier_freq_hz)
    st_j, out_j = jeng.track_superblock(
        jnp.asarray(samples), jnp.int64(0), jnp.asarray(ctabs),
        jnp.asarray(ptabs), state, p_pl, n_epochs)
    tstate = teng.init_channel_state(channels, tsig.chip_rate_hz, "cpu",
                                     dopplers=dops,
                                     carrier_freq_hz=tsig.carrier_freq_hz)
    st_t, out_t = teng.track_superblock(
        torch.from_numpy(samples), 0, torch.from_numpy(ttabs), None,
        tstate, tparams, n_epochs)

    for name in ("i_e", "q_e", "i_p", "q_p", "i_l", "q_l",
                 "pilot_ip", "pilot_qp"):
        a = np.asarray(getattr(out_j, name))
        b = getattr(out_t, name).numpy()
        assert a.shape == b.shape == (n_epochs, n_ch), name
        scale = np.abs(a).max() + 1.0
        assert np.allclose(a, b, atol=2e-4 * scale), (
            name, np.abs(a - b).max(), scale)
    for name in ("carr_freq", "code_freq", "rem_code_phase",
                 "rem_carr_phase"):
        a = np.asarray(getattr(st_j, name))
        b = getattr(st_t, name).numpy()
        assert b.dtype == np.float64
        assert np.allclose(a, b, rtol=1e-6, atol=1e-4), (name, a, b)
    assert np.array_equal(np.asarray(st_j.abs_sample),
                          st_t.abs_sample.numpy())
    for name in ("abs_sample", "blksize"):
        assert np.array_equal(np.asarray(getattr(out_j, name)),
                              getattr(out_t, name).numpy()), name
