"""Parity of the port's staged-window correlators with the JAX reference's
three staged TPU kernels.

- ``correlate_windows_plain`` against ``correlate_bank(..., interpret=True)``
  (cusdr_tpu/ops/correlator.py): no pilot, a pilot at all four rotations,
  the dual pilot, both tap modes, k in {1, 5}, pilot windows with their own
  fraction.
- ``correlate_windows_ramp_plain`` / ``correlate_windows_table_plain``
  against ``make_correlate_kernel`` / ``make_table_carrier_kernel`` of
  tools/perf_pallas.py.  That file builds its ``pallas_call`` without an
  ``interpret`` argument, so the kernels themselves are run here, unedited,
  under ``pltpu.force_tpu_interpret_mode()`` (the installed jax has it);
  the ramp version is also held against the u·v kernel at matching inputs
  (``shi`` converted from the 256-split to the 128-split).
- ``stage_windows`` + ``correlate_windows_plain`` equals
  ``correlate_bank_plain`` bit for bit, and the engine's staged path
  (``fetch_in_kernel=False``) equals its fetch path on the CPU.

Tolerance: ``1e-4·(max|ref| + 1)`` on the sums (f32 summation order), as
tests/test_torch_pilot_correlator.py uses for the fetch kernel.  The CUDA
kernels' own cases are in tests/test_torch_cuda.py.
"""

import dataclasses
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from cusdr_tpu.ops.correlator import correlate_bank as j_correlate_bank
from cusdr_tpu_torch import get_config as t_get_config
from cusdr_tpu_torch.ops import correlator as tcorr
from cusdr_tpu_torch.signals.defs import get_signal as t_get_signal
from cusdr_tpu_torch.tracking import engine as teng

from test_torch_threads import few_torch_threads  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
W1, W2 = float(np.sqrt(29.0 / 33.0)), float(np.sqrt(4.0 / 33.0))
# (pilot windows: 0 / 1 / 2, pilot_rot, pilot2_rot, w1, w2)
VARIANTS = {"none": (0, 1, 2, 1.0, 0.0), "rot0": (1, 0, 2, 1.0, 0.0),
            "rot1": (1, 1, 2, 1.0, 0.0), "rot2": (1, 2, 2, 1.0, 0.0),
            "rot3": (1, 3, 2, 1.0, 0.0), "dual": (2, 3, 2, W1, W2)}


@pytest.fixture(scope="module")
def perf_pallas():
    spec = importlib.util.spec_from_file_location(
        "perf_pallas", ROOT / "tools" / "perf_pallas.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _windows(seed, n_ch, blk, k, n_pilots=0):
    """Random staged windows (numpy) at the reference kernel's sizes: blk a
    multiple of 128, wlen the next multiple of 128 past blk + 2k + 1."""
    rng = np.random.default_rng(seed)
    wlen = -(-(blk + 2 * k + 2) // 128) * 128
    pm = np.array([-1, 1], np.int8)
    inc_c = (7000.0 + rng.uniform(-5000, 5000, n_ch)) / 2.048e6
    return dict(
        si=rng.integers(-16, 17, (n_ch, blk)).astype(np.int8),
        sq=rng.integers(-16, 17, (n_ch, blk)).astype(np.int8),
        wt=rng.choice(pm, (n_ch, wlen)),
        wp=[rng.choice(pm, (n_ch, wlen)) for _ in range(n_pilots)],
        inc_c=inc_c, remc=rng.uniform(0, 1, n_ch).astype(np.float32),
        alpha=rng.uniform(0, 1, n_ch).astype(np.float32),
        palpha=rng.uniform(0, 1, n_ch).astype(np.float32),
        bsz=(blk - 64 - rng.integers(0, 9, n_ch)).astype(np.int64))


def _col(x):
    return jnp.asarray(np.asarray(x, np.float32)[:, None])


def _t32(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _siq(d):
    return torch.from_numpy(np.stack([d["si"], d["sq"]], axis=-1))


def _close(got, ref):
    scale = np.abs(ref).max() + 1.0
    assert got.shape == ref.shape
    assert np.allclose(got, ref, atol=1e-4 * scale), (
        np.abs(got - ref).max(), scale)


@pytest.mark.parametrize("k", [1, 5])
@pytest.mark.parametrize("interp_taps", [True, False])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_windows_plain_matches_reference_kernel(variant, interp_taps, k):
    n_pilots, rot, rot2, w1, w2 = VARIANTS[variant]
    blk = 2048
    # the reference kernel takes banks of 8 channels
    d = _windows(21 + k, 8, blk, k, n_pilots)
    shi = np.mod(d["inc_c"] * 128.0, 1.0)
    slo = np.mod(d["inc_c"], 1.0)
    ref = np.asarray(j_correlate_bank(
        _col(d["alpha"]), _col(d["remc"]), _col(shi), _col(slo),
        _col(d["bsz"]), jnp.asarray(d["si"]), jnp.asarray(d["sq"]),
        jnp.asarray(d["wt"]), *(jnp.asarray(w) for w in d["wp"]), k=k,
        alpha_p=_col(d["palpha"]), pilot_rot=rot, pilot2_rot=rot2,
        pilot_w1=w1, pilot_w2=w2, interp_taps=interp_taps, interpret=True))
    wp = None
    if n_pilots:
        wp = torch.from_numpy(d["wp"][0] if n_pilots == 1
                              else np.stack(d["wp"], axis=1))
    got = tcorr.correlate_windows_plain(
        _siq(d), torch.from_numpy(d["wt"]), _t32(d["alpha"]),
        _t32(d["remc"]), _t32(shi), _t32(slo), torch.from_numpy(d["bsz"]),
        k=k, interp_taps=interp_taps, wp=wp,
        palpha=_t32(d["palpha"]) if n_pilots else None, pilot_rot=rot,
        pilot2_rot=rot2, pilot_w1=w1, pilot_w2=w2).numpy()
    assert got.shape == (8, 16 if n_pilots else 8)
    _close(got, ref)
    if n_pilots:
        assert not got[:, 12:].any()
        scale = np.abs(ref).max() + 1.0
        assert np.abs(got[:, 6:12] - got[:, :6]).max() > 0.1 * scale
    else:
        assert not got[:, 6:].any()


@pytest.mark.parametrize("k", [1, 5])
def test_ramp_plain_matches_reference_kernel(perf_pallas, k):
    blk = 2048
    d = _windows(5 + k, 8, blk, k)
    shi = np.mod(d["inc_c"] * 256.0, 1.0)
    slo = np.mod(d["inc_c"], 1.0)
    kern = perf_pallas.make_correlate_kernel(blk, k)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(kern(
            _col(d["alpha"]), _col(d["remc"]), _col(shi), _col(slo),
            _col(d["bsz"]), jnp.asarray(d["si"]), jnp.asarray(d["sq"]),
            jnp.asarray(d["wt"])))
    args = (_siq(d), torch.from_numpy(d["wt"]), _t32(d["alpha"]),
            _t32(d["remc"]))
    bsz = torch.from_numpy(d["bsz"])
    got = tcorr.correlate_windows_ramp_plain(*args, _t32(shi), _t32(slo),
                                             bsz, k=k).numpy()
    assert got.shape == (8, 8) and not got[:, 6:].any()
    _close(got, ref)
    # the same carrier through the u·v kernel: shi on the 128-split.  The
    # ramp's f32 phase carries up to ~255 cycles (ulp 1.5e-5 cycles), so
    # the two carriers agree to ~1e-4 rad per sample, not to rounding
    uv = tcorr.correlate_windows_plain(
        *args, _t32(np.mod(d["inc_c"] * 128.0, 1.0)), _t32(slo), bsz,
        k=k).numpy()
    scale = np.abs(uv).max() + 1.0
    assert np.allclose(got, uv, atol=1e-3 * scale)


@pytest.mark.parametrize("k", [1, 5])
def test_table_plain_matches_reference_kernel(perf_pallas, k):
    blk = 2048
    d = _windows(9 + k, 8, blk, k)
    n = np.arange(blk)
    ph = 2 * np.pi * d["inc_c"][:, None] * n[None, :]
    tc, ts = np.cos(ph).astype(np.float32), np.sin(ph).astype(np.float32)
    phi0 = 2 * np.pi * d["remc"].astype(np.float64)
    c0, s0 = np.cos(phi0), np.sin(phi0)
    kern = perf_pallas.make_table_carrier_kernel(blk, k)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(kern(
            _col(d["alpha"]), _col(c0), _col(s0), _col(d["bsz"]),
            jnp.asarray(d["si"]), jnp.asarray(d["sq"]), jnp.asarray(tc),
            jnp.asarray(ts), jnp.asarray(d["wt"])))
    siq, wt, bsz = _siq(d), torch.from_numpy(d["wt"]), torch.from_numpy(
        d["bsz"])
    got = tcorr.correlate_windows_table_plain(
        siq, wt, torch.from_numpy(tc), torch.from_numpy(ts),
        _t32(d["alpha"]), _t32(c0), _t32(s0), bsz, k=k).numpy()
    assert got.shape == (8, 8) and not got[:, 6:].any()
    _close(got, ref)
    # the basis tables hold the carrier the u·v factors make
    uv = tcorr.correlate_windows_plain(
        siq, wt, _t32(d["alpha"]), _t32(d["remc"]),
        _t32(np.mod(d["inc_c"] * 128.0, 1.0)),
        _t32(np.mod(d["inc_c"], 1.0)), bsz, k=k).numpy()
    _close(got, uv)


@pytest.mark.parametrize("n_pilots", [0, 1, 2])
def test_staged_windows_equal_the_fetch_version(n_pilots):
    """Staging + the window version is the fetch version: same windows,
    same arithmetic, clamped offsets included."""
    rng = np.random.default_rng(3)
    blk, k, n_ch, n_samp = 1000, 3, 5, 4000
    t_len, p_len = blk + 300, blk + 900
    pm = np.array([-1, 1], np.int8)
    iq = torch.from_numpy(rng.integers(-16, 17, 2 * n_samp).astype(np.int8))
    table = torch.from_numpy(rng.choice(pm, (2, t_len)))
    ptable = None
    if n_pilots:
        ptable = torch.from_numpy(rng.choice(
            pm, (2, p_len) if n_pilots == 1 else (2, 2, p_len)))
    off = torch.tensor([0, 17, n_samp - blk, n_samp + 5, -3])
    start = torch.tensor([0, 100, t_len, 40, -1])
    pstart = torch.tensor([5, p_len, 700, -2, 0]) if n_pilots else None
    wrow = torch.arange(n_ch) % 2
    f = lambda: _t32(rng.uniform(0, 1, n_ch))
    alpha, remc, shi, slo, palpha = f(), f(), f(), f(), f()
    bsz = torch.tensor([blk, blk - 1, 0, 7, blk + 4])
    pal = palpha if n_pilots else None
    want = tcorr.correlate_bank_plain(
        iq, off, table, wrow, start, alpha, remc, shi, slo, bsz, k=k,
        blk=blk, ptable=ptable, pstart=pstart, palpha=pal, pilot_rot=3,
        pilot_w1=W1, pilot_w2=W2)
    siq, wt, wp = tcorr.stage_windows(iq, off, table, wrow, start, k=k,
                                      blk=blk, ptable=ptable, pstart=pstart)
    assert siq.shape == (n_ch, blk, 2) and siq.is_contiguous()
    assert wt.shape == (n_ch, blk + 2 * k + 1)
    assert (wp is None) == (n_pilots == 0)
    if n_pilots == 2:
        assert wp.shape == (n_ch, 2, blk + 2 * k + 1)
    before = dict(tcorr.LAUNCHES)
    got = tcorr.correlate_windows(siq, wt, alpha, remc, shi, slo, bsz, k=k,
                                  wp=wp, palpha=pal, pilot_rot=3,
                                  pilot_w1=W1, pilot_w2=W2)
    assert tcorr.LAUNCHES == before            # no kernel on the CPU
    assert torch.equal(got, want)
    assert not got[2].any()                    # bsz 0: nothing summed


def test_window_wrappers_check_their_inputs():
    d = _windows(1, 3, 256, 2)
    siq, wt = _siq(d), torch.from_numpy(d["wt"])
    v = _t32(d["alpha"])
    bsz = torch.from_numpy(d["bsz"])
    with pytest.raises(ValueError, match="siq"):
        tcorr.correlate_windows(siq[..., 0], wt, v, v, v, v, bsz, k=2)
    with pytest.raises(ValueError, match="wt"):
        tcorr.correlate_windows(siq, wt[:, :256], v, v, v, v, bsz, k=2)
    with pytest.raises(ValueError, match="bsz"):
        tcorr.correlate_windows_ramp(siq, wt, v, v, v, v, bsz.float(), k=2)
    with pytest.raises(ValueError, match="palpha"):
        tcorr.correlate_windows(siq, wt, v, v, v, v, bsz, k=2, wp=wt)
    with pytest.raises(ValueError, match="tc"):
        tcorr.correlate_windows_table(siq, wt, v, v, v, v, v, bsz, k=2)
    with pytest.raises(ValueError, match="kernel source"):
        tcorr.load_library("nothing")


@pytest.mark.parametrize("signal,over", [
    ("gps_l1ca", dict(sampling_freq=2.048e6)),
    ("gps_l1ca", dict(sampling_freq=2.048e6, interp_taps=False)),
    ("gal_e5a", dict(sampling_freq=12.288e6)),
    ("bds_b1c", dict(sampling_freq=16.368e6, pilot_trk_flag=2))])
def test_engine_staged_path_equals_fetch_path(signal, over):
    """``fetch_in_kernel=False`` stages what the fetch path reads: on the
    CPU both end in the same plain arithmetic, so 6 epochs agree bit for
    bit, with a per-row record end that freezes one row early."""
    cfg = t_get_config(signal, if_freq=7000.0, **over)
    sig = t_get_signal(signal)
    params = teng.make_track_params(cfg, sig)
    assert params.fetch_in_kernel
    spc = cfg.samples_per_code
    n_epochs, n_ch = 6, 3
    rng = np.random.default_rng(11)
    samples = torch.from_numpy(rng.integers(
        -16, 16, 2 * (n_epochs + 3) * spc).astype(np.int8))
    channels = [(1 + j, 7000.0 + 200.0 * j, 101 + 37 * j)
                for j in range(n_ch)]
    dops = [c[1] - cfg.if_freq for c in channels]
    ctabs, ptabs = teng.build_replica_tables(cfg, sig, params, channels,
                                             dops)
    tables = torch.from_numpy(ctabs)
    ptables = None if ptabs is None else torch.from_numpy(ptabs)
    state = teng.init_channel_state(channels, sig.chip_rate_hz, "cpu",
                                    dopplers=dops,
                                    carrier_freq_hz=sig.carrier_freq_hz)
    total = samples.shape[0] // 2
    end_rows = torch.tensor([total, 138 + 3 * spc + params.blk - 8, total])
    runs = []
    for fetch in (True, False):
        p = dataclasses.replace(params, fetch_in_kernel=fetch)
        runs.append(teng.track_superblock(samples, 0, tables, ptables, state,
                                          p, n_epochs, end_rows))
    (st_a, out_a), (st_b, out_b) = runs
    for a, b in zip(tuple(st_a) + tuple(out_a), tuple(st_b) + tuple(out_b)):
        assert torch.equal(a, b)
    # row 1 froze after its third epoch, the others ran on
    assert out_a.blksize[:, 1].tolist()[3:] == [0, 0, 0]
    assert (out_a.blksize[:, 0] > 0).all()
    assert (out_a.blksize[:3, 1] > 0).all()
    assert not st_a.active[1] and st_a.active[0] and st_a.active[2]
