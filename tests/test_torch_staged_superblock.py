"""The staged superblock kernel's host side on the CPU.

On a card ``track_superblock`` with ``fetch_in_kernel=False`` is one launch
of csrc/superblock_staged.cu, which stages each epoch's windows into a ring
in shared memory by bulk copies; its plain version is the eager loop on
staged windows.  The kernel runs only on a card (tests/test_torch_cuda.py);
here, without one:

- the stage plan (``stage_plan``, which the wrapper passes to the kernel)
  holds every tap of every sample of a window inside the chunk's staged
  superset, for every preset's block size, spacing and pilot banks (B1C in
  NB and WB), one block per row or a cluster, within the 227 KB of shared
  memory a block may use;
- on the scenes of tests/test_torch_superblock.py (gps_l1ca, gal_e5a,
  bds_b1c WB, gps_l2c CL), every epoch's sample and replica window starts
  lie inside what the kernel prefetches for them one and two epochs before
  (``prefetch_window``), so none takes the slow path;
- the eager loop on staged windows equals the one on fetched windows bit
  for bit (the two kernels' plain versions compute the same function);
- the library and its launch counts are registered, and the wrapper refuses
  CPU tensors;
- the eager yardstick of ``track_time_parallel`` (``epoch_loop``) computes
  what its default path does.
"""

import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from cusdr_tpu_torch.config import PRESETS
from cusdr_tpu_torch import get_config as t_get_config
from cusdr_tpu_torch.ops import correlator as tcorr
from cusdr_tpu_torch.parallel import timeblocks
from cusdr_tpu_torch.signals.defs import get_signal as t_get_signal
from cusdr_tpu_torch.tracking import engine as teng

from test_torch_superblock import _setup
from test_torch_threads import few_torch_threads  # noqa: F401 (autouse)

# the shared memory a block of the H100 may opt into (227 KB)
SMEM_OPT_IN = 232448


def _preset_shapes():
    """(preset, blk, k, pilot banks) of every preset, B1C in NB and WB."""
    shapes = []
    for name in PRESETS:
        for over in ({}, dict(pilot_trk_flag=2)) if name == "bds_b1c" \
                else ({},):
            cfg, sig = t_get_config(name, **over), t_get_signal(name)
            k = max(int(round(cfg.dll_correlator_spacing * cfg.sampling_freq
                              / sig.chip_rate_hz)), 1)
            pilots = (2 if cfg.pilot_trk_flag == 2
                      and sig.pilot_code_wb is not None
                      else 1 if cfg.pilot_trk_flag > 0
                      and sig.pilot_code is not None else 0)
            shapes.append((name + (" WB" if over else ""),
                           cfg.samples_per_code + cfg.track_block_pad, k,
                           pilots))
    return shapes


SHAPES = _preset_shapes()


def test_every_preset_has_a_shape():
    assert len(SHAPES) == len(PRESETS) + 1
    assert {s[3] for s in SHAPES} == {0, 1, 2}


@settings(max_examples=150, deadline=None)
@given(shape=st.sampled_from(SHAPES), cluster=st.sampled_from([1, 2, 4, 8]),
       data=st.data())
def test_stage_plan_holds_every_tap_of_a_window(shape, cluster, data):
    _check_plan(shape, cluster, data, sample_bytes=2)


@settings(max_examples=150, deadline=None)
@given(shape=st.sampled_from(SHAPES), cluster=st.sampled_from([1, 2, 4, 8]),
       data=st.data())
def test_stage_plan_holds_every_tap_of_an_int16_window(shape, cluster,
                                                       data):
    """The same with int16 samples: 4 bytes a sample in the sample
    buffers (a 1 ms epoch at 18 Msps is then one 72 KB chunk)."""
    _check_plan(shape, cluster, data, sample_bytes=4)


def test_int16_stage_plan_at_the_presets():
    # gps_l1ca: one chunk of 18 432 samples, 73 776 sample bytes a stage;
    # bds_b1c WB's 180 008-sample window needs more chunks than with int8
    l1 = tcorr.stage_plan(18008, 9, 0, 1, sample_bytes=4)
    assert (l1.chunk, l1.per_rank, l1.samp_bytes) == (18432, 1, 73776)
    assert (tcorr.stage_plan(180008, 1, 2, 1, sample_bytes=4).per_rank
            > tcorr.stage_plan(180008, 1, 2, 1).per_rank)


def _check_plan(shape, cluster, data, sample_bytes):
    name, blk, k, n_pilots = shape
    plan = tcorr.stage_plan(blk, k, n_pilots, cluster,
                            sample_bytes=sample_bytes)
    # one block per row: whole 512-thread strides (the per-epoch kernels'
    # order of summation); a cluster: whole carrier steps
    assert plan.chunk % (512 if cluster == 1 else 128) == 0
    assert 2 <= plan.n_stages <= 8
    assert plan.smem_bytes(n_pilots) <= tcorr.SMEM_BUDGET < SMEM_OPT_IN
    assert all(b % 16 == 0 for b in plan[3:5]) and plan.uv_bytes % 128 == 0
    off_lo = data.draw(st.integers(0, 1 << 40), label="least offset")
    off_hi = off_lo + data.draw(st.integers(0, tcorr.SAMPLE_SPREAD))
    off = data.draw(st.integers(off_lo, off_hi), label="exact offset")
    lo = data.draw(st.integers(0, 1 << 24), label="least replica start")
    spread = data.draw(st.integers(0, sum(tcorr.PREFETCH_SPREAD)))
    start = data.draw(st.integers(lo, lo + spread), label="exact start")
    n_valid = data.draw(st.integers(0, blk), label="valid samples")
    sizes = [plan.samp_bytes] + [plan.rep_bytes] * (1 + n_pilots)
    covered = 0
    for rank in range(cluster):
        for j in range(plan.per_rank):
            ranges = tcorr.staged_ranges(plan, j, rank, (off_lo, off_hi),
                                         [(lo, lo + spread)] * (1 + n_pilots),
                                         k, blk, sample_bytes=sample_bytes)
            for (first, x0, x1), size in zip(ranges, sizes):
                # the aligned copy starts on the grid, within 16 bytes of
                # what was asked for, and fits the buffer
                assert first % 16 == 0 and 0 <= x0 - first < 16, name
                assert -(-x1 // 16) * 16 - first <= size, (name, cluster)
            n0 = (rank * plan.per_rank + j) * plan.chunk
            n1 = min(n0 + plan.chunk, n_valid)
            if n0 >= n1:
                continue
            covered += n1 - n0
            # I/Q of samples n0 .. n1 - 1, and taps E (start + n) to
            # L + 1 (start + n + 2k + 1) of each
            _, s0, s1 = ranges[0]
            assert (s0 <= sample_bytes * (off + n0)
                    and sample_bytes * (off + n1) <= s1), name
            for _, r0, r1 in ranges[1:]:
                assert r0 <= start + n0 and start + n1 + 2 * k <= r1 - 1, (
                    name, cluster)
    # the blocks' chunks tile the window's valid samples
    assert covered == n_valid


def test_stage_plan_refuses_what_does_not_fit():
    # 3.6 M-sample windows: the carrier factors leave no room for a ring
    with pytest.raises(ValueError, match="shared memory"):
        tcorr.stage_plan(3_600_000, 1, 0, 1)


def _starts(out, state, params, tables, ptables):
    """Each epoch's data and pilot replica window starts as the eager loop
    on the CPU computes them, from the state it reports per epoch."""
    k, blk = params.k_spacing, params.blk
    win = blk + 2 * k + 1
    step = out.code_freq / params.fs
    shift = torch.floor(out.rem_code_phase / step).long()
    start = (teng.UP_MARGIN - k + shift).clamp(0, tables.shape[1] - win)
    pstart = start
    if params.pilot_period_mod > 1:
        n_epochs = out.code_freq.shape[0]
        pper = torch.remainder(state.pilot_period[None, :].long()
                               + torch.arange(n_epochs)[:, None],
                               params.pilot_period_mod)
        pshift = torch.floor((out.rem_code_phase + pper * params.code_len)
                             / (state.code_freq_basis / params.fs))
        pstart = (teng.UP_MARGIN - k + pshift.long()).clamp(
            0, ptables.shape[-1] - win)
    return start, pstart


@pytest.mark.parametrize("case", ["gps_l1ca", "gal_e5a", "bds_b1c_wb",
                                  "gps_l2c_cl"])
def test_prefetch_holds_every_epochs_windows(case):
    _, port, channels = _setup(case)
    iq, sb_start, tables, ptables, state, params, n_epochs = port
    params = dataclasses.replace(params, fetch_in_kernel=False)
    _, out = teng.track_superblock_epochs(iq, sb_start, tables, ptables,
                                          state, params, n_epochs)
    start, pstart = _starts(out, state, params, tables, ptables)
    assert (out.blksize > 0).all()
    mod = max(params.pilot_period_mod, 1)
    held = 0
    for e in range(1, n_epochs):
        for ahead in (1, 2)[:e]:
            for c in range(len(channels)):
                # what the kernel copies for epoch e while epoch e - ahead
                # runs
                b = e - ahead
                offs, data, pilot = tcorr.prefetch_window(
                    ahead, int(out.abs_sample[b, c]), int(out.blksize[b, c]),
                    (int(state.pilot_period[c]) + b) % mod,
                    float(state.code_freq_basis[c]), params,
                    sb_start=sb_start, n_samples=iq.shape[0] // 2,
                    up_margin=teng.UP_MARGIN, table_len=tables.shape[1],
                    ptable_len=0 if ptables is None else ptables.shape[-1])
                off = int(out.abs_sample[e, c]) - sb_start
                assert offs[0] <= off <= offs[1], (e, ahead, c)
                assert data[0] <= start[e, c] <= data[1], (e, ahead, c)
                if pilot is not None:
                    assert pilot[0] <= pstart[e, c] <= pilot[1], (e, ahead)
                held += 1
    assert held == (2 * n_epochs - 3) * len(channels)


@pytest.mark.parametrize("case", ["gps_l1ca", "bds_b1c_wb", "gps_l2c_cl"])
def test_staged_eager_loop_is_the_fetched_one(case):
    _, port, _ = _setup(case)
    staged = dataclasses.replace(port[5], fetch_in_kernel=False)
    before = dict(tcorr.LAUNCHES)
    st_s, out_s = teng.track_superblock(*port[:5], staged, port[6])
    st_f, out_f = teng.track_superblock(*port)
    assert tcorr.LAUNCHES == before                 # no kernel on the CPU
    for name, a, b in zip(st_s._fields + out_s._fields, st_s + out_s,
                          st_f + out_f):
        assert a.dtype == b.dtype and torch.equal(a, b), name


def test_staged_superblock_kernel_is_registered_and_takes_cuda_tensors_only():
    assert "superblock_staged" in tcorr.SOURCES
    for src in ("superblock_staged.cu", "superblock_common.cuh"):
        assert (tcorr.CSRC_DIR / src).is_file()
    # int8 launches count under the variant, int16 ones under
    # "<variant>[int16]"
    staged = [n for n in tcorr.LAUNCHES
              if n.startswith("track_superblock_staged")]
    assert tcorr.STAGED_SUPERBLOCK_VARIANTS == tuple(
        n for n in staged if not n.endswith("[int16]"))
    assert tuple(n + "[int16]" for n in tcorr.STAGED_SUPERBLOCK_VARIANTS) \
        == tuple(n for n in staged if n.endswith("[int16]"))
    _, port, _ = _setup("gps_l1ca")
    iq, sb_start, tables, _, state, params, n_epochs = port
    end = torch.full((3,), iq.shape[0] // 2)
    before = dict(tcorr.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tcorr.track_superblock_staged_bank(
            iq, sb_start, tables, None, *teng.pack_state(state), end,
            n_epochs, params, up_margin=teng.UP_MARGIN)
    assert tcorr.LAUNCHES == before


@pytest.mark.parametrize("fetch_in_kernel", [True, False])
def test_epoch_loop_yardstick_is_the_same_function(fetch_in_kernel):
    """``track_time_parallel(epoch_loop=True)`` runs the superblock kernels'
    plain version in their place; on the CPU both are that loop, so the
    results are equal field by field."""
    cfg = t_get_config("gps_l1ca", sampling_freq=2.048e6, if_freq=7000.0)
    sig = t_get_signal("gps_l1ca")
    spc = cfg.samples_per_code
    samples = np.random.default_rng(9).integers(
        -16, 16, 2 * 16 * spc).astype(np.int8)
    channels = [(1, 7000.0, 101), (2, 7300.0, 900)]
    res = [timeblocks.track_time_parallel(
        cfg, sig, samples, channels, 10, 2, handoff_iters=1, device="cpu",
        fetch_in_kernel=fetch_in_kernel, epoch_loop=loop)
        for loop in (False, True)]
    for name in teng.TrackOutputs._fields:
        assert np.array_equal(getattr(res[0], name),
                              getattr(res[1], name)), name
