"""The phase-ramp correlator's cluster plan (``ramp_plan``, ``ramp_slices``
of cusdr_tpu_torch/ops/correlator.py) and what its wrapper refuses, on the
CPU.

The kernel (csrc/correlator_staged.cu) splits every row over a cluster of
thread blocks, block r taking the row's samples [r·chunk, (r + 1)·chunk)
in tiles copied into shared memory (one, or a ring of two stages).  The
plan is made on the host, so it is checked here: the slices tile [0, blk)
with no gap and no overlap at the row counts and block sizes the
receiver's presets give (1-96 rows, 1 ms to 10 ms epochs), the tiles cover
each slice and the shared memory stays within what a block may opt into.
The wrapper refuses on the CPU what the card would refuse, and otherwise
runs the plain version there.  The kernel itself is held to the plain
version on a card in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from cusdr_tpu_torch.ops import correlator as corr

BLKS = (1, 255, 256, 18008, 72008, 180008)
ROWS = (1, 12, 15, 96)


def _assert_plan(plan, blk, k):
    slices = corr.ramp_slices(plan, blk)
    assert len(slices) == plan.cluster
    assert slices[0][0] == 0 and slices[-1][1] == blk
    for (_, end), (begin, _) in zip(slices, slices[1:]):
        assert end == begin                       # no gap, no overlap
    assert all(b <= e for b, e in slices)
    assert 0 < plan.tile <= plan.chunk
    # the tiles of the longest slice cover it; a ring of two when several
    n_tiles = -(-plan.chunk // plan.tile)
    assert plan.stages == min(n_tiles, 2)
    assert plan.smem_bytes % 16 == 0
    assert plan.smem_bytes == corr.ramp_smem_bytes(plan.tile, k, plan.stages)
    assert plan.smem_bytes <= corr.RAMP_SMEM_BYTES <= 227 * 1024 - 2048
    return slices


@pytest.mark.parametrize("n_rows", ROWS)
@pytest.mark.parametrize("blk", BLKS)
def test_plan_slices_tile_the_row(blk, n_rows):
    for k in (1, 9):
        plan = corr.ramp_plan(n_rows, blk, k)
        assert plan.cluster in (1, 2, 4, 8)
        slices = _assert_plan(plan, blk, k)
        # the default plan gives every block some samples
        assert all(b < e for b, e in slices)
        # and keeps the bank's blocks within the card's SMs
        assert (n_rows * plan.cluster <= corr.N_SMS
                or plan.cluster == 1)


def test_plan_at_the_prototype_shapes():
    """12 rows x 18 008 (the TPU prototype's default bank) run on 96
    blocks, 96 rows (gps_l1ca's eight time blocks) on one block a row, as
    the superblock kernel's ``cluster_size`` puts them, each slice in one
    tile; long slices go through a ring of two."""
    small = corr.ramp_plan(12, 18008, 9)
    assert (small.cluster, small.chunk, small.tile, small.stages) == (
        8, 2251, 2251, 1)
    wide = corr.ramp_plan(96, 18008, 9)
    assert (wide.cluster, wide.chunk, wide.tile, wide.stages) == (
        1, 18008, 18008, 1)
    for n_rows in (1, 12, 15, 16, 17, 33, 66, 67, 132, 500):
        assert corr.ramp_plan(n_rows, 18008, 9).cluster == \
            corr.cluster_size(n_rows)
    ring = corr.ramp_plan(200, 180008, 9)
    assert ring.stages == 2 and ring.tile < ring.chunk


@pytest.mark.parametrize("cluster", corr.RAMP_CLUSTERS)
def test_plan_takes_a_forced_cluster(cluster):
    for blk in BLKS:
        plan = corr.ramp_plan(12, blk, 9, cluster)
        assert plan.cluster == cluster
        _assert_plan(plan, blk, 9)


@pytest.mark.parametrize("smem_bytes", [2048, 40 * 1024, 96 * 1024])
def test_plan_within_a_smaller_budget(smem_bytes):
    """A smaller shared-memory budget gives more, smaller tiles through the
    ring of two, each fitting it; planning again at its own size and
    budget gives it back."""
    for blk in BLKS:
        plan = corr.ramp_plan(96, blk, 9, smem_bytes=smem_bytes)
        slices = _assert_plan(plan, blk, 9)
        assert plan.smem_bytes <= smem_bytes
        assert plan == corr.ramp_plan(96, blk, 9, plan.cluster,
                                      smem_bytes=plan.smem_bytes)
        assert slices[-1][1] == blk


def _windows(n_ch=4, blk=300, k=2, seed=3):
    rng = np.random.default_rng(seed)
    siq = torch.from_numpy(rng.integers(-16, 17, (n_ch, blk, 2)).astype(
        np.int8))
    wt = torch.from_numpy(rng.choice(np.array([-1, 1], np.int8),
                                     (n_ch, blk + 2 * k + 1)))
    f32 = [torch.from_numpy(rng.uniform(0, 1, n_ch).astype(np.float32))
           for _ in range(4)]
    bsz = torch.tensor([blk, blk - 7, 0, blk + 5][:n_ch])
    return siq, wt, f32, bsz


def _shifted(x, offset):
    """A contiguous copy of ``x`` starting ``offset`` bytes past a 16-byte
    boundary."""
    buf = torch.zeros(x.numel() + 32, dtype=x.dtype)
    at = (-buf.data_ptr()) % 16 + offset
    view = buf[at:at + x.numel()].view(x.shape)
    view.copy_(x)
    return view


def test_wrapper_refuses_on_the_cpu_what_the_card_refuses():
    siq, wt, f32, bsz = _windows()
    before = dict(corr.LAUNCHES)
    with pytest.raises(ValueError, match="int8"):
        corr.correlate_windows_ramp(siq.to(torch.int16), wt, *f32, bsz, k=2)
    with pytest.raises(ValueError, match="clusters"):
        corr.ramp_plan(4, 300, 2, 3)
    with pytest.raises(ValueError, match="exceeds"):
        corr.ramp_plan(4, 300, 2, smem_bytes=corr.RAMP_SMEM_BYTES + 16)
    with pytest.raises(ValueError, match="contiguous"):
        corr.correlate_windows_ramp(siq.transpose(0, 1).contiguous()
                                    .transpose(0, 1), wt, *f32, bsz, k=2)
    with pytest.raises(ValueError, match="contiguous"):
        corr.correlate_windows_ramp(
            siq, torch.cat([wt, wt], dim=1)[:, ::2], *f32, bsz, k=2)
    for offset in (2, 8):
        with pytest.raises(ValueError, match="16-byte"):
            corr.correlate_windows_ramp(_shifted(siq, offset), wt, *f32, bsz,
                                        k=2)
    with pytest.raises(ValueError, match="16-byte"):
        corr.correlate_windows_ramp(siq, _shifted(wt, 3), *f32, bsz, k=2)
    k = corr.RAMP_SMEM_BYTES // 10
    wide = torch.zeros((siq.shape[0], siq.shape[1] + 2 * k + 1),
                       dtype=torch.int8)
    with pytest.raises(ValueError, match="shared"):
        corr.correlate_windows_ramp(siq, wide, *f32, bsz, k=k)
    for bad in (0, -1):
        with pytest.raises(ValueError):
            corr.ramp_plan(12, 18008, bad)
    assert corr.LAUNCHES == before


@pytest.mark.parametrize("cluster", [None, 1, 8])
def test_wrapper_on_the_cpu_is_the_plain_version(cluster):
    """Ragged rows (one at 0 valid samples, one past blk), replica rows of
    an odd length: the wrapper gives the plain version, and no launch
    counted; the kernel's launch itself, at the wrapper's plan or another
    cluster size, takes no CPU tensor (no plain version behind it)."""
    siq, wt, f32, bsz = _windows()
    assert wt.shape[1] % 2
    before = dict(corr.LAUNCHES)
    plan = corr.ramp_plan(siq.shape[0], siq.shape[1], 2, cluster)
    got = corr.correlate_windows_ramp(siq, wt, *f32, bsz, k=2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        corr._ramp_launch(siq, wt, *f32, bsz, k=2, plan=plan)
    assert corr.LAUNCHES == before
    want = corr.correlate_windows_ramp_plain(siq, wt, *f32, bsz, k=2)
    assert torch.equal(got, want)
    assert not got[2].any() and not got[:, 6:].any()
