"""The superblock kernel's roofline arithmetic, pinned at the gps_l1ca
bank of PERF.md's kernel table: 12 rows x 18 008 samples x 250 epochs."""

import pytest

from benchmark.roofline import bound_s, superblock_work

ROWS, BLK, EPOCHS = 12, 18_008, 250


def _work(pilots=0, sample_bytes=2):
    return superblock_work(rows=ROWS, epochs=EPOCHS,
                           valid_epochs=ROWS * EPOCHS,
                           valid_samples=ROWS * EPOCHS * BLK,
                           span=EPOCHS * 18_000 + BLK, blk=BLK,
                           pilots=pilots, sample_bytes=sample_bytes)


def test_s1_bytes_and_operations():
    n_bytes, ops = _work()
    # record: 2 bytes per sample of the span; tables 12 x (18 008 + 2 048);
    # state 12 x 226; outputs 250 x 12 x 96
    assert n_bytes == 2 * 4_518_008 + 12 * 20_056 + 12 * 226 + 288_000
    # 33 per valid sample (6 carrier, 6 wipe-off, 21 for the data bank's
    # taps), 150 per valid epoch
    assert ops == 54_024_000 * 33 + 3_000 * 150
    t, what = bound_s(n_bytes, ops)
    assert what == "operations"
    # 0.026616 ms: chip_smoke.py's superblock_bound gave 0.0267 ms (PERF.md
    # kernel table) with 4 x (141 + 128) more operations per epoch for the
    # carrier's u.v factors, which this bound no longer counts
    assert t * 1e3 == pytest.approx(0.026616, abs=5e-7)
    old = (ops + 3_000 * 4 * ((BLK + 127) // 128 + 128)) / 67e12
    assert old * 1e3 == pytest.approx(0.02666, abs=5e-6)


def test_s1p_counts_a_second_bank():
    _, ops0 = _work(0)
    n_bytes, ops1 = _work(1)
    assert ops1 - ops0 == 54_024_000 * 21
    assert bound_s(n_bytes, ops1)[0] * 1e3 == pytest.approx(0.04355,
                                                            abs=1e-5)


def test_int16_doubles_the_record_bytes():
    b8, _ = _work(sample_bytes=2)
    b16, _ = _work(sample_bytes=4)
    assert b16 - b8 == 2 * 4_518_008
