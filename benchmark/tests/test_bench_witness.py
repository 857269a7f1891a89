"""The reference's own tracking loop (``tracking.follow``), the witness
for the lock of the program's channels, on a tiny capture on the CPU: from
the program's hand-off it follows the program's carrier epoch for epoch at
the start, holds code and carrier lock where the program does, and loses
it on a record of noise alone."""

import numpy as np
import pytest

import tiny


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    root = tiny.make(tmp_path_factory.mktemp("tiny") / "checkout")
    tiny.harness(root)
    from benchmark.harness import cells, program, records
    from benchmark.traffic.codes import signal_of
    cell = cells.find_cell(root, "tsnap", root / "benchmark")
    (iq, sky), _ = records.make_pool(cell.config, cell.traffic, 31, "cpu")
    prog = program.plain(program.receiver(cell.config, "cpu").run(iq))
    return cell, iq, prog, signal_of(cell.config["signal"])


def _follow(cell, iq, prog, codes):
    from benchmark.reference import tracking
    from benchmark.reference.precision import REFERENCE
    s, g = cell.config["settings"], cell.config["signal"]
    trk = prog["track"]
    return tracking.follow(iq, trk, tracking.tables_for(trk, s, g, codes),
                           s, g, "cpu", REFERENCE, trk["blksize"].shape[1])


def test_follows_the_program_and_holds_lock(capture):
    from benchmark.reference.check import LOCK_EPOCHS, holds_lock
    cell, iq, prog, codes = capture
    trk = prog["track"]
    wit = _follow(cell, iq, prog, codes)
    assert wit["i_p"].shape[1] >= trk["blksize"].shape[1] - 2
    np.testing.assert_allclose(wit["carr_freq"][:, :20],
                               trk["carr_freq"][:, :20], atol=1e-3)
    for c in range(len(trk["prns"])):
        tail = np.s_[c, -LOCK_EPOCHS:]
        assert holds_lock(wit["i_p"][tail], wit["q_p"][tail],
                          wit["noise"][tail])
        assert trk["active_until"][c] == trk["blksize"].shape[1]


def test_loses_lock_on_noise(capture):
    from benchmark.reference.check import LOCK_EPOCHS, holds_lock
    cell, iq, prog, codes = capture
    rng = np.random.default_rng(5)
    noise = np.clip(np.round(rng.normal(0, 4, iq.shape)), -127,
                    127).astype(np.int8)
    wit = _follow(cell, noise, prog, codes)
    for c in range(wit["i_p"].shape[0]):
        tail = np.s_[c, -LOCK_EPOCHS:]
        assert not holds_lock(wit["i_p"][tail], wit["q_p"][tail],
                              wit["noise"][tail])
