"""``correct`` on a whole run (the harness's look for a card skipped, the
program on the CPU at 2.048 Msps): true for the program as it is, false
with the timed path broken underneath in each way a cell can break, and
false for the control (the reference one precision step below, in the
program's place)."""

import numpy as np
import pytest

import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("tiny") / "checkout")


def test_sound_run_is_correct(root):
    res = tiny.run(root, "tsnap")
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert list(res)[-1] == "checks"


def _state_unchanged(mp):
    """Each superblock step hands back the loop state it was given (the
    first sample moves on, or the program's own guard stops the run)."""
    from cusdr_tpu_torch.tracking import engine
    orig = engine.track_superblock

    def step(iq, sb_start, tables, pilot_tables, state, *a, **kw):
        new, outs = orig(iq, sb_start, tables, pilot_tables, state, *a,
                         **kw)
        return state._replace(abs_sample=new.abs_sample,
                              active=new.active), outs
    mp.setattr(engine, "track_superblock", step)


def _half_the_channels(mp):
    from cusdr_tpu_torch.receiver import Receiver
    orig = Receiver.track

    def track(self, samples_iq, channels, n_epochs=None):
        return orig(self, samples_iq, channels[:max(len(channels) // 2, 1)],
                    n_epochs)
    mp.setattr(Receiver, "track", track)


def _prompt_altered(mp):
    from cusdr_tpu_torch.tracking import engine
    orig = engine.track_superblock

    def step(*a, **kw):
        state, outs = orig(*a, **kw)
        return state, outs._replace(i_p=outs.i_p * 1.001)
    mp.setattr(engine, "track_superblock", step)


def _code_phase_altered(mp):
    from cusdr_tpu_torch import receiver
    orig = receiver.acquire

    def acquire(*a, **kw):
        res = orig(*a, **kw)
        res.code_phase = res.code_phase + res.detected.astype(np.int64)
        return res
    mp.setattr(receiver, "acquire", acquire)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_the_channels,
                                   _prompt_altered, _code_phase_altered],
                         ids=lambda f: f.__name__.strip("_"))
def test_broken_path_is_not_correct(root, monkeypatch, fault):
    fault(monkeypatch)
    res = tiny.run(root, "tsnap")
    assert not res["correct"]
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


def test_control_is_not_correct(root):
    """The control's outputs, judged like the program's, go over at least
    one limit, and over each gap's limit the control is meant to
    separate."""
    runner = tiny.harness(root)   # noqa: F841 (imports the copy)
    from benchmark.harness import cells, control
    cell = cells.find_cell(root, "tsnap", root / "benchmark")
    rows = control.readings(cell, 77, True, "cpu", out=open("/dev/null",
                                                            "w"))
    for row in rows:
        over = {k for k, v in row["control"].items()
                if v > cell.limits[k]}
        assert {"acq_gap", "trk_sum_gap", "trk_carr_gap_hz",
                "trk_code_gap_hz", "trk_phase_gap"} <= over, row
        assert not {k for k, v in row["program"].items()
                    if v > cell.limits[k]}, row
