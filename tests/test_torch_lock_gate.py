"""The lock gate's carrier test on a Galileo E5a scene, held to the
benchmark's plain reference (``benchmark/reference``: numpy and plain
torch, nothing of the port or of jax).

The scene: three E5a SVs at 50 dB-Hz with random F/NAV symbols, 0.75 s at
12.288 Msps, superblocks of 100 ms.  Two channels start from the sky's
carrier and code phase; one from a carrier 295 Hz off the sky, as a
hand-off from the coarse bin second nearest the sky does (the fine stage
searches half a coarse step around it).

- With the preset's test (``carrier_lock_test`` 'in_phase_share') the port
  keeps exactly the channels whose prompts hold lock by the reference's
  rule (``check.holds_lock``) at the end of the reference's own loop
  (``tracking.follow``) from the same hand-offs, and drops the off one by
  the end of its third superblock (two superblocks judged, read one
  late).
- With the reference's detector ('nbd_nbp', every other preset's) the off
  channel is kept to the end: NBD/NBP rectifies I, so it reads high on a
  rotating carrier whose data signs flip every epoch.
- On noise alone the in-phase share reads under its threshold in every
  superblock, and the channel is dropped; NBD/NBP reads above its own.
"""

import json
from pathlib import Path

import numpy as np
import pytest

from benchmark.reference import tracking as ref_tracking
from benchmark.reference.check import LOCK_EPOCHS, holds_lock
from benchmark.reference.precision import REFERENCE
from benchmark.traffic.codes import signal_of
from cusdr_tpu_torch import PRESETS, get_config
from cusdr_tpu_torch.io.synth import SynthSV, quantize_iq_int8, synthesize_if
from cusdr_tpu_torch.signals.defs import get_signal
from cusdr_tpu_torch.tracking import engine
from cusdr_tpu_torch.tracking.cno import pll_lock_detector

from test_torch_threads import few_torch_threads  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
OVER = dict(sampling_freq=12.288e6, if_freq=7000.0, superblock_ms=100)
SB = 100                                  # epochs in a superblock
RECORD_MS = 750
OFF_HZ = 295.0
SVS = [SynthSV(prn=4, code_phase=5233.0, doppler_hz=1100.0, cn0_dbhz=50.0),
       SynthSV(prn=11, code_phase=901.0, doppler_hz=-2204.9, cn0_dbhz=50.0),
       SynthSV(prn=19, code_phase=10412.0, doppler_hz=620.0, cn0_dbhz=50.0)]
OFF = 1                                   # the channel handed off 295 Hz off


def _cfg(test=None):
    cfg = get_config("gal_e5a", **OVER)
    return cfg if test is None else cfg.replace(carrier_lock_test=test)


def _record(svs, seed):
    cfg, sig = _cfg(), get_signal("gal_e5a")
    rng = np.random.default_rng(seed)
    n_sym = int(RECORD_MS / sig.nav_symbol_ms) + 2
    svs = [SynthSV(prn=s.prn, code_phase=s.code_phase,
                   doppler_hz=s.doppler_hz, cn0_dbhz=s.cn0_dbhz,
                   nav_bits=rng.choice([-1, 1], n_sym).astype(np.int8))
           for s in svs]
    return quantize_iq_int8(synthesize_if(cfg, sig, svs, num_ms=RECORD_MS,
                                          seed=seed))


def _handoffs(cfg):
    return [(sv.prn, cfg.if_freq + sv.doppler_hz + (OFF_HZ if c == OFF
                                                    else 0.0),
             int(sv.code_phase)) for c, sv in enumerate(SVS)]


def _plain(trk) -> dict:
    return {k: np.asarray(getattr(trk, k)) for k in (
        "abs_sample", "carr_freq", "code_freq", "rem_code_phase",
        "rem_carr_phase", "blksize")} | {"prns": np.asarray(trk.prns)}


def _kept(trk):
    n_ep = trk.i_p.shape[1]
    return {int(p) for p, a in zip(trk.prns, trk.active_until) if a == n_ep}


@pytest.fixture(scope="module")
def scene():
    """(iq, the port's results with each carrier test, the channels the
    reference's own loop holds locked at the end)."""
    iq = _record(SVS, seed=19)
    sig = get_signal("gal_e5a")
    runs = {t: engine.track(_cfg(t), sig, iq, _handoffs(_cfg()), "cpu")
            for t in engine.CARRIER_LOCK_TESTS}
    bench = json.loads((ROOT / "benchmark/configs/gal_e5a_lockgate.json")
                       .read_text())
    s, g = dict(bench["settings"], **OVER), bench["signal"]
    trk = _plain(runs["in_phase_share"])
    n_ep = trk["blksize"].shape[1]
    wit = ref_tracking.follow(iq, trk, ref_tracking.tables_for(
        trk, s, g, signal_of(g)), s, g, "cpu", REFERENCE, n_ep)
    tail = np.s_[-LOCK_EPOCHS:]
    held = {int(p) for c, p in enumerate(trk["prns"])
            if holds_lock(wit["i_p"][c, tail], wit["q_p"][c, tail],
                          wit["noise"][c, tail])}
    return iq, runs, held


def test_the_gate_keeps_the_channels_the_reference_holds_locked(scene):
    _, runs, held = scene
    trk = runs["in_phase_share"]
    assert held == {SVS[c].prn for c in range(len(SVS)) if c != OFF}
    assert _kept(trk) == held
    assert 2 * SB < trk.active_until[OFF] <= 3 * SB
    assert np.all(trk.blksize[OFF, trk.active_until[OFF]:] == 0)


def test_the_reference_detector_keeps_the_off_channel(scene):
    _, runs, held = scene
    trk = runs["nbd_nbp"]
    assert _kept(trk) == {sv.prn for sv in SVS} != held
    # the same hand-offs and the same loop up to the gate's drop
    ours = runs["in_phase_share"]
    upto = int(ours.active_until[OFF])
    assert np.array_equal(trk.abs_sample[:, :upto], ours.abs_sample[:, :upto])
    assert np.array_equal(trk.i_p[:, :upto], ours.i_p[:, :upto])
    i_p, q_p = trk.i_p[OFF], trk.q_p[OFF]
    for end in range(SB, 3 * SB + 1, SB):
        assert pll_lock_detector(i_p[end - 40:end], q_p[end - 40:end]) \
            >= _cfg().lock_threshold
        assert engine.carrier_unlocked(_cfg(), i_p[end - 40:end],
                                       q_p[end - 40:end])


def test_the_in_phase_share_reads_below_threshold_on_noise():
    iq = _record([], seed=23)
    sig = get_signal("gal_e5a")
    hand = [(4, 7000.0 + 1100.0, 5233)]
    trk = engine.track(_cfg(), sig, iq, hand, "cpu")
    kept = engine.track(_cfg("nbd_nbp"), sig, iq, hand, "cpu")
    assert trk.active_until[0] <= 3 * SB
    assert kept.active_until[0] == kept.i_p.shape[1]
    for end in range(SB, kept.i_p.shape[1] + 1, SB):
        i_p, q_p = kept.i_p[0, end - 40:end], kept.q_p[0, end - 40:end]
        share = np.mean(np.abs(i_p) > np.abs(q_p))
        assert share < engine.IN_PHASE_SHARE
        assert engine.carrier_unlocked(_cfg(), i_p, q_p)
        assert pll_lock_detector(i_p, q_p) >= _cfg().lock_threshold


def test_only_gal_e5a_departs_from_the_reference_detector():
    tests = {name: get_config(name).carrier_lock_test for name in PRESETS}
    assert tests.pop("gal_e5a") == "in_phase_share"
    assert set(tests.values()) == {"nbd_nbp"}
    with pytest.raises(ValueError, match="carrier_lock_test"):
        engine.track(_cfg("pld"), get_signal("gal_e5a"),
                     np.zeros(2 * 12288 * 40, np.int8), [(4, 8100.0, 0)],
                     "cpu")
