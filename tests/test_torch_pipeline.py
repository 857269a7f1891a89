"""``engine.track``'s pipelined superblock loop on the CPU.

On a card the loop stages each superblock into one of two reused host
buffers (page-locked) and copies it to the card on a side stream while the
card tracks the previous one; on the CPU the same loop runs through the
same staging ring without the copy.  Here:

- ``stage_superblock(out=...)`` into a reused buffer equals a fresh
  ``stage_superblock``, int8 and int16, the part past the record's end
  zeroed where the buffer held other samples before;
- each superblock's (epochs, sb_start, buf_len) equals the reference loop's
  arithmetic (``cusdr_tpu/tracking/engine.py``, ``track``'s while loop,
  transcribed below as ``_reference_windows``) and the buffers the
  reference's own loop builds, on gps_l1ca, gal_e5a with its pilot bank and
  an int16 record, and every buffer the loop hands ``track_superblock``
  equals a fresh ``stage_superblock`` of its window;
- ``track`` over 35 superblocks (``superblock_ms=20``) equals the JAX
  package's ``track`` within the tolerances of
  tests/test_torch_receiver.py: ``abs_sample`` exact, I_P within
  2e-4·(max|I_P| + 1), carrier within 1e-3 Hz;
- a channel that fails the lock gate in two superblocks in a row is
  dropped one superblock later than a synchronous loop would drop it, at
  the reference's epoch.

The file takes a few seconds.  The card's cases (the loop against a
synchronous one, element for element) are in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from cusdr_tpu import get_config
from cusdr_tpu.signals.defs import get_signal
from cusdr_tpu.tracking import engine as jeng
from cusdr_tpu_torch import get_config as t_get_config
from cusdr_tpu_torch.io.synth import SynthSV, quantize_iq_int8, synthesize_if
from cusdr_tpu_torch.signals.defs import get_signal as t_get_signal
from cusdr_tpu_torch.tracking import engine as teng

from test_torch_threads import few_torch_threads  # noqa: F401 (autouse)

L1 = dict(sampling_freq=2.048e6, if_freq=7000.0, superblock_ms=20,
          lock_detect=False)


def _scene(over, svs, num_ms, seed=5):
    cfg = t_get_config("gps_l1ca", **over)
    sig = t_get_signal("gps_l1ca")
    iq = quantize_iq_int8(synthesize_if(cfg, sig, svs, num_ms=num_ms,
                                        seed=seed))
    return iq, [(sv.prn, over["if_freq"] + sv.doppler_hz + 3.0,
                 int(sv.code_phase)) for sv in svs]


SVS = [SynthSV(prn=3, code_phase=200.0, doppler_hz=1200.0, cn0_dbhz=48.0),
       SynthSV(prn=7, code_phase=900.5, doppler_hz=-800.0, cn0_dbhz=48.0),
       SynthSV(prn=12, code_phase=1500.0, doppler_hz=300.0, cn0_dbhz=48.0)]


@pytest.mark.parametrize("dtype", [np.int8, np.int16])
@pytest.mark.parametrize("sb_start,buf_len", [
    (0, 600), (1234, 600), (4700, 600), (4999, 8), (4999, 600)])
def test_staging_into_a_reused_buffer_equals_a_fresh_one(dtype, sb_start,
                                                         buf_len):
    """The record holds 5 000 samples: the last three windows run past its
    end (the last two hold one sample of it).  The reused buffer held other
    samples everywhere before."""
    rng = np.random.default_rng(3)
    record = rng.integers(-100, 100, 2 * 5000).astype(dtype)
    want = teng.stage_superblock(record, sb_start, buf_len)
    out = np.full(2 * buf_len, 77, dtype)
    got = teng.stage_superblock(record, sb_start, buf_len, out=out)
    assert got is out and got.dtype == want.dtype
    assert np.array_equal(got, want)
    n = 2 * max(min(sb_start + buf_len, 5000) - sb_start, 0)
    assert not got[n:].any()


def test_staging_refuses_a_buffer_of_another_size_or_type():
    record = np.zeros(200, np.int8)
    for out in (np.zeros(98, np.int8), np.zeros(100, np.int16)):
        with pytest.raises(ValueError, match="out must be"):
            teng.stage_superblock(record, 0, 50, out=out)


def _reference_windows(n_epochs, sb_epochs, spc, channels, blk):
    """The reference loop's window arithmetic, transcribed from
    cusdr_tpu/tracking/engine.py (``track``, its ``while done < n_epochs``
    loop): (epochs, sb_start, buf_len) per superblock."""
    max_phase = max(ch[2] for ch in channels)
    min_phase0 = min(ch[2] for ch in channels)
    done, buf_len, out = 0, None, []
    while done < n_epochs:
        cur = min(sb_epochs, n_epochs - done)
        drift = 2 * (done + cur + 3)
        sb_start = max(min_phase0 + done * spc - drift - spc, 0)
        need = (max_phase + (done + cur + 3) * spc + drift
                + blk + 256 - sb_start)
        if buf_len is None:
            drift_end = 2 * (n_epochs + 3)
            buf_len = jeng._round_up(
                max_phase - min_phase0 + (sb_epochs + 4) * spc
                + 2 * drift_end + blk + 256, 4 * spc)
        buf_len = max(buf_len, jeng._round_up(need, 4 * spc))
        out.append((cur, sb_start, buf_len))
        done += cur
    return out


def _fake_outputs(fields, n_epochs, n_ch, zeros):
    """Outputs of ``n_epochs`` x ``n_ch`` in which no channel tracked (the
    drain's buffer check reads only live windows)."""
    return fields(*(zeros((n_epochs, n_ch)) for _ in fields._fields))


# gps_l1ca; gal_e5a with its pilot bank (10 230 samples a code period, a
# 100-epoch superblock); an int16 record (the reference stages int16 as
# int16 pairs, int8 as one uint16 a sample)
WINDOW_CASES = {
    "gps_l1ca": ("gps_l1ca", L1, np.int8, 301, [(3, 0.0, 200),
                                                (7, 0.0, 1900)]),
    "gal_e5a_pilot": ("gal_e5a", dict(sampling_freq=10.23e6, if_freq=0.0,
                                      superblock_ms=100, lock_detect=False),
                      np.int8, 250, [(1, 0.0, 5000), (5, 0.0, 17),
                                     (9, 0.0, 9000)]),
    "int16": ("gps_l1ca", dict(L1, superblock_ms=30, data_type="int16"),
              np.int16, 200, [(3, 0.0, 1000), (7, 0.0, 40)]),
}


@pytest.mark.parametrize("case", list(WINDOW_CASES))
def test_windows_are_the_reference_loops(monkeypatch, case):
    signal, over, dtype, n_epochs, channels = WINDOW_CASES[case]
    cfg, sig = get_config(signal, **over), get_signal(signal)
    tcfg, tsig = t_get_config(signal, **over), t_get_signal(signal)
    jparams = jeng.make_track_params(cfg, sig)
    tparams = teng.make_track_params(tcfg, tsig)
    assert jparams.blk == tparams.blk
    assert tparams.has_pilot == (case == "gal_e5a_pilot")
    spc = cfg.samples_per_code
    sb_epochs = min(n_epochs, max(int(cfg.superblock_ms
                                      / sig.code_period_ms), 1))
    want = _reference_windows(n_epochs, sb_epochs, spc, channels,
                              jparams.blk)
    assert len(want) > 2 and want[-1][0] < sb_epochs
    assert teng.superblock_windows(
        n_epochs, min(n_epochs, teng.superblock_epochs(tcfg, tsig)), spc,
        min(ch[2] for ch in channels), max(ch[2] for ch in channels),
        tparams.blk) == want
    # a record that ends inside the last superblock's buffer
    n_samp = want[-1][1] + want[-1][2] - 3 * spc
    record = np.random.default_rng(1).integers(
        -100, 100, 2 * n_samp).astype(dtype)

    # the reference's own loop, its track_superblock replaced by a recorder
    jcalls = []

    def jrecord(buf, sb_start, ctabs, ptabs, state, params, cur, end):
        eps = 2 if buf.dtype == np.int16 else 1
        jcalls.append((cur, int(sb_start), buf.shape[0] // eps))
        return state, _fake_outputs(jeng.TrackOutputs, cur, len(channels),
                                    np.zeros)

    monkeypatch.setattr(jeng, "track_superblock", jrecord)
    jeng.track(cfg, sig, record, channels, n_epochs=n_epochs)
    assert jcalls == want

    # the port's loop: its buffers equal fresh stagings of the same windows
    tcalls = []

    def trecord(iq, sb_start, tables, ptables, state, params, cur, end):
        assert iq.dtype == torch.from_numpy(record[:0]).dtype
        buf_len = iq.shape[0] // 2
        assert np.array_equal(iq.numpy(), teng.stage_superblock(
            record, sb_start, buf_len))
        tcalls.append((cur, sb_start, buf_len))
        return state, _fake_outputs(
            teng.TrackOutputs, cur, len(channels),
            lambda shape: torch.zeros(shape, dtype=torch.int64))

    monkeypatch.setattr(teng, "track_superblock", trecord)
    teng.track(tcfg, tsig, record, channels, "cpu", n_epochs=n_epochs)
    assert tcalls == want


def test_track_across_35_superblocks_matches_the_reference():
    iq, channels = _scene(L1, SVS, 720)
    ref = jeng.track(get_config("gps_l1ca", **L1), get_signal("gps_l1ca"),
                     iq, channels)
    port = teng.track(t_get_config("gps_l1ca", **L1),
                      t_get_signal("gps_l1ca"), iq, channels, "cpu")
    assert port.i_p.shape == ref.i_p.shape and port.i_p.shape[1] >= 700
    assert port.status == ref.status == ["T"] * 3
    assert np.array_equal(port.abs_sample, ref.abs_sample)
    assert np.array_equal(port.blksize, ref.blksize)
    scale = np.abs(ref.i_p).max() + 1.0
    assert np.abs(port.i_p - ref.i_p).max() <= 2e-4 * scale
    assert np.allclose(port.carr_freq, ref.carr_freq, rtol=0, atol=1e-3)


def test_drop_takes_effect_one_superblock_late():
    """PRN 7 stops transmitting at 450 ms.  Superblocks of 100 epochs:
    the lock gate fails it in superblocks 5 and 6 (500-700 ms); the drain
    of superblock 6 runs after superblock 7 was dispatched, so the drop
    takes effect from superblock 8, epoch 800 (a synchronous loop would
    drop it at 700), in the reference as in the port."""
    over = dict(L1, superblock_ms=100, lock_detect=True)
    svs = [SynthSV(prn=3, code_phase=200.0, doppler_hz=1200.0,
                   cn0_dbhz=48.0),
           SynthSV(prn=7, code_phase=900.5, doppler_hz=-800.0,
                   cn0_dbhz=48.0, stop_ms=450.0)]
    iq, channels = _scene(over, svs, 1010)
    ref = jeng.track(get_config("gps_l1ca", **over), get_signal("gps_l1ca"),
                     iq, channels)
    port = teng.track(t_get_config("gps_l1ca", **over),
                      t_get_signal("gps_l1ca"), iq, channels, "cpu")
    assert port.i_p.shape[1] > 900
    # the gate's own reading of each superblock: PRN 7 fails it first in
    # superblocks 5 and 6
    cfg = t_get_config("gps_l1ca", **over)
    pwr = (port.i_p[1].astype(np.float64) ** 2
           + port.q_p[1].astype(np.float64) ** 2)[:800].reshape(8, 100)
    pwr = pwr.mean(axis=1)
    bad = [bool(teng.pll_lock_detector(port.i_p[1, j - 40:j],
                                       port.q_p[1, j - 40:j])
                < cfg.lock_threshold
                or p < 10.0 ** (-cfg.lock_power_drop_db / 10.0)
                * pwr[:k + 1].max())
           for k, (j, p) in enumerate(zip(range(100, 900, 100), pwr))]
    assert bad[:7] == [False] * 5 + [True] * 2
    assert port.status == ref.status == ["T", "-"]
    assert list(port.active_until) == list(ref.active_until)
    assert port.active_until[1] == 800
    assert np.all(port.blksize[1, :800] > 0)
    assert not port.blksize[1, 800:].any()
