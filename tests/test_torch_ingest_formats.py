"""The sample formats through the port (the mirror of
tests/test_ingest_formats.py): interleaved I/Q files of schar and int16
and a real schar file (the real branch: I + j·0) read by the port's
``read_if_file`` and run through the port's ``Receiver`` on the CPU, each
held against the JAX reference's ``Receiver`` on the same file (the same
channels; ``abs_sample`` equal, prompt sums within 2e-4·(max + 1)); and the
int16 record that is an int8 one times 64 through ``track`` and
``track_time_parallel`` (flat bank and per-block path): the int8 run's
states, loop outputs and block sizes exactly, and 64 times its correlator
sums exactly (every operation on the samples scales by the power of two,
and the loops see only ratios of the sums).
"""

import numpy as np
import pytest

from cusdr_tpu import get_config
from cusdr_tpu.io.synth import SynthSV, synthesize_if
from cusdr_tpu.receiver import Receiver as JReceiver
from cusdr_tpu.signals.defs import get_signal
from cusdr_tpu_torch import get_config as t_get_config
from cusdr_tpu_torch.io.ingest import read_if_file, unpack_2bit_iq
from cusdr_tpu_torch.io.synth import quantize_iq_int8
from cusdr_tpu_torch.parallel.timeblocks import track_time_parallel
from cusdr_tpu_torch.receiver import Receiver as TReceiver
from cusdr_tpu_torch.signals.defs import get_signal as t_get_signal
from cusdr_tpu_torch.tracking.engine import track

from test_torch_threads import few_torch_threads  # noqa: F401 (autouse)

PRN = 9
SUMS = ("i_e", "q_e", "i_p", "q_p", "i_l", "q_l", "pilot_ip", "pilot_qp")


def _scene(cfg, num_ms=400):
    sv = SynthSV(prn=PRN, code_phase=777.0, doppler_hz=1500.0,
                 cn0_dbhz=50)
    return synthesize_if(cfg, get_signal("gps_l1ca"), [sv], num_ms=num_ms,
                         seed=11)


def _check(res, cfg):
    """The reference test's bounds on the port's run."""
    i = list(res.acq.prns).index(PRN)
    assert res.acq.detected[i]
    err = abs(int(res.acq.code_phase[i]) - 777) % cfg.samples_per_code
    assert min(err, cfg.samples_per_code - err) <= 2
    trk = res.track
    ip = np.abs(trk.i_p[0, -150:]).mean()
    qp = np.abs(trk.q_p[0, -150:]).mean()
    assert ip > 3 * qp


def _both(over):
    """The reference's and the port's ``Receiver`` on ``over``'s file."""
    ref = JReceiver(get_config("gps_l1ca", **over)).run(n_epochs=300)
    tcfg = t_get_config("gps_l1ca", **over)
    port = TReceiver(tcfg, "cpu").run(read_if_file(tcfg.file_name, tcfg),
                                      n_epochs=300)
    assert port.channels == ref.channels
    assert np.array_equal(port.track.abs_sample, ref.track.abs_sample)
    scale = np.abs(ref.track.i_p).max() + 1.0
    assert np.abs(port.track.i_p - ref.track.i_p).max() <= 2e-4 * scale
    return tcfg, port


@pytest.mark.parametrize("data_type,scale", [("schar", 1.0),
                                             ("int16", 64.0)])
def test_iq_file(tmp_path, data_type, scale):
    over = dict(sampling_freq=2.048e6, if_freq=7000.0,
                acq_satellite_list=(PRN, PRN + 3), acq_threshold=2.5,
                file_type=2, data_type=data_type,
                file_name=str(tmp_path / f"iq_{data_type}.bin"))
    samples = _scene(get_config("gps_l1ca", **over))
    dt = np.int8 if data_type == "schar" else np.int16
    out = np.empty(samples.size * 2, dt)
    out[0::2] = np.clip(np.round(samples.real * scale), -127 * scale,
                        127 * scale).astype(dt)
    out[1::2] = np.clip(np.round(samples.imag * scale), -127 * scale,
                        127 * scale).astype(dt)
    out.tofile(over["file_name"])
    tcfg = t_get_config("gps_l1ca", **over)
    assert read_if_file(tcfg.file_name, tcfg).dtype == dt
    cfg, port = _both(over)
    _check(port, cfg)


def test_real_file_schar(tmp_path):
    # real sampling needs IF above half the code bandwidth so the -IF
    # image stays out of the correlator band; fs/4 is the classic choice
    over = dict(sampling_freq=4.096e6, if_freq=1.024e6,
                acq_satellite_list=(PRN, PRN + 3), acq_threshold=2.2,
                file_type=1, data_type="schar",
                file_name=str(tmp_path / "real.bin"))
    samples = _scene(get_config("gps_l1ca", **over))
    np.clip(np.round(samples.real * np.sqrt(2.0)), -127,
            127).astype(np.int8).tofile(over["file_name"])
    cfg, port = _both(over)
    _check(port, cfg)


def test_skip_samples_resume(tmp_path):
    """skip_number_of_bytes with an offset: the port reads the same bytes
    as a slice of the file."""
    cfg = t_get_config("gps_l1ca", sampling_freq=2.048e6, if_freq=7000.0,
                       acq_satellite_list=(PRN,), acq_threshold=2.5,
                       file_type=2, data_type="schar",
                       file_name=str(tmp_path / "skip.bin"))
    samples = _scene(cfg, num_ms=120)
    out = np.empty(samples.size * 2, np.int8)
    out[0::2] = np.clip(np.round(samples.real), -127, 127)
    out[1::2] = np.clip(np.round(samples.imag), -127, 127)
    out.tofile(cfg.file_name)
    skip = 3 * cfg.samples_per_code
    arr = read_if_file(cfg.file_name, cfg, offset_samples=skip)
    assert np.array_equal(arr, out[2 * skip:])
    arr = read_if_file(cfg.file_name,
                       cfg.replace(skip_number_of_bytes=2 * skip))
    assert np.array_equal(arr, out[2 * skip:])


def test_unpack_2bit_matches_lut():
    """2-bit sign/magnitude bytes unpack to ±1/±3."""
    raw = np.arange(256, dtype=np.uint8)
    out = unpack_2bit_iq(raw)
    assert out.dtype == np.int8
    assert set(np.unique(out)) <= {-3, -1, 1, 3}
    assert out.size == raw.size * 4
    assert out[:4].tolist() == [1, 1, 1, 1]          # byte 0: all +1
    assert unpack_2bit_iq(np.asarray([0xFF], np.uint8)).tolist() == [-3] * 4


@pytest.fixture(scope="module")
def records():
    """An int8 record of two SVs and the int16 record 64 times it."""
    cfg = t_get_config("gps_l1ca", sampling_freq=2.048e6, if_freq=7000.0)
    sig = t_get_signal("gps_l1ca")
    from cusdr_tpu_torch.io.synth import SynthSV as TSynthSV
    from cusdr_tpu_torch.io.synth import synthesize_if as t_synthesize
    svs = [TSynthSV(prn=3, code_phase=101.0, doppler_hz=1500.0,
                    cn0_dbhz=47),
           TSynthSV(prn=9, code_phase=777.0, doppler_hz=-900.0,
                    cn0_dbhz=45)]
    iq = quantize_iq_int8(t_synthesize(cfg, sig, svs, num_ms=300, seed=1))
    channels = [(3, 7000.0 + 1500.0, 101), (9, 7000.0 - 900.0, 777)]
    return cfg, sig, iq, iq.astype(np.int16) * 64, channels


def _assert_times_64(a, b):
    """``b`` is ``a`` with every correlator sum 64 times, all else equal."""
    fields = [f for f, v in vars(a).items() if isinstance(v, np.ndarray)]
    assert {"i_p", "carr_freq", "abs_sample", "blksize"} <= set(fields)
    for f in fields:
        want = 64 * getattr(a, f) if f in SUMS else getattr(a, f)
        assert np.array_equal(getattr(b, f), want), f
    assert a.status == b.status


def test_track_int16_is_int8_times_64(records):
    cfg, sig, iq8, iq16, channels = records
    a = track(cfg, sig, iq8, channels, "cpu", n_epochs=250)
    b = track(cfg, sig, iq16, channels, "cpu", n_epochs=250)
    _assert_times_64(a, b)


@pytest.mark.parametrize("fetch_in_kernel", [True, False])
def test_time_parallel_int16_is_int8_times_64(records, fetch_in_kernel):
    cfg, sig, iq8, iq16, channels = records
    a, b = (track_time_parallel(cfg, sig, iq, channels, 240, 4,
                                device="cpu",
                                fetch_in_kernel=fetch_in_kernel)
            for iq in (iq8, iq16))
    _assert_times_64(a, b)


def test_other_sample_types_are_refused(records):
    cfg, sig, iq8, iq16, channels = records
    with pytest.raises(ValueError, match="int8 or int16"):
        track(cfg, sig, iq8.astype(np.int32), channels, "cpu", n_epochs=10)
