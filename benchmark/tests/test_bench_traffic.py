"""The frozen traffic copies against the program's originals, on the CPU
at a tiny size (the tests may import the program; the reference may
not)."""

import numpy as np
import pytest
import torch

from benchmark.frozen import codes, lnav
from benchmark.traffic import scenario
from benchmark.traffic.codes import signal_of
from benchmark.traffic.synth import make_record, record_chunks

CFG = {"codes": "gps_l1ca", "carrier_freq_hz": 1575.42e6,
       "chip_rate_hz": 1.023e6, "code_length_chips": 1023,
       "nav_symbol_ms": 20.0}


E5A = {"codes": "gal_e5a", "carrier_freq_hz": 1176.45e6,
       "chip_rate_hz": 10.23e6, "code_length_chips": 10230,
       "nav_symbol_ms": 20.0}


def test_e5a_codes_are_the_programs():
    from cusdr_tpu_torch.signals.codes import galileo
    for prn in (1, 2, 19, 36):
        assert np.array_equal(codes.e5ai(prn), galileo.e5ai(prn))
        assert np.array_equal(codes.e5aq(prn), galileo.e5aq(prn))
        assert np.array_equal(codes.e5aq_secondary(prn),
                              galileo.e5aq_secondary(prn))
    assert np.array_equal(codes.E5AI_SECONDARY, galileo.E5AI_SECONDARY)


def test_fnav_is_the_programs():
    from cusdr_tpu_torch.nav import galileo_nav as pgal
    sky = scenario.galileo_sky(3, fs=12.288e6, n_svs=2, duration_s=2.0,
                               cn0_dbhz=50.0, prns=range(1, 37),
                               nav_pages=5)
    for prn, eph in sky.eph_by_prn.items():
        want = np.concatenate([pgal.fnav_encode_page(
            1 + i % 4, eph, tow_raw=int(sky.frame_t0) + 10 * i)
            for i in range(5)])
        assert np.array_equal(scenario.fnav_stream(eph, sky.frame_t0, 5),
                              1 - 2 * want.astype(np.int8))
        got, first, tow = pgal.fnav_decode_symbol_stream(
            scenario.fnav_stream(eph, sky.frame_t0, 5).astype(float))
        assert first == 0 and tow == sky.frame_t0
        assert got["sqrtA"] == pytest.approx(eph["sqrtA"], abs=2 ** -19)


def test_l1ca_codes_are_the_programs():
    from cusdr_tpu_torch.signals.codes.gps import l1ca
    for prn in range(1, 33):
        assert np.array_equal(codes.l1ca(prn), l1ca(prn))


def test_sample_code_is_the_programs():
    from cusdr_tpu_torch.signals.defs import sample_code
    chips = codes.l1ca(7)
    for fs, phase in ((2.048e6, 0.0), (18e6, -1024 * 1.023e6 / 18e6)):
        assert np.array_equal(
            codes.sample_code(chips, 1.023e6, fs, 40_000, phase),
            sample_code(chips, 1, 1.023e6, fs, 40_000,
                        code_phase_chips=phase))


@pytest.mark.parametrize("n_frames", [1, 3])
def test_lnav_is_the_programs(n_frames):
    from cusdr_tpu_torch.nav import lnav as plnav
    sky = scenario.gps_sky(5, fs=2.048e6, n_svs=4, duration_s=2.0,
                           cn0_dbhz=46.0, nav_frames=n_frames)
    for prn, eph in sky.eph_by_prn.items():
        ours = lnav.nav_bit_stream(eph, int(sky.frame_t0), n_frames)
        assert np.array_equal(ours, plnav.nav_bit_stream(
            eph, int(sky.frame_t0), n_frames))
        got, tow = lnav.decode_frame(((ours[:1500] + 1) // 2).astype(
            np.int8))
        assert tow == sky.frame_t0
        assert got["sqrtA"] == pytest.approx(eph["sqrtA"], abs=2 ** -19)


def _port_svs(sky):
    from cusdr_tpu_torch.io.synth import SynthSV
    return [SynthSV(prn=sv.prn, code_phase=sv.code_phase,
                    doppler_hz=sv.doppler_hz, doppler_rate=sv.doppler_rate,
                    cn0_dbhz=sv.cn0_dbhz, carrier_phase=sv.carrier_phase,
                    nav_bits=sv.nav_bits) for sv in sky.svs]


@pytest.mark.parametrize("geometric, n0", [(True, 0), (False, 37_000_000)])
def test_synthesizer_is_synthesize_if(geometric, n0):
    """Noiseless, the card synthesizer (run on the CPU) is the program's
    synthesize_if at 2.048 Msps: over a geometric sky with LNAV bits and a
    Doppler rate from sample 0, and over a snapshot sky far into a record
    (the program's model started there), each across a chunk boundary."""
    from cusdr_tpu_torch import get_config
    from cusdr_tpu_torch.io import synth as psynth
    from cusdr_tpu_torch.signals.defs import get_signal
    fs = 2.048e6
    cfg = get_config("gps_l1ca", sampling_freq=fs)
    sky = (scenario.gps_sky(11, fs=fs, n_svs=4, duration_s=30.0,
                            cn0_dbhz=60.0, nav_frames=3) if geometric
           else scenario.snapshot_sky(11, 0, samples_per_code=2048,
                                      prns=range(1, 33), n_svs=4,
                                      cn0_dbhz=60.0, seconds=20.0,
                                      nav_symbol_ms=20.0,
                                      doppler_hz=4500.0))
    n = 6_000
    ours = [(i, q) for _, i, q in record_chunks(
        signal_of(CFG), sky.svs, fs, cfg.if_freq, n0, n, "cpu",
        chunk=4_096)]
    i = torch.cat([x[0] for x in ours]).numpy()
    q = torch.cat([x[1] for x in ours]).numpy()
    svs = _port_svs(sky)
    for sv in svs:
        sv.code_phase -= n0
        sv.carrier_phase += 2 * np.pi * (cfg.if_freq + sv.doppler_hz) \
            * n0 / fs
    # synthesize_if's noise_std also scales the SVs' amplitudes: take its
    # noise off by a run with no SVs on the same seed
    want = psynth.synthesize_if(cfg, get_signal("gps_l1ca"), svs,
                                num_ms=3, seed=3)
    noise = psynth.synthesize_if(cfg, get_signal("gps_l1ca"), [],
                                 num_ms=3, seed=3)
    ref = (want - noise)[:n]
    np.testing.assert_allclose(i, ref.real, atol=2e-4)
    np.testing.assert_allclose(q, ref.imag, atol=2e-4)


def test_same_seed_same_record():
    sig = signal_of(CFG)
    sky = scenario.snapshot_sky(9, 0, samples_per_code=2048,
                                prns=range(1, 33), n_svs=4, cn0_dbhz=45.0,
                                seconds=0.01, nav_symbol_ms=20.0,
                                doppler_hz=4500.0)
    a = make_record(sig, sky.svs, 2.048e6, 20e3, 20_000, 2 ** 40 + 1,
                    "cpu")
    b = make_record(sig, sky.svs, 2.048e6, 20e3, 20_000, 2 ** 40 + 1,
                    "cpu")
    c = make_record(sig, sky.svs, 2.048e6, 20e3, 20_000, 2 ** 40 + 2,
                    "cpu")
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert a.dtype == np.int8 and len(a) == 40_000


def test_every_seed_the_same_work():
    for seed in (0, 2 ** 31 + 5, 7 * 10 ** 9):
        sky = scenario.gps_sky(seed, fs=2.048e6, n_svs=8, duration_s=60.0,
                               cn0_dbhz=46.0, nav_frames=4)
        assert len(sky.svs) == 8
        assert len({sv.prn for sv in sky.svs}) == 8
        snap = scenario.snapshot_sky(seed, 3, samples_per_code=18_000,
                                     prns=range(1, 33), n_svs=12,
                                     cn0_dbhz=45.0, seconds=4.0,
                                     nav_symbol_ms=20.0, doppler_hz=4500.0)
        assert len({sv.prn for sv in snap.svs}) == 12


def test_pilot_synthesizer_is_synthesize_if():
    """Noiseless, E5a data (CS20, F/NAV symbols) on I and pilot (CS100)
    on Q as synthesize_if makes them, at 12.288 Msps over a geometric
    sky, across a chunk boundary."""
    from cusdr_tpu_torch import get_config
    from cusdr_tpu_torch.io import synth as psynth
    from cusdr_tpu_torch.signals.defs import get_signal
    fs = 12.288e6
    cfg = get_config("gal_e5a", sampling_freq=fs)
    sky = scenario.galileo_sky(4, fs=fs, n_svs=3, duration_s=1.0,
                               cn0_dbhz=60.0, prns=range(1, 37),
                               nav_pages=10)
    n = 30_000
    ours = list(record_chunks(signal_of(E5A), sky.svs, fs, cfg.if_freq, 0,
                              n, "cpu", chunk=16_384))
    i = torch.cat([x[1] for x in ours]).numpy()
    q = torch.cat([x[2] for x in ours]).numpy()
    want = psynth.synthesize_if(cfg, get_signal("gal_e5a"), _port_svs(sky),
                                num_ms=3, seed=3)
    noise = psynth.synthesize_if(cfg, get_signal("gal_e5a"), [], num_ms=3,
                                 seed=3)
    ref = (want - noise)[:n]
    np.testing.assert_allclose(i, ref.real, atol=2e-4)
    np.testing.assert_allclose(q, ref.imag, atol=2e-4)
