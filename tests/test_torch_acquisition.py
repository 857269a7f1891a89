"""Parity of the ported PCPS acquisition with the JAX reference on
synthetic scenes: the same detected PRNs, the exact code phase, the same
carrier (the coarse and fine searches pick grid points; measured equal on
every detected PRN of these scenes), the same coarse bins.  Peak metrics
agree to 1e-5 relative: measured within 3.6e-7 on an x86 CPU, the f32 FFT
and summation order of XLA against PyTorch's.

Three fine-stage modes: gps_l1ca (nav-bit-edge windows), bds_b1i (NH20
data secondary) and gal_e1c (two jointly weighted components, CS25 pilot
secondary), and the FDMA search of glo_l1 (one shared code, a carrier grid
per frequency channel), at the reduced rates of the reference's own tests.
The three coarse kernels the CDMA scenes do not reach, the FDMA search,
the circular-shift search (in batches of shifts) and the long-pilot period
search, are held to the reference's on small random inputs.

The conjugate code spectra, cached on the device per signal, PRN list and
rate: bit for bit the spectra the per-call loop built, the same results
from the cache as after a clear, never written by a search, and a new
entry for another PRN list or a resampled rate."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from cusdr_tpu import get_config
from cusdr_tpu.acquisition import acquire as j_acquire
from cusdr_tpu.acquisition import pcps as jpcps
from cusdr_tpu.io.synth import SynthSV, quantize_iq_int8, synthesize_if
from cusdr_tpu.signals.defs import get_signal
from cusdr_tpu_torch import get_config as t_get_config
from cusdr_tpu_torch.acquisition import pcps as tpcps
from cusdr_tpu_torch.acquisition.pcps import acquire as t_acquire
from cusdr_tpu_torch.acquisition.resample import maybe_resample
from cusdr_tpu_torch.ops.correlator import LAUNCHES as t_LAUNCHES
from cusdr_tpu_torch.signals.defs import REGISTRY as T_REGISTRY
from cusdr_tpu_torch.signals.defs import get_signal as t_get_signal
from cusdr_tpu_torch.signals.defs import sample_code as t_sample_code
from cusdr_tpu_torch.tracking.engine import make_track_params

from test_torch_threads import few_torch_threads  # noqa: F401 (autouse)

SCENES = {
    "gps_l1ca": (dict(sampling_freq=2.048e6, if_freq=7000.0,
                      acq_satellite_list=tuple(range(1, 33))),
                 [SynthSV(prn=3, code_phase=101.0, doppler_hz=2750.0,
                          cn0_dbhz=47),
                  SynthSV(prn=11, code_phase=1500.0, doppler_hz=-3300.0,
                          cn0_dbhz=45),
                  SynthSV(prn=19, code_phase=777.0, doppler_hz=400.0,
                          cn0_dbhz=44),
                  SynthSV(prn=27, code_phase=2000.0, doppler_hz=-150.0,
                          cn0_dbhz=49)], 80),
    "bds_b1i": (dict(sampling_freq=4.096e6, if_freq=7000.0,
                     acq_satellite_list=tuple(range(6, 38)),
                     acq_search_step=250.0, acq_non_coh_time=8),
                [SynthSV(prn=9, code_phase=3000.0, doppler_hz=-1800.0,
                         cn0_dbhz=47),
                 SynthSV(prn=21, code_phase=512.0, doppler_hz=2600.0,
                         cn0_dbhz=48)], 70),
    "gal_e1c": (dict(sampling_freq=4.096e6, if_freq=7000.0,
                     acq_satellite_list=(2, 4, 6), acq_search_band=2000.0,
                     acq_search_step=125.0, acq_non_coh_time=2,
                     acq_threshold=2.5),
                [SynthSV(prn=4, code_phase=2233.0, doppler_hz=800.0,
                         cn0_dbhz=48)], 120),
    "glo_l1": (dict(sampling_freq=4.096e6, if_freq=7000.0,
                    acq_satellite_list=tuple(range(-3, 4)),
                    acq_search_band=2000.0, acq_search_step=250.0,
                    acq_non_coh_time=8),
               [SynthSV(prn=2, fdma_channel=2, code_phase=1600.0,
                        doppler_hz=-700.0, cn0_dbhz=48),
                SynthSV(prn=-1, fdma_channel=-1, code_phase=700.0,
                        doppler_hz=450.0, cn0_dbhz=47)], 80),
}


@pytest.fixture(scope="module", params=sorted(SCENES))
def both(request):
    name = request.param
    over, svs, num_ms = SCENES[name]
    cfg = get_config(name, **over)
    sig = get_signal(name)
    iq = quantize_iq_int8(synthesize_if(cfg, sig, svs, num_ms=num_ms,
                                        seed=3))
    x = iq[0::2].astype(np.float32) + 1j * iq[1::2].astype(np.float32)
    ref = j_acquire(cfg, sig, x)
    port = t_acquire(t_get_config(name, **over), t_get_signal(name), x,
                     "cpu")
    return cfg, svs, ref, port


def test_same_detections_as_reference(both):
    cfg, svs, ref, port = both
    assert np.array_equal(port.prns, ref.prns)
    assert np.array_equal(port.detected, ref.detected)
    assert {sv.prn for sv in svs} <= set(port.prns[port.detected].tolist())
    assert np.allclose(port.peak_metric, ref.peak_metric, rtol=1e-5)


def test_code_phase_exact_and_carrier_within_a_fine_step(both):
    cfg, svs, ref, port = both
    det = ref.detected
    assert np.array_equal(port.code_phase[det], ref.code_phase[det])
    assert np.array_equal(port.carr_freq[det], ref.carr_freq[det])
    assert np.array_equal(port.coarse_freq, ref.coarse_freq)


def test_best_channels_match_reference_and_truth(both):
    cfg, svs, ref, port = both
    assert [c[0] for c in port.best_channels(12)] == \
        [c[0] for c in ref.best_channels(12)]
    chans = {c[0]: c for c in port.best_channels(12)}
    sig = t_get_signal(cfg.signal)
    for sv in svs:
        _, carr, cp, _ = chans[sv.prn]
        assert abs(cp - sv.code_phase) <= 1
        # an FDMA channel's carrier sits its channel's offset off the IF
        offset = sig.fdma_spacing_hz * sv.fdma_channel if sig.fdma else 0.0
        assert abs(carr - (cfg.if_freq + offset + sv.doppler_hz)) <= \
            2 * cfg.fine_search_step


def test_unported_modes_raise():
    # nothing on the receiver's path is left unported: a correlator
    # spacing under half a sample, which raised here until the per-epoch
    # gather path was ported, now selects that path as the reference does,
    # with the reference's warning, and no longer raises
    from cusdr_tpu.tracking.engine import make_track_params as j_params
    over = dict(sampling_freq=2.048e6, dll_correlator_spacing=0.1)
    with pytest.warns(UserWarning, match="per-epoch gather path"):
        got = make_track_params(t_get_config("gps_l1ca", **over),
                                t_get_signal("gps_l1ca"))
    with pytest.warns(UserWarning, match="per-epoch gather path"):
        want = j_params(get_config("gps_l1ca", **over),
                        get_signal("gps_l1ca"))
    assert got.fast_code is want.fast_code is False
    assert (got.spacing, got.elements_per_chip) == (0.1, 1)


def _random_search(seed, n_prn, n_comp, noncoh=2, nfft=512):
    """Random slabs and conjugate code spectra, as (real, imag) pairs for
    the reference and complex64 tensors for the port."""
    rng = np.random.default_rng(seed)

    def pair(*shape):
        return (rng.normal(size=shape).astype(np.float32),
                rng.normal(size=shape).astype(np.float32))

    slabs, codes = pair(noncoh, nfft), pair(n_prn, n_comp, nfft)
    weights = rng.uniform(0.3, 1.0, n_comp).astype(np.float32)
    return ((tuple(map(jnp.asarray, slabs)), tuple(map(jnp.asarray, codes)),
             jnp.asarray(weights)),
            (torch.complex(*map(torch.from_numpy, slabs)),
             torch.complex(*map(torch.from_numpy, codes)),
             torch.from_numpy(weights)))


def _assert_search_equal(ref, got, index_fields):
    """Index outputs equal, values to f32 FFT rounding."""
    for i, (a, b) in enumerate(zip(ref, got)):
        a, b = np.asarray(a), b.numpy()
        if i in index_fields:
            assert np.array_equal(a, b), i
        else:
            assert np.allclose(a, b, rtol=1e-5, atol=0), i


TS = np.float32(1.0 / 2.048e6)


def test_fdma_kernel_matches_reference():
    (js, jc, jw), (ts_, tc, tw) = _random_search(1, 1, 1, noncoh=3)
    freqs = (7000.0 + np.arange(-2, 3)[:, None] * 562.5e3
             + 250.0 * np.arange(5)[None, :]).astype(np.float32)
    kw = dict(n_noncoh=3, n_comp=1, search_len=300, excl_samples=3,
              period=150)
    ref = jpcps._pcps_fdma_kernel(js, jc, jw, jnp.asarray(freqs), TS, **kw)
    got = tpcps._pcps_fdma_kernel(ts_, tc, tw, torch.from_numpy(freqs), TS,
                                  **kw)
    _assert_search_equal(ref, got, index_fields=(1, 2))


@pytest.mark.parametrize("batch", [None, 1, 4, 50])
def test_circshift_kernel_matches_reference(batch):
    """23 shifts of 2 sub-bins for 3 PRNs of 2 components, in batches of
    ``batch`` shifts (None: the device's default, here one batch): the
    same shift, sub-bin and phase as the reference's scan, the peak, second
    peak and floor to f32 rounding."""
    (js, jc, jw), (ts_, tc, tw) = _random_search(2, 3, 2)
    subs = np.asarray([7000.0, 6990.0], np.float32)
    kw = dict(n_shift=23, n_comp=2, search_len=300, excl_samples=3,
              period=150)
    ref = jpcps._pcps_circshift_kernel(js, jc, jw, jnp.asarray(subs), TS,
                                       **kw)
    got = tpcps._pcps_circshift_kernel(ts_, tc, tw, torch.from_numpy(subs),
                                       TS, batch=batch, **kw)
    _assert_search_equal(ref, got, index_fields=(1, 2, 3))


def test_circshift_kernel_keeps_the_first_of_equal_peaks():
    """A spectrum periodic in the bin index makes several shifts give the
    same peak, to the bit: the first of them is kept, as the reference's
    scan keeps it (a later shift replaces the best only when strictly
    larger), whatever the batching."""
    rng = np.random.default_rng(3)
    nfft, period = 256, 8
    tile = (rng.normal(size=period) + 1j * rng.normal(size=period))
    sig = np.fft.ifft(np.tile(tile, nfft // period)).astype(np.complex64)
    code = np.conj(np.fft.fft(rng.normal(size=nfft))).astype(np.complex64)
    slabs = torch.from_numpy(sig[None, :])
    codes = torch.from_numpy(code[None, None, :])
    w = torch.ones(1)
    subs = torch.zeros(1)
    outs = [tpcps._pcps_circshift_kernel(
        slabs, codes, w, subs, TS, n_shift=3 * period, n_comp=1,
        search_len=100, batch=b) for b in (1, 5, None)]
    ref = jpcps._pcps_circshift_kernel(
        (jnp.asarray(sig.real[None]), jnp.asarray(sig.imag[None])),
        (jnp.asarray(code.real[None, None]), jnp.asarray(code.imag[None,
                                                                   None])),
        jnp.ones(1, jnp.float32), jnp.zeros(1, jnp.float32), TS,
        n_shift=3 * period, n_comp=1,
        search_len=100)
    for got in outs:
        assert int(got[1][0]) == int(np.asarray(ref[1])[0]) < period
        assert int(got[3][0]) == int(np.asarray(ref[3])[0])


def test_pilot_phase_kernel_matches_reference():
    """Three detected PRNs, 10 period hypotheses of 200 samples each: the
    same hypothesis as the reference's."""
    rng = np.random.default_rng(4)
    n_det, n_hyp, spc = 3, 10, 200
    sig_r = rng.normal(size=4000).astype(np.float32)
    sig_i = rng.normal(size=4000).astype(np.float32)
    reps = rng.choice(np.array([-1, 1], np.int8), (n_det, n_hyp, spc))
    truth = [3, 7, 0]
    cps = [100, 1500, 3000]
    for j, (cp, h) in enumerate(zip(cps, truth)):
        sig_r[cp:cp + spc] += 0.5 * reps[j, h]
    freqs = np.asarray([20.0, -35.0, 0.0], np.float32)
    ref = jpcps._pilot_phase_kernel(
        jnp.asarray(sig_r), jnp.asarray(sig_i), jnp.asarray(cps),
        jnp.asarray(freqs), jnp.asarray(reps), TS)
    got = tpcps._pilot_phase_kernel(
        torch.from_numpy(sig_r), torch.from_numpy(sig_i), cps,
        torch.from_numpy(freqs), torch.from_numpy(reps), TS)
    assert got.tolist() == np.asarray(ref).tolist() == truth


# ---- the fine stage on code tables (fine_search) ---------------------------

def _fine_n_codes(cfg, sig):
    return cfg.fine_n_codes or max(
        int(round(40.0 / max(sig.code_period_ms, 1e-9))), 4)


def _assert_table_replica_is_sample_codes(cfg, sig, n_codes):
    k = int(cfg.acq_satellite_list[0])
    code_fn, _ = tpcps.fine_setup(sig, k, n_codes)
    prn = 0 if sig.fdma else k
    offset = 0.0
    if sig.pilot_phase_hypotheses > 1 and code_fn is sig.pilot_code:
        offset = float(37 * sig.code_length_chips)     # a long-pilot period
    n = n_codes * cfg.samples_per_code
    want = t_sample_code(code_fn(prn), sig.elements_per_chip,
                         sig.chip_rate_hz, cfg.sampling_freq, n,
                         code_phase_chips=offset)
    table = tpcps._fine_table(code_fn, prn, "cpu")
    got = tpcps.table_replica(table, len(table), offset,
                              epc=sig.elements_per_chip,
                              ratio=sig.chip_rate_hz / cfg.sampling_freq,
                              n_samples=n)
    assert got.dtype == torch.int8
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", sorted(T_REGISTRY))
def test_table_replica_is_sample_codes(name):
    """Every preset's fine set-up at its own rate and fine length, on
    ``fine_setup``'s code for its first PRN (GLONASS: the FDMA channel's
    shared code(0); gal_e1c: the BOC pilot table at 2 elements a chip;
    gps_l2c: the CL pilot 37 periods in): the replica drawn from the
    device table equals ``sample_code``'s element for element over the
    whole fine segment."""
    cfg, sig = t_get_config(name), t_get_signal(name)
    _assert_table_replica_is_sample_codes(cfg, sig, _fine_n_codes(cfg, sig))


def test_table_replica_at_a_resampled_rate():
    """gps_l1ca decimated by the bandpass resampler (18 to 2.586 Msps):
    the same element for element."""
    cfg = t_get_config("gps_l1ca", resampling_flag=True)
    _, cfg, info = maybe_resample(np.zeros(40_000, np.complex64), cfg)
    assert info.enabled and cfg.sampling_freq == 2.586e6
    sig = t_get_signal("gps_l1ca")
    _assert_table_replica_is_sample_codes(cfg, sig, _fine_n_codes(cfg, sig))


# (preset, overrides, fine code periods, fine bins, PRNs): bit-edge windows,
# the CS100 pilot secondary, the CL pilot at long-pilot offsets, envelope
FINE_CASES = {
    "gps_l1ca": (dict(sampling_freq=2.048e6, if_freq=7000.0), 40, 21,
                 (3, 11, 27)),
    "gal_e5a": (dict(sampling_freq=12e6, if_freq=7000.0), 10, 21,
                (5, 19, 30)),
    "gps_l2c": (dict(sampling_freq=2.048e6, if_freq=7000.0), 2, 3,
                (7, 9)),
    "bds_b1c": (dict(sampling_freq=4.096e6, if_freq=7000.0), 4, 3,
                (20, 33)),
}


@pytest.mark.parametrize("name", sorted(FINE_CASES))
def test_table_fine_search_equals_the_replica_fine_kernel(name):
    """On one random segment holding each PRN's replica on its own carrier
    bin, the table-based plain search (``fine_search`` on CPU tensors, no
    launch) and the hypotheses after it give the powers of the JAX
    package's ``_fine_kernel`` on the host-sampled replica to 1e-6 of the
    largest, and the same bin: the same f32 operations, but XLA's cos/sin
    and sums against PyTorch's."""
    over, n_codes, n_fine, prns = FINE_CASES[name]
    cfg, sig = t_get_config(name, **over), t_get_signal(name)
    fs, spc = cfg.sampling_freq, cfg.samples_per_code
    ts = np.float32(1.0 / fs)
    n_seg = n_codes * spc
    rng = np.random.default_rng(len(name))
    x = (rng.normal(size=(n_codes + 3) * spc)
         + 1j * rng.normal(size=(n_codes + 3) * spc))
    cps = [int(c) for c in rng.integers(0, 3 * spc, len(prns))]
    freqs = (cfg.if_freq + 40.0 * rng.normal(size=(len(prns), 1))
             - 25.0 * np.arange(n_fine)[None, :]).astype(np.float32)
    truth = rng.integers(0, n_fine, len(prns))
    rows, offsets, reps, hyps = [], [], [], []
    for j, prn in enumerate(prns):
        code_fn, H = tpcps.fine_setup(sig, prn, n_codes)
        offset = (float((12 + j) * sig.code_length_chips)
                  if sig.pilot_phase_hypotheses > 1 else 0.0)
        rep = t_sample_code(code_fn(prn), sig.elements_per_chip,
                            sig.chip_rate_hz, fs, n_seg,
                            code_phase_chips=offset).astype(np.float32)
        # a secondary code's hypotheses are signs: the segment carries one
        signs = (H[j % len(H)] if H is not None and np.all(np.abs(H) == 1)
                 else np.ones(n_codes))
        t = np.arange(n_seg) / fs
        x[cps[j]:cps[j] + n_seg] += 0.5 * rep * np.repeat(signs, spc) * np.exp(
            2j * np.pi * freqs[j, truth[j]] * t)
        rows.append(tpcps._fine_table(code_fn, prn, "cpu"))
        offsets.append(offset)
        reps.append(rep)
        hyps.append(np.ones((1, n_codes), np.float32) if H is None else H)
    envelope = name == "bds_b1c"
    sig_r = torch.from_numpy(x.real.astype(np.float32))
    sig_i = torch.from_numpy(x.imag.astype(np.float32))
    hyp = torch.from_numpy(np.stack(hyps))
    before = dict(t_LAUNCHES)
    sr, si = tpcps.fine_search(
        sig_r, sig_i, cps, torch.nn.utils.rnn.pad_sequence(
            rows, batch_first=True), [len(r) for r in rows], offsets,
        float(2.0 * np.pi * ts) * torch.from_numpy(freqs),
        epc=sig.elements_per_chip, ratio=sig.chip_rate_hz / fs,
        n_codes=n_codes, spc=spc)
    assert t_LAUNCHES == before                   # no kernel on the CPU
    assert sr.shape == si.shape == (len(prns), n_fine, n_codes)
    got = tpcps._fine_powers(sr, si, hyp, envelope).numpy()
    want = np.stack([np.asarray(jpcps._fine_kernel(
        jnp.asarray(x.real[cp:cp + n_seg], jnp.float32),
        jnp.asarray(x.imag[cp:cp + n_seg], jnp.float32), jnp.asarray(rep),
        jnp.asarray(f), jnp.asarray(hyps[j]), ts, envelope=envelope))
        for j, (cp, rep, f) in enumerate(zip(cps, reps, freqs))])
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    assert got.argmax(axis=1).tolist() == want.argmax(axis=1).tolist() \
        == truth.tolist()


def test_fine_search_refuses_what_it_cannot_take():
    """dtype, device, a table shorter than its code, a segment past the
    record, rows that disagree in number; the plain version refuses the
    same.  (The kernel's own limit, a segment past its f32 sample index,
    is held in the card tests.)"""
    sig = torch.zeros(1000)
    tables = torch.ones((2, 50), dtype=torch.int8)
    omega = torch.zeros((2, 3))
    good = dict(sig_r=sig, sig_i=sig, cps=[0, 500], tables=tables,
                lengths=[50, 40], offsets=[0.0, 0.0], omega=omega)
    kw = dict(epc=1, ratio=0.5, n_codes=4, spc=100)
    assert tpcps.fine_search(**good, **kw)[0].shape == (2, 3, 4)
    bad = [dict(sig_r=sig.double()), dict(tables=tables.float()),
           dict(omega=omega.double()), dict(omega=omega.to("meta")),
           dict(lengths=[50, 51]), dict(lengths=[0, 10]),
           dict(cps=[0, 601]), dict(cps=[-1, 0]), dict(offsets=[0.0]),
           dict(sig_i=torch.zeros(999))]
    for b in bad:
        for fn in (tpcps.fine_search, tpcps.fine_search_plain):
            with pytest.raises(ValueError):
                fn(**dict(good, **b), **kw)


# --------------------------------------------------------------------------
# The conjugate code spectra, cached on the device per signal, PRNs and rate
# --------------------------------------------------------------------------

def _acq_shape(cfg, sig):
    """(fs, samples per code, coherent periods, FFT length) as ``acquire``
    forms them."""
    spc = cfg.samples_per_code
    n_coh = max(1, int(round(cfg.acq_coh_time
                             / max(sig.code_period_ms, 1e-9))))
    return (cfg.sampling_freq, spc, n_coh,
            1 << (n_coh * spc + spc - 1).bit_length())


def _spectra_as_built_per_call(cfg, sig, prns):
    """The spectra as ``acquire`` built them on every call before they were
    cached: the same numpy calls in the same order."""
    fs, spc, n_coh, nfft = _acq_shape(cfg, sig)
    comps = sig.acq_code_fns()
    code_prns = prns[:1] if sig.fdma else prns
    cfc = np.empty((len(code_prns), len(comps), nfft), np.complex64)
    for i, prn in enumerate(code_prns):
        for c, fn in enumerate(comps):
            table = t_sample_code(fn(0 if sig.fdma else int(prn)),
                                  sig.elements_per_chip, sig.chip_rate_hz,
                                  fs, spc)
            padded = np.zeros(nfft, np.float32)
            padded[:n_coh * spc] = np.tile(table.astype(np.float32), n_coh)
            cfc[i, c] = np.conj(np.fft.fft(padded))
    return cfc


# the benchmark's two configurations at their rates, an FDMA preset, and the
# circular-shift search's preset at a reduced rate
SPECTRA_CASES = {"gps_l1ca": {}, "gal_e5a": {}, "glo_l1": {},
                 "gps_l2c": dict(sampling_freq=2.048e6, if_freq=7000.0)}


@pytest.mark.parametrize("name", sorted(SPECTRA_CASES))
def test_cached_spectra_are_the_per_call_spectra_bit_for_bit(name):
    """The cached spectra, built and then taken from the cache, equal bit
    for bit those the per-call loop built, at the preset's PRN list."""
    cfg = t_get_config(name, **SPECTRA_CASES[name])
    sig = t_get_signal(name)
    prns = np.asarray(cfg.acq_satellite_list)
    want = _spectra_as_built_per_call(cfg, sig, prns)
    tpcps._code_spectra.cache_clear()
    for hit_expected in (False, True):
        got, hit = tpcps.code_spectra(sig, prns, *_acq_shape(cfg, sig),
                                      "cpu")
        assert hit is hit_expected
        assert got.dtype == torch.complex64 and got.shape == want.shape
        assert np.array_equal(got.numpy().view(np.uint64),
                              want.view(np.uint64))
    tpcps._code_spectra.cache_clear()


CACHE_OVER = dict(sampling_freq=2.048e6, if_freq=7000.0,
                  acq_satellite_list=(3, 7, 11, 19, 24, 27))


@pytest.fixture(scope="module")
def two_records():
    """Two 80 ms gps_l1ca records at 2.048 Msps with different SVs, as
    ``acquire`` takes them."""
    cfg = t_get_config("gps_l1ca", **CACHE_OVER)
    out = []
    for seed, svs in ((4, [SynthSV(prn=3, code_phase=101.0, doppler_hz=2750.0,
                                   cn0_dbhz=47),
                           SynthSV(prn=19, code_phase=777.0,
                                   doppler_hz=400.0, cn0_dbhz=46)]),
                      (5, [SynthSV(prn=11, code_phase=1500.0,
                                   doppler_hz=-3300.0, cn0_dbhz=47),
                           SynthSV(prn=27, code_phase=2000.0,
                                   doppler_hz=-150.0, cn0_dbhz=48)])):
        iq = quantize_iq_int8(synthesize_if(
            get_config("gps_l1ca", **CACHE_OVER), get_signal("gps_l1ca"),
            svs, num_ms=80, seed=seed))
        out.append(iq[0::2].astype(np.float32)
                   + 1j * iq[1::2].astype(np.float32))
    return cfg, out


ACQ_FIELDS = ("prns", "detected", "code_phase", "carr_freq", "coarse_freq",
              "peak_metric", "pilot_phase")


def test_acquire_from_the_cache_equals_acquire_after_a_clear(two_records):
    """Each of two records acquired after the other (its spectra from the
    cache) gives the detections, code phases, carriers and metrics it
    gives as the first call after the cache is cleared (spectra built)."""
    cfg, recs = two_records
    sig = t_get_signal("gps_l1ca")
    tpcps._code_spectra.cache_clear()
    first = [t_acquire(cfg, sig, x, "cpu") for x in recs]
    tpcps._code_spectra.cache_clear()
    second = [t_acquire(cfg, sig, x, "cpu") for x in recs[::-1]][::-1]
    info = tpcps._code_spectra.cache_info()
    assert (info.hits, info.misses) == (1, 1)
    for a, b in zip(first, second):
        assert a.detected.sum() >= 2
        for name in ACQ_FIELDS:
            assert np.array_equal(getattr(a, name), getattr(b, name)), name


def test_acquire_leaves_the_cached_spectra_unwritten(two_records):
    """The entry ``acquire`` made is the one ``code_spectra`` returns for
    the same key, and a second ``acquire``, which reads it, leaves its
    version counter where it was."""
    cfg, recs = two_records
    sig = t_get_signal("gps_l1ca")
    prns = np.asarray(cfg.acq_satellite_list)
    tpcps._code_spectra.cache_clear()
    t_acquire(cfg, sig, recs[0], "cpu")
    cfc, hit = tpcps.code_spectra(sig, prns, *_acq_shape(cfg, sig), "cpu")
    assert hit
    version = cfc._version
    t_acquire(cfg, sig, recs[1], "cpu")
    info = tpcps._code_spectra.cache_info()
    assert (info.hits, info.misses, info.currsize) == (2, 1, 1)
    again, _ = tpcps.code_spectra(sig, prns, *_acq_shape(cfg, sig), "cpu")
    assert again is cfc and cfc._version == version


def test_another_prn_list_or_a_resampled_rate_is_a_new_entry():
    """Another PRN list misses, the first one again hits; ``acquire`` on a
    record the bandpass resampler decimates (gps_l1ca at 18 Msps to 2.586
    Msps) keys its entry on the resampled rate: a miss, then a hit for the
    resampled shape, with spectra of its own length."""
    sig = t_get_signal("gps_l1ca")
    cfg = t_get_config("gps_l1ca", **CACHE_OVER)
    shape = _acq_shape(cfg, sig)
    tpcps._code_spectra.cache_clear()
    a, hit_a = tpcps.code_spectra(sig, [3, 7, 11], *shape, "cpu")
    b, hit_b = tpcps.code_spectra(sig, [3, 7, 12], *shape, "cpu")
    a2, hit_a2 = tpcps.code_spectra(sig, [3, 7, 11], *shape, "cpu")
    assert (hit_a, hit_b, hit_a2) == (False, False, True)
    assert a2 is a and not torch.equal(a, b)
    assert torch.equal(a[:2], b[:2])

    hi = t_get_config("gps_l1ca", resampling_flag=True)
    rng = np.random.default_rng(6)
    x = (rng.normal(size=900_000) + 1j * rng.normal(size=900_000)
         ).astype(np.complex64)
    before = tpcps._code_spectra.cache_info()
    t_acquire(hi, sig, x, "cpu", prn_list=[3, 7, 11])
    after = tpcps._code_spectra.cache_info()
    assert (after.hits, after.misses) == (before.hits, before.misses + 1)
    _, lo, _ = maybe_resample(np.zeros(40_000, np.complex64), hi)
    assert lo.sampling_freq == 2.586e6
    c, hit_c = tpcps.code_spectra(sig, [3, 7, 11], *_acq_shape(lo, sig),
                                  "cpu")
    assert hit_c and c.shape[-1] != a.shape[-1]
    tpcps._code_spectra.cache_clear()
