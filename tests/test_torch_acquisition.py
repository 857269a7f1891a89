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
search, are held to the reference's on small random inputs."""

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
from cusdr_tpu_torch.signals.defs import get_signal as t_get_signal
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
