"""chip_smoke.py's card synthesizer (phase 20's scene) on the CPU against
the signal model it evaluates, ``io/synth.synthesize_if``.

Phase 20 cannot make its 60 s, 18 Msps record with the numpy synthesizer in
its time, so ``chip_smoke.card_if`` evaluates the same model with torch on
the card, in chunks, and ``card_quantize`` rounds it to int8.  Here both run
on ``"cpu"`` over 20 ms of phase 20's own SVs (``chip_smoke.full_scene``),
noise set aside: synthesize_if's noise, drawn again from its seed as it
draws it, is taken off its output, and ``card_if`` draws none at the same
amplitudes.  Two windows: from sample 0, and from a start offset past
sample 1.08e9 (past 2^31 interleaved elements) with a chunk boundary inside
the window.  synthesize_if always starts at sample 0, so the second window's
reference is synthesize_if of the same SVs moved to that offset: at time
t0 an SV of Doppler d, rate r and phase phi is one of Doppler d + r t0,
carrier phase phi + 2 pi (f_IF + d) t0 + pi r t0^2, and a code phase that
puts its chip count at the offset where the original's is.

Tolerances.  Both sum each SV's f64 product, rounded to f32, in SV order;
the reference starts from its noise, so its sum rounds at a larger
magnitude.  Each of the n_svs + 1 additions rounds by at most half an f32
ulp of the largest magnitude, and taking the noise off adds one more
rounding: |card - (reference - noise)| <= (n_svs + 2) ulp(max|reference|).
The int8 samples are equal, except by 1 LSB where both sums lie within that
tolerance of a rounding boundary (k + 1/2).
"""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from cusdr_tpu_torch.io.synth import quantize_iq_int8, synthesize_if
from cusdr_tpu_torch.signals.defs import get_signal

ROOT = Path(__file__).resolve().parents[1]
WINDOW_MS = 20
SEED = 7
NOISE_STD = 4.0
# a start past sample 1.08e9, off any round number
FAR_START = 1_080_000_000 + 123_457


@pytest.fixture(scope="module")
def smoke():
    """chip_smoke.py as a module (its jax block runs only as a script)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_card_scene", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def scene(smoke):
    cfg, scn = smoke.full_scene()
    return cfg, get_signal("gps_l1ca"), scn.svs


def _moved(cfg, sig, sv, n0):
    """``sv`` as seen from sample ``n0`` on: the same signal at sample
    n0 + m as ``sv`` gives at sample m."""
    fs = cfg.sampling_freq
    t0 = n0 / fs
    code_freq = sig.chip_rate_hz * (1.0 + sv.doppler_hz / sig.carrier_freq_hz)
    k = 0.5 * sig.chip_rate_hz * sv.doppler_rate / sig.carrier_freq_hz
    chips_at_n0 = (n0 - sv.code_phase) * (code_freq / fs) + k * t0 * t0
    doppler = sv.doppler_hz + sv.doppler_rate * t0
    code_freq_n0 = sig.chip_rate_hz * (1.0 + doppler / sig.carrier_freq_hz)
    phase = (sv.carrier_phase
             + 2 * np.pi * (cfg.if_freq + sv.doppler_hz) * t0
             + np.pi * sv.doppler_rate * t0 * t0)
    return dataclasses.replace(
        sv, code_phase=-chips_at_n0 * fs / code_freq_n0, doppler_hz=doppler,
        carrier_phase=float(np.mod(phase, 2 * np.pi)))


def _reference(cfg, sig, svs, n):
    """synthesize_if's first ``n`` samples of ``svs`` less its noise,
    complex128."""
    got = synthesize_if(cfg, sig, svs, num_ms=WINDOW_MS, noise_std=NOISE_STD,
                        seed=SEED)
    assert len(got) == n
    # synthesize_if's draws for one chunk: the real parts, then the
    # imaginary ones (20 ms lies inside its first 200 ms chunk)
    rng = np.random.default_rng(SEED)
    noise = ((rng.standard_normal(n) + 1j * rng.standard_normal(n))
             * NOISE_STD).astype(np.complex64)
    return got, got.astype(np.complex128) - noise


@pytest.mark.parametrize("where", ["sample_0", "past_2_31"])
def test_card_synthesizer_is_synthesize_if(smoke, scene, where):
    cfg, sig, svs = scene
    n = int(round(WINDOW_MS * cfg.sampling_freq * 1e-3))
    n0 = 0 if where == "sample_0" else FAR_START
    # past 2^31: a chunk boundary inside the window
    chunk = n if where == "sample_0" else n // 2 + 1001
    chunks = list(smoke.card_if(cfg, sig, svs, n0, n, "cpu",
                                noise_std=NOISE_STD, chunk=chunk))
    assert [a for a, _, _ in chunks] == list(range(n0, n0 + n, chunk))
    card = (torch.cat([i for _, i, _ in chunks]).numpy().astype(np.float64)
            + 1j * torch.cat([q for _, _, q in chunks]).numpy())
    ref_svs = svs if n0 == 0 else [_moved(cfg, sig, sv, n0) for sv in svs]
    noisy, clean = _reference(cfg, sig, ref_svs, n)
    assert np.abs(clean).max() > 1.0           # the SVs are there
    tol = (len(svs) + 2) * float(np.spacing(np.float32(np.abs(noisy).max())))
    err = np.abs(card - clean)
    assert err.max() <= tol, (err.max(), tol)

    got = torch.cat([smoke.card_quantize(i, q) for _, i, q in chunks])
    want = quantize_iq_int8(clean.astype(np.complex64))
    assert got.dtype == torch.int8 and got.shape == want.shape
    got = got.numpy()
    differ = np.flatnonzero(got != want)
    if len(differ):
        parts = np.empty(2 * n)
        parts[0::2], parts[1::2] = clean.real, clean.imag
        near = np.abs(np.abs(parts[differ] - np.floor(parts[differ]))
                      - 0.5) <= tol
        assert near.all() and (np.abs(got[differ].astype(int)
                                      - want[differ]) == 1).all()
    assert len(differ) <= 1e-4 * got.size


def test_card_record_draws_the_noise_it_is_given(smoke, scene):
    """``card_record`` on the CPU: interleaved int8 of the length asked,
    noise of std ``noise_std`` per component, the same record from the
    same seed."""
    cfg, sig, svs = scene
    rec = smoke.card_record(cfg, sig, svs[:2], 2, SEED, device="cpu")
    assert rec.dtype == np.int8 and len(rec) == 2 * 36_000
    assert 3.8 < rec.astype(np.float64).std() < 4.2
    assert np.array_equal(
        rec, smoke.card_record(cfg, sig, svs[:2], 2, SEED, device="cpu"))
