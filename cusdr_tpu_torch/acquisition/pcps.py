"""Batched PCPS acquisition in PyTorch (CDMA, plain-data fine stage).

Counterpart of cusdr_tpu/acquisition/pcps.py, same names.  The reference
runs this stage as XLA programs (no Pallas kernel); here it is complex64
``torch.fft`` (cuFFT on a card) and plain tensor ops.  The Doppler-mixed
signal FFT is computed once and shared by all PRNs; the coarse search
loops over PRNs on the device and the host reads the per-PRN peaks once.

Covered: CDMA signals with the 'pcps' method, and the fine stage's
bit-edge, secondary-code, coherent and envelope hypothesis modes.  FDMA
(GLONASS), the circular-shift frequency search and the long-pilot phase
search raise ``NotImplementedError`` (ROADMAP.md Queue A item 9).
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ..signals.defs import SignalDef, sample_code


@dataclass
class AcquisitionResult:
    """Per-PRN acquisition outputs."""
    prns: np.ndarray           # PRN (or FDMA channel) ids searched
    carr_freq: np.ndarray      # detected carrier freq [Hz] (0 if none)
    code_phase: np.ndarray     # sample offset of code start (0-based)
    peak_metric: np.ndarray    # GLRT statistic peak/σ/N_noncoh
    detected: np.ndarray       # bool mask (metric > threshold)
    coarse_freq: np.ndarray    # coarse-stage bin freq [Hz]
    pilot_phase: np.ndarray | None = None   # long-pilot phase hypothesis

    def best_channels(self, n: int):
        """PRNs sorted by peak metric, detected first: tuples (prn,
        carr_freq, code_phase, pilot_phase)."""
        order = np.argsort(-self.peak_metric)
        order = [i for i in order if self.detected[i]][:n]
        pp = self.pilot_phase if self.pilot_phase is not None \
            else np.zeros(len(self.prns), np.int64)
        return [(int(self.prns[i]), float(self.carr_freq[i]),
                 int(self.code_phase[i]), int(pp[i])) for i in order]


# --------------------------------------------------------------------------
# Coarse stage
# --------------------------------------------------------------------------

def _mixed_fft(slabs, f_grid, ts):
    """FFT of the Doppler-mixed signal: complex64 [n_bins, n_noncoh, nfft].

    slabs: complex64 [n_noncoh, nfft]; f_grid: f32 [n_bins].  Mixing by
    e^{-jθ}: (sr + j·si)(cosθ - j·sinθ), θ in f32 as in the reference."""
    nfft = slabs.shape[-1]
    n = torch.arange(nfft, dtype=torch.float32, device=slabs.device)
    phase = (float(2.0 * np.pi * ts) * f_grid)[:, None] * n[None, :]
    c = torch.cos(phase)[:, None, :]
    sn = torch.sin(phase)[:, None, :]
    sr, si = slabs.real[None], slabs.imag[None]
    return torch.fft.fft(torch.complex(sr * c + si * sn, si * c - sr * sn),
                         dim=-1)


def _second_peak(row, peak_phase, period: int, excl_samples: int):
    """Largest value in ``row`` outside ±excl_samples of the peak,
    excluded periodically (the peak repeats every code period)."""
    lags = torch.arange(row.shape[-1], device=row.device)
    d = torch.remainder(lags - peak_phase, period)
    dist = torch.minimum(d, period - d)
    return torch.where(dist > excl_samples, row, 0.0).max()


def _corr_peak(mf, cfftc, weights, n_comp, search_len=None,
               excl_samples: int = 0, period: Optional[int] = None):
    """Envelope-summed correlation peak for one PRN.

    mf: complex [n_bins, n_noncoh, nfft]; cfftc: complex [n_comp, nfft]
    conjugate code spectra.  Returns (peak, bin, phase, second_peak,
    floor) as 0-d device tensors: the peak of the weighted envelope
    surface over the first ``search_len`` lags, its Doppler bin and lag,
    the largest value of the peak's row outside ±excl_samples of it, and
    the surface mean (the GLRT metric's noise floor)."""
    nfft = mf.shape[-1]
    search = nfft if search_len is None else search_len
    acc = torch.zeros((mf.shape[0], search), dtype=torch.float32,
                      device=mf.device)
    for c in range(n_comp):
        corr = torch.fft.ifft(mf * cfftc[c][None, None, :], dim=-1)
        acc = acc + weights[c] * corr[..., :search].abs().sum(dim=1)
    flat = acc.reshape(-1)
    k = torch.argmax(flat)
    peak_bin = k // search
    peak_phase = k % search
    spc = period if period is not None else search // 2
    second = _second_peak(acc[peak_bin], peak_phase, spc, excl_samples)
    return flat[k], peak_bin, peak_phase, second, flat.mean()


def _pcps_cdma_kernel(slabs, code_fft_conj, weights, f_grid, ts,
                      n_noncoh: int, n_comp: int, search_len: int,
                      excl_samples: int = 0,
                      period: Optional[int] = None):
    """CDMA PCPS: the mixed-signal FFT is computed once and shared by all
    PRNs.

    slabs: complex64 [n_noncoh, nfft]; code_fft_conj: complex64 [n_prn,
    n_comp, nfft]; weights: [n_comp] f32; f_grid: [n_bins] f32.
    Returns (peak, bin, phase, second, floor), each [n_prn] on the device.
    """
    if slabs.shape[0] != n_noncoh:
        raise ValueError(f"slabs hold {slabs.shape[0]} non-coherent "
                         f"blocks, expected {n_noncoh}")
    mf = _mixed_fft(slabs, f_grid, ts)
    per_prn = [_corr_peak(mf, cfftc, weights, n_comp, search_len,
                          excl_samples, period) for cfftc in code_fft_conj]
    return tuple(torch.stack(x) for x in zip(*per_prn))


# --------------------------------------------------------------------------
# Fine stage
# --------------------------------------------------------------------------

def _fine_kernel(sig_r, sig_i, code_replica, freqs, hyp, ts,
                 envelope: bool = False):
    """Fine-frequency search by long coherent integration.

    sig_r/sig_i:  [n_codes * spc] f32 I/Q starting at the code edge
    code_replica: [n_codes * spc] f32 (±1 sampled replica)
    freqs:        [n_fine] f32 candidate carrier frequencies
    hyp:          [n_hyp, n_codes] f32 coherent-combination hypotheses
                  over per-code sums (bit-edge windows, secondary-code
                  phases)
    envelope:     sum |per-code sums| instead

    Returns power [n_fine] (max over hypotheses).
    """
    n_codes = hyp.shape[1]
    spc = sig_r.shape[0] // n_codes
    n = torch.arange(sig_r.shape[0], dtype=torch.float32,
                     device=sig_r.device)
    wr = sig_r * code_replica
    wi = sig_i * code_replica
    phase = (float(2.0 * np.pi * ts) * freqs)[:, None] * n[None, :]
    c, sn = torch.cos(phase), torch.sin(phase)
    sr = (wr * c + wi * sn).reshape(-1, n_codes, spc).sum(dim=2)
    si = (wi * c - wr * sn).reshape(-1, n_codes, spc).sum(dim=2)
    if envelope:
        return torch.hypot(sr, si).sum(dim=1)
    return torch.hypot(sr @ hyp.T, si @ hyp.T).max(dim=1).values


def _fine_batched(sig_r, sig_i, cps, replicas, freqs, hyp, ts,
                  envelope: bool = False):
    """`_fine_kernel` over detected PRNs, each on its segment of the
    record starting at cps[j] (host ints).

    replicas: [n_det, n_codes*spc]; freqs: [n_det, n_fine];
    hyp: [n_det, n_hyp, n_codes].  Returns powers [n_det, n_fine]."""
    n_seg = replicas.shape[1]
    return torch.stack([
        _fine_kernel(sig_r[cp:cp + n_seg], sig_i[cp:cp + n_seg],
                     replicas[j], freqs[j], hyp[j], ts, envelope=envelope)
        for j, cp in enumerate(cps)])


def _bit_edge_hypotheses(n_codes: int, window: int) -> np.ndarray:
    """Sliding all-ones windows: nav-bit-edge search."""
    n_hyp = n_codes - window + 1
    H = np.zeros((n_hyp, n_codes), np.float32)
    for k in range(n_hyp):
        H[k, k:k + window] = 1.0
    return H


def _secondary_hypotheses(secondary: np.ndarray, n_codes: int) -> np.ndarray:
    """All circular shifts of a secondary code, tiled to n_codes."""
    m = len(secondary)
    reps = int(np.ceil(n_codes / m))
    H = np.zeros((m, n_codes), np.float32)
    for k in range(m):
        H[k] = np.tile(np.roll(secondary, k), reps)[:n_codes]
    return H


# --------------------------------------------------------------------------
# Public API
# --------------------------------------------------------------------------

def acquire(cfg, sig: SignalDef, samples: np.ndarray, device,
            prn_list: Optional[Sequence[int]] = None,
            fine_n_codes: Optional[int] = None) -> AcquisitionResult:
    """Run coarse+fine acquisition over ``prn_list`` on ``device``.

    samples: complex IF samples; needs at least
    (acq_non_coh_time + 1 + fine_n_codes) code periods.
    """
    from .resample import maybe_resample, recover
    if sig.fdma or cfg.acq_method != "pcps":
        raise NotImplementedError(
            "FDMA and circular-shift acquisition are not ported yet "
            "(ROADMAP.md Queue A item 9)")
    if sig.pilot_phase_hypotheses > 1 and sig.pilot_code is not None:
        raise NotImplementedError(
            "the long-pilot phase search is not ported yet (ROADMAP.md "
            "Queue A item 9)")
    device = torch.device(device)
    samples, cfg, rs_info = maybe_resample(np.asarray(samples), cfg)

    prns = np.asarray(list(prn_list if prn_list is not None
                           else cfg.acq_satellite_list))
    spc = cfg.samples_per_code
    # coherent span: acq_coh_time [ms] of code periods in one slab
    n_coh = max(1, int(round(cfg.acq_coh_time
                             / max(sig.code_period_ms, 1e-9))))
    spc_c = n_coh * spc
    win_len = spc_c + spc              # full-overlap lags cover [0, spc]
    # FFT length: next power of two; the peak search stays on the
    # reference's span (2 code periods at n_coh == 1, 1 otherwise)
    search_len = 2 * spc if n_coh == 1 else spc
    nfft = 1 << (win_len - 1).bit_length()
    noncoh = cfg.acq_non_coh_time
    fs = cfg.sampling_freq
    ts = np.float32(1.0 / fs)

    # ---- signal slabs [noncoh, nfft] -------------------------------------
    if len(samples) < noncoh * spc_c + spc:
        raise ValueError(f"need {noncoh * spc_c + spc} samples, got "
                         f"{len(samples)}")
    idx = (np.arange(noncoh)[:, None] * spc_c
           + np.arange(win_len)[None, :])
    slabs = np.zeros((noncoh, nfft), np.complex64)
    slabs[:, :win_len] = np.asarray(samples)[idx]

    # ---- conjugate code spectra [n_prn, n_comp, nfft] --------------------
    comps = sig.acq_code_fns()
    n_comp = len(comps)
    weights = np.asarray(sig.acq_weights[:n_comp], np.float32)
    cfc = np.empty((len(prns), n_comp, nfft), np.complex64)
    for i, prn in enumerate(prns):
        for c, fn in enumerate(comps):
            table = sample_code(fn(int(prn)), sig.elements_per_chip,
                                sig.chip_rate_hz, fs, spc)
            padded = np.zeros(nfft, np.float32)
            padded[:spc_c] = np.tile(table.astype(np.float32), n_coh)
            cfc[i, c] = np.conj(np.fft.fft(padded))

    # ---- Doppler grid (descending) ---------------------------------------
    band, step = cfg.acq_search_band, cfg.acq_search_step
    n_bins = cfg.num_freq_bins
    base = (cfg.if_freq + band - step * np.arange(n_bins)).astype(np.float32)
    excl = int(round(fs / sig.chip_rate_hz)) + 1   # ±1 chip exclusion
    peak, bin_idx, phase_idx, second, floor = (
        x.cpu().numpy() for x in _pcps_cdma_kernel(
            torch.from_numpy(slabs).to(device),
            torch.from_numpy(cfc).to(device),
            torch.from_numpy(weights).to(device),
            torch.from_numpy(base).to(device), ts,
            n_noncoh=noncoh, n_comp=n_comp, search_len=search_len,
            excl_samples=excl, period=spc))

    if cfg.acq_metric == "second_peak":
        metric = peak / np.maximum(second, 1e-12)
    else:
        # noise-floor-referenced GLRT (see the reference's acquire)
        metric = (np.sqrt(np.pi) / 2.0) * peak / np.maximum(floor, 1e-12)
    detected = metric > cfg.acq_threshold
    coarse_freq = base[bin_idx]

    # ---- fine frequency stage --------------------------------------------
    n_codes = fine_n_codes or cfg.fine_n_codes or max(
        int(round(40.0 / max(sig.code_period_ms, 1e-9))), 4)
    n_codes_max = len(samples) // spc - 1
    if n_codes > n_codes_max:
        warnings.warn(
            f"fine stage clamped from {n_codes} to {n_codes_max} code "
            f"periods by the record length ({len(samples)} samples)")
        n_codes = max(n_codes_max, 1)
    carr_freq = np.zeros(len(prns))
    code_phase = np.zeros(len(prns), np.int64)
    fine_step = cfg.fine_search_step
    n_fine = int(round(cfg.acq_search_step / fine_step)) + 1
    nav_codes = max(int(round(sig.nav_symbol_ms / sig.code_period_ms)), 1)

    def fine_setup(prn: int):
        """(code_fn, hypotheses H or None=envelope) for this PRN."""
        psec = sig.pilot_secondary(int(prn)) \
            if sig.pilot_secondary is not None else None
        if sig.pilot_code is not None and psec is None:
            return sig.pilot_code, np.ones((1, n_codes), np.float32)
        if psec is not None and len(psec) <= 100:
            return sig.pilot_code, _secondary_hypotheses(psec, n_codes)
        if sig.data_secondary is not None \
                and len(sig.data_secondary) <= 100:
            return sig.data_code, _secondary_hypotheses(
                sig.data_secondary, n_codes)
        if nav_codes > 1:
            return sig.data_code, _bit_edge_hypotheses(
                n_codes, min(nav_codes, max(n_codes // 2, 1)))
        if nav_codes == 1 and psec is None:
            return sig.data_code, np.eye(n_codes, dtype=np.float32)
        return sig.data_code, None     # envelope mode

    det_idx = [i for i in range(len(prns)) if detected[i]]
    if det_idx:
        n_det = len(det_idx)
        # code-aligned segment starts, stepped back whole periods when
        # the fine window would run off the record
        cps = []
        for i in det_idx:
            cp = int(phase_idx[i])
            need = cp + n_codes * spc
            if need > len(samples):
                back = int(np.ceil((need - len(samples)) / spc)) * spc
                cp = cp - back if cp >= back else cp % spc
            cps.append(cp)
        if min(cps) < 0 or max(cps) + n_codes * spc > len(samples):
            raise ValueError("fine stage needs at least (fine_n_codes + 1) "
                             "code periods")
        seg = np.asarray(samples)
        seg_r = torch.from_numpy(np.real(seg).astype(np.float32)).to(device)
        seg_i = torch.from_numpy(np.imag(seg).astype(np.float32)).to(device)
        cfreqs = coarse_freq[det_idx].astype(np.float32)

        replicas = np.empty((n_det, n_codes * spc), np.float32)
        Hs = None
        envelope = False
        for j, i in enumerate(det_idx):
            code_fn, H = fine_setup(int(prns[i]))
            replicas[j] = sample_code(
                code_fn(int(prns[i])), sig.elements_per_chip,
                sig.chip_rate_hz, fs, n_codes * spc).astype(np.float32)
            envelope = H is None
            if Hs is None:
                Hs = np.empty((n_det,) + (np.ones((1, n_codes))
                                          if envelope else H).shape,
                              np.float32)
            Hs[j] = np.ones((1, n_codes), np.float32) if envelope else H
        fine_freqs = (cfreqs[:, None] + cfg.acq_search_step / 2
                      - fine_step * np.arange(n_fine)[None, :]
                      ).astype(np.float32)
        powers = _fine_batched(
            seg_r, seg_i, cps, torch.from_numpy(replicas).to(device),
            torch.from_numpy(fine_freqs).to(device),
            torch.from_numpy(Hs).to(device), ts,
            envelope=envelope).cpu().numpy()
        for j, i in enumerate(det_idx):
            carr_freq[i] = fine_freqs[j, int(np.argmax(powers[j]))]
            if carr_freq[i] == 0.0:
                carr_freq[i] = 1.0
            code_phase[i] = int(phase_idx[i])
            code_phase[i], carr_freq[i] = recover(code_phase[i],
                                                  carr_freq[i], rs_info)

    return AcquisitionResult(
        prns=prns, carr_freq=carr_freq, code_phase=code_phase,
        peak_metric=np.asarray(metric), detected=np.asarray(detected),
        coarse_freq=np.asarray(coarse_freq),
        pilot_phase=np.zeros(len(prns), np.int64))
