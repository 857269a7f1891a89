"""Batched PCPS acquisition in PyTorch.

Counterpart of cusdr_tpu/acquisition/pcps.py, same names.  The reference
runs this stage as XLA programs (no Pallas kernel); here it is complex64
``torch.fft`` (cuFFT on a card) and plain tensor ops.  Three coarse
searches, as in the reference:

  * CDMA 'pcps': the Doppler-mixed signal FFT is computed once and shared
    by all PRNs; the search loops over PRNs on the device and the host
    reads the per-PRN peaks once;
  * FDMA (GLONASS): one shared code, each frequency channel k searched on
    its own carrier grid ``base + k·fdma_spacing_hz``;
  * 'circshift' (GPS L2C): the signal is mixed and transformed once per
    sub-bin offset, and every other Doppler hypothesis is that spectrum
    rotated by a whole number of bins.  The shifts run in batches whose
    products stay within ``SHIFT_BATCH_BYTES`` on the device, and the best
    shift is kept as the reference's scan keeps it.

The conjugate code spectra they correlate with depend on no record: they
are built by numpy once per signal, PRN list and rate and kept on the
device (``code_spectra``).

Then, for a long pilot (L2C CL), the search over its code periods (a
matmul of the hypotheses' replicas against the wiped segment), and the
fine stage's bit-edge, secondary-code, coherent and envelope hypothesis
modes.

The fine stage's per-code-period sums are ``fine_search``, which takes the
place of the reference's ``_fine_kernel`` / ``_fine_batched``: on a CUDA
tensor one launch of ops/csrc/fine.cu, which draws each sample's replica
from the detected PRN's code table (cached on the device) and wipes and
sums in registers, so that neither a sampled replica nor an [n_fine ×
segment] product exists; on a CPU tensor ``fine_search_plain``, the same
replica index and the reference's arithmetic in torch.  The hypotheses are
combined after it, as in the reference.
"""

from __future__ import annotations

import functools
import warnings
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ..ops import correlator as ops
from ..runtime.profiling import count, span
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
                                            # (L2C CL period index)
    # host-clock seconds of the coarse search, the long-pilot phase search
    # and the fine stage, each ending with its results on the host
    timings: dict | None = None

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

@functools.lru_cache(maxsize=4)
def _code_spectra(comps, code_prns, epc: int, chip_rate_hz: float,
                  fs: float, spc: int, n_coh: int, nfft: int, device):
    """The conjugate code spectra, complex64 [len(code_prns), len(comps),
    nfft] on ``device``: ``comps[c](code_prns[i])`` sampled for one code
    period, tiled ``n_coh`` times, zero-padded and transformed by numpy.
    Built and uploaded once per key, never written.  An entry holds 0.26
    MB (glo_l1) to 520 MB (bds_b1c: 62 PRNs x 2 components x 524 288),
    16.8 MB for gps_l1ca's 32 PRNs at 18 Msps: four entries hold the
    signals one process runs together (``run_multi``) in 2.1 GB at most."""
    cfc = np.empty((len(code_prns), len(comps), nfft), np.complex64)
    for i, prn in enumerate(code_prns):
        for c, fn in enumerate(comps):
            table = sample_code(fn(prn), epc, chip_rate_hz, fs, spc)
            padded = np.zeros(nfft, np.float32)
            padded[:n_coh * spc] = np.tile(table.astype(np.float32), n_coh)
            cfc[i, c] = np.conj(np.fft.fft(padded))
    return torch.from_numpy(cfc).to(device)


def code_spectra(sig: SignalDef, prns, fs: float, spc: int, n_coh: int,
                 nfft: int, device):
    """(spectra, hit): ``_code_spectra`` of the signal's acquisition
    components at ``prns`` (an FDMA signal has one code for every channel:
    code(0)), and whether they came from the cache."""
    code_prns = (0,) if sig.fdma else tuple(int(p) for p in prns)
    hits = _code_spectra.cache_info().hits
    cfc = _code_spectra(tuple(sig.acq_code_fns()), code_prns,
                        sig.elements_per_chip, sig.chip_rate_hz, fs, spc,
                        n_coh, nfft, torch.device(device))
    return cfc, _code_spectra.cache_info().hits > hits


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
    excluded periodically (the peak repeats every code period); rows
    [..., lags] with peak phases [...]."""
    lags = torch.arange(row.shape[-1], device=row.device)
    d = torch.remainder(lags - peak_phase[..., None], period)
    dist = torch.minimum(d, period - d)
    return torch.where(dist > excl_samples, row, 0.0).max(dim=-1).values


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
    _check_noncoh(slabs, n_noncoh)
    mf = _mixed_fft(slabs, f_grid, ts)
    per_prn = [_corr_peak(mf, cfftc, weights, n_comp, search_len,
                          excl_samples, period) for cfftc in code_fft_conj]
    return tuple(torch.stack(x) for x in zip(*per_prn))


def _check_noncoh(slabs, n_noncoh: int):
    if slabs.shape[0] != n_noncoh:
        raise ValueError(f"slabs hold {slabs.shape[0]} non-coherent "
                         f"blocks, expected {n_noncoh}")


def _pcps_fdma_kernel(slabs, code_fft_conj, weights, freqs, ts,
                      n_noncoh: int, n_comp: int, search_len: int,
                      excl_samples: int = 0,
                      period: Optional[int] = None):
    """FDMA PCPS (GLONASS): one shared code, a carrier grid per frequency
    channel.

    freqs: f32 [n_chan, n_bins]; code_fft_conj: complex64 [1, n_comp,
    nfft] (the shared code).  Returns (peak, bin, phase, second, floor),
    each [n_chan] on the device."""
    _check_noncoh(slabs, n_noncoh)
    per_chan = [_corr_peak(_mixed_fft(slabs, f_grid, ts), code_fft_conj[0],
                           weights, n_comp, search_len, excl_samples, period)
                for f_grid in freqs]
    return tuple(torch.stack(x) for x in zip(*per_chan))


# bytes of one batch of the circular-shift search's products (all PRNs and
# sub-bins of a few shifts, complex64); the inverse FFT's output and the
# envelopes take as much again and half
SHIFT_BATCH_BYTES = {"cuda": 2 << 30, "cpu": 128 << 20}


def _pcps_circshift_kernel(slabs, code_fft_conj, weights, sub_offsets, ts,
                           n_shift: int, n_comp: int, search_len: int,
                           excl_samples: int = 0,
                           period: Optional[int] = None,
                           batch: Optional[int] = None):
    """Circular-shift frequency search: the signal is mixed and transformed
    only ``n_sub`` times (the sub-bin offsets); every other Doppler
    hypothesis is that spectrum rotated by an integer number of bins.

    slabs: complex64 [n_noncoh, nfft]; code_fft_conj: complex64 [n_prn,
    n_comp, nfft]; sub_offsets: f32 [n_sub] absolute mix frequencies.
    Hypothesis (m, j) is the carrier sub_offsets[j] - m·fs/nfft (the
    spectrum's content at -m bins is brought to DC by rotating it right by
    m).  ``batch`` shifts at a time (default: as many as keep a batch's
    products within ``SHIFT_BATCH_BYTES``), all PRNs' correlations of a
    batch as one batched inverse FFT.  The best is kept as the reference's
    scan over shifts keeps it: a later shift replaces the best only with a
    strictly larger peak, and within a shift the first index of the
    largest value wins.  The floor is the sum, in shift order, of each
    shift's surface mean, over ``n_shift``.

    Returns (peak, shift_idx, sub_idx, phase, second, floor), each [n_prn]
    on the device."""
    mf = _mixed_fft(slabs, sub_offsets, ts)          # [n_sub, noncoh, nfft]
    n_sub, nfft = mf.shape[0], mf.shape[-1]
    n_prn = code_fft_conj.shape[0]
    dev = mf.device
    per = period if period is not None else search_len // 2
    if batch is None:
        budget = SHIFT_BATCH_BYTES.get(dev.type, SHIFT_BATCH_BYTES["cpu"])
        batch = max(1, budget // (n_prn * mf.numel() * 8))
    batch = min(batch, n_shift)
    rows_of = torch.arange(n_prn, device=dev)
    lags = torch.arange(nfft, device=dev)
    b_val = torch.full((n_prn,), -torch.inf, device=dev)
    b_m = torch.zeros(n_prn, dtype=torch.int64, device=dev)
    b_sub = torch.zeros_like(b_m)
    b_ph = torch.zeros_like(b_m)
    b_row = torch.zeros((n_prn, search_len), device=dev)
    b_floor = torch.zeros(n_prn, device=dev)
    for m0 in range(0, n_shift, batch):
        ms = torch.arange(m0, min(m0 + batch, n_shift), device=dev)
        # rotated right by m: bin i holds the content of bin i - m
        rolled = mf[:, :, torch.remainder(lags[None, :] - ms[:, None],
                                          nfft)].permute(2, 0, 1, 3)
        acc = torch.zeros((len(ms), n_prn, n_sub, search_len), device=dev)
        for c in range(n_comp):
            corr = torch.fft.ifft(
                rolled[:, None] * code_fft_conj[None, :, c, None, None, :],
                dim=-1)
            acc = acc + weights[c] * corr[..., :search_len].abs().sum(dim=3)
        flat = acc.reshape(len(ms), n_prn, -1)
        k = flat.argmax(dim=-1)                              # [B, n_prn]
        val = flat.gather(-1, k[..., None])[..., 0]
        # the batch's first shift with its largest peak, per PRN
        bb = val.argmax(dim=0)
        top = val[bb, rows_of]
        imp = top > b_val
        k_top = k[bb, rows_of]
        sub, ph = k_top // search_len, k_top % search_len
        b_val = torch.where(imp, top, b_val)
        b_m = torch.where(imp, ms[bb], b_m)
        b_sub = torch.where(imp, sub, b_sub)
        b_ph = torch.where(imp, ph, b_ph)
        b_row = torch.where(imp[:, None], acc[bb, rows_of, sub], b_row)
        for mean in flat.mean(dim=-1):
            b_floor = b_floor + mean
    second = _second_peak(b_row, b_ph, per, excl_samples)
    return b_val, b_m, b_sub, b_ph, second, b_floor / n_shift


# --------------------------------------------------------------------------
# Fine stage
# --------------------------------------------------------------------------

def _check_fine(sig_r, sig_i, cps, tables, lengths, offsets, omega,
                epc: int, n_codes: int, spc: int) -> None:
    """Raises on what neither ``fine_search`` nor its plain version
    takes."""
    dev = sig_r.device
    for name, x, dt, dim in (("sig_r", sig_r, torch.float32, 1),
                             ("sig_i", sig_i, torch.float32, 1),
                             ("tables", tables, torch.int8, 2),
                             ("omega", omega, torch.float32, 2)):
        if x.dtype != dt or x.dim() != dim:
            raise ValueError(f"{name} must be a {dim}-D {dt} tensor, got "
                             f"{x.dtype} of shape {tuple(x.shape)}")
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, sig_r on {dev}")
    if sig_i.shape != sig_r.shape:
        raise ValueError("sig_r and sig_i differ in length")
    n_det = len(cps)
    if not (len(lengths) == len(offsets) == tables.shape[0]
            == omega.shape[0] == n_det):
        raise ValueError(f"{n_det} segment starts, {len(lengths)} lengths, "
                         f"{len(offsets)} offsets, {tables.shape[0]} table "
                         f"rows and {omega.shape[0]} omega rows")
    if min(epc, n_codes, spc) < 1:
        raise ValueError("epc, n_codes and spc must be >= 1")
    n_seg = n_codes * spc
    if any(not 1 <= int(L) <= tables.shape[1] for L in lengths):
        raise ValueError(f"a code length outside [1, {tables.shape[1]}]: "
                         "the table is shorter than its code")
    if any(cp < 0 or cp + n_seg > sig_r.shape[0] for cp in cps):
        raise ValueError(f"a segment of {n_codes} x {spc} samples runs "
                         f"past the record's {sig_r.shape[0]}")


def table_replica(table, length: int, offset: float, *, epc: int,
                  ratio: float, n_samples: int):
    """``sample_code``'s replica drawn from a code table on its device:
    element ⌊(offset + n·ratio)·epc⌋ mod length of ``table`` for n in
    [0, n_samples), the index formed in f64 as ``sample_code`` forms it."""
    k = torch.arange(n_samples, dtype=torch.float64, device=table.device)
    idx = torch.floor((float(offset) + k * float(ratio)) * epc).long()
    return table[torch.remainder(idx, int(length))]


def fine_search_plain(sig_r, sig_i, cps, tables, lengths, offsets, omega,
                      *, epc: int, ratio: float, n_codes: int, spc: int):
    """Plain PyTorch version of ``fine_search``, same arguments.

    Each row's replica is drawn from its table (``table_replica``), then
    wiped and summed as the reference's ``_fine_kernel`` does, one
    [n_fine, n_codes·spc] product per row."""
    _check_fine(sig_r, sig_i, cps, tables, lengths, offsets, omega, epc,
                n_codes, spc)
    n_seg = n_codes * spc
    n = torch.arange(n_seg, dtype=torch.float32, device=sig_r.device)
    out_r, out_i = [], []
    for j, cp in enumerate(cps):
        rep = table_replica(tables[j], lengths[j], offsets[j], epc=epc,
                            ratio=ratio, n_samples=n_seg).float()
        wr = sig_r[cp:cp + n_seg] * rep
        wi = sig_i[cp:cp + n_seg] * rep
        phase = omega[j][:, None] * n[None, :]
        c, sn = torch.cos(phase), torch.sin(phase)
        out_r.append((wr * c + wi * sn).reshape(-1, n_codes, spc).sum(dim=2))
        out_i.append((wi * c - wr * sn).reshape(-1, n_codes, spc).sum(dim=2))
    return torch.stack(out_r), torch.stack(out_i)


def fine_search(sig_r, sig_i, cps, tables, lengths, offsets, omega, *,
                epc: int, ratio: float, n_codes: int, spc: int):
    """Per-code-period sums of the fine-frequency search, for every
    detected row at once.

    sig_r/sig_i: [S] f32 record; cps: host ints, each row's segment start
    (the code edge); tables: [n_det, L_max] int8 code-element tables;
    lengths: host ints, each row's code length L (<= L_max); offsets: host
    floats, each row's code phase in chips at its segment start (a long
    pilot's period); omega: [n_det, n_fine] f32, ``float(2π·ts) · freqs``;
    epc: elements per chip; ratio: chip rate / fs, as ``sample_code``
    forms it.  Sample n of row j is wiped by ``table[j][e(n)]`` with e(n) =
    ⌊(offsets[j] + n·ratio)·epc⌋ mod L and by the carrier at f32 phase
    omega·n.  Returns (sr, si), f32 [n_det, n_fine, n_codes]: the real and
    imaginary sums of each code period.

    On a CUDA tensor one launch of ops/csrc/fine.cu (built at first use)
    or an error; on a CPU tensor ``fine_search_plain``.  A launch adds one
    to ``LAUNCHES["fine_search"]``."""
    dev = sig_r.device
    if dev.type == "cpu":
        return fine_search_plain(sig_r, sig_i, cps, tables, lengths, offsets,
                                 omega, epc=epc, ratio=ratio,
                                 n_codes=n_codes, spc=spc)
    _check_fine(sig_r, sig_i, cps, tables, lengths, offsets, omega, epc,
                n_codes, spc)
    if dev.type != "cuda":
        raise ValueError(f"no fine search for device {dev}")
    if not all(x.is_contiguous() for x in (sig_r, sig_i, tables, omega)):
        raise ValueError("fine_search: sig_r, sig_i, tables and omega must "
                         "be contiguous")
    lib = ops.load_library("fine")
    if n_codes * spc > lib.fine_search_max_samples():
        # the kernel carries the sample index n in f32 (the phase omega·n)
        raise ValueError(f"{n_codes} x {spc} samples: the kernel's f32 "
                         "sample index is exact only below "
                         f"{lib.fine_search_max_samples()}")
    n_det, n_fine = omega.shape
    n_tiles = -(-spc // lib.fine_search_tile_samples())
    rows = torch.tensor([list(cps), list(lengths)], dtype=torch.int64
                        ).to(dev)
    offs = torch.tensor(list(offsets), dtype=torch.float64).to(dev)
    partial = torch.empty((n_det, n_fine, n_codes, n_tiles, 2),
                          dtype=torch.float32, device=dev)
    sr = torch.empty((n_det, n_fine, n_codes), dtype=torch.float32,
                     device=dev)
    si = torch.empty_like(sr)
    rc = lib.fine_search_launch(
        sig_r.data_ptr(), sig_i.data_ptr(), rows[0].data_ptr(),
        tables.data_ptr(), tables.shape[1], rows[1].data_ptr(),
        offs.data_ptr(), omega.data_ptr(), partial.data_ptr(),
        sr.data_ptr(), si.data_ptr(), n_det, n_fine, n_codes, spc, n_tiles,
        int(epc), float(ratio), torch.cuda.current_stream(dev).cuda_stream)
    ops._launched("fine_search", rc)
    return sr, si


def _fine_powers(sr, si, hyp, envelope: bool):
    """Each row's power per fine bin, [n_det, n_fine]: the largest over
    hypotheses hyp [n_det, n_hyp, n_codes] of the coherent combinations'
    magnitude, or with ``envelope`` the sum of the code periods'
    magnitudes."""
    if envelope:
        return torch.hypot(sr, si).sum(dim=2)
    h = hyp.transpose(1, 2)
    return torch.hypot(sr @ h, si @ h).max(dim=2).values


@functools.lru_cache(maxsize=256)
def _fine_table(code_fn, prn: int, device):
    """The code table of ``code_fn(prn)`` (one signal component's code
    elements) as int8 on ``device``: uploaded once, never written."""
    return torch.from_numpy(np.ascontiguousarray(
        code_fn(prn), dtype=np.int8)).to(device)


def _pilot_phase_kernel(sig_r, sig_i, cps, freqs, reps, ts):
    """Long-pilot period search over the detected PRNs.

    sig_r/sig_i: [S] f32 record; cps: host ints, each PRN's segment start;
    freqs: f32 [n_det] coarse carriers; reps: int8 [n_det, n_hyp, spc]
    pilot replicas, one row per period hypothesis.  Each segment is wiped
    of its carrier and correlated with every hypothesis as one
    [n_hyp, spc] · [spc] product per PRN (``torch.matmul``; the reference
    leaves this product to XLA, outside any Pallas kernel).  Returns the
    argmax hypothesis [n_det] on the device."""
    spc = reps.shape[2]
    t = torch.arange(spc, dtype=torch.float32, device=sig_r.device)
    phase = (float(2.0 * np.pi * ts) * freqs)[:, None] * t[None, :]
    c, sn = torch.cos(phase), torch.sin(phase)
    sr = torch.stack([sig_r[cp:cp + spc] for cp in cps])
    si = torch.stack([sig_i[cp:cp + spc] for cp in cps])
    wr = sr * c + si * sn
    wi = si * c - sr * sn
    repf = reps.float()
    pr = torch.matmul(repf, wr[..., None])[..., 0]
    pi = torch.matmul(repf, wi[..., None])[..., 0]
    return torch.argmax(torch.hypot(pr, pi), dim=1)


def _bit_edge_hypotheses(n_codes: int, window: int) -> np.ndarray:
    """Sliding all-ones windows: nav-bit-edge search."""
    n_hyp = n_codes - window + 1
    H = np.zeros((n_hyp, n_codes), np.float32)
    for k in range(n_hyp):
        H[k, k:k + window] = 1.0
    return H


def _secondary_hypotheses(secondary: np.ndarray, n_codes: int) -> np.ndarray:
    """All circular shifts of a secondary code, tiled to n_codes: row k
    is ``np.tile(np.roll(secondary, k), ...)[:n_codes]``."""
    m = len(secondary)
    shift = np.arange(n_codes)[None, :] - np.arange(m)[:, None]
    return np.asarray(secondary, np.float32)[shift % m]


def fine_setup(sig: SignalDef, prn: int, n_codes: int):
    """(code_fn, hypotheses H [n_hyp, n_codes] or None = envelope) of the
    fine stage for this PRN."""
    nav_codes = max(int(round(sig.nav_symbol_ms / sig.code_period_ms)), 1)
    psec = sig.pilot_secondary(int(prn)) \
        if sig.pilot_secondary is not None else None
    if sig.pilot_code is not None and psec is None:
        # a pilot with no secondary: fully coherent (L2C CL, B2a); a long
        # pilot's replica starts at the period the CL search found
        return sig.pilot_code, np.ones((1, n_codes), np.float32)
    if psec is not None and len(psec) <= 100:
        return sig.pilot_code, _secondary_hypotheses(psec, n_codes)
    if sig.data_secondary is not None and len(sig.data_secondary) <= 100:
        return sig.data_code, _secondary_hypotheses(sig.data_secondary,
                                                    n_codes)
    if nav_codes > 1:
        return sig.data_code, _bit_edge_hypotheses(
            n_codes, min(nav_codes, max(n_codes // 2, 1)))
    if nav_codes == 1 and psec is None:
        return sig.data_code, np.eye(n_codes, dtype=np.float32)
    return sig.data_code, None     # envelope mode


# --------------------------------------------------------------------------
# Public API
# --------------------------------------------------------------------------

def acquire(cfg, sig: SignalDef, samples: np.ndarray, device,
            prn_list: Optional[Sequence[int]] = None,
            fine_n_codes: Optional[int] = None) -> AcquisitionResult:
    """Run coarse+fine acquisition over ``prn_list`` on ``device``.

    samples: complex IF samples; needs at least
    (acq_non_coh_time + 1 + fine_n_codes) code periods.  For an FDMA
    signal the PRNs are the frequency channels k, and each detected
    carrier includes the channel's offset ``k·fdma_spacing_hz``.
    """
    from .resample import maybe_resample, recover
    device = torch.device(device)
    with span("acq.codes"):
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

        # ---- signal slabs [noncoh, nfft] ------------------------------------
        if len(samples) < noncoh * spc_c + spc:
            raise ValueError(f"need {noncoh * spc_c + spc} samples, got "
                             f"{len(samples)}")
        idx = (np.arange(noncoh)[:, None] * spc_c
               + np.arange(win_len)[None, :])
        slabs = np.zeros((noncoh, nfft), np.complex64)
        slabs[:, :win_len] = np.asarray(samples)[idx]

        # ---- conjugate code spectra [n_prn, n_comp, nfft] -------------------
        cfc_d, hit = code_spectra(sig, prns, fs, spc, n_coh, nfft, device)
        # 1 where the spectra came from the cache, 0 where they were built
        count("acq_codes_hit", int(hit))
        n_comp = cfc_d.shape[1]
        weights = np.asarray(sig.acq_weights[:n_comp], np.float32)

        # ---- Doppler grid (descending) --------------------------------------
        band, step = cfg.acq_search_band, cfg.acq_search_step
        n_bins = cfg.num_freq_bins
        base = (cfg.if_freq + band
                - step * np.arange(n_bins)).astype(np.float32)
        excl = int(round(fs / sig.chip_rate_hz)) + 1   # ±1 chip exclusion
        slabs_d = torch.from_numpy(slabs).to(device)
        weights_d = torch.from_numpy(weights).to(device)
        kw = dict(n_comp=n_comp, search_len=search_len, excl_samples=excl,
                  period=spc)
    with span("acq.coarse") as coarse:
        coarse_freq = None
        if sig.fdma:
            # the 'PRN' is the frequency channel k
            offs = (prns * sig.fdma_spacing_hz).astype(np.float32)
            freqs = np.ascontiguousarray(base[None, :] + offs[:, None])
            out = _pcps_fdma_kernel(slabs_d, cfc_d, weights_d,
                                    torch.from_numpy(freqs).to(device), ts,
                                    n_noncoh=noncoh, **kw)
            peak, bin_idx, phase_idx, second, floor = (x.cpu().numpy()
                                                       for x in out)
        elif cfg.acq_method == "circshift":
            # one signal FFT per sub-bin; Doppler via spectrum rotation
            dfreq = fs / nfft
            n_sub = max(1, int(np.ceil(dfreq / step)))
            sub_step = dfreq / n_sub
            n_shift = int(round(2.0 * band / dfreq)) + 1
            f_max = cfg.if_freq + band
            sub_offsets = (f_max - sub_step * np.arange(n_sub)
                           ).astype(np.float32)
            out = _pcps_circshift_kernel(
                slabs_d, cfc_d, weights_d, torch.from_numpy(sub_offsets).to(
                    device), ts, n_shift=n_shift, **kw)
            peak, m_idx, sub_idx, phase_idx, second, floor = (
                x.cpu().numpy() for x in out)
            # carrier = f_max - m·Δf - j·sub_step
            coarse_freq = f_max - m_idx * dfreq - sub_idx * sub_step
            bin_idx = np.zeros(len(prns), np.int64)
        else:
            freqs = np.broadcast_to(base, (len(prns), n_bins))
            out = _pcps_cdma_kernel(slabs_d, cfc_d, weights_d,
                                    torch.from_numpy(base).to(device), ts,
                                    n_noncoh=noncoh, **kw)
            peak, bin_idx, phase_idx, second, floor = (x.cpu().numpy()
                                                       for x in out)

        if cfg.acq_metric == "second_peak":
            metric = peak / np.maximum(second, 1e-12)
        else:
            # noise-floor-referenced GLRT (see the reference's acquire)
            metric = (np.sqrt(np.pi) / 2.0) * peak / np.maximum(floor, 1e-12)
        detected = metric > cfg.acq_threshold
        if coarse_freq is None:
            coarse_freq = freqs[np.arange(len(prns)), bin_idx]

    # ---- fine frequency stage --------------------------------------------
    pilot = span("acq.pilot_phase")    # 0 s where it does not run
    with span("acq.fine") as fine:
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

        pilot_phase = np.zeros(len(prns), np.int64)
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
                raise ValueError("fine stage needs at least (fine_n_codes "
                                 "+ 1) code periods")
            seg = np.asarray(samples)
            seg_r = torch.from_numpy(
                np.real(seg).astype(np.float32)).to(device)
            seg_i = torch.from_numpy(
                np.imag(seg).astype(np.float32)).to(device)
            cfreqs = coarse_freq[det_idx].astype(np.float32)

            # ---- long-pilot phase search (L2C CL) ---------------------------
            nhyp = sig.pilot_phase_hypotheses
            ph_seg = None
            if nhyp > 1 and sig.pilot_code is not None:
                with pilot:
                    epc = sig.elements_per_chip
                    n_elem_period = sig.code_length_chips * epc
                    eidx = np.floor(np.arange(spc) * (sig.chip_rate_hz / fs)
                                    * epc).astype(np.int64)
                    reps = np.empty((n_det, nhyp, spc), np.int8)
                    for j, i in enumerate(det_idx):
                        pilot_elems = sig.pilot_code(int(prns[i]))
                        shift = (eidx[None, :]
                                 + (np.arange(nhyp) * n_elem_period)[:, None]
                                 ) % len(pilot_elems)
                        reps[j] = pilot_elems[shift]
                    ph_seg = _pilot_phase_kernel(
                        seg_r, seg_i, cps,
                        torch.from_numpy(cfreqs).to(device),
                        torch.from_numpy(reps).to(device), ts).cpu().numpy()
                    for j, i in enumerate(det_idx):
                        # the hypothesis indexes the segment at cps[j];
                        # convert to the pilot period at phase_idx[i] (the
                        # tracking start)
                        back_periods = (int(phase_idx[i])
                                        - int(cps[j])) // spc
                        pilot_phase[i] = (int(ph_seg[j])
                                          + back_periods) % nhyp

            rows, offsets = [], []
            Hs = None
            envelope = False
            for j, i in enumerate(det_idx):
                code_fn, H = fine_setup(sig, int(prns[i]), n_codes)
                # a pilot-based fine stage on a long pilot starts its replica
                # at the period found for the SEGMENT at cps[j]
                fine_offset_chips = 0.0
                if ph_seg is not None and code_fn is sig.pilot_code:
                    fine_offset_chips = float(int(ph_seg[j])
                                              * sig.code_length_chips)
                rows.append(_fine_table(
                    code_fn, 0 if sig.fdma else int(prns[i]), device))
                offsets.append(fine_offset_chips)
                envelope = H is None
                if Hs is None:
                    Hs = np.empty((n_det,) + (np.ones((1, n_codes))
                                              if envelope else H).shape,
                                  np.float32)
                Hs[j] = np.ones((1, n_codes), np.float32) if envelope else H
            fine_freqs = (cfreqs[:, None] + cfg.acq_search_step / 2
                          - fine_step * np.arange(n_fine)[None, :]
                          ).astype(np.float32)
            omega = float(2.0 * np.pi * ts) * torch.from_numpy(
                fine_freqs).to(device)
            sr, si = fine_search(
                seg_r, seg_i, cps,
                torch.nn.utils.rnn.pad_sequence(rows, batch_first=True),
                [len(r) for r in rows], offsets, omega,
                epc=sig.elements_per_chip, ratio=sig.chip_rate_hz / fs,
                n_codes=n_codes, spc=spc)
            powers = _fine_powers(sr, si, torch.from_numpy(Hs).to(device),
                                  envelope).cpu().numpy()
            for j, i in enumerate(det_idx):
                carr_freq[i] = fine_freqs[j, int(np.argmax(powers[j]))]
                if carr_freq[i] == 0.0:
                    carr_freq[i] = 1.0
                code_phase[i] = int(phase_idx[i])
                code_phase[i], carr_freq[i] = recover(code_phase[i],
                                                      carr_freq[i], rs_info)
        # the detected PRNs whose fine search ran (0 included)
        count("acq_fine_rows", len(det_idx))

    return AcquisitionResult(
        prns=prns, carr_freq=carr_freq, code_phase=code_phase,
        peak_metric=np.asarray(metric), detected=np.asarray(detected),
        coarse_freq=np.asarray(coarse_freq), pilot_phase=pilot_phase,
        timings=dict(coarse_s=coarse.seconds, pilot_phase_s=pilot.seconds,
                     fine_s=fine.seconds - pilot.seconds))
