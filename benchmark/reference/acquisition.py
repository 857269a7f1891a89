"""Plain PCPS acquisition: the coarse search over PRNs, Doppler bins and
code phases, and the fine frequency search of each detected PRN.

The same search as the receiver's (GPS_L1CA/include/acquisition.m and its
cusdr ports): ``acq_non_coh_time`` slabs of one coherent span plus a code
period, zero-padded to a power of two, mixed to each Doppler bin, FFT
correlation with the sampled code, envelopes summed over the slabs; GLRT
metric against the surface mean.  The carrier phases are taken in float32,
as the search defines them; everything after the mixing is float64 here
(bfloat16 in the control).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..frozen.codes import sample_code
from .precision import Precision


@dataclass
class Acquired:
    prns: np.ndarray
    metric: np.ndarray
    detected: np.ndarray
    bin: np.ndarray           # coarse Doppler bin of the peak
    code_phase: np.ndarray    # lag of the peak [samples]
    carr_freq: np.ndarray     # fine carrier [Hz] (0 where not detected)
    coarse_freq: np.ndarray   # f32 coarse grid
    surface_peak: list        # per PRN: the envelope surface [bins, lags]
    fine_power: dict          # prn -> (f32 fine grid, powers)


def samples_per_code(s: dict, g: dict) -> int:
    return int(round(s["sampling_freq"]
                     / (g["chip_rate_hz"] / g["code_length_chips"])))


def leading_samples(s: dict, g: dict) -> int:
    """Samples the search reads from the record's start: the coarse slabs
    and a fine window of at least 45 code periods."""
    code_ms = 1e3 * g["code_length_chips"] / g["chip_rate_hz"]
    n_coh = max(1, int(round(s["acq_coh_time"] / code_ms)))
    return ((s["acq_non_coh_time"] * n_coh + max(s["fine_n_codes"], 45) + 2)
            * samples_per_code(s, g))


def _bits_hypotheses(n_codes: int, window: int) -> np.ndarray:
    h = np.zeros((n_codes - window + 1, n_codes), np.float64)
    for k in range(h.shape[0]):
        h[k, k:k + window] = 1.0
    return h


def _secondary_hypotheses(sec: np.ndarray, n_codes: int) -> np.ndarray:
    m = len(sec)
    reps = int(np.ceil(n_codes / m))
    return np.stack([np.tile(np.roll(sec, k), reps)[:n_codes]
                     for k in range(m)]).astype(np.float64)


def fine_setup(g: dict, codes, prn: int, n_codes: int):
    """(replica chips, hypotheses) of the fine stage: the pilot with its
    secondary code's shifts where the signal has one, else the data code
    over nav-bit-edge windows."""
    code_ms = 1e3 * g["code_length_chips"] / g["chip_rate_hz"]
    if codes.pilot_code is not None and codes.pilot_secondary is not None:
        return (codes.pilot_code(prn),
                _secondary_hypotheses(codes.pilot_secondary(prn), n_codes))
    nav_codes = max(int(round(g["nav_symbol_ms"] / code_ms)), 1)
    return (codes.data_code(prn),
            _bits_hypotheses(n_codes, min(nav_codes, max(n_codes // 2, 1))))


def acquire(iq: np.ndarray, s: dict, g: dict, codes, device,
            prec: Precision) -> Acquired:
    """Search the leading samples of the interleaved int8 record ``iq``."""
    dev = torch.device(device)
    fs = s["sampling_freq"]
    spc = samples_per_code(s, g)
    code_ms = 1e3 * g["code_length_chips"] / g["chip_rate_hz"]
    n_coh = max(1, int(round(s["acq_coh_time"] / code_ms)))
    spc_c = n_coh * spc
    win = spc_c + spc
    search = 2 * spc if n_coh == 1 else spc
    nfft = 1 << (win - 1).bit_length()
    noncoh = s["acq_non_coh_time"]
    n_lead = leading_samples(s, g)
    x = torch.from_numpy(np.asarray(iq[:2 * n_lead])).to(dev).double()
    sr, si = x[0::2], x[1::2]
    # carrier phases in float32: f32(2 pi ts) * f32(f) * f32(n)
    ts = np.float32(1.0 / fs)
    w = float(2.0 * np.pi * ts)
    band, step = s["acq_search_band"], s["acq_search_step"]
    n_bins = int(round(band * 2 / step)) + 1
    grid = (s["if_freq"] + band - step * np.arange(n_bins)).astype(
        np.float32)
    grid_d = torch.from_numpy(grid).to(dev)
    n = torch.arange(win, device=dev, dtype=torch.float32)
    phase = ((w * grid_d)[:, None] * n[None, :]).double()
    c = prec.sums(torch.cos(phase))
    sn = prec.sums(torch.sin(phase))
    idx = (torch.arange(noncoh, device=dev)[:, None] * spc_c
           + torch.arange(win, device=dev)[None, :])
    slab_r, slab_i = sr[idx], si[idx]                   # [noncoh, win]
    mr = prec.sums(slab_r[None] * c[:, None] + slab_i[None] * sn[:, None])
    mi = prec.sums(slab_i[None] * c[:, None] - slab_r[None] * sn[:, None])
    mixed = torch.zeros((n_bins, noncoh, nfft), dtype=torch.complex128,
                        device=dev)
    mixed[..., :win] = torch.complex(mr, mi)
    del mr, mi
    spec = torch.fft.fft(mixed, dim=-1)
    del mixed
    spec = torch.complex(prec.sums(spec.real), prec.sums(spec.imag))
    prns = np.asarray(s["acq_satellite_list"])
    excl = int(round(fs / g["chip_rate_hz"])) + 1
    lags = torch.arange(search, device=dev)
    metric = np.zeros(len(prns))
    peak_bin = np.zeros(len(prns), np.int64)
    peak_lag = np.zeros(len(prns), np.int64)
    surfaces = []
    for j, prn in enumerate(prns):
        table = np.zeros(nfft)
        table[:spc_c] = np.tile(sample_code(codes.data_code(int(prn)),
                                            g["chip_rate_hz"], fs, spc),
                                n_coh)
        cf = torch.conj(torch.fft.fft(torch.from_numpy(table).to(dev)))
        prod = spec * cf[None, None, :]
        prod = torch.complex(prec.sums(prod.real), prec.sums(prod.imag))
        corr = torch.fft.ifft(prod, dim=-1)[..., :search]
        surf = prec.sums(prec.sums(corr.abs()).sum(dim=1))   # [bins, lags]
        k = int(torch.argmax(surf))
        b, lag = divmod(k, search)
        d = torch.remainder(lags - lag, spc)
        dist = torch.minimum(d, spc - d)
        second = float(torch.where(dist > excl, surf[b], 0.0).max())
        peak = float(surf[b, lag])
        if s["acq_metric"] == "second_peak":
            metric[j] = peak / max(second, 1e-12)
        else:
            metric[j] = (np.sqrt(np.pi) / 2.0) * peak / max(
                float(surf.mean()), 1e-12)
        peak_bin[j], peak_lag[j] = b, lag
        surfaces.append(surf.cpu().numpy())
    del spec
    detected = metric > s["acq_threshold"]
    coarse = grid[peak_bin]
    carr = np.zeros(len(prns))
    fine = {}
    n_codes = s["fine_n_codes"] or max(int(round(40.0 / code_ms)), 4)
    n_codes = min(n_codes, n_lead // spc - 1)
    fstep = s["fine_search_step"]
    n_fine = int(round(step / fstep)) + 1
    m = torch.arange(n_codes * spc, device=dev, dtype=torch.float32)
    for j in np.flatnonzero(detected):
        prn = int(prns[j])
        cp = int(peak_lag[j])
        if cp + n_codes * spc > n_lead:
            back = int(np.ceil((cp + n_codes * spc - n_lead) / spc)) * spc
            cp = cp - back if cp >= back else cp % spc
        chips, hyp = fine_setup(g, codes, prn, n_codes)
        rep = torch.from_numpy(sample_code(chips, g["chip_rate_hz"], fs,
                                           n_codes * spc)).to(dev).double()
        freqs = (np.float32(coarse[j]) + np.float32(step / 2)
                 - np.float32(fstep) * np.arange(n_fine, dtype=np.float32)
                 ).astype(np.float32)
        fr = torch.from_numpy(freqs).to(dev)
        seg_r = sr[cp:cp + n_codes * spc] * rep
        seg_i = si[cp:cp + n_codes * spc] * rep
        ph = ((w * fr)[:, None] * m[None, :]).double()
        cs, sn_ = prec.sums(torch.cos(ph)), prec.sums(torch.sin(ph))
        ar = prec.sums(seg_r * cs + seg_i * sn_).reshape(n_fine, n_codes,
                                                         spc).sum(2)
        ai = prec.sums(seg_i * cs - seg_r * sn_).reshape(n_fine, n_codes,
                                                         spc).sum(2)
        h = torch.from_numpy(hyp).to(dev)
        power = torch.hypot(prec.sums(ar) @ h.T,
                            prec.sums(ai) @ h.T).max(dim=1).values
        power = power.cpu().numpy()
        carr[j] = freqs[int(np.argmax(power))]
        fine[prn] = (freqs, power)
    return Acquired(prns=prns, metric=metric, detected=detected,
                    bin=peak_bin, code_phase=peak_lag, carr_freq=carr,
                    coarse_freq=coarse, surface_peak=surfaces,
                    fine_power=fine)


def best_prns(acq: Acquired, n: int) -> list:
    """The PRNs a receiver of ``n`` channels tracks: detected, by metric."""
    order = [int(i) for i in np.argsort(-acq.metric) if acq.detected[i]]
    return sorted(int(acq.prns[i]) for i in order[:n])
