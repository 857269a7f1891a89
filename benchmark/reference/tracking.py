"""Plain recomputation of tracked epochs from the program's per-epoch
state, and the reference's own tracking loop.

A channel's tracking is a chain of epochs; the reference does not run the
chain in a run's check (an eager loop runs at about real time on the
card), it takes a sample of its links.  For each sampled epoch it starts
from the state the program reports at that epoch (carrier and code
frequency, code and carrier phase, first sample) and works out again:

  * the window: samples in the epoch, and where the next one starts;
  * the six correlator sums (early, prompt, late, I and Q) of the record's
    samples against the code replica sampled at the channel's
    Doppler-aided code rate with a +-1024-sample margin, sliced at the
    epoch's code phase with a linear interpolation between samples, and
    the carrier at the epoch's phase and frequency;
  * the discriminators and second-order loop filters (calcLoopCoef.m), so
    the next epoch's carrier and code frequency;
  * the code and carrier phase carried to the next epoch.

The start of every chain (the state at epoch 0 against the acquisition)
and the lock at its end are checked apart (``check``), and every link of
the chain from the program's own sums by the same rules (``pll_discr``,
``dll_discr``, ``loop_next``, ``carry``).  ``follow`` runs the whole chain
on the reference's own sums from the acquisition's hand-off: the witness
for the lock (``harness/witness.py``), not part of a run.
"""

from __future__ import annotations

import numpy as np
import torch

from ..frozen.codes import sample_code
from ..frozen.loop import calc_loop_coef
from .precision import Precision

UP_MARGIN = 1024
_TWO_PI = 2.0 * np.pi


def loop_params(s: dict, g: dict) -> dict:
    """Block size, tap spacing and loop constants of the configuration."""
    fs = s["sampling_freq"]
    spc = int(round(fs / (g["chip_rate_hz"] / g["code_length_chips"])))
    t1c, t2c = calc_loop_coef(s["dll_noise_bandwidth"],
                              s["dll_damping_ratio"], 1.0)
    t1p, t2p = calc_loop_coef(s["pll_noise_bandwidth"],
                              s["pll_damping_ratio"], 0.25)
    return dict(blk=spc + s["track_block_pad"],
                k=max(int(round(s["dll_correlator_spacing"] * fs
                                / g["chip_rate_hz"])), 1),
                t1c=t1c, t2c=t2c, t1p=t1p, t2p=t2p, pdi=s["int_time"])


def replica_table(chips, code_freq: float, fs: float, blk: int):
    """The code sampled at ``code_freq`` over blk + 2 * UP_MARGIN samples,
    index m at chip (m - UP_MARGIN) * code_freq / fs."""
    return sample_code(chips, code_freq, fs, blk + 2 * UP_MARGIN,
                       code_phase_chips=-UP_MARGIN * code_freq / fs)


def _taps(table, start, alpha, k: int, blk: int, prec: Precision):
    """E, P, L replica windows [P, blk] of rows ``table`` [P, L] from
    ``start`` [P], each interpolated by ``alpha`` [P] towards the next
    sample."""
    n = torch.arange(blk + 1, device=table.device)
    out = []
    for d in (0, k, 2 * k):
        w = torch.gather(table, 1, (start[:, None] + d + n[None, :]))
        r = w[:, :-1] + alpha[:, None] * (w[:, 1:] - w[:, :-1])
        out.append(prec.sums(r))
    return out


def pll_discr(ip, qp, pilot_ip=None, pilot_qp=None):
    """The Costas PLL discriminator [cycles] of prompt sums (tensors of any
    float dtype, computed in it): atan(Q / I), averaged with the pilot's
    (rotated onto +I) where there is one."""
    ce = torch.atan(qp / (ip + 1e-12)) / _TWO_PI
    if pilot_ip is not None:
        ce = 0.5 * ce + 0.5 * torch.atan(pilot_qp / (pilot_ip + 1e-12)) \
            / _TWO_PI
    return ce


def dll_discr(ie, qe, il, ql):
    """The normalised early-minus-late envelope DLL discriminator."""
    env_e, env_l = torch.hypot(ie, qe), torch.hypot(il, ql)
    return (env_e - env_l) / (env_e + env_l + 1e-12)


def _same(x):
    return x


def loop_next(lp: dict, cf, kf, carr_basis, code_basis, ce, de, ce_prev,
              de_prev, st=_same):
    """The next epoch's carrier and code frequency: the second-order loop
    filters (calcLoopCoef.m) fed with this epoch's discriminators and the
    previous epoch's, around the channel's first-epoch frequencies."""
    carr_nco = st(st(cf - carr_basis)
                  + st(lp["t2p"] / lp["t1p"] * (ce - ce_prev))
                  + st(ce * (lp["pdi"] / lp["t1p"])))
    code_nco = st(st(code_basis - kf)
                  + st(lp["t2c"] / lp["t1c"] * (de - de_prev))
                  + st(de * (lp["pdi"] / lp["t1c"])))
    return st(carr_basis + carr_nco), st(code_basis - code_nco)


def carry(rc, rcar, cf, kf, bsz, fs: float, code_len: float, st=_same):
    """Code phase [chips] and carrier phase [rad] carried over an epoch of
    ``bsz`` samples."""
    step = st(kf / fs)
    return (st(st(rc + st(bsz * step)) - code_len),
            st(rcar + st(st(_TWO_PI * cf / fs) * bsz)) % _TWO_PI)


def _epoch(iq, first, cf, kf, rc, rcar, rows, tab, lp, fs, code_len,
           prec: Precision):
    """One epoch of rows ``rows`` from the given state: its samples, its
    six sums (and the pilot's, rotated onto +I), and the noise of one
    sum.  ``iq`` is the record as a tensor on the device; ``first`` the
    epochs' first samples [P] (long, on the device)."""
    st = prec.state
    blk, k = lp["blk"], lp["k"]
    dev = cf.device
    n_all = torch.arange(blk, device=dev, dtype=torch.float64)
    step = st(kf / fs)
    bsz = torch.clamp(torch.ceil(st((code_len - rc) / step)),
                      max=blk).long()
    shift_f = st(rc / step)
    shift = torch.floor(shift_f)
    alpha = (shift_f - shift).float().double()
    start = (UP_MARGIN - k + shift).long()
    sidx = (first[:, None] + torch.arange(blk, device=dev)[None, :]) * 2
    si, sq = iq[sidx].double(), iq[sidx + 1].double()
    phase = st(rcar[:, None] + st(_TWO_PI * cf / fs)[:, None]
               * n_all[None, :])
    cos, sin = prec.sums(torch.cos(phase)), prec.sums(torch.sin(phase))
    mask = (n_all[None, :] < bsz[:, None]).double()
    bb_i = prec.sums((si * cos + sq * sin) * mask)
    bb_q = prec.sums((sq * cos - si * sin) * mask)

    def six(table):
        sums = []
        for r in _taps(table[rows], start, alpha, k, blk, prec):
            sums += [prec.sums(prec.sums(r * bb_i).sum(1)),
                     prec.sums(prec.sums(r * bb_q).sum(1))]
        return sums

    out = dict(bsz=bsz)
    out.update(zip(("i_e", "q_e", "i_p", "q_p", "i_l", "q_l"),
                   six(tab["data"])))
    if "pilot" in tab:
        pie, pqe, pip, pqp, pil, pql = six(tab["pilot"])
        # the pilot rides on +Q: rotate it onto +I (j^1 of i + jq)
        out["pilot"] = (-pqe, pie, -pqp, pip, -pql, pil)
    # the noise of one sum: the samples' power per component times the
    # samples summed
    out["noise"] = torch.sqrt(((si * si + sq * sq) * mask).sum(1) / 2.0)
    return out


def _discriminators(e: dict):
    ce = pll_discr(e["i_p"], e["q_p"], *(
        (e["pilot"][2], e["pilot"][3]) if "pilot" in e else ()))
    de = dll_discr(e["i_e"], e["q_e"], e["i_l"], e["q_l"])
    if "pilot" in e:
        pie, pqe, _, _, pil, pql = e["pilot"]
        de = 0.5 * de + 0.5 * dll_discr(pie, pqe, pil, pql)
    return ce, de


def recompute(iq: np.ndarray, trk: dict, chan: np.ndarray, ep: np.ndarray,
              tables: dict, s: dict, g: dict, device, prec: Precision,
              batch: int = 192) -> dict:
    """Recompute epochs ``ep`` of channels ``chan`` (index arrays [P]).

    trk: the program's per-epoch arrays [C, E] (carr_freq, code_freq,
    rem_code_phase, rem_carr_phase, abs_sample, blksize, pll_discr,
    dll_discr); tables: {"data": [C, L] int8, optionally "pilot"}.
    Returns {name: [P] numpy}: the reference's blksize, sums (i_e ..
    q_l, and pilot_ip/pilot_qp with a pilot bank), next carrier and code
    frequency, next code phase and carrier phase, and the noise (standard
    deviation) of one correlator sum of the window."""
    dev = torch.device(device)
    lp = loop_params(s, g)
    fs, code_len = s["sampling_freq"], g["code_length_chips"]
    tab = {b: torch.from_numpy(t).to(dev).double() for b, t in
           tables.items()}
    st = prec.state
    out = {}
    for a in range(0, len(chan), batch):
        c, e = chan[a:a + batch], ep[a:a + batch]

        def f(name, at=e):
            return torch.from_numpy(np.ascontiguousarray(
                trk[name][c, at])).to(dev).double()

        cf, kf = st(f("carr_freq")), st(f("code_freq"))
        rc, rcar = st(f("rem_code_phase")), st(f("rem_carr_phase"))
        first = trk["abs_sample"][c, e]
        # the record's samples of each window, one row of blk each
        sidx = (first[:, None] + np.arange(lp["blk"])[None, :]) * 2
        rec = torch.from_numpy(np.stack([iq[sidx], iq[sidx + 1]], -1)
                               .reshape(-1)).to(dev)
        pos = torch.arange(len(c), device=dev) * lp["blk"]
        r = _epoch(rec.reshape(-1), pos, cf, kf, rc, rcar,
                   torch.from_numpy(c).to(dev), tab, lp, fs, code_len, prec)
        ce, de = _discriminators(r)
        prev = np.maximum(e - 1, 0)
        first_ep = torch.from_numpy(e == 0).to(dev)
        ce_prev = torch.where(first_ep, 0.0, f("pll_discr", prev))
        de_prev = torch.where(first_ep, 0.0, f("dll_discr", prev))
        carr_next, code_next = loop_next(
            lp, cf, kf, f("carr_freq", np.zeros_like(e)),
            f("code_freq", np.zeros_like(e)), ce, de, ce_prev, de_prev, st)
        rem_code_next, rem_carr_next = carry(rc, rcar, cf, kf,
                                             r["bsz"].double(), fs,
                                             code_len, st)
        vals = dict(bsz=r["bsz"], noise=r["noise"], carr_next=carr_next,
                    code_next=code_next, rem_code_next=rem_code_next,
                    rem_carr_next=rem_carr_next)
        for nm in ("i_e", "q_e", "i_p", "q_p", "i_l", "q_l"):
            vals[nm] = r[nm]
        if "pilot" in r:
            vals["pilot_ip"], vals["pilot_qp"] = r["pilot"][2:4]
        for nm, v in vals.items():
            out.setdefault(nm, []).append(v)
    return {nm: torch.cat(v).cpu().numpy() for nm, v in out.items()}


def follow(iq, trk: dict, tables: dict, s: dict, g: dict, device,
           prec: Precision, n_epochs: int) -> dict:
    """The reference's own tracking loop, a witness: every channel of
    ``trk`` from the state its first epoch was handed (the acquisition's
    code phase and carrier), run on the reference's own sums, loop filters
    and carried phases for up to ``n_epochs`` epochs, while the record
    lasts.  Returns {"i_p", "q_p", "noise", "carr_freq"} [C, E] numpy:
    each epoch's data prompt, the noise of one sum, and the carrier
    frequency."""
    dev = torch.device(device)
    lp = loop_params(s, g)
    fs, code_len = s["sampling_freq"], g["code_length_chips"]
    tab = {b: torch.from_numpy(t).to(dev).double() for b, t in
           tables.items()}
    rec = torch.from_numpy(iq).to(dev)
    n_ch = len(trk["prns"])
    rows = torch.arange(n_ch, device=dev)

    def at0(name):
        return torch.from_numpy(np.ascontiguousarray(
            trk[name][:, 0])).to(dev).double()

    first = torch.from_numpy(trk["abs_sample"][:, 0].astype(np.int64)).to(
        dev)
    cf, kf = at0("carr_freq"), at0("code_freq")
    rc, rcar = at0("rem_code_phase"), at0("rem_carr_phase")
    carr_basis, code_basis = cf.clone(), kf.clone()
    ce_prev = de_prev = torch.zeros_like(cf)
    out = {nm: torch.zeros((n_ch, n_epochs), dtype=torch.float64,
                           device=dev) for nm in ("i_p", "q_p", "noise", "carr_freq")}
    last = len(iq) // 2 - lp["blk"]
    n = 0
    while n < n_epochs and int(first.max()) <= last:
        r = _epoch(rec, first, cf, kf, rc, rcar, rows, tab, lp, fs,
                   code_len, prec)
        ce, de = _discriminators(r)
        for nm in ("i_p", "q_p", "noise"):
            out[nm][:, n] = r[nm]
        out["carr_freq"][:, n] = cf
        bsz = r["bsz"]
        rc, rcar = carry(rc, rcar, cf, kf, bsz.double(), fs, code_len,
                         prec.state)
        cf, kf = loop_next(lp, cf, kf, carr_basis, code_basis, ce, de,
                           ce_prev, de_prev, prec.state)
        ce_prev, de_prev = ce, de
        first = first + bsz
        n += 1
    return {nm: v[:, :n].cpu().numpy() for nm, v in out.items()}


def tables_for(trk: dict, s: dict, g: dict, codes) -> dict:
    """Each channel's replica tables at the Doppler-aided code rate of its
    first epoch's carrier (the acquisition's)."""
    lp = loop_params(s, g)
    fs = s["sampling_freq"]
    data, pilot = [], []
    for c, prn in enumerate(trk["prns"]):
        dopp = float(trk["carr_freq"][c, 0]) - s["if_freq"]
        cfq = g["chip_rate_hz"] * (1.0 + dopp / g["carrier_freq_hz"])
        data.append(replica_table(codes.data_code(int(prn)), cfq, fs,
                                  lp["blk"]))
        if codes.pilot_code is not None and s["pilot_trk_flag"] > 0:
            pilot.append(replica_table(codes.pilot_code(int(prn)), cfq, fs,
                                       lp["blk"]))
    out = {"data": np.stack(data)}
    if pilot:
        out["pilot"] = np.stack(pilot)
    return out
