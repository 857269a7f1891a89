"""The numbers compared for one record: the program's outputs against the
reference's, layer by layer.

Exact comparisons (limit 0) count disagreements: ``acq_set_diff`` (PRNs
detected), ``trk_chan_diff`` (PRNs tracked, and each channel's first epoch
against the acquisition that started it), ``trk_geom_diff`` (samples per
epoch and the next epoch's first sample), ``trk_lock_diff`` (channels the
program keeps to the end against those whose recomputed prompt still
holds code and carrier phase lock at their last epochs), ``nav_diff``
(channels whose decode is missing where the channel's own span, to its
``active_until``, holds a frame, whose ephemeris or TOW differ from what
was transmitted, or that decode from a span too short to hold a whole
message) and ``pvt_count_diff`` (measurement epochs with a fix on one side
only).
The others are gaps: ``acq_gap`` (relative, of the GLRT metric of every
PRN, and the share of the reference's peak lost at the program's code
phase and fine carrier), ``trk_sum_gap`` (correlator sums, relative to the
channel's prompt level), ``trk_carr_gap_hz`` and ``trk_code_gap_hz`` (the
next epoch's frequencies), ``trk_phase_gap`` (code phase in chips, carrier
phase in cycles), ``pvt_gap_m`` (fixes, against the reference's from the
same decoded frames) and ``pvt_truth_m`` (fixes, against the sky's true
receiver position)."""

from __future__ import annotations

import numpy as np
import torch

from . import acquisition, nav, tracking
from .codecs import codec_of
from .precision import Precision

EPOCHS_PER_CHANNEL = 128      # sampled links of each channel's chain
LOCK_EPOCHS = 64              # the last valid epochs, for the lock
# a channel holds its signal where its recomputed prompt's envelope over
# its last epochs averages this many times the noise of one sum (at the
# cells' 45-50 dB-Hz a 1 ms prompt in code lock reads 8-10, one off the
# code about 1.25), and its carrier where the prompt's in-phase part
# outweighs its quadrature part in this share of those epochs (a Costas
# loop in phase lock: nearly all of them; one that slips: about half)
LOCK_SNR = 4.0
LOCK_CARRIER_SHARE = 0.8
# the gap read where one side has fixes and the other none
NO_COMMON_FIX_M = 1e9
NAMES = ("acq_set_diff", "acq_gap", "trk_chan_diff", "trk_geom_diff",
         "trk_sum_gap", "trk_carr_gap_hz", "trk_code_gap_hz",
         "trk_phase_gap", "trk_lock_diff", "nav_diff", "pvt_count_diff",
         "pvt_gap_m", "pvt_truth_m")


def holds_lock(i_p, q_p, noise) -> bool:
    """Whether a channel's prompts over its last epochs hold code and
    carrier phase lock: envelope over ``LOCK_SNR`` times the noise of one
    sum, and |I| > |Q| in ``LOCK_CARRIER_SHARE`` of the epochs."""
    return bool(np.mean(np.hypot(i_p, q_p)) > LOCK_SNR * np.mean(noise)
                and np.mean(np.abs(i_p) > np.abs(q_p)) >= LOCK_CARRIER_SHARE)


def sample_epochs(trk: dict, rng: np.random.Generator):
    """(channel, epoch) index arrays of the links to recompute: epoch 0,
    ``EPOCHS_PER_CHANNEL`` drawn from each channel's valid epochs, and
    its last ``LOCK_EPOCHS`` valid ones; and per channel the lock
    epochs' positions in them."""
    n_ch, n_ep = trk["blksize"].shape
    chan, ep, lock = [], [], {}
    for c in range(n_ch):
        valid = np.flatnonzero(trk["blksize"][c, :n_ep - 1] > 0)
        if len(valid) == 0:
            lock[c] = np.zeros(0, np.int64)
            continue
        drawn = rng.choice(valid, min(EPOCHS_PER_CHANNEL, len(valid)),
                           replace=False)
        tail = valid[-LOCK_EPOCHS:]
        picks = np.unique(np.concatenate([[valid[0]], drawn, tail]))
        lock[c] = sum(len(x) for x in ep) + np.searchsorted(picks, tail)
        chan.append(np.full(len(picks), c))
        ep.append(picks)
    if not chan:
        return np.zeros(0, np.int64), np.zeros(0, np.int64), lock
    return np.concatenate(chan), np.concatenate(ep), lock


def chain_gaps(trk: dict, s: dict, g: dict) -> dict:
    """The whole chain of every channel, link by link, from the program's
    own outputs: each valid epoch's next first sample (exact, counted),
    code and carrier phase carried on (chips, cycles), and the next
    carrier and code frequency from the loop filters fed with the
    discriminators of the program's own sums (float32, as the receiver
    forms them; the pilot's DLL term, whose early and late sums are not
    output, as the program reports it), by the reference's own rules
    (``tracking.pll_discr``, ``dll_discr``, ``loop_next``, ``carry``)."""
    lp = tracking.loop_params(s, g)
    fs, code_len = s["sampling_freq"], g["code_length_chips"]
    bsz = trk["blksize"]
    v = bsz[:, :-1] > 0
    if not v.any():
        return dict(geom=0, phase=0.0, carr=0.0, code=0.0)
    a, b = np.s_[:, :-1], np.s_[:, 1:]
    geom = int(np.sum(v & (trk["abs_sample"][b] - trk["abs_sample"][a]
                           != bsz[a])))

    def t(name, f32=False):
        x = np.ascontiguousarray(trk[name])
        return torch.from_numpy(x.astype(np.float32 if f32 else np.float64))

    pilot = s["pilot_trk_flag"] > 0 and g.get("pilot")
    with np.errstate(all="ignore"):
        ce = tracking.pll_discr(t("i_p", 1), t("q_p", 1), *(
            (t("pilot_ip", 1), t("pilot_qp", 1)) if pilot else ()))
        de = t("dll_discr", 1) if pilot else tracking.dll_discr(
            t("i_e", 1), t("q_e", 1), t("i_l", 1), t("q_l", 1))
    ce, de = ce.double(), de.double()
    prev_ce = torch.cat([torch.zeros_like(ce[:, :1]), ce[:, :-1]], 1)
    prev_de = torch.cat([torch.zeros_like(de[:, :1]), de[:, :-1]], 1)
    cf, kf = t("carr_freq"), t("code_freq")
    carr_next, code_next = tracking.loop_next(
        lp, cf[a], kf[a], cf[:, :1], kf[:, :1], ce[a], de[a], prev_ce[a],
        prev_de[a])
    code_next_ph, carr_next_ph = tracking.carry(
        t("rem_code_phase")[a], t("rem_carr_phase")[a], cf[a], kf[a],
        t("blksize")[a], fs, code_len)
    d_code = np.abs(code_next_ph.numpy() - trk["rem_code_phase"][b])
    d_carr = np.abs(carr_next_ph.numpy() - trk["rem_carr_phase"][b])
    d_carr = np.minimum(d_carr, 2.0 * np.pi - d_carr) / (2.0 * np.pi)
    return dict(
        geom=geom,
        phase=float(max(d_code[v].max(), d_carr[v].max())),
        carr=float(np.abs(carr_next.numpy() - trk["carr_freq"][b])[v].max()),
        code=float(np.abs(code_next.numpy() - trk["code_freq"][b])[v].max()))


def truth_gap(fixes: dict, sky) -> float:
    """The farthest of ``fixes`` from the sky's true receiver [m]; 0 with
    no fixes or no receiver."""
    if sky.rx_ecef is None:
        return 0.0
    return float(max((np.linalg.norm(xyz - sky.rx_ecef)
                      for xyz in fixes.values()), default=0.0))


def _acq_numbers(prog: dict, ref: acquisition.Acquired, s: dict):
    """(acq_set_diff, acq_gap)."""
    pa = prog["acq"]
    order = {int(p): i for i, p in enumerate(pa["prns"])}
    set_diff, gap = 0, 0.0
    for j, prn in enumerate(ref.prns):
        i = order.get(int(prn))
        if i is None:
            set_diff += 1
            continue
        gap = max(gap, abs(pa["peak_metric"][i] - ref.metric[j])
                  / max(ref.metric[j], 1e-12))
        if bool(pa["detected"][i]) != bool(ref.detected[j]):
            set_diff += 1
            continue
        if not ref.detected[j]:
            continue
        surf = ref.surface_peak[j]
        grid = np.float32(s["if_freq"] + s["acq_search_band"]
                          - s["acq_search_step"]
                          * np.arange(surf.shape[0]))
        b = np.flatnonzero(grid == np.float32(pa["coarse_freq"][i]))
        lag = int(pa["code_phase"][i])
        top = surf[ref.bin[j], ref.code_phase[j]]
        got = surf[b[0], lag] if len(b) and 0 <= lag < surf.shape[1] \
            else 0.0
        gap = max(gap, (top - got) / top)
        freqs, power = ref.fine_power[int(prn)]
        k = np.flatnonzero(freqs == np.float32(pa["carr_freq"][i]))
        got = power[k[0]] if len(k) else 0.0
        gap = max(gap, (power.max() - got) / power.max())
    return set_diff, float(gap)


def check_record(iq: np.ndarray, prog: dict, sky, s: dict, g: dict, codes,
                 device, prec: Precision, rng: np.random.Generator
                 ) -> dict:
    """(the numbers of ``NAMES``, what was compared: channels, channels
    decoded, fixes of the program and of the reference) for one record.  ``prog`` holds the
    program's outputs as plain arrays: "acq" (prns, peak_metric, detected,
    code_phase, carr_freq, coarse_freq), "channels" ((prn, carrier, code
    phase) tracked), "track" ([C, E] arrays, prns, active_until; None when
    nothing was tracked) and "fixes" ({measurement sample: xyz})."""
    out = dict.fromkeys(NAMES, 0.0)
    ref_acq = acquisition.acquire(iq, s, g, codes, device, prec)
    out["acq_set_diff"], out["acq_gap"] = _acq_numbers(prog, ref_acq, s)
    trk = prog["track"]
    want = acquisition.best_prns(ref_acq, s["num_channels"])
    got = sorted(int(ch[0]) for ch in prog["channels"])
    chan_diff = len(set(want) ^ set(got))
    if trk is not None:
        chan_diff += len(set(got) ^ {int(p) for p in trk["prns"]})
    if trk is None:
        out["trk_chan_diff"] = chan_diff
        out["pvt_count_diff"] = len(prog["fixes"])
        return out, dict(channels=0, decoded=0, fixes=len(prog["fixes"]),
                         ref_fixes=0)
    pa = prog["acq"]
    index = {int(p): i for i, p in enumerate(pa["prns"])}
    for c, prn in enumerate(trk["prns"]):
        i = index[int(prn)]
        if (int(trk["abs_sample"][c, 0]) != int(pa["code_phase"][i])
                or float(trk["carr_freq"][c, 0]) != float(pa["carr_freq"][i])):
            chan_diff += 1
    out["trk_chan_diff"] = chan_diff

    chain = chain_gaps(trk, s, g)
    chan, ep, lock = sample_epochs(trk, rng)
    tables = tracking.tables_for(trk, s, g, codes)
    r = tracking.recompute(iq, trk, chan, ep, tables, s, g, device, prec)
    nxt = ep + 1
    out["trk_geom_diff"] = chain["geom"] + int(np.sum(
        (r["bsz"] != trk["blksize"][chan, ep])
        | (trk["abs_sample"][chan, nxt] - trk["abs_sample"][chan, ep]
           != r["bsz"])))
    sums = ["i_e", "q_e", "i_p", "q_p", "i_l", "q_l"]
    if "pilot_ip" in r:
        sums += ["pilot_ip", "pilot_qp"]
    level = np.zeros(len(trk["prns"]))
    for c in range(len(level)):
        m = chan == c
        if m.any():
            level[c] = np.sqrt(np.mean(r["i_p"][m] ** 2 + r["q_p"][m] ** 2))
    scale = np.maximum(level[chan], 1e-9)
    out["trk_sum_gap"] = float(max(
        np.max(np.abs(trk[nm][chan, ep] - r[nm]) / scale) for nm in sums))
    out["trk_carr_gap_hz"] = float(max(np.max(np.abs(
        trk["carr_freq"][chan, nxt] - r["carr_next"])), chain["carr"]))
    out["trk_code_gap_hz"] = float(max(np.max(np.abs(
        trk["code_freq"][chan, nxt] - r["code_next"])), chain["code"]))
    dcarr = np.abs(trk["rem_carr_phase"][chan, nxt] - r["rem_carr_next"])
    dcarr = np.minimum(dcarr, 2 * np.pi - dcarr) / (2 * np.pi)
    out["trk_phase_gap"] = float(max(np.max(np.abs(
        trk["rem_code_phase"][chan, nxt] - r["rem_code_next"])),
        np.max(dcarr), chain["phase"]))
    n_ep = trk["blksize"].shape[1]
    lock_diff = 0
    for c in range(len(trk["prns"])):
        at = lock[c]
        held = len(at) > 0 and holds_lock(r["i_p"][at], r["q_p"][at],
                                          r["noise"][at])
        lock_diff += int(held != (trk["active_until"][c] == n_ep))
    out["trk_lock_diff"] = lock_diff

    # navigation: the program's prompt sums decoded by the frozen decoder,
    # held to the transmitted frames and the sky's timing, where the sky
    # sent any
    decoded, ref_fix = {}, {}
    if sky.eph_by_prn:
        codec = codec_of(g["nav_codec"])
        ms_per_bit = nav.ms_per_bit(g)
        by_prn = {sv.prn: sv for sv in sky.svs}
        nav_diff = 0
        for c, prn in enumerate(trk["prns"]):
            eph, start, tow = codec.decode(trk["i_p"][c], ms_per_bit)
            truth = sky.eph_by_prn.get(int(prn))
            span = int(trk["active_until"][c])
            if truth is None or span < codec.NEVER:
                nav_diff += int(eph is not None)
                continue
            if eph is None:
                nav_diff += int(span >= codec.ALWAYS)
                continue
            sent = codec.broadcast(truth, tow)
            same = all(eph.get(k) == v for k, v in sent.items()
                       if k not in codec.SKIP)
            t_sig = nav.signal_time(by_prn[int(prn)], sky.frame_t0,
                                    int(trk["abs_sample"][c, start]), s, g)
            if not same or abs(t_sig - tow) > 0.5e-3:
                nav_diff += 1
            decoded[c] = (eph, start, tow)
        out["nav_diff"] = nav_diff
        ref_fix = nav.solve(trk, decoded, s, g, prec, codec.pos)
    got_fix = prog["fixes"]
    out["pvt_count_diff"] = len(set(ref_fix) ^ set(got_fix))
    common = set(ref_fix) & set(got_fix)
    out["pvt_gap_m"] = float(max(
        (np.linalg.norm(ref_fix[m] - got_fix[m]) for m in common),
        default=0.0 if not ref_fix and not got_fix else NO_COMMON_FIX_M))
    out["pvt_truth_m"] = truth_gap(got_fix, sky)
    return out, dict(channels=len(trk["prns"]), decoded=len(decoded),
                     fixes=len(got_fix), ref_fixes=len(ref_fix))
