#!/usr/bin/env python3
"""Smoke run of the PyTorch port (cusdr_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run when it fails:

1. environment: the card, its power limit, CUDA and nvcc versions;
2. build the CUDA correlator from cusdr_tpu_torch/ops/csrc/correlator.cu;
3. the kernel against its plain PyTorch version at the main path's shapes
   (12 channels, blk = 18 008 samples, k = 9, both tap modes, some windows
   clamped at the record's end), with both times;
3b. the pilot and dual-pilot variants against the plain version at the
   shapes of their paths (gal_e5a 12 x 18 008 k = 1, gal_e1c 12 x 72 008
   k = 5, bds_b1c WB 15 x 180 008 k = 1), both tap modes, windows clamped
   at the record's, the code table's and the pilot table's ends, with
   both times;
4. the main path at the gps_l1ca preset's full width (18 Msps, 12
   channels, 32 PRNs x 29 Doppler bins x 20 ms): ``Receiver.run`` on a few
   seconds of a 12-SV synthetic scene; every SV acquired, every channel in
   lock, one kernel launch per tracked epoch;
5. PVT: the 40 s, 2.048 Msps, 6-SV scene of tests/test_e2e_l1ca.py through
   ``Receiver.run``; fixes within that test's bounds;
6. the pilot path at the gal_e5a preset's full width (18 Msps, 12
   channels, 36 PRNs x 21 bins x 15 ms, the 100 ms coherent CS100 fine
   stage) on a 3 s 12-SV scene at 50 dB-Hz: every SV acquired, data and
   pilot prompts locked, one pilot-kernel launch per epoch;
7. the dual pilot bank at the bds_b1c preset in WB mode (pilot_trk_flag=2,
   18 Msps, 15 channels, 62 PRNs x 201 bins x 10 ms) on a 2.5 s 15-SV
   scene, checked as phase 6;
8. PVT on a pilot signal: the 26 s, 12.288 Msps, 4-SV GPS L5 scene of
   tests/test_e2e_l5c.py (pilot_trk_flag=1); fixes within that test's
   bounds.

The scenes of phases 4-8 are made in five worker processes while phases
1-3 run, and are all finished before phase 4 starts.

Prints a JSON line with each kernel variant's numbers, the card's name and
power limit, and last ``{"ok": true, "device": {...}}``.  Exits non-zero
without a CUDA card, and outside a checkout of the repository.  Imports no
jax.
"""

from __future__ import annotations

import json
import multiprocessing
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# the port must run where jax is absent: make any jax import fail loudly
sys.modules["jax"] = None

# |kernel - plain| <= KERNEL_RTOL * (max|plain| + 1): the two sum 18 000-
# 180 000 f32 products in different orders (per-thread strides and a block
# tree against PyTorch's reductions), so they differ by f32 rounding of the
# sums, which grows with the sum's magnitude
KERNEL_RTOL = 1e-4
N_TIMED = 200          # launches per timing round
SOURCE = "cusdr_tpu_torch/ops/csrc/correlator.cu"
REPLACES = "cusdr_tpu/ops/correlator.py:563"
# phase 3b: (variant, the path it stands for, channels, blk, k)
PILOT_SHAPES = (
    ("correlate_bank_pilot", "gal_e5a", 12, 18008, 1),
    ("correlate_bank_pilot", "gal_e1c", 12, 72008, 5),
    ("correlate_bank_dual_pilot", "bds_b1c WB", 15, 180008, 1),
)


def log(msg: str) -> None:
    print(msg, flush=True)


def environment():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    from cusdr_tpu_torch.ops.correlator import _nvcc
    nvcc = subprocess.run([_nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip()
    log(f"[env] {smi}")
    log(f"[env] torch {torch.__version__}, torch.version.cuda "
        f"{torch.version.cuda}, nvcc: {nvcc.splitlines()[-1]}")
    return smi


def build():
    from cusdr_tpu_torch.ops import correlator
    t0 = time.perf_counter()
    correlator.load_library()
    sec = time.perf_counter() - t0
    logs = sorted(correlator.BUILD_DIR.glob("*.log"))
    regs = [ln.strip() for p in logs for ln in p.read_text().splitlines()
            if "registers" in ln or "spill" in ln or "Compiling" in ln]
    log(f"[build] correlator.cu built and loaded in {sec:.2f} s")
    for ln in regs:
        log(f"[build] {ln}")


def _timed(fn, n):
    """Mean device milliseconds per call over n calls (CUDA events)."""
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def _bank_inputs(rng, n_ch, blk, k, n_pilots):
    """Random kernel inputs on the card: a 1000 ms 18 Msps record (the
    last three windows run off its end), tables of blk + 2 * 1024.  With
    pilot banks, a pilot table of the same length at its own starts and
    fractions; one code-table and two pilot-table windows run off their
    tables' ends.  All are clamped by the wrapper."""
    import numpy as np
    import torch
    dev = torch.device("cuda")
    n_samp = 1_000 * 18_000
    table_len = blk + 2 * 1024
    iq = torch.from_numpy(rng.integers(-16, 17, 2 * n_samp).astype(
        np.int8)).to(dev)
    table = torch.from_numpy(rng.choice(np.array([-1, 1], np.int8),
                                        (n_ch, table_len))).to(dev)
    off = rng.integers(0, n_samp - blk, n_ch)
    off[-3:] = [n_samp - blk, n_samp - blk + 5, n_samp + 100]  # clamped
    start = rng.integers(1024 - k - 1, 1024 - k + 2, n_ch)
    if n_pilots:
        start[-3] = table_len                                # clamped
    inc = (20e3 + rng.uniform(-7e3, 7e3, n_ch)) / 18e6

    def t(x, dt):
        return torch.as_tensor(np.asarray(x), dtype=dt, device=dev)

    f32, i64 = torch.float32, torch.int64
    args = (iq, t(off, i64), table, torch.arange(n_ch, device=dev),
            t(start, i64), t(rng.uniform(0, 1, n_ch), f32),
            t(rng.uniform(0, 1, n_ch), f32),
            t(np.mod(inc * 128, 1.0), f32), t(np.mod(inc, 1.0), f32),
            t(blk - rng.integers(0, 9, n_ch), i64))
    kw = dict(k=k, blk=blk)
    if n_pilots:
        shape = (n_ch, table_len) if n_pilots == 1 \
            else (n_ch, 2, table_len)
        pstart = rng.integers(0, table_len - blk - 2 * k - 1, n_ch)
        pstart[-2:] = [table_len - blk, -3]                  # clamped
        kw.update(
            ptable=t(rng.choice(np.array([-1, 1], np.int8), shape),
                     torch.int8),
            pstart=t(pstart, i64), palpha=t(rng.uniform(0, 1, n_ch), f32),
            pilot_rot=3 if n_pilots == 2 else 1, pilot2_rot=2,
            pilot_w1=float(np.sqrt(29 / 33)) if n_pilots == 2 else 1.0,
            pilot_w2=float(np.sqrt(4 / 33)) if n_pilots == 2 else 0.0)
    return args, kw


def kernel_check(label, n_ch, blk, k, n_pilots, seed=0):
    """One kernel variant against its plain version on the same CUDA
    tensors, in both tap modes, with its device time (torch.profiler) and
    its wall time per wrapper call (CUDA events) beside the plain
    version's."""
    import numpy as np
    import torch
    from cusdr_tpu_torch.ops.correlator import (VARIANTS, correlate_bank,
                                                correlate_bank_plain)
    rng = np.random.default_rng(seed)
    args, kw = _bank_inputs(rng, n_ch, blk, k, n_pilots)
    n_out = 16 if n_pilots else 8
    rows = {}
    for interp in (True, False):
        got = correlate_bank(*args, interp_taps=interp, **kw)
        want = correlate_bank_plain(*args, interp_taps=interp, **kw)
        torch.cuda.synchronize()
        if got.shape != (n_ch, n_out) or not torch.isfinite(got).all():
            raise AssertionError(f"{label}: kernel output "
                                 f"{tuple(got.shape)} not finite "
                                 f"[{n_ch}, {n_out}]")
        err = (got - want).abs().max().item()
        tol = KERNEL_RTOL * (want.abs().max().item() + 1.0)
        if not err <= tol:
            raise AssertionError(f"{label}: kernel disagrees with plain "
                                 f"version (interp_taps={interp}): {err} > "
                                 f"{tol}")

        def kern():
            correlate_bank(*args, interp_taps=interp, **kw)

        def plain():
            correlate_bank_plain(*args, interp_taps=interp, **kw)

        # wall time per wrapper call, host work included: alternate plain,
        # kernel, kernel, plain on the same card
        p1, k1, k2, p2 = (_timed(f, N_TIMED)
                          for f in (plain, kern, kern, plain))
        row = dict(err=err, tol=tol, wrapper_ms=(k1 + k2) / 2,
                   plain_wrapper_ms=(p1 + p2) / 2,
                   device_ms=_device_ms(kern, "correlate_bank"),
                   plain_device_ms=_device_ms(plain))
        rows[interp] = row
        tag = f"[kernel] {label}, interp_taps={interp}"
        log(f"{tag}: max|kernel-plain|={err:.3e} <= {tol:.3e}")
        log(f"{tag}: device time per call (torch.profiler): kernel "
            f"{_fmt_ms(row['device_ms'])}, plain "
            f"{_fmt_ms(row['plain_device_ms'])}")
        log(f"{tag}: wall time per wrapper call (CUDA events, mean of "
            f"{N_TIMED}): kernel {row['wrapper_ms']:.4f} ms ({k1:.4f}, "
            f"{k2:.4f}), plain {row['plain_wrapper_ms']:.4f} ms "
            f"({p1:.4f}, {p2:.4f})")
    return dict(name=VARIANTS[n_pilots], label=label, n_ch=n_ch, blk=blk,
                k=k, rows=rows)


def _device_ms(fn, name=None, n=50):
    """Device milliseconds per call from torch.profiler (CUPTI): the
    kernels whose name contains ``name``, or all kernels; None when the
    trace holds no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if name is None or name in e.key)
    return us / n / 1e3 if us > 0 else None


def _fmt_ms(ms):
    return "not measured" if ms is None else f"{ms:.4f} ms"


def scene(cfg, sig, prns, seconds, cn0_dbhz=45.0, seed=1, dopplers=None):
    """SVs at ``cn0_dbhz`` with random nav symbols, spread over the
    Doppler search band (or at ``dopplers``) and the code period.  Returns
    (svs, iq, seconds it took to make them)."""
    import numpy as np
    from cusdr_tpu_torch.host.io.synth import (SynthSV, quantize_iq_int8,
                                               synthesize_if)
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    spc = cfg.samples_per_code
    n_bits = int(seconds * 1000 / sig.nav_symbol_ms) + 2
    if dopplers is None:
        dopplers = np.linspace(-4400.0, 4600.0, len(prns))
    svs = [SynthSV(prn=p, code_phase=float(rng.uniform(0, spc - 1)),
                   doppler_hz=float(d), cn0_dbhz=cn0_dbhz,
                   nav_bits=rng.choice([-1.0, 1.0], n_bits))
           for p, d in zip(prns, dopplers)]
    iq = quantize_iq_int8(synthesize_if(cfg, sig, svs,
                                        num_ms=int(seconds * 1000),
                                        seed=seed))
    return svs, iq, time.perf_counter() - t0


def scene_job(signal, overrides, prns, seconds, cn0_dbhz=45.0,
              dopplers=None):
    """``scene`` at the ``signal`` preset with ``overrides``, made in a
    worker process of the scene pool."""
    from cusdr_tpu_torch import get_config
    from cusdr_tpu_torch.host.signals.defs import get_signal
    return scene(get_config(signal, **overrides), get_signal(signal), prns,
                 seconds, cn0_dbhz, dopplers=dopplers)


def check_main(cfg, svs, res, launches=None, tail_epochs=500,
               pilot=False, acq_carr_tol_hz=None):
    """Every simulated SV acquired where it was put (within
    ``acq_carr_tol_hz``, by default two fine steps, and the DLL's
    half-chip pull-in, or the one-sample grid of the search where a chip
    spans under two samples), every channel in lock near its true
    frequency (means over the last ``tail_epochs``; the pilot prompt too
    with ``pilot``), outputs finite, one launch per epoch.  Returns
    (epochs, prompt SNRs, tracked and acquired carrier errors)."""
    import numpy as np
    if acq_carr_tol_hz is None:
        acq_carr_tol_hz = 2 * cfg.fine_search_step
    spc = cfg.samples_per_code
    acq_err = []
    got = {c[0]: c for c in res.channels}
    missing = [sv.prn for sv in svs if sv.prn not in got]
    if missing:
        raise AssertionError(f"SVs not acquired: {missing}")
    for sv in svs:
        _, carr, cp, _ = got[sv.prn]
        dcp = (cp - sv.code_phase + spc / 2) % spc - spc / 2
        dfr = carr - (cfg.if_freq + sv.doppler_hz)
        acq_err.append(dfr)
        if (abs(dcp) > max(0.5 * cfg.sampling_freq / cfg.code_freq_basis,
                           1.0)
                or abs(dfr) > acq_carr_tol_hz):
            raise AssertionError(f"PRN {sv.prn}: code phase off by {dcp} "
                                 f"samples, carrier by {dfr} Hz")
    trk = res.track
    n_ep = trk.i_p.shape[1]
    names = ["i_p", "q_p", "carr_freq", "code_freq"]
    pairs = [("i_p", "q_p")]
    if pilot:
        names += ["pilot_ip", "pilot_qp"]
        pairs.append(("pilot_ip", "pilot_qp"))
    for name in names:
        if not np.isfinite(getattr(trk, name)).all():
            raise AssertionError(f"non-finite {name}")
    tail = slice(n_ep - tail_epochs, n_ep)
    snr = [np.abs(getattr(trk, i)[:, tail]).mean(axis=1)
           / getattr(trk, q)[:, tail].std(axis=1) for i, q in pairs]
    truth = {sv.prn: cfg.if_freq + sv.doppler_hz for sv in svs}
    fr_err = np.asarray([trk.carr_freq[c, tail].mean() - truth[p]
                         for c, p in enumerate(trk.prns)])
    if not (all(s == "T" for s in trk.status)
            and all((x > 3.0).all() for x in snr)
            and (np.abs(fr_err) < 5.0).all()):
        raise AssertionError(f"lock lost: status {trk.status}, mean|I_P|"
                             f"/std(Q_P) {snr}, carrier error {fr_err} Hz")
    if launches is not None and launches != n_ep:
        raise AssertionError(f"{launches} kernel launches for {n_ep} "
                             "tracked epochs")
    return n_ep, snr, fr_err, np.asarray(acq_err)


def run_path(card, tag, cfg, made, variant, pilot, tail_epochs,
             acq_carr_tol_hz=None):
    """``Receiver(cfg, "cuda").run`` on the scene ``made`` (``scene``'s
    result) with every launch count set to 0 just before it; returns the
    launches of ``variant``."""
    import numpy as np
    import torch
    from cusdr_tpu_torch.host.signals.defs import get_signal
    from cusdr_tpu_torch.ops.correlator import (correlate_bank,
                                                reset_launches)
    from cusdr_tpu_torch.receiver import Receiver
    sig = get_signal(cfg.signal)
    svs, iq, made_s = made
    log(f"[{tag}] scene: {len(svs)} SVs at {svs[0].cn0_dbhz:g} dB-Hz, "
        f"{len(iq) // 2} samples at {cfg.sampling_freq / 1e6:g} Msps, "
        f"made in {made_s:.1f} s")
    rx = Receiver(cfg, "cuda")
    torch.cuda.synchronize()
    reset_launches()
    res = rx.run(iq)
    launches = dict(correlate_bank.launches)
    others = {k: v for k, v in launches.items() if k != variant and v}
    if others:
        raise AssertionError(f"[{tag}] launched other variants: {others}")
    n_ep, snr, fr_err, acq_err = check_main(cfg, svs, res,
                                            launches[variant], tail_epochs,
                                            pilot, acq_carr_tol_hz)
    tm = res.timings
    rec_s = n_ep * sig.code_period_ms * 1e-3
    n_samp = rec_s * cfg.sampling_freq
    log(f"[{tag}] acquisition on {card}: {len(res.channels)} channels, "
        f"{len(cfg.acq_satellite_list)} PRNs x {cfg.num_freq_bins} bins x "
        f"{cfg.acq_non_coh_time} x {cfg.acq_coh_time} ms, "
        f"{tm['acquisition_s']:.3f} s")
    log(f"[{tag}] tracking on {card}: {len(res.channels)} channels x "
        f"{n_ep} epochs of {sig.code_period_ms:g} ms in "
        f"{tm['tracking_s']:.3f} s = {n_samp / tm['tracking_s']:.4g} "
        f"record samples/s ({rec_s / tm['tracking_s']:.3f}x real time), "
        f"{launches[variant]} {variant} launches")
    for (i, q), x in zip([("I_P", "Q_P"), ("pilot I_P", "pilot Q_P")],
                         snr):
        log(f"[{tag}] mean|{i}|/std({q}) "
            f"{[round(float(v), 1) for v in x]}")
    log(f"[{tag}] carrier error: acquisition max "
        f"{np.abs(acq_err).max():.2f} Hz, tracking (mean) max "
        f"{np.abs(fr_err).max():.2f} Hz")
    return launches[variant]


MAIN_SCENE = ("gps_l1ca", {}, [1, 3, 6, 8, 11, 13, 17, 19, 22, 24, 28, 31],
              3.0)
# gal_e5a at 50 dB-Hz: the preset's GLRT threshold of 4.5 over 15 x 1 ms
# non-coherent rounds of the primary code leaves most 45 dB-Hz SVs below
# it (metrics 3.5-4.8 on the card), as tests/test_e2e_l5c.py notes for L5
# at the same threshold
E5A_SCENE = ("gal_e5a", {}, [1, 3, 5, 7, 9, 11, 13, 19, 21, 24, 26, 30],
             3.0, 50.0)
B1C_WB = dict(pilot_trk_flag=2)
# bds_b1c WB: the spread of the other scenes snapped to the fine stage's
# 25 Hz grid, 5 Hz off it.  The fine stage leaves up to half a step plus
# noise, and the 10 ms PLL does not pull in 14 Hz: at -4400..4600 Hz
# unsnapped, PRN 28 at +1385.7 Hz is acquired 14.3 Hz off and stays 16.5
# Hz off, in the reference as in the port (ROADMAP.md Queue C)
B1C_SCENE = ("bds_b1c", B1C_WB, list(range(19, 34)), 2.5, 45.0,
             [-4395, -3745, -3120, -2470, -1820, -1170, -545, 105, 755,
              1380, 2030, 2680, 3330, 3955, 4605])


def main_path(card: str, made):
    from cusdr_tpu_torch import get_config
    return run_path(card, "main", get_config("gps_l1ca"), made,
                    "correlate_bank", pilot=False, tail_epochs=500)


def pilot_path(card: str, made):
    """The acquired carrier is held to half a coarse step, not two fine
    steps: the fine stage searches 5 Hz bins only within half a coarse
    step of the coarse pick, so a Doppler within a few Hz of a coarse-bin
    boundary whose neighbouring bin wins the coarse search is left at the
    fine window's edge (13.6 Hz from truth for PRN 5's -2763.6 Hz here,
    in the reference as in the port).  The PLL pulls it in; the tracked
    carrier is held to 5 Hz."""
    from cusdr_tpu_torch import get_config
    cfg = get_config("gal_e5a")
    return run_path(card, "e5a", cfg, made, "correlate_bank_pilot",
                    pilot=True, tail_epochs=500,
                    acq_carr_tol_hz=cfg.acq_search_step / 2)


def dual_pilot_path(card: str, made):
    from cusdr_tpu_torch import get_config
    return run_path(card, "b1c-wb", get_config("bds_b1c", **B1C_WB), made,
                    "correlate_bank_dual_pilot", pilot=True,
                    tail_epochs=100)


def _pvt_config():
    from cusdr_tpu_torch import get_config
    return get_config("gps_l1ca", sampling_freq=2.048e6, if_freq=7000.0,
                      acq_satellite_list=tuple(range(1, 33)),
                      acq_non_coh_time=12, use_trop_corr=False,
                      ms_to_process=40_000)


def pvt_scene_job():
    """The L1 C/A PVT scene, made in a worker process of the scene pool.
    Returns (scenario, int8 I/Q, seconds it took)."""
    from cusdr_tpu_torch.host.io.scenario import make_gps_scenario
    from cusdr_tpu_torch.host.io.synth import quantize_iq_int8, synthesize_if
    from cusdr_tpu_torch.host.signals.defs import get_signal
    cfg = _pvt_config()
    sig = get_signal("gps_l1ca")
    t0 = time.perf_counter()
    scn = make_gps_scenario(cfg, sig, n_svs=6, duration_s=40.0,
                            cn0_dbhz=46.0)
    samples = quantize_iq_int8(
        synthesize_if(cfg, sig, scn.svs, num_ms=40_500, seed=7))
    return scn, samples, time.perf_counter() - t0


def pvt(card: str, made):
    from cusdr_tpu_torch.receiver import Receiver
    scn, samples, _ = made
    res = Receiver(_pvt_config(), "cuda").run(samples)
    _check_fixes("pvt", card, scn, res, "test_e2e_l1ca", 60, 15.0, 50.0)


def _check_fixes(tag, card, scn, res, test, min_fixes, mean_m, max_m):
    import numpy as np
    missing = {sv.prn for sv in scn.svs} - {c[0] for c in res.channels}
    if missing or res.nav is None:
        raise AssertionError(f"{tag}: SVs {missing} not acquired or no "
                             "fix")
    err = np.sqrt((np.asarray(res.nav.X) - scn.rx_ecef[0]) ** 2
                  + (np.asarray(res.nav.Y) - scn.rx_ecef[1]) ** 2
                  + (np.asarray(res.nav.Z) - scn.rx_ecef[2]) ** 2)
    log(f"[{tag}] on {card}: {len(err)} fixes, 3-D error mean "
        f"{err.mean():.2f} m, max {err.max():.2f} m; acquisition "
        f"{res.timings['acquisition_s']:.2f} s, tracking "
        f"{res.timings['tracking_s']:.2f} s for "
        f"{res.track.i_p.shape[1]} epochs x {len(res.channels)} channels")
    if not (len(err) >= min_fixes and err.mean() < mean_m
            and err.max() < max_m):
        raise AssertionError(f"{tag}: fixes outside the {test} bounds: "
                             f"{len(err)} fixes, mean {err.mean()} m, max "
                             f"{err.max()} m")


L5_MSG_S = 6.0          # one CNAV message at 50 bps = 6 s


def _cnav_eph(prn: int, toe: float, *, m0: float, omega0: float) -> dict:
    """CNAV MT10/11/30 ephemeris on the codec's field grids, orbit near
    the GPS nominal shell (as tests/test_e2e_l5c.py builds it)."""
    import numpy as np
    rng = np.random.default_rng(prn + 100)
    toe = 300.0 * round(toe / 300.0)      # t_oe grid is 300 s (MT10)
    return dict(
        PRN=float(prn), weekNumber=1214.0, health=0.0, T_op=toe,
        URA_ED=1.0, t_oe=toe, t_oc=toe,
        deltaA=float(rng.uniform(-200.0, 200.0)), ADot=0.0,
        delta_n_0=float(rng.uniform(3.5e-9, 5.5e-9)), delta_n_0Dot=0.0,
        M_0=m0, e=float(rng.uniform(0.003, 0.02)),
        omega=float(rng.uniform(-np.pi, np.pi) * 0.99),
        omega_0=omega0, i_0=np.radians(55.0),
        delta_omegaDot=0.0, i_0Dot=0.0,
        C_is=float(rng.uniform(-2e-7, 2e-7)),
        C_ic=float(rng.uniform(-2e-7, 2e-7)),
        C_rs=float(rng.uniform(-80, 80)),
        C_rc=float(rng.uniform(150, 350)),
        C_us=float(rng.uniform(2e-6, 9e-6)),
        C_uc=float(rng.uniform(-6e-6, 6e-6)),
        a_f0=float(rng.uniform(-2e-4, 2e-4)), a_f1=0.0, a_f2=0.0,
        T_GD=float(rng.uniform(-8e-9, 8e-9)), ISC_L5I=0.0, ISC_L2C=0.0,
    )


def _cnav_stream(eph, frame_t0):
    """±1 CNAV symbols at 10 ms/symbol from signal time frame_t0."""
    import numpy as np
    from cusdr_tpu_torch.host.nav import cnav
    mids = [10, 11, 30, 10, 11, 30]
    msgs = [cnav.encode_message(mid, eph,
                                int(frame_t0 + L5_MSG_S * (k + 1)),
                                prn=int(eph["PRN"]))
            for k, mid in enumerate(mids)]
    return cnav.encode_symbol_stream(msgs).astype(np.int8)


def _l5_config():
    from cusdr_tpu_torch import get_config
    return get_config("gps_l5c", sampling_freq=12.288e6, if_freq=7000.0,
                      acq_satellite_list=tuple(range(1, 13)),
                      acq_non_coh_time=10, pilot_trk_flag=1,
                      use_trop_corr=False, ms_to_process=26_000)


def l5_scene_job():
    """The L5 PVT scene, made in a worker process of the scene pool.
    Returns (scenario, int8 I/Q, seconds it took)."""
    from cusdr_tpu_torch.host.io.scenario import make_generic_scenario
    from cusdr_tpu_torch.host.io.synth import quantize_iq_int8, synthesize_if
    from cusdr_tpu_torch.host.orbits.cnav_kepler import sat_pos_cnav
    from cusdr_tpu_torch.host.signals.defs import get_signal
    cfg = _l5_config()
    sig = get_signal("gps_l5c")
    t0 = time.perf_counter()
    scn = make_generic_scenario(
        cfg, sig, eph_factory=_cnav_eph, satpos_fn=sat_pos_cnav,
        nav_stream_fn=_cnav_stream, frame_period_s=L5_MSG_S, n_svs=4,
        duration_s=26.0, cn0_dbhz=50.0, prn_pool=range(1, 13))
    samples = quantize_iq_int8(
        synthesize_if(cfg, sig, scn.svs, num_ms=26_400, seed=11))
    return scn, samples, time.perf_counter() - t0


def pvt_pilot(card: str, made):
    from cusdr_tpu_torch.receiver import Receiver
    cfg = _l5_config()
    scn, samples, made_s = made
    log(f"[pvt-l5] scene: 4 SVs, {len(samples) // 2} samples at "
        f"{cfg.sampling_freq / 1e6:g} Msps, made in {made_s:.1f} s")
    res = Receiver(cfg, "cuda").run(samples)
    _check_fixes("pvt-l5", card, scn, res, "test_e2e_l5c", 5, 20.0, 60.0)


def _kernel_json(name, launches, checks):
    """One kernel variant's entry of the JSON line: ``ms``/``plain_ms`` at
    the first shape listed for it (its path's, preset tap mode), every
    shape and tap mode under ``shapes``."""
    first = checks[0]["rows"][True]
    # ms / plain_ms: device time per call (torch.profiler), or the wall
    # time per wrapper call where the trace held no device time
    on_device = (first["device_ms"] is not None
                 and first["plain_device_ms"] is not None)
    shapes = [dict(shape=(f"{c['label']}: {c['n_ch']} x {c['blk']}, "
                          f"k={c['k']}, interp_taps={interp}"),
                   max_abs_err=r["err"], tol=r["tol"],
                   ms=r["device_ms"], plain_ms=r["plain_device_ms"],
                   wrapper_ms=r["wrapper_ms"],
                   plain_wrapper_ms=r["plain_wrapper_ms"])
              for c in checks for interp, r in c["rows"].items()]
    return {
        "name": name, "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "launches": launches,
        "max_abs_err": max(s["max_abs_err"] for s in shapes),
        "ms": first["device_ms"] if on_device else first["wrapper_ms"],
        "plain_ms": (first["plain_device_ms"] if on_device
                     else first["plain_wrapper_ms"]),
        "ms_from": ("torch.profiler device time" if on_device
                    else "CUDA events per wrapper call"),
        "wrapper_ms": first["wrapper_ms"],
        "plain_wrapper_ms": first["plain_wrapper_ms"],
        "shapes": shapes}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    if not (ROOT / "cusdr_tpu_torch" / "ops" / "csrc").is_dir():
        print(f"chip_smoke: no cusdr_tpu_torch package beside {__file__}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    t_start = time.perf_counter()
    # the scenes of phases 4-8 (up to a few minutes of numpy each) are made
    # in worker processes, one each, while phases 1-3 run; all are
    # finished before phase 4, so no scene work overlaps a receiver run
    pool = ProcessPoolExecutor(
        max_workers=5, mp_context=multiprocessing.get_context("spawn"))
    try:
        jobs = dict(main=pool.submit(scene_job, *MAIN_SCENE),
                    pvt=pool.submit(pvt_scene_job),
                    e5a=pool.submit(scene_job, *E5A_SCENE),
                    b1c=pool.submit(scene_job, *B1C_SCENE),
                    l5=pool.submit(l5_scene_job))
        smi = environment()
        build()
        checks = {"correlate_bank": [
            kernel_check("gps_l1ca", 12, 18008, 9, 0)]}
        for name, label, n_ch, blk, k in PILOT_SHAPES:
            n_pilots = 2 if name == "correlate_bank_dual_pilot" else 1
            checks.setdefault(name, []).append(
                kernel_check(label, n_ch, blk, k, n_pilots))
        t0 = time.perf_counter()
        scenes = {name: job.result() for name, job in jobs.items()}
        log(f"[scenes] waited {time.perf_counter() - t0:.1f} s for the "
            "scenes of phases 4-8")
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    launches = {"correlate_bank": main_path(smi, scenes["main"])}
    pvt(smi, scenes["pvt"])
    launches["correlate_bank_pilot"] = pilot_path(smi, scenes["e5a"])
    launches["correlate_bank_dual_pilot"] = dual_pilot_path(smi,
                                                            scenes["b1c"])
    pvt_pilot(smi, scenes["l5"])
    log(f"[done] all phases in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [
        _kernel_json(name, launches[name], checks[name])
        for name in checks]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
