#!/usr/bin/env python3
"""Smoke run of the PyTorch port (cusdr_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run when it fails:

1. environment: the card, its power limit, CUDA and nvcc versions;
2. build the CUDA correlators from cusdr_tpu_torch/ops/csrc/correlator.cu
   and correlator_staged.cu (one nvcc each, started together);
3. the fetch kernel against its plain PyTorch version at the main path's
   shapes (12 channels, and the 96 rows of eight time blocks, blk = 18 008
   samples, k = 9, both tap modes, some windows clamped at the record's
   end), with both times and the card's bound for the same work;
3b. the pilot and dual-pilot variants against the plain version at the
   shapes of their paths (gal_e5a 12 x 18 008 k = 1, gal_e1c 12 x 72 008
   k = 5, bds_b1c WB 15 x 180 008 k = 1), both tap modes, windows clamped
   at the record's, the code table's and the pilot table's ends, with
   both times;
3c. the staged-window kernels against their plain versions: the u.v
   carrier (no pilot at gps_l1ca 12 and 96 x 18 008 k = 9, pilot at gal_e1c
   12 x 72 008 k = 5, dual pilot at bds_b1c WB 15 x 180 008, both tap
   modes), the phase-ramp and the table carrier (12 and 96 x 18 008), and
   the 500-epoch loops of cusdr_tpu_torch/tools/perf_correlator.py;
3d. the per-epoch profile of ``track_superblock`` (launches, wall, device
   and correlator time, idle share) from
   cusdr_tpu_torch/runtime/profiling.py, for the 12-row bank of each path
   and the 96-row time-parallel bank, fetched and staged;
4. the main path at the gps_l1ca preset's full width (18 Msps, 12
   channels, 32 PRNs x 29 Doppler bins x 20 ms): ``Receiver.run`` on four
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
   bounds;
9. time-parallel tracking at full width: phase 4's record through
   ``Receiver.run`` with ``time_blocks=8`` (a 96-row flat bank, two
   passes): every channel in lock over each block's tail, prompt signs as
   the sequential run's across every block boundary, launches = epochs per
   block x passes, all of the fetch kernel; then the same record through
   the per-block path (staged windows), and the pilot and dual-pilot
   staged variants on the records of phases 6 and 7 (two blocks each);
10. time-parallel PVT: phase 5's scene with ``time_blocks=8``; fixes
   within phase 5's bounds.

The scenes of phases 4-10 are made in five worker processes while the
kernel checks of phases 1-3c run, and are all finished before the
host-bound measurements (the 500-epoch loops, phase 3d) and phase 4
start.

Prints a JSON line with each kernel's numbers (launches on its path, error
against the plain version, device time, the plain version's, the card's
bound for the same work), the card's name and power limit, and last
``{"ok": true, "device": {...}}``.  Exits non-zero without a CUDA card, and
outside a checkout of the repository.  Imports no jax and nothing of
cusdr_tpu.
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
_CSRC = "cusdr_tpu_torch/ops/csrc/"
# kernel: (source, the TPU kernel it replaces, its name in a trace)
KERNELS = {
    "correlate_bank": (
        _CSRC + "correlator.cu", "cusdr_tpu/ops/correlator.py:563",
        "correlate_bank_kernel"),
    "correlate_windows": (
        _CSRC + "correlator_staged.cu", "cusdr_tpu/ops/correlator.py:237",
        "correlate_windows_kernel"),
    "correlate_windows_ramp": (
        _CSRC + "correlator_staged.cu", "tools/perf_pallas.py:30",
        "correlate_windows_ramp_kernel"),
    "correlate_windows_table": (
        _CSRC + "correlator_staged.cu", "tools/perf_pallas.py:208",
        "correlate_windows_table_kernel"),
}
for _base in ("correlate_bank", "correlate_windows"):
    for _suffix in ("_pilot", "_dual_pilot"):
        KERNELS[_base + _suffix] = KERNELS[_base]
# the card's published peaks (H100 SXM): device memory and f32 outside the
# tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# phases 3-3c: (kernel, the path it stands for, rows, blk, k); the first
# shape listed for a kernel is the one its ``ms`` is reported at
SHAPES = (
    ("correlate_bank", "gps_l1ca", 12, 18008, 9),
    ("correlate_bank", "gps_l1ca time_blocks=8", 96, 18008, 9),
    ("correlate_bank_pilot", "gal_e5a", 12, 18008, 1),
    ("correlate_bank_pilot", "gal_e1c", 12, 72008, 5),
    ("correlate_bank_dual_pilot", "bds_b1c WB", 15, 180008, 1),
    ("correlate_windows", "gps_l1ca", 12, 18008, 9),
    ("correlate_windows", "gps_l1ca time_blocks=8", 96, 18008, 9),
    ("correlate_windows_pilot", "gal_e1c", 12, 72008, 5),
    ("correlate_windows_dual_pilot", "bds_b1c WB", 15, 180008, 1),
    ("correlate_windows_ramp", "gps_l1ca", 12, 18008, 9),
    ("correlate_windows_ramp", "gps_l1ca time_blocks=8", 96, 18008, 9),
    ("correlate_windows_table", "gps_l1ca time_blocks=8", 96, 18008, 9),
    ("correlate_windows_table", "gps_l1ca", 12, 18008, 9),
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
    """Build both kernel sources, one nvcc each, started together."""
    from concurrent.futures import ThreadPoolExecutor
    from cusdr_tpu_torch.ops import correlator
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(correlator.SOURCES)) as threads:
        list(threads.map(correlator.load_library, correlator.SOURCES))
    sec = time.perf_counter() - t0
    logs = sorted(correlator.BUILD_DIR.glob("*.log"))
    regs = [ln.strip() for p in logs for ln in p.read_text().splitlines()
            if "registers" in ln or "spill" in ln or "Compiling" in ln]
    log(f"[build] {', '.join(n + '.cu' for n in correlator.SOURCES)} built "
        f"and loaded in {sec:.2f} s")
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
    last three windows run off its end), tables of blk + 2 * 1024 (banks of
    more than 15 rows share 12 table rows by row modulo, as the
    time-parallel bank does).  With pilot banks, a pilot table of the same
    length at its own starts and fractions; one code-table and two
    pilot-table windows run off their tables' ends.  All are clamped by the
    wrapper.  Returns (args, keywords, carrier steps in cycles/sample)."""
    import numpy as np
    import torch
    dev = torch.device("cuda")
    n_samp = 1_000 * 18_000
    n_tab = n_ch if n_ch <= 15 else 12
    table_len = blk + 2 * 1024
    iq = torch.from_numpy(rng.integers(-16, 17, 2 * n_samp).astype(
        np.int8)).to(dev)
    table = torch.from_numpy(rng.choice(np.array([-1, 1], np.int8),
                                        (n_tab, table_len))).to(dev)
    off = rng.integers(0, n_samp - blk, n_ch)
    off[-3:] = [n_samp - blk, n_samp - blk + 5, n_samp + 100]  # clamped
    start = rng.integers(1024 - k - 1, 1024 - k + 2, n_ch)
    if n_pilots:
        start[-3] = table_len                                # clamped
    inc = (20e3 + rng.uniform(-7e3, 7e3, n_ch)) / 18e6

    def t(x, dt):
        return torch.as_tensor(np.asarray(x), dtype=dt, device=dev)

    f32, i64 = torch.float32, torch.int64
    args = (iq, t(off, i64), table, torch.arange(n_ch, device=dev) % n_tab,
            t(start, i64), t(rng.uniform(0, 1, n_ch), f32),
            t(rng.uniform(0, 1, n_ch), f32),
            t(np.mod(inc * 128, 1.0), f32), t(np.mod(inc, 1.0), f32),
            t(blk - rng.integers(0, 9, n_ch), i64))
    kw = dict(k=k, blk=blk)
    if n_pilots:
        shape = (n_tab, table_len) if n_pilots == 1 \
            else (n_tab, 2, table_len)
        pstart = rng.integers(0, table_len - blk - 2 * k - 1, n_ch)
        pstart[-2:] = [table_len - blk, -3]                  # clamped
        kw.update(
            ptable=t(rng.choice(np.array([-1, 1], np.int8), shape),
                     torch.int8),
            pstart=t(pstart, i64), palpha=t(rng.uniform(0, 1, n_ch), f32),
            pilot_rot=3 if n_pilots == 2 else 1, pilot2_rot=2,
            pilot_w1=float(np.sqrt(29 / 33)) if n_pilots == 2 else 1.0,
            pilot_w2=float(np.sqrt(4 / 33)) if n_pilots == 2 else 0.0)
    return args, kw, inc


def bound(name, n_ch, blk, k, n_valid, interp):
    """The least time the card could take for one call: the larger of the
    bytes the function must move over the card's memory rate and its f32
    operations over the card's f32 peak.

    Bytes, each input read once and the output written once: 2 per sample
    of every row's sample window, 1 per replica window element (blk + 2k +
    1 per row and bank), the per-row scalars (8 per int64, 4 per f32), 8
    per sample of the table carrier's f32 basis tables, and 32 or 64 per
    output row.  Operations, per valid sample of this call's inputs
    (``n_valid`` = the rows' bsz summed): 6 to make the carrier (u.v: a
    complex product; ramp: two products, two sums, a floor and a sincos
    counted as one each; table: a complex product), 6 to wipe it off, and
    per replica bank 12 for the six products and sums plus 9 for three
    interpolated taps; u.v adds 4 per carrier factor (blk / 128 + 128 per
    row).  Returns (milliseconds, "bytes" or "operations", bytes, ops)."""
    n_pilots = 2 if "dual" in name else 1 if "pilot" in name else 0
    banks = 1 + n_pilots
    win = blk + 2 * k + 1
    staged = name.startswith("correlate_windows")
    # fetch kernel: off, wrow, start, bsz + alpha, remc, shi, slo (+ pstart,
    # palpha); staged: bsz + four f32 (+ palpha); table: bsz + three f32
    scalars = ((8 + 16 + (4 if n_pilots else 0)) if staged
               else (32 + 16 + (12 if n_pilots else 0)))
    n_bytes = n_ch * (2 * blk + banks * win + scalars
                      + (64 if n_pilots else 32))
    ops = n_valid * (12 + banks * (12 + (9 if interp else 0)))
    if name.endswith("_table"):
        n_bytes += n_ch * blk * 8 - n_ch * 4
    elif not name.endswith("_ramp"):
        ops += n_ch * 4 * ((blk + 127) // 128 + 128)
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_F32_FLOPS * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", n_bytes, ops)


def _kernel_calls(name, args, kw, inc):
    """(kernel call, plain call) of ``name`` on the bank inputs, each taking
    ``interp_taps``; the staged kernels get their windows staged once,
    outside the timed calls."""
    import numpy as np
    import torch
    from cusdr_tpu_torch.ops import correlator as corr
    if name.startswith("correlate_bank"):
        return (lambda i: corr.correlate_bank(*args, interp_taps=i, **kw),
                lambda i: corr.correlate_bank_plain(*args, interp_taps=i,
                                                    **kw))
    iq, off, table, wrow, start, alpha, remc, shi, slo, bsz = args
    siq, wt, wp = corr.stage_windows(iq, off, table, wrow, start,
                                     k=kw["k"], blk=kw["blk"],
                                     ptable=kw.get("ptable"),
                                     pstart=kw.get("pstart"))
    k = kw["k"]
    if name.endswith("_ramp"):
        shi256 = torch.as_tensor(np.mod(inc * 256, 1.0),
                                 dtype=torch.float32, device=iq.device)
        scal = (siq, wt, alpha, remc, shi256, slo, bsz)
        return (lambda i: corr.correlate_windows_ramp(*scal, k=k),
                lambda i: corr.correlate_windows_ramp_plain(*scal, k=k))
    if name.endswith("_table"):
        ph = 2 * np.pi * inc[:, None] * np.arange(kw["blk"])[None, :]
        f32 = dict(dtype=torch.float32, device=iq.device)
        scal = (siq, wt, torch.as_tensor(np.cos(ph), **f32),
                torch.as_tensor(np.sin(ph), **f32), alpha,
                torch.cos(remc * 6.2831855), torch.sin(remc * 6.2831855),
                bsz)
        return (lambda i: corr.correlate_windows_table(*scal, k=k),
                lambda i: corr.correlate_windows_table_plain(*scal, k=k))
    pkw = dict(k=k, wp=wp, palpha=kw.get("palpha"),
               **{n: v for n, v in kw.items() if n.startswith("pilot")})
    scal = (siq, wt, alpha, remc, shi, slo, bsz)
    return (lambda i: corr.correlate_windows(*scal, interp_taps=i, **pkw),
            lambda i: corr.correlate_windows_plain(*scal, interp_taps=i,
                                                   **pkw))


def kernel_check(name, label, n_ch, blk, k, seed=0):
    """One kernel against its plain version on the same CUDA tensors, in
    its tap modes (the ramp and table carriers have interpolated taps
    only), with its device time (torch.profiler), its wall time per
    wrapper call (CUDA events) beside the plain version's, and the card's
    bound for the same work."""
    import numpy as np
    import torch
    n_pilots = 2 if "dual" in name else 1 if "pilot" in name else 0
    rng = np.random.default_rng(seed)
    args, kw, inc = _bank_inputs(rng, n_ch, blk, k, n_pilots)
    call, call_plain = _kernel_calls(name, args, kw, inc)
    n_valid = int(args[9].clamp(0, blk).sum().item())
    n_out = 16 if n_pilots else 8
    both = not name.endswith(("_ramp", "_table"))
    rows = {}
    for interp in ((True, False) if both else (True,)):
        got = call(interp)
        want = call_plain(interp)
        torch.cuda.synchronize()
        if got.shape != (n_ch, n_out) or not torch.isfinite(got).all():
            raise AssertionError(f"{name} {label}: kernel output "
                                 f"{tuple(got.shape)} not finite "
                                 f"[{n_ch}, {n_out}]")
        err = (got - want).abs().max().item()
        tol = KERNEL_RTOL * (want.abs().max().item() + 1.0)
        if not err <= tol:
            raise AssertionError(f"{name} {label}: kernel disagrees with "
                                 f"plain version (interp_taps={interp}): "
                                 f"{err} > {tol}")

        def kern():
            call(interp)

        def plain():
            call_plain(interp)

        # wall time per wrapper call, host work included: alternate plain,
        # kernel, kernel, plain on the same card
        p1, k1, k2, p2 = (_timed(f, N_TIMED)
                          for f in (plain, kern, kern, plain))
        b_ms, b_by, n_bytes, ops = bound(name, n_ch, blk, k, n_valid, interp)
        row = dict(err=err, tol=tol, wrapper_ms=(k1 + k2) / 2,
                   plain_wrapper_ms=(p1 + p2) / 2,
                   device_ms=_device_ms(kern, KERNELS[name][2]),
                   plain_device_ms=_device_ms(plain),
                   bound_ms=b_ms, bound_by=b_by, bytes=n_bytes, ops=ops)
        rows[interp] = row
        tag = f"[kernel] {name} {label} {n_ch} x {blk}, interp_taps={interp}"
        log(f"{tag}: max|kernel-plain|={err:.3e} <= {tol:.3e}")
        log(f"{tag}: device time per call (torch.profiler): kernel "
            f"{_fmt_ms(row['device_ms'])}, plain "
            f"{_fmt_ms(row['plain_device_ms'])}; bound {b_ms:.6f} ms by "
            f"{b_by} ({n_bytes} bytes, {ops} operations)")
        log(f"{tag}: wall time per wrapper call (CUDA events, mean of "
            f"{N_TIMED}): kernel {row['wrapper_ms']:.4f} ms ({k1:.4f}, "
            f"{k2:.4f}), plain {row['plain_wrapper_ms']:.4f} ms "
            f"({p1:.4f}, {p2:.4f})")
    return dict(name=name, label=label, n_ch=n_ch, blk=blk, k=k, rows=rows)


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
    from cusdr_tpu_torch.io.synth import (SynthSV, quantize_iq_int8,
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
    from cusdr_tpu_torch.signals.defs import get_signal
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
    launches of ``variant`` and the receiver's results."""
    import numpy as np
    import torch
    from cusdr_tpu_torch.signals.defs import get_signal
    from cusdr_tpu_torch.ops.correlator import LAUNCHES, reset_launches
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
    launches = dict(LAUNCHES)
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
    return launches[variant], res


# four seconds: phase 9 tracks the same record as 8 blocks of ~500 epochs
MAIN_SCENE = ("gps_l1ca", {}, [1, 3, 6, 8, 11, 13, 17, 19, 22, 24, 28, 31],
              4.0)
TIME_BLOCKS = 8
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


def _block_tails_locked(tag, trk, tail, pilot=False):
    """mean|I_P| / std(Q_P) over the last ``tail`` epochs of every block
    and channel (and the pilot prompt's with ``pilot``): all above 3."""
    import numpy as np
    epb = trk.epochs_per_block
    worst = np.inf
    for i, q in [("i_p", "q_p")] + ([("pilot_ip", "pilot_qp")] if pilot
                                    else []):
        for b in range(trk.n_blocks):
            sl = slice((b + 1) * epb - tail, (b + 1) * epb)
            snr = (np.abs(getattr(trk, i)[:, sl]).mean(axis=1)
                   / getattr(trk, q)[:, sl].std(axis=1))
            worst = min(worst, float(snr.min()))
            if not (snr > 3.0).all():
                raise AssertionError(f"[{tag}] block {b}: mean|{i}|/std({q})"
                                     f" {snr} over its last {tail} epochs")
    if not all(st == "T" for st in trk.status):
        raise AssertionError(f"[{tag}] status {trk.status}")
    return worst


def _signs_as_sequential(tag, trk, seq):
    """The stitched prompt stream has the sequential run's bit signs in
    every block: per channel and block, the share of epochs whose I_P sign
    equals the sequential run's is above 99 % (or below 1 % in every
    block, were block 0 itself locked half a cycle away).  Returns the
    lowest share."""
    import numpy as np
    row = {prn: c for c, prn in enumerate(seq.prns)}
    epb = trk.epochs_per_block
    n = min(trk.i_p.shape[1], seq.i_p.shape[1]) // epb * epb
    worst = 1.0
    for c, prn in enumerate(trk.prns):
        same = (np.sign(trk.i_p[c, :n]) == np.sign(seq.i_p[row[prn], :n]))
        share = same.reshape(-1, epb).mean(axis=1)
        if share[0] < 0.5:
            share = 1.0 - share
        worst = min(worst, float(share.min()))
        if not (share > 0.99).all():
            raise AssertionError(f"[{tag}] PRN {prn}: sign agreement with "
                                 f"the sequential run per block {share}")
    return worst


def _only(tag, launches, variant, want):
    """``launches`` holds ``want`` launches of ``variant`` and none of any
    other kernel."""
    others = {k: v for k, v in launches.items() if k != variant and v}
    if others or launches[variant] != want:
        raise AssertionError(f"[{tag}] {launches[variant]} {variant} "
                             f"launches for {want} epoch steps; other "
                             f"kernels: {others}")


def time_parallel_path(card: str, made, seq_res):
    """Phase 9 on the main path's record: ``Receiver.run`` with
    ``time_blocks=8`` (flat bank, fetch kernel), then the per-block path
    (staged kernel) through ``track_time_parallel``.  Returns the launches
    of (correlate_bank, correlate_windows)."""
    import torch
    from cusdr_tpu_torch import get_config
    from cusdr_tpu_torch.ops.correlator import LAUNCHES, reset_launches
    from cusdr_tpu_torch.parallel.timeblocks import track_time_parallel
    from cusdr_tpu_torch.receiver import Receiver
    from cusdr_tpu_torch.signals.defs import get_signal
    cfg = get_config("gps_l1ca", time_blocks=TIME_BLOCKS)
    sig = get_signal("gps_l1ca")
    svs, iq, _ = made
    passes = cfg.handoff_iters + 1
    rx = Receiver(cfg, "cuda")
    torch.cuda.synchronize()
    reset_launches()
    res = rx.run(iq)
    launches = dict(LAUNCHES)
    trk = res.track
    n_ep, epb = trk.i_p.shape[1], trk.epochs_per_block
    if trk.n_blocks != TIME_BLOCKS or n_ep != TIME_BLOCKS * epb:
        raise AssertionError(f"[tp] {trk.n_blocks} blocks x {epb} epochs "
                             f"for {n_ep} epochs")
    _only("tp", launches, "correlate_bank", epb * passes)
    check_main(cfg, svs, res, None, tail_epochs=200)
    worst_snr = _block_tails_locked("tp", trk, 200)
    share = _signs_as_sequential("tp", trk, seq_res.track)
    rec_s = n_ep * sig.code_period_ms * 1e-3
    seq_n = seq_res.track.i_p.shape[1]
    seq_rt = (seq_n * sig.code_period_ms * 1e-3
              / seq_res.timings["tracking_s"])
    flat_s = res.timings["tracking_s"]
    log(f"[tp] flat bank on {card}: {TIME_BLOCKS} blocks x "
        f"{len(res.channels)} channels = {TIME_BLOCKS * len(res.channels)} "
        f"rows x {epb} epochs x {passes} passes in {flat_s:.3f} s = "
        f"{rec_s / flat_s:.3f}x real time "
        f"({flat_s / (epb * passes) * 1e3:.3f} ms per epoch step), "
        f"{launches['correlate_bank']} correlate_bank launches; lowest "
        f"block-tail mean|I_P|/std(Q_P) {worst_snr:.1f}; lowest per-block "
        f"sign agreement with the sequential run {share:.4f}")

    # the per-block path: staged windows, on the record's first two seconds
    n_short = TIME_BLOCKS * 250
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    trk_b = track_time_parallel(cfg, sig, iq, res.channels, n_short,
                                TIME_BLOCKS, device="cuda",
                                fetch_in_kernel=False)
    blocks_s = time.perf_counter() - t0
    launches_b = dict(LAUNCHES)
    _only("tp-blocks", launches_b, "correlate_windows", 250 * passes)
    worst_b = _block_tails_locked("tp-blocks", trk_b, 100)
    share_b = _signs_as_sequential("tp-blocks", trk_b, seq_res.track)
    log(f"[tp-blocks] per-block path on {card}: {TIME_BLOCKS} blocks x "
        f"{len(res.channels)} channels x 250 epochs x {passes} passes in "
        f"{blocks_s:.3f} s = {n_short * 1e-3 / blocks_s:.3f}x real time "
        f"({blocks_s / (250 * passes) * 1e3:.3f} ms per epoch step), "
        f"{launches_b['correlate_windows']} correlate_windows launches; "
        f"lowest block-tail mean|I_P|/std(Q_P) {worst_b:.1f}; lowest "
        f"per-block sign agreement {share_b:.4f}")
    log(f"[tp] real-time factors on {card}: sequential {seq_rt:.3f}x "
        f"({seq_n} epochs), flat time_blocks={TIME_BLOCKS} "
        f"{rec_s / flat_s:.3f}x ({n_ep} epochs), per-block "
        f"{n_short * 1e-3 / blocks_s:.3f}x ({n_short} epochs)")
    return launches["correlate_bank"], launches_b["correlate_windows"]


def staged_pilot_path(card, tag, cfg, made, res, variant, epb, tail):
    """The per-block path on a pilot signal: two blocks of ``epb`` epochs
    of the record ``made`` on the channels ``res`` acquired, through
    ``track_time_parallel`` with staged windows.  Returns the launches of
    ``variant``."""
    import torch
    from cusdr_tpu_torch.ops.correlator import LAUNCHES, reset_launches
    from cusdr_tpu_torch.parallel.timeblocks import track_time_parallel
    from cusdr_tpu_torch.signals.defs import get_signal
    sig = get_signal(cfg.signal)
    passes = cfg.handoff_iters + 1
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    trk = track_time_parallel(cfg, sig, made[1], res.channels, 2 * epb, 2,
                              device="cuda", fetch_in_kernel=False)
    sec = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    _only(tag, launches, variant, epb * passes)
    worst = _block_tails_locked(tag, trk, tail, pilot=True)
    rec_s = 2 * epb * sig.code_period_ms * 1e-3
    log(f"[{tag}] per-block path on {card}: 2 blocks x "
        f"{len(res.channels)} channels x {epb} epochs of "
        f"{sig.code_period_ms:g} ms x {passes} passes in {sec:.3f} s = "
        f"{rec_s / sec:.3f}x real time, {launches[variant]} {variant} "
        f"launches; lowest block-tail prompt SNR (data and pilot) "
        f"{worst:.1f}")
    return launches[variant]


def pvt_time_parallel(card: str, made):
    """Phase 10: phase 5's scene with time_blocks=8."""
    from cusdr_tpu_torch.ops.correlator import LAUNCHES, reset_launches
    from cusdr_tpu_torch.receiver import Receiver
    scn, samples, _ = made
    cfg = _pvt_config().replace(time_blocks=TIME_BLOCKS)
    reset_launches()
    res = Receiver(cfg, "cuda").run(samples)
    _only("pvt-tp", dict(LAUNCHES), "correlate_bank",
          res.track.epochs_per_block * (cfg.handoff_iters + 1))
    if res.track.n_blocks != TIME_BLOCKS or res.track.settle_epochs != 0:
        raise AssertionError("[pvt-tp] not an exactly stitched 8-block run")
    _check_fixes("pvt-tp", card, scn, res, "test_e2e_timeparallel", 60,
                 15.0, 50.0)


def profiles(card: str):
    """Phase 3d: the per-epoch profile of ``track_superblock`` for each
    path's bank (cusdr_tpu_torch/runtime/profiling.py)."""
    from cusdr_tpu_torch import get_config
    from cusdr_tpu_torch.runtime.profiling import (format_profile,
                                                   profile_epochs)
    out = []
    for cfg, n_blocks, fetch in (
            (get_config("gps_l1ca"), 1, True),
            (get_config("gps_l1ca"), TIME_BLOCKS, True),
            (get_config("gps_l1ca"), TIME_BLOCKS, False),
            (get_config("gal_e5a"), 1, True),
            (get_config("bds_b1c", **B1C_WB), 1, True)):
        p = profile_epochs(cfg, "cuda", n_blocks=n_blocks, n_epochs=20,
                           fetch_in_kernel=fetch)
        log(f"[profile] on {card}: {format_profile(p)}")
        out.append(p)
    return out


def perf_tool(card: str):
    """The 500-epoch loops of tools/perf_correlator.py, with the launch
    counts set to 0 before them; returns the launches of
    (correlate_windows_ramp, correlate_windows_table) in the timed loops
    and the tool's results."""
    from cusdr_tpu_torch.ops.correlator import LAUNCHES, reset_launches
    from cusdr_tpu_torch.tools import perf_correlator
    import torch
    dev = torch.device("cuda")
    reset_launches()
    results = [perf_correlator.bench_ramp(dev),
               perf_correlator.bench_table(dev)]
    launches = dict(LAUNCHES)
    for r in results:
        log(f"[perf_correlator] on {card}: "
            f"{perf_correlator.report(r, dev)}")
        # one launch outside the loops: the comparison with the plain version
        if not 0 < r["loop_launches"] == launches[r["name"]] - 1:
            raise AssertionError(f"[perf_correlator] {r['name']}: "
                                 f"{r['loop_launches']} launches in the "
                                 f"loops, {launches[r['name']]} counted")
    others = {k: v for k, v in launches.items()
              if v and k not in (r["name"] for r in results)}
    if others:
        raise AssertionError(f"[perf_correlator] other kernels ran: "
                             f"{others}")
    return results


def _pvt_config():
    from cusdr_tpu_torch import get_config
    return get_config("gps_l1ca", sampling_freq=2.048e6, if_freq=7000.0,
                      acq_satellite_list=tuple(range(1, 33)),
                      acq_non_coh_time=12, use_trop_corr=False,
                      ms_to_process=40_000)


def pvt_scene_job():
    """The L1 C/A PVT scene, made in a worker process of the scene pool.
    Returns (scenario, int8 I/Q, seconds it took)."""
    from cusdr_tpu_torch.io.scenario import make_gps_scenario
    from cusdr_tpu_torch.io.synth import quantize_iq_int8, synthesize_if
    from cusdr_tpu_torch.signals.defs import get_signal
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
    from cusdr_tpu_torch.nav import cnav
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
    from cusdr_tpu_torch.io.scenario import make_generic_scenario
    from cusdr_tpu_torch.io.synth import quantize_iq_int8, synthesize_if
    from cusdr_tpu_torch.orbits.cnav_kepler import sat_pos_cnav
    from cusdr_tpu_torch.signals.defs import get_signal
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
    """One kernel's entry of the JSON line: ``ms`` / ``plain_ms`` /
    ``bound_ms`` at the first shape listed for it (its path's, the preset's
    tap mode), every shape and tap mode under ``shapes``."""
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
                   plain_wrapper_ms=r["plain_wrapper_ms"],
                   bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                   bytes=r["bytes"], operations=r["ops"])
              for c in checks for interp, r in c["rows"].items()]
    source, replaces, _ = KERNELS[name]
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches,
        "max_abs_err": max(s["max_abs_err"] for s in shapes),
        "ms": first["device_ms"] if on_device else first["wrapper_ms"],
        "plain_ms": (first["plain_device_ms"] if on_device
                     else first["plain_wrapper_ms"]),
        "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
        # no single PyTorch call computes these sums
        "library_ms": None,
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
    # the scenes of phases 4-10 (up to a few minutes of numpy each) are made
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
        checks = {}
        for shape in SHAPES:
            checks.setdefault(shape[0], []).append(kernel_check(*shape))
        t0 = time.perf_counter()
        scenes = {name: job.result() for name, job in jobs.items()}
        log(f"[scenes] waited {time.perf_counter() - t0:.1f} s for the "
            "scenes of phases 4-10")
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    # host-bound measurements run with no scene work beside them
    tool = perf_tool(smi)
    launches = {r["name"]: r["loop_launches"] for r in tool}
    profiled = profiles(smi)
    from cusdr_tpu_torch import get_config
    launches["correlate_bank"], seq_res = main_path(smi, scenes["main"])
    pvt(smi, scenes["pvt"])
    launches["correlate_bank_pilot"], e5a_res = pilot_path(smi,
                                                           scenes["e5a"])
    launches["correlate_bank_dual_pilot"], b1c_res = dual_pilot_path(
        smi, scenes["b1c"])
    pvt_pilot(smi, scenes["l5"])
    tp_bank, launches["correlate_windows"] = time_parallel_path(
        smi, scenes["main"], seq_res)
    launches["correlate_windows_pilot"] = staged_pilot_path(
        smi, "e5a-blocks", get_config("gal_e5a"), scenes["e5a"], e5a_res,
        "correlate_windows_pilot", epb=500, tail=200)
    launches["correlate_windows_dual_pilot"] = staged_pilot_path(
        smi, "b1c-wb-blocks", get_config("bds_b1c", **B1C_WB),
        scenes["b1c"], b1c_res, "correlate_windows_dual_pilot", epb=100,
        tail=50)
    pvt_time_parallel(smi, scenes["pvt"])
    missing = [name for name in checks if not launches.get(name)]
    if missing:
        raise AssertionError(f"kernels never launched on their path: "
                             f"{missing}")
    log(f"[done] all phases in {time.perf_counter() - t_start:.1f} s")
    kernels = [_kernel_json(name, launches[name], checks[name])
               for name in checks]
    kernels[0]["launches_time_parallel"] = tp_bank
    print(json.dumps({"perf_correlator": tool, "profiles": profiled}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
