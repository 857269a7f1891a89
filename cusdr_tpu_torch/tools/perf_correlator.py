"""The staged-window correlators with a phase-ramp and a table carrier
against their plain versions, and a 500-epoch loop of each.

    python -m cusdr_tpu_torch.tools.perf_correlator --device cuda

Counterpart of tools/perf_pallas.py (``main`` and ``bench_table_carrier``):
gps_l1ca inputs made from a seed — a random int8 record of 506 code periods,
the preset's replica tables, channels 500 Hz apart — one epoch through
``correlate_windows_ramp`` (12 rows) and ``correlate_windows_table`` (96
rows) held against the plain PyTorch versions and a numpy f64 sum of row 0's
prompt, then 500 epochs in which every epoch stages its windows (offsets
advancing one code period) and launches the kernel, as the reference's scan
does.  Times are CUDA-event times on a card (host-clock times on the CPU,
where the wrappers run their plain versions), three repeats after a
warm-up.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import get_config, resolve_device
from ..ops import correlator as corr
from ..signals.defs import get_signal
from ..tracking import engine

RTOL = 1e-4         # |kernel - plain| <= RTOL * (max|plain| + 1)
N_EPOCHS = 500


def _loop_ms(step, n_epochs: int, device, repeats: int = 3):
    """Milliseconds per repeat of ``n_epochs`` calls of ``step(e)``."""
    def once():
        for e in range(n_epochs):
            step(e)

    once()
    times = []
    if device.type == "cuda":
        for _ in range(repeats):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            once()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
    else:
        for _ in range(repeats):
            t0 = time.perf_counter()
            once()
            times.append((time.perf_counter() - t0) * 1e3)
    return times


def _inputs(device, n_rows: int, seed: int, n_epochs: int):
    cfg = get_config("gps_l1ca")
    sig = get_signal("gps_l1ca")
    params = engine.make_track_params(cfg, sig)
    spc, blk, k = cfg.samples_per_code, params.blk, params.k_spacing
    rng = np.random.default_rng(seed)
    n_samp = (n_epochs + 6) * spc
    iq = torch.from_numpy(
        rng.integers(-16, 16, 2 * n_samp).astype(np.int8)).to(device)
    n_tab = min(n_rows, 12)
    channels = [(1 + j, cfg.if_freq + 500.0 * (j - 6), 149 * j)
                for j in range(n_tab)]
    dops = [c[1] - cfg.if_freq for c in channels]
    ctabs, _ = engine.build_replica_tables(cfg, sig, params, channels, dops)
    freqs = cfg.if_freq + 500.0 * (np.arange(n_rows) % 12 - 6)

    def t(x, dt):
        return torch.as_tensor(np.asarray(x), dtype=dt, device=device)

    f32, i64 = torch.float32, torch.int64
    return dict(
        cfg=cfg, blk=blk, k=k, spc=spc, iq=iq, inc_c=freqs / cfg.sampling_freq,
        table=torch.from_numpy(ctabs).to(device),
        wrow=t(np.arange(n_rows) % n_tab, i64),
        off=t(np.arange(n_rows) * 149, i64),
        start=t(np.full(n_rows, engine.UP_MARGIN - k), i64),
        alpha=t(np.full(n_rows, 0.3), f32), remc=t(np.full(n_rows, 0.1), f32),
        bsz=t(np.full(n_rows, spc), i64))


def _stage(d, epoch: int):
    siq, wt, _ = corr.stage_windows(d["iq"], d["off"] + epoch * d["spc"],
                                    d["table"], d["wrow"], d["start"],
                                    k=d["k"], blk=d["blk"])
    return siq, wt


def _numpy_prompt(d, siq, wt, cosw, sinw):
    """Row 0's prompt I sum in numpy f64 from the staged windows and the
    carrier given as f64 cos/sin."""
    k, n = d["k"], int(d["bsz"][0])
    s = siq[0, :n].cpu().numpy().astype(np.float64)
    w = wt[0].cpu().numpy().astype(np.float64)
    a, b = w[k:k + n], w[k + 1:k + 1 + n]
    prompt = a + float(d["alpha"][0]) * (b - a)
    return float(np.sum(prompt * (s[:, 0] * cosw[:n] + s[:, 1] * sinw[:n])))


def _check(name, got, want, ref_prompt):
    err = (got - want).abs().max().item()
    tol = RTOL * (want.abs().max().item() + 1.0)
    rel = abs(ref_prompt - got[0, 2].item()) / (abs(ref_prompt) + 1.0)
    if not (torch.isfinite(got).all() and err <= tol and rel < 1e-3):
        raise AssertionError(f"{name}: max|kernel-plain| {err} against "
                             f"{tol}; prompt I rel. error {rel} to numpy")
    return err, tol, rel


def bench_ramp(device, n_rows: int = 12, seed: int = 0,
               n_epochs: int = N_EPOCHS) -> dict:
    """``correlate_windows_ramp`` at ``n_rows`` x 18 008, k = 9."""
    device = resolve_device(device)
    d = _inputs(device, n_rows, seed, n_epochs)
    f32 = torch.float32
    shi = torch.as_tensor(np.mod(256.0 * d["inc_c"], 1.0), dtype=f32,
                          device=device)
    slo = torch.as_tensor(np.mod(d["inc_c"], 1.0), dtype=f32, device=device)
    scal = (d["alpha"], d["remc"], shi, slo, d["bsz"])
    siq, wt = _stage(d, 0)
    got = corr.correlate_windows_ramp(siq, wt, *scal, k=d["k"])
    want = corr.correlate_windows_ramp_plain(siq, wt, *scal, k=d["k"])
    n = np.arange(d["blk"])
    cyc = (np.float32(0.1) + shi[0].item() * (n // 256).astype(np.float32)
           + slo[0].item() * (n % 256).astype(np.float32))
    ph = 2 * np.pi * (cyc - np.floor(cyc)).astype(np.float64)
    err, tol, rel = _check("ramp", got, want,
                           _numpy_prompt(d, siq, wt, np.cos(ph), np.sin(ph)))
    acc = torch.zeros(n_rows, device=device)
    before = corr.LAUNCHES["correlate_windows_ramp"]

    def step(e):
        s, w = _stage(d, e)
        acc.add_(corr.correlate_windows_ramp(s, w, *scal, k=d["k"])[:, 2])

    times = _loop_ms(step, n_epochs, device)
    return dict(name="correlate_windows_ramp", rows=n_rows, blk=d["blk"],
                k=d["k"], epochs=n_epochs, max_abs_err=err, tol=tol,
                prompt_rel_err=rel, loop_ms=times,
                loop_launches=(corr.LAUNCHES["correlate_windows_ramp"]
                               - before))


def bench_table(device, n_rows: int = 96, seed: int = 0,
                n_epochs: int = N_EPOCHS) -> dict:
    """``correlate_windows_table`` at ``n_rows`` x 18 008, k = 9."""
    device = resolve_device(device)
    d = _inputs(device, n_rows, seed, n_epochs)
    ph = 2 * np.pi * d["inc_c"][:, None] * np.arange(d["blk"])[None, :]
    tc = torch.as_tensor(np.cos(ph), dtype=torch.float32, device=device)
    ts = torch.as_tensor(np.sin(ph), dtype=torch.float32, device=device)
    phi0 = 2 * np.pi * 0.1
    c0 = torch.full((n_rows,), float(np.cos(phi0)), device=device)
    s0 = torch.full((n_rows,), float(np.sin(phi0)), device=device)
    scal = (d["alpha"], c0, s0, d["bsz"])
    siq, wt = _stage(d, 0)
    got = corr.correlate_windows_table(siq, wt, tc, ts, *scal, k=d["k"])
    want = corr.correlate_windows_table_plain(siq, wt, tc, ts, *scal,
                                              k=d["k"])
    err, tol, rel = _check("table", got, want, _numpy_prompt(
        d, siq, wt, np.cos(ph[0] + phi0), np.sin(ph[0] + phi0)))
    acc = torch.zeros(n_rows, device=device)
    before = corr.LAUNCHES["correlate_windows_table"]

    def step(e):
        s, w = _stage(d, e)
        acc.add_(corr.correlate_windows_table(s, w, tc, ts, *scal,
                                              k=d["k"])[:, 2])

    times = _loop_ms(step, n_epochs, device)
    return dict(name="correlate_windows_table", rows=n_rows, blk=d["blk"],
                k=d["k"], epochs=n_epochs, max_abs_err=err, tol=tol,
                prompt_rel_err=rel, loop_ms=times,
                loop_launches=(corr.LAUNCHES["correlate_windows_table"]
                               - before))


def report(r: dict, device) -> str:
    t = min(r["loop_ms"])
    clock = "CUDA events" if device.type == "cuda" else "host clock, CPU"
    return (f"{r['name']} {r['rows']} x {r['blk']}, k={r['k']}: "
            f"max|kernel-plain| {r['max_abs_err']:.3e} <= {r['tol']:.3e}, "
            f"prompt I rel. error to numpy {r['prompt_rel_err']:.2e}; "
            f"{r['epochs']} epochs (stage + launch) in {t:.1f} ms "
            f"({clock}; repeats "
            f"{', '.join(f'{x:.1f}' for x in r['loop_ms'])}), "
            f"{t / r['epochs'] * 1e3:.1f} us per epoch, "
            f"{t / r['epochs'] / (r['rows'] * r['blk']) * 1e6:.3f} ns per "
            "row-sample")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", required=True, help="cuda or cpu")
    ap.add_argument("--epochs", type=int, default=N_EPOCHS)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    for bench in (bench_ramp, bench_table):
        print(report(bench(device, seed=args.seed, n_epochs=args.epochs),
                     device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
