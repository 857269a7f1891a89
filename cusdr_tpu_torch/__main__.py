"""Command-line entry point of the PyTorch port.

Examples:
  python -m cusdr_tpu_torch signals
  python -m cusdr_tpu_torch probe --signal gps_l1ca --file L1.bin
  python -m cusdr_tpu_torch run --signal gps_l1ca --file L1.bin --out out/
  python -m cusdr_tpu_torch run --signal gps_l1ca --file L1.bin --out out/ \
      --skip-acquisition out/acqResults.npz --no-plots --timing
  python -m cusdr_tpu_torch run --signal gps_l1ca --file L1.bin \
      --time-blocks 8 --handoff-iters 1
  python -m cusdr_tpu_torch run --signal gps_l1ca --file L1.bin --device cpu
  python -m cusdr_tpu_torch run --signal glo_l1 --file G1.bin \
      --data-type int16 --file-type 1
  python -m cusdr_tpu_torch run-multi --set gps_l1ca=L1.bin \
      --set gal_e5a=E5a.bin --ms 1000 --out out/

``run`` writes acqResults.npz, trkResults.npz and navResults.npz into
``--out`` (and PNG plots unless ``--no-plots``; plots need matplotlib,
which is imported only when a plot is made); ``run-multi`` writes
trk_<signal>.npz and nav_<signal>.npz.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np


def _add_common(p):
    p.add_argument("--signal", default="gps_l1ca",
                   help="signal key (see `signals`)")
    p.add_argument("--file", required=True, help="IF sample file")
    p.add_argument("--fs", type=float, help="override sampling freq [Hz]")
    p.add_argument("--if-freq", type=float, help="override IF [Hz]")
    p.add_argument("--ms", type=int, help="ms to process")
    p.add_argument("--skip-bytes", type=int, default=0)
    p.add_argument("--prns", help="comma-separated PRN (or FDMA channel) "
                                  "search list")
    p.add_argument("--acq-threshold", type=float,
                   help="override acquisition threshold")
    p.add_argument("--file-type", type=int, choices=(1, 2),
                   help="1 = real samples, 2 = interleaved I/Q (the "
                        "preset's default)")
    p.add_argument("--data-type", choices=("schar", "int16"),
                   help="sample scalar type: schar (int8, the preset's "
                        "default) or int16")


def _add_device(p):
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda, which "
                        "raises without a card; cpu must be asked for)")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="cusdr_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("probe", help="pre-flight data checks: time "
                                     "domain, spectrum, histograms (PNG)")
    _add_common(p)
    p.add_argument("--out", default="probe.png")

    p = sub.add_parser("run", help="acquisition -> tracking -> nav -> PVT")
    _add_common(p)
    _add_device(p)
    p.add_argument("--out", default="out", help="output directory")
    p.add_argument("--skip-acquisition", metavar="ACQ_NPZ",
                   help="reuse a saved acquisition checkpoint")
    p.add_argument("--no-plots", action="store_true")
    p.add_argument("--profile", metavar="TRACE_DIR", default=None,
                   help="write a torch.profiler Chrome trace of the whole "
                        "run (acquisition through navigation: the stages' "
                        "spans beside the card's kernels and copies) into "
                        "this directory, then print the span totals under "
                        "their stages")
    p.add_argument("--timing", action="store_true",
                   help="print the per-stage timing table at the end")
    p.add_argument("--time-blocks", type=int, default=None,
                   help="track this many concurrent time blocks "
                        "(0/1 = sequential)")
    p.add_argument("--handoff-iters", type=int, default=None,
                   help="time-parallel ring state-handoff rounds")
    p.add_argument("--pilot-trk-flag", type=int, choices=(0, 1, 2),
                   default=None,
                   help="0 = data only, 1 = data+pilot (B1C: NB), "
                        "2 = B1C wideband QMBOC")
    p.add_argument("--lock-detect", dest="lock_detect",
                   action="store_true", default=None,
                   help="drop channels on loss of lock (default on)")
    p.add_argument("--no-lock-detect", dest="lock_detect",
                   action="store_false")

    p = sub.add_parser("run-multi",
                       help="several signals, one IF file each, tracked "
                            "at once")
    p.add_argument("--set", action="append", required=True,
                   metavar="SIGNAL=FILE", dest="sets",
                   help="signal preset and its IF recording; repeatable")
    p.add_argument("--ms", type=int, help="common ms span to process")
    p.add_argument("--out", default="out", help="output directory")
    _add_device(p)

    sub.add_parser("signals", help="list registered signals")
    args = ap.parse_args(argv)

    from .config import PRESETS, get_config
    if args.cmd == "signals":
        from .signals.defs import REGISTRY
        for k in sorted(PRESETS):
            sig = REGISTRY[k]
            print(f"{k:10s}  {sig.chip_rate_hz / 1e6:6.3f} Mcps x "
                  f"{sig.code_length_chips:6d} chips  codec={sig.nav_codec}")
        return 0
    if args.cmd == "run-multi":
        return _run_multi(args)

    over = {"file_name": args.file, "skip_number_of_bytes": args.skip_bytes}
    if args.fs:
        over["sampling_freq"] = args.fs
    if args.if_freq is not None:
        over["if_freq"] = args.if_freq
    if args.ms:
        over["ms_to_process"] = args.ms
    if args.prns:
        over["acq_satellite_list"] = tuple(
            int(x) for x in args.prns.split(","))
    for name in ("acq_threshold", "file_type", "data_type", "time_blocks",
                 "handoff_iters", "pilot_trk_flag", "lock_detect"):
        if getattr(args, name, None) is not None:
            over[name] = getattr(args, name)
    cfg = get_config(args.signal, **over)

    if args.cmd == "probe":
        from .io.ingest import load_if_samples
        from .plotting import probe_data
        sig_samples = load_if_samples(args.file, cfg,
                                      num_samples=int(cfg.sampling_freq
                                                      * 0.01))
        probe_data(sig_samples, cfg).savefig(args.out, dpi=110)
        print(f"probe written to {args.out}")
        return 0
    return _run(args, cfg)


def _run(args, cfg):
    from .io.ingest import read_if_file
    from .receiver import Receiver
    from .runtime.profiling import StageTimer, device_trace

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    rx = Receiver(cfg, args.device)
    samples = read_if_file(args.file, cfg)
    timer = StageTimer(sampling_freq=cfg.sampling_freq, device=rx.device)
    with device_trace(args.profile):
        done = _stages(args, cfg, rx, samples, timer, out)
    if args.profile:
        print(f"device trace written to {args.profile}/trace.json")
        print(timer.report())
    if done is None:
        return 1
    acq, channels, trk, nav = done
    if not args.no_plots:
        from .plotting import (plot_acquisition, plot_navigation,
                               plot_tracking, sky_plot)
        plot_acquisition(acq).savefig(out / "acquisition.png", dpi=110)
        for ch in range(len(channels)):
            plot_tracking(trk, ch, cfg).savefig(
                out / f"tracking_ch{ch}.png", dpi=100)
        if nav is not None:
            plot_navigation(nav).savefig(out / "navigation.png", dpi=110)
            sky_plot(nav, trk.prns).savefig(out / "skyplot.png", dpi=110)
        print(f"plots written to {out}/")
    if args.timing and not args.profile:
        print(timer.report())
    return 0


def _stages(args, cfg, rx, samples, timer, out):
    """``run``'s acquisition (or its checkpoint), tracking and navigation,
    each in its stage of ``timer``, their results saved into ``out``.
    Returns (acq, channels, trk, nav), or None where nothing was
    detected."""
    from . import checkpoint
    from .receiver import acquisition_samples, as_interleaved, nav_solve
    sig = rx.sig
    t0 = time.time()
    if args.skip_acquisition:
        samples = as_interleaved(cfg, samples)
        acq = checkpoint.load_acquisition(args.skip_acquisition)
        print(f"acquisition reused from {args.skip_acquisition}")
    else:
        with timer.stage("acquisition",
                         samples=acquisition_samples(cfg, sig)):
            samples, acq = rx.acquire(samples)
        checkpoint.save_acquisition(out / "acqResults.npz", acq)
        print(f"acquisition done in {time.time() - t0:.1f}s -> "
              f"{out / 'acqResults.npz'}")
    channels = acq.best_channels(cfg.num_channels)
    print(f"acquisition: {len(channels)} channels "
          f"(PRN {','.join(str(c[0]) for c in channels)})")
    if not channels:
        print("no signals detected")
        return None
    if not args.no_plots:
        from .plotting import show_channel_status
        print(show_channel_status(channels, acq, cfg))

    n_epochs = None
    if cfg.ms_to_process:
        # never more epochs than the record holds
        spc = cfg.samples_per_code
        avail = (len(samples) // 2 - 3 * spc) // spc
        n_epochs = max(min(int(cfg.ms_to_process / sig.code_period_ms),
                           avail), 1)
    t0 = time.time()
    with timer.stage("tracking", samples=len(samples) // 2):
        trk = rx.track(samples, channels, n_epochs)
    checkpoint.save_tracking(out / "trkResults.npz", trk)
    print(f"tracking: {trk.i_p.shape[1]} epochs in {time.time() - t0:.2f} "
          f"s -> {out / 'trkResults.npz'}")

    t0 = time.time()
    with timer.stage("navigation"):
        nav = nav_solve(cfg, sig, trk)
    if nav is None:
        print("no navigation solution (too few decoded channels)")
    else:
        checkpoint.save_navigation(out / "navResults.npz", nav)
        print(f"PVT: {len(nav.X)} fixes in {time.time() - t0:.1f}s, mean "
              f"lat={np.mean(nav.latitude):.6f} "
              f"lon={np.mean(nav.longitude):.6f} "
              f"h={np.mean(nav.height):.1f} m")
    return acq, channels, trk, nav


def _run_multi(args):
    from . import checkpoint
    from .config import get_config
    from .receiver import run_multi
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    entries = []
    for item in args.sets:
        name, _, path = item.partition("=")
        if not path:
            print(f"--set needs SIGNAL=FILE, got {item!r}")
            return 2
        cfg = get_config(name, file_name=path,
                         **({"ms_to_process": args.ms} if args.ms else {}))
        entries.append((cfg, None))
    results = run_multi(entries, device=args.device, n_ms=args.ms)
    rc = 1
    for (cfg, _), res in zip(entries, results):
        tag = cfg.signal
        if not res.channels:
            print(f"{tag}: no signals detected")
            continue
        rc = 0
        checkpoint.save_tracking(out / f"trk_{tag}.npz", res.track)
        prns = ",".join(str(p) for p, *_ in res.channels)
        msg = (f"{tag}: {len(res.channels)} channels (PRN {prns}), "
               f"{res.track.i_p.shape[1]} epochs")
        if res.nav is not None and len(res.nav.X):
            checkpoint.save_navigation(out / f"nav_{tag}.npz", res.nav)
            msg += (f", {len(res.nav.X)} fixes, mean lat="
                    f"{np.mean(res.nav.latitude):.6f} lon="
                    f"{np.mean(res.nav.longitude):.6f}")
        print(msg)
    return rc


if __name__ == "__main__":
    sys.exit(main())
