"""Command-line entry point of the PyTorch port.

Examples:
  python -m cusdr_tpu_torch signals
  python -m cusdr_tpu_torch run --signal gps_l1ca --file L1.bin --device cuda
  python -m cusdr_tpu_torch run --signal gps_l1ca --file L1.bin --device cuda \
      --time-blocks 8 --handoff-iters 1
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(prog="cusdr_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("run", help="acquisition -> tracking -> nav -> PVT")
    p.add_argument("--signal", default="gps_l1ca",
                   help="signal key (see `signals`)")
    p.add_argument("--file", required=True, help="IF sample file")
    p.add_argument("--device", required=True,
                   help="torch device to run on, e.g. cuda or cpu")
    p.add_argument("--fs", type=float, help="override sampling freq [Hz]")
    p.add_argument("--if-freq", type=float, help="override IF [Hz]")
    p.add_argument("--ms", type=int, help="ms to process")
    p.add_argument("--skip-bytes", type=int, default=0)
    p.add_argument("--prns", help="comma-separated PRN search list")
    p.add_argument("--time-blocks", type=int, default=None,
                   help="track this many concurrent time blocks "
                        "(0/1 = sequential)")
    p.add_argument("--handoff-iters", type=int, default=None,
                   help="time-parallel ring state-handoff rounds")
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
    for name in ("time_blocks", "handoff_iters"):
        if getattr(args, name) is not None:
            over[name] = getattr(args, name)
    cfg = get_config(args.signal, **over)

    from .io.ingest import read_if_file
    from .receiver import Receiver
    samples = read_if_file(args.file, cfg)
    rx = Receiver(cfg, args.device)
    n_epochs = None
    if cfg.ms_to_process:
        # never more epochs than the record holds
        spc = cfg.samples_per_code
        avail = (len(samples) // 2 - 3 * spc) // spc
        n_epochs = max(min(int(cfg.ms_to_process / rx.sig.code_period_ms),
                           avail), 1)
    res = rx.run(samples, n_epochs=n_epochs)
    t = res.timings
    print(f"acquisition: {len(res.channels)} channels "
          f"(PRN {','.join(str(c[0]) for c in res.channels)}) in "
          f"{t['acquisition_s']:.2f} s")
    if not res.channels:
        print("no signals detected")
        return 1
    print(f"tracking: {res.track.i_p.shape[1]} epochs in "
          f"{t['tracking_s']:.2f} s")
    if res.nav is None:
        print("no navigation solution (too few decoded channels)")
        return 0
    print(f"PVT: {len(res.nav.X)} fixes, mean lat="
          f"{np.mean(res.nav.latitude):.6f} lon="
          f"{np.mean(res.nav.longitude):.6f} h="
          f"{np.mean(res.nav.height):.1f} m")
    return 0


if __name__ == "__main__":
    sys.exit(main())
