"""A second witness for the lock of a cell's channels: the program's
tracking against the reference's own eager loop (``tracking.follow``) run
from the same acquisition hand-off over the whole record, channel by
channel, as one JSON line per record.

    python3 -m benchmark.harness.witness --workload e5a_snap4s \
        --seed 3200000001 [--records 0,1] [--device cuda]

For each channel: its PRN; the sky's Doppler; the hand-off's, the
program's and the witness's carrier at the end (all less the IF); whether
the program keeps it to the end; and for each side, over its last
``LOCK_EPOCHS`` epochs, the envelope over the noise of one sum and the
share of epochs with |I| > |Q| (the program's from its prompts recomputed
by the reference)."""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np


def _lock(i_p, q_p, noise):
    return (float(np.mean(np.hypot(i_p, q_p)) / np.mean(noise)),
            float(np.mean(np.abs(i_p) > np.abs(q_p))))


def witness(cell, seed: int, records, device, out=sys.stdout):
    import torch
    from . import program, records as records_mod
    from ..reference import tracking
    from ..reference.check import LOCK_EPOCHS, check_record
    from ..reference.precision import REFERENCE
    from ..traffic.codes import signal_of
    from ..traffic.scenario import rng_of
    s, g = cell.config["settings"], cell.config["signal"]
    codes = signal_of(g)
    pool = records_mod.make_pool(cell.config, cell.traffic, seed, device)
    rx = program.receiver(cell.config, device)
    for j in records:
        t0 = time.perf_counter()
        iq, sky = pool[j]
        prog = program.plain(rx.run(iq))
        trk = prog["track"]
        nums, _ = check_record(iq, prog, sky, s, g, codes, device,
                               REFERENCE, rng_of(seed, 3, j))
        n_ep = trk["blksize"].shape[1]
        tables = tracking.tables_for(trk, s, g, codes)
        wit = tracking.follow(iq, trk, tables, s, g, device, REFERENCE,
                              n_ep)
        dopp = {sv.prn: sv.doppler_hz for sv in sky.svs}
        chans = []
        for c, prn in enumerate(trk["prns"]):
            valid = np.flatnonzero(trk["blksize"][c, :n_ep - 1] > 0)
            tail = valid[-LOCK_EPOCHS:]
            r = tracking.recompute(iq, trk, np.full(len(tail), c), tail,
                                   tables, s, g, device, REFERENCE)
            w = np.s_[c, -LOCK_EPOCHS:]
            ifq = s["if_freq"]
            chans.append(dict(
                prn=int(prn), sky_dopp=dopp.get(int(prn)),
                handoff_dopp=float(trk["carr_freq"][c, 0] - ifq),
                prog_end_dopp=float(trk["carr_freq"][c, tail[-1]] - ifq),
                wit_end_dopp=float(wit["carr_freq"][w][-1] - ifq),
                kept=bool(trk["active_until"][c] == n_ep),
                active_until=int(trk["active_until"][c]),
                prog=_lock(r["i_p"], r["q_p"], r["noise"]),
                wit=_lock(wit["i_p"][w], wit["q_p"][w], wit["noise"][w]),
                prog_carr_track=[float(trk["carr_freq"][c, e] - ifq)
                                 for e in range(0, n_ep, 250)],
                wit_carr_track=[float(wit["carr_freq"][c, e] - ifq)
                                for e in range(0, wit["carr_freq"].shape[1],
                                               250)]))
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        print(json.dumps(dict(seed=seed, record=j, epochs=n_ep,
                              wit_epochs=int(wit["i_p"].shape[1]),
                              trk_lock_diff=nums["trk_lock_diff"],
                              seconds=time.perf_counter() - t0,
                              channels=chans)), file=out, flush=True)


def main(argv=None) -> int:
    from . import cells
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--records", default="")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    cell = cells.find_cell(Path.cwd(), a.workload)
    recs = [int(x) for x in a.records.split(",") if x] or \
        list(range(cell.traffic["pool"]))
    witness(cell, a.seed, recs, a.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
