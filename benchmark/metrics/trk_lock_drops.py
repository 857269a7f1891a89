"""Mean channels per record of the window that tracking's lock gate
dropped before the record's end (the program's counter
``ReceiverResults.timings["trk_lock_drops"]``), read in the traced run;
None where the program has no such counter."""


def read(run):
    vals = [r["timings"]["trk_lock_drops"] for r in run.records
            if "trk_lock_drops" in r["timings"]]
    return sum(vals) / len(vals) if vals else None
