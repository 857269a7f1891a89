"""Mean seconds per record of the window of the tracking loop's waits on the
device: for a staging slot's last copy before restaging it, and for a
superblock's outputs before draining them (the program's span ``trk.wait``,
``ReceiverResults.timings["trk_wait_s"]``), read in the traced run; None
where the program has no such span."""


def read(run):
    vals = [r["timings"]["trk_wait_s"] for r in run.records
            if "trk_wait_s" in r["timings"]]
    return sum(vals) / len(vals) if vals else None
