"""Mean seconds per record of the window of tracking's results: the
superblocks' outputs merged and ``TrackResults`` built (active_until, the
C/N0 of every channel's every 40 ms window; the program's span
``trk.results``, ``ReceiverResults.timings["trk_results_s"]``), read in the
traced run; None where the program has no such span."""


def read(run):
    vals = [r["timings"]["trk_results_s"] for r in run.records
            if "trk_results_s" in r["timings"]]
    return sum(vals) / len(vals) if vals else None
