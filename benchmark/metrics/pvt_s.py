"""Mean seconds per record of the window of navigation's fixes: the
measurement-epoch loop of pseudoranges, orbits, least squares and geodesy
(the program's span ``nav.pvt``, ``ReceiverResults.timings["nav_pvt_s"]``),
read in the traced run; None where the program has no such span."""


def read(run):
    vals = [r["timings"]["nav_pvt_s"] for r in run.records
            if "nav_pvt_s" in r["timings"]]
    return sum(vals) / len(vals) if vals else None
