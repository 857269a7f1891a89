"""Mean seconds per record of the window of Galileo's de-interleave and
Viterbi decode of every page, inside navigation's decode (the program's
span ``nav.fec``, ``ReceiverResults.timings["nav_fec_s"]``), read in the
traced run; None where the program has no such span."""


def read(run):
    vals = [r["timings"]["nav_fec_s"] for r in run.records
            if "nav_fec_s" in r["timings"]]
    return sum(vals) / len(vals) if vals else None
