"""Mean seconds per record of the window of navigation's frame sync and
decode of every channel's message, apart from the fixes (the program's span
``nav.decode``, ``ReceiverResults.timings["nav_decode_s"]``), read in the
traced run; None where the program has no such span."""


def read(run):
    vals = [r["timings"]["nav_decode_s"] for r in run.records
            if "nav_decode_s" in r["timings"]]
    return sum(vals) / len(vals) if vals else None
