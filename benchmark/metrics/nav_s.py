"""Mean seconds of the receiver's navigation stage per record of the window
(``ReceiverResults.timings["navigation_s"]``, a stage ended with the device
synchronised), read in the traced run."""


def read(run):
    vals = [r["timings"]["navigation_s"] for r in run.records
            if "navigation_s" in r["timings"]]
    return sum(vals) / len(vals) if vals else None
