"""Mean seconds of the receiver's tracking stage per record of the window
(``ReceiverResults.timings["tracking_s"]``, a stage ended with the device
synchronised), read in the traced run."""


def read(run):
    vals = [r["timings"]["tracking_s"] for r in run.records
            if "tracking_s" in r["timings"]]
    return sum(vals) / len(vals) if vals else None
