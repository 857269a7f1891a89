"""Mean seconds of the receiver's acquisition stage per record of the window
(``ReceiverResults.timings["acquisition_s"]``, a stage ended with the device
synchronised), read in the traced run."""


def read(run):
    vals = [r["timings"]["acquisition_s"] for r in run.records
            if "acquisition_s" in r["timings"]]
    return sum(vals) / len(vals) if vals else None
