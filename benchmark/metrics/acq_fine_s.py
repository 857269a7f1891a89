"""Mean seconds per record of the window of acquisition's fine stage: the
detected PRNs' segments copied to the device, their replicas, the fine
search and its read-back (the program's span ``acq.fine``,
``ReceiverResults.timings["acq_fine_s"]``), read in the traced run; None
where the program has no such span."""


def read(run):
    vals = [r["timings"]["acq_fine_s"] for r in run.records
            if "acq_fine_s" in r["timings"]]
    return sum(vals) / len(vals) if vals else None
