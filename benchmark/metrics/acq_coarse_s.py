"""Mean seconds per record of the window of acquisition's coarse search: the
PCPS kernels, their results read back to the host and the detection metric
(the program's span ``acq.coarse``,
``ReceiverResults.timings["acq_coarse_s"]``), read in the traced run; None
where the program has no such span."""


def read(run):
    vals = [r["timings"]["acq_coarse_s"] for r in run.records
            if "acq_coarse_s" in r["timings"]]
    return sum(vals) / len(vals) if vals else None
