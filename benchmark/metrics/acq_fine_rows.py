"""Mean detected PRNs per record whose fine search acquisition ran (the
program's counter ``acq_fine_rows``, counted inside the span ``acq.fine``,
``ReceiverResults.timings["acq_fine_rows"]``), read in the traced run;
None where the program has no such counter."""


def read(run):
    vals = [r["timings"]["acq_fine_rows"] for r in run.records
            if "acq_fine_rows" in r["timings"]]
    return sum(vals) / len(vals) if vals else None
