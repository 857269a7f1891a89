"""Share of the window's records whose acquisition took its conjugate code
spectra from the program's cache on the device (the program's counter
``acq_codes_hit``, 1 a hit and 0 a build, counted inside the span
``acq.codes``, ``ReceiverResults.timings["acq_codes_hit"]``), in %, read
in the traced run; None where the program has no such counter."""


def read(run):
    vals = [r["timings"]["acq_codes_hit"] for r in run.records
            if "acq_codes_hit" in r["timings"]]
    return 100.0 * sum(vals) / len(vals) if vals else None
