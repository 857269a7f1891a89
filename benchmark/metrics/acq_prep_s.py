"""Mean seconds per record of the window of acquisition's host preparation:
the record's leading samples interleaved and made complex float32, then
the slabs and the conjugate code spectra built and copied to the device
(the program's spans ``acq.input`` and ``acq.codes``,
``ReceiverResults.timings["acq_input_s"]`` + ``["acq_codes_s"]``), read in
the traced run; None where the program has no such spans."""


def read(run):
    vals = [r["timings"]["acq_input_s"] + r["timings"]["acq_codes_s"]
            for r in run.records
            if "acq_input_s" in r["timings"]
            and "acq_codes_s" in r["timings"]]
    return sum(vals) / len(vals) if vals else None
