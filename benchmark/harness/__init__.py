"""The harness: finds a cell's files by name, makes its records, drives
the program through the measured window, reads the trace and the metrics,
and has the reference judge the outputs.  ``program`` is the one module
that imports cusdr_tpu_torch."""
