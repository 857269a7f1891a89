"""The plain reference that decides ``correct``: numpy and plain torch,
importing nothing of the program (nor jax).

``acquisition`` searches the record's leading samples again; ``tracking``
recomputes a sample of epochs from the program's per-epoch state (window
geometry, correlator sums, discriminators and loop filters, phase
propagation); ``nav`` decodes the program's prompt sums with a frozen
decoder, holds ephemerides and TOW to the transmitted truth and solves the
fixes again.  ``check`` turns them into the numbers compared with their
limits.  Each runs in the configuration's precision, or, for the control,
one step below it (``Precision``).
"""
