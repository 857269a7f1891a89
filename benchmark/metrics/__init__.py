"""One reader per metric, found by the metric's name: ``<name>.py`` holds
``read(run) -> float | None`` (None: nothing to read in this run, and the
metric is left out of the line).  ``run`` holds the window's records
(``record_s``, ``latency_s``, ``timings``, ``work``), ``window_s``,
``setup_s``, ``trace`` (None in an untraced run), ``config`` and
``traffic``."""
