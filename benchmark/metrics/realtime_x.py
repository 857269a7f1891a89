"""Seconds of record processed per wall second: all the record seconds the
window completed over the window's seconds."""


def read(run):
    if not run.records:
        return None
    return sum(r["record_s"] for r in run.records) / run.window_s
