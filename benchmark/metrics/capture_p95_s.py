"""95th percentile of the wall seconds from a record's call to its
results, over every record of the window."""

import numpy as np


def read(run):
    if not run.records:
        return None
    return float(np.percentile([r["latency_s"] for r in run.records], 95))
