"""Shared by the superblock kernels' roofline readers: the least time of
the window's tracking work over the kernel's device time in the trace."""

import re

from benchmark.roofline import bound_s, superblock_work

KERNEL = "track_superblock_kernel"
_PILOTS = re.compile(KERNEL + r"<\s*\w+\s*,\s*(\d+)")


def kernel_seconds(trace, pilots: int) -> float:
    """Device seconds of the superblock kernel instantiated for
    ``pilots`` pilot banks."""
    total = 0.0
    for name, sec in trace.op_seconds.items():
        if KERNEL not in name:
            continue
        m = _PILOTS.search(name)
        if m is not None and int(m.group(1)) != pilots:
            continue
        total += sec
    return total


def roofline(run, pilots: int):
    """100 * least time / kernel time, or None where the cell's bank has
    another number of pilots or the trace holds no such kernel."""
    s, g = run.config["settings"], run.config["signal"]
    has = 1 if s["pilot_trk_flag"] > 0 and g.get("pilot") else 0
    if run.trace is None or has != pilots:
        return None
    ksec = kernel_seconds(run.trace, pilots)
    if ksec <= 0:
        return None
    spc = int(round(s["sampling_freq"]
                    / (g["chip_rate_hz"] / g["code_length_chips"])))
    least = 0.0
    for r in run.records:
        w = r["work"]
        if w["rows"] == 0:
            continue
        n_bytes, ops = superblock_work(
            rows=w["rows"], epochs=w["epochs"],
            valid_epochs=w["valid_epochs"], valid_samples=w["valid_samples"],
            span=w["span"], blk=spc + s["track_block_pad"], pilots=pilots,
            interp=s["interp_taps"],
            sample_bytes=2 if s["data_type"] == "schar" else 4)
        least += bound_s(n_bytes, ops)[0]
    return 100.0 * least / ksec
