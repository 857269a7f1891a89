"""Mean seconds per record of the window of tracking's set-up before its
superblock loop: loop constants, code tables built and copied to the device,
channel state, window plan and staging ring (the program's span
``trk.setup``, ``ReceiverResults.timings["trk_setup_s"]``), read in the
traced run; None where the program has no such span."""


def read(run):
    vals = [r["timings"]["trk_setup_s"] for r in run.records
            if "trk_setup_s" in r["timings"]]
    return sum(vals) / len(vals) if vals else None
