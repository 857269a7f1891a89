"""The superblock kernel's share of its roofline with a pilot bank (S1p),
in %."""

from benchmark.metrics._superblock import roofline


def read(run):
    return roofline(run, 1)
