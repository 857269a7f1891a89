"""The superblock kernel's share of its roofline on the data bank (S1:
``track_superblock_kernel`` with no pilot), in %."""

from benchmark.metrics._superblock import roofline


def read(run):
    return roofline(run, 0)
