"""scan.traverse_roofline: as `fit.traverse_roofline`, over the rays of
the scans completed in the traced window (32 B a ray at 3.35 TB/s over
the K1 and K2 device time)."""

from perfbench import readers


def read(run):
    return readers.traverse_roofline(run)
