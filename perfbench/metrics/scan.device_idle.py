"""scan.device_idle: 1 - (union of device intervals) / traced window."""

from perfbench import readers


def read(run):
    return readers.device_idle(run)
