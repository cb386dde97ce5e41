"""fit.device_idle: the share of the traced window in which no operation
ran on the device, 1 - (union of device intervals) / window."""

from perfbench import readers


def read(run):
    return readers.device_idle(run)
