"""scan.construct_share: the share of the traced window spent inside
each `Simulator`'s construction (the wrapper around `api.Simulator`)."""

from perfbench import readers


def read(run):
    return readers.span_share(run, "construct_s")
