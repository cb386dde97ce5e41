"""scan.readback_share: the share of the traced window in
`Simulator.run`'s `stats["readback_s"]`: the compacted clouds' copies to
the host."""

from perfbench import readers


def read(run):
    return readers.span_share(run, "readback_s")
