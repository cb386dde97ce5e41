"""scan.cull_share: the share of the traced window in `Simulator.run`'s
`stats["cull_s"]`: each chunk's upload and cull (K5, buckets, ladders)
to a synchronize."""

from perfbench import readers


def read(run):
    return readers.span_share(run, "cull_s")
