"""scan.order_share: the share of the traced window in
`Simulator.run`'s `stats["order_s"]`: the host gather, BSP order and
ray-content keys."""

from perfbench import readers


def read(run):
    return readers.span_share(run, "order_s")
