"""fit.forward_idle_ms: milliseconds a step in which the host is inside
the program's ``lbt.forward`` span (the traversal, returns, shading,
cloud and loss of `bench.make_step`'s step) and no device interval of the
traced run (`trace.py`'s device operations) runs: the card waiting on the
forward's host work."""

from perfbench import spans


def read(run):
    return spans.idle_ms(run, "lbt.forward")
