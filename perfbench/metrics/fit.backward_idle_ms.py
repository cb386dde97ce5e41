"""fit.backward_idle_ms: milliseconds a step in which the host is inside
the program's ``lbt.backward`` span (autograd's backward of the step's
loss) and no device interval of the traced run runs: the card waiting on
the backward's host work."""

from perfbench import spans


def read(run):
    return spans.idle_ms(run, "lbt.backward")
