"""scan.prep_wait_share: the share of the traced window in the program's
``lbt.prep_wait`` spans: `Simulator.run`'s main thread waiting for the
worker thread's slice (and, on the pulse path, hash) of the next chunk."""

from perfbench import spans


def read(run):
    return spans.survey_share(run, "lbt.prep_wait")
