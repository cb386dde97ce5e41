"""scan.unspanned_share: the share of the traced window that no span of
the program's main thread below ``lbt.simulate`` covers (1 - the union of
``lbt.rays``, ``lbt.construct``, ``lbt.run`` and what they hold, over the
window): the time the program's spans leave unnamed."""

from perfbench import spans


def read(run):
    covered = spans.survey_share(run, None)
    return None if covered is None else 1.0 - covered
