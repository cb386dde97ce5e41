"""scan.rays_share: the share of the traced window in the program's
``lbt.rays`` spans on the main thread (`api.build_rays`: the flight plan
and the survey's rays), inside `api.simulate`."""

from perfbench import spans


def read(run):
    return spans.survey_share(run, "lbt.rays")
